// Check of the plain model of the tensor cores' TF32 arithmetic
// (diffpose_tpu_torch/ops/tf32.py): C [M, N] = C0 + A [M, K] @ W [K, N] on
// mma.sync.aligned.m16n8k8 TF32, each warp one 16 x 8 tile of C^T = W^T A^T
// as train_kernel.cuh:tc_gemm lays it out (W's columns on the M side, A's
// rows on the N side), fragments read straight from global memory:
//   MODE 0: 1xTF32, the whole K into one accumulator that starts at C0 (the
//           operands rounded by to_tf32; C0's bits as given);
//   MODE 1: 3xTF32 as tc_gemm computes it: each k-step of 8 a fresh partial
//           sum of W_big A_small, W_small A_big and W_big A_big, in that order,
//           added to the f32 accumulator with round-to-nearest (C0 ignored);
//   MODE 2: 3xTF32 with the three passes fed into the one accumulator over the
//           whole K (C0 ignored), the design tc_gemm replaced.
// Nothing on a main path calls this.  M % 8 == 0, N % 16 == 0, K % 8 == 0.
// Plain C interface for ctypes, built by diffpose_tpu_torch/ops/_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_tf32.cuh"

namespace probe_tf32 {

constexpr int WARPS = 4;

template <int MODE>
__global__ void __launch_bounds__(32 * WARPS)
gemm_kernel(const float* __restrict__ a, const float* __restrict__ w, const float* __restrict__ c0,
            float* __restrict__ c, int m, int n, int k) {
  const int ctiles = n / 16, tiles = ctiles * (m / 8);
  const int tile = blockIdx.x * WARPS + threadIdx.x / 32;
  if (tile >= tiles) return;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int col0 = 16 * (tile % ctiles), row0 = 8 * (tile / ctiles);
  float acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + 2 * t + (i & 1), col = col0 + g + 8 * (i >> 1);
    acc[i] = MODE == 0 ? c0[r * n + col] : 0.f;
  }
  for (int k0 = 0; k0 < k; k0 += 8) {
    // the mma's A operand: W^T (16 columns x 8 k); its B operand: A^T (8 k x 8 rows)
    float wf[4], af[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) wf[i] = w[(k0 + t + 4 * (i >> 1)) * n + col0 + g + 8 * (i & 1)];
#pragma unroll
    for (int i = 0; i < 2; ++i) af[i] = a[(row0 + g) * k + k0 + t + 4 * i];
    uint32_t wb[4], ws[4], ab[2], as[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) tf32::split(wf[i], wb[i], ws[i]);
#pragma unroll
    for (int i = 0; i < 2; ++i) tf32::split(af[i], ab[i], as[i]);
    if constexpr (MODE == 0) {
      tf32::mma(acc, wb, ab);
    } else if constexpr (MODE == 1) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      tf32::mma(part, wb, as);
      tf32::mma(part, ws, ab);
      tf32::mma(part, wb, ab);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += part[i];
    } else {
      tf32::mma(acc, wb, as);
      tf32::mma(acc, ws, ab);
      tf32::mma(acc, wb, ab);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) c[(row0 + 2 * t + (i & 1)) * n + col0 + g + 8 * (i >> 1)] = acc[i];
}

template <int MODE>
cudaError_t launch(int m, int n, int k, const float* a, const float* w, const float* c0, float* c,
                   cudaStream_t stream) {
  const int tiles = (n / 16) * (m / 8);
  gemm_kernel<MODE><<<(tiles + WARPS - 1) / WARPS, 32 * WARPS, 0, stream>>>(a, w, c0, c, m, n, k);
  return cudaGetLastError();
}

}  // namespace probe_tf32

// c [m, n] = (c0 +) a [m, k] @ w [k, n] in mode 0, 1 or 2 (above), row-major
// float32.  Returns 0 or the cudaError_t.
extern "C" int probe_tf32_gemm(int device, int mode, int m, int n, int k, const float* a,
                               const float* w, const float* c0, float* c, void* stream) {
  if (m < 8 || n < 16 || k < 8 || m % 8 || n % 16 || k % 8 || a == nullptr || w == nullptr ||
      c0 == nullptr || c == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == 0) return probe_tf32::launch<0>(m, n, k, a, w, c0, c, s);
  if (mode == 1) return probe_tf32::launch<1>(m, n, k, a, w, c0, c, s);
  if (mode == 2) return probe_tf32::launch<2>(m, n, k, a, w, c0, c, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* probe_tf32_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
