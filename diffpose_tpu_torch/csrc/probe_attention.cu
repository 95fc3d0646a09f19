// Capability probe (kernel row 12): batched attention o[t] = softmax(q[t] k[t]^T) v[t]
// for q, k, v [T, F, 24], no 1/sqrt(dk) scale, with both products on the
// tensor cores: mma.sync.aligned.m16n8k8 TF32 in inline PTX, f32 accumulation.
// Counterpart of scripts/probe_batched_dot.py:kernel (which asked whether
// Mosaic lowers a batched dot_general); this one asks what error TF32 tensor
// cores give at the video family's temporal shapes:
//   MODE 1 (1xTF32): a * b with both operands rounded to TF32;
//   MODE 3 (3xTF32): each operand split as big = tf32(x), small = tf32(x - big),
//                    and big*big + big*small + small*big accumulated in f32
//                    (the Hopper counterpart of the bf16x3 split of
//                    diffpose_tpu/ops/pallas_denoiser.py:_dot).
// The softmax is f32.  Nothing on a main path calls this.
//
// One CTA a row t, one warp per 16 query frames (F <= 96).  Q, K and V are
// staged in shared memory, zero-padded to whole tiles; each warp keeps its
// 16 x F score strip in registers (accumulator layout), takes the softmax
// there (a row's entries live in the 4 lanes of a quad), writes the
// probabilities to its own shared-memory strip and reads them back in the
// A-operand layout for P V.  The TF32 split and the mma are
// csrc/mma_tf32.cuh's.  Plain C interface for ctypes, built by
// diffpose_tpu_torch/ops/_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "mma_tf32.cuh"

namespace probe_attn {

using tf32::mma_f32;

constexpr int DK = 24;
constexpr int MAX_F = 96;
constexpr int MAX_WARPS = MAX_F / 16;        // query tiles of 16
constexpr int MAX_NT = MAX_F / 8;            // key tiles of 8
constexpr int LDQ = DK + 4;                  // row strides in shared memory, floats
constexpr int LDP = MAX_F + 4;

template <int MODE>
__global__ void __launch_bounds__(32 * MAX_WARPS) attention_kernel(const float* __restrict__ q,
                                                                    const float* __restrict__ k,
                                                                    const float* __restrict__ v,
                                                                    float* __restrict__ o,
                                                                    int frames) {
  extern __shared__ float4 smem4[];
  const int qtiles = (frames + 15) / 16, ktiles = (frames + 7) / 8;
  const int qrows = 16 * qtiles, krows = 8 * ktiles;
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + qrows * LDQ;
  float* vs = ks + krows * LDQ;
  float* ps = vs + krows * LDQ;  // [warps][16][LDP]
  const size_t base = static_cast<size_t>(blockIdx.x) * frames * DK;
  const int tid = threadIdx.x, nthreads = blockDim.x;

  for (int i = tid; i < qrows * DK; i += nthreads) {
    const int r = i / DK, c = i % DK;
    qs[r * LDQ + c] = r < frames ? q[base + i] : 0.f;
  }
  for (int i = tid; i < krows * DK; i += nthreads) {
    const int r = i / DK, c = i % DK;
    ks[r * LDQ + c] = r < frames ? k[base + i] : 0.f;
    vs[r * LDQ + c] = r < frames ? v[base + i] : 0.f;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int q0 = 16 * warp;
  // S = Q K^T for the warp's 16 queries against every key tile
  float s[MAX_NT][4];
#pragma unroll
  for (int j = 0; j < MAX_NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
    if (j >= ktiles) continue;
#pragma unroll
    for (int kk = 0; kk < DK; kk += 8) {
      const float a[4] = {qs[(q0 + g) * LDQ + kk + t], qs[(q0 + g + 8) * LDQ + kk + t],
                          qs[(q0 + g) * LDQ + kk + t + 4], qs[(q0 + g + 8) * LDQ + kk + t + 4]};
      const float b[2] = {ks[(8 * j + g) * LDQ + kk + t], ks[(8 * j + g) * LDQ + kk + t + 4]};
      mma_f32<MODE>(s[j], a, b);
    }
  }
  // softmax over the real keys, rows g (entries 0, 1) and g + 8 (entries 2, 3)
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < MAX_NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool real = j < ktiles && 8 * j + 2 * t + (i & 1) < frames;
      if (real) mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
#pragma unroll
  for (int j = 0; j < MAX_NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool real = j < ktiles && 8 * j + 2 * t + (i & 1) < frames;
      s[j][i] = real ? expf(s[j][i] - mx[i >> 1]) : 0.f;
      sum[i >> 1] += s[j][i];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
  }
  float* pw = ps + warp * 16 * LDP;
#pragma unroll
  for (int j = 0; j < MAX_NT; ++j) {
    if (j >= ktiles) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pw[(g + 8 * (i >> 1)) * LDP + 8 * j + 2 * t + (i & 1)] = s[j][i] / sum[i >> 1];
  }
  __syncwarp();
  // O = P V: the warp's 16 queries, DK / 8 output tiles, a reduction over the key tiles
#pragma unroll
  for (int jn = 0; jn < DK / 8; ++jn) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kt = 0; kt < ktiles; ++kt) {
      const int kk = 8 * kt;
      const float a[4] = {pw[g * LDP + kk + t], pw[(g + 8) * LDP + kk + t],
                          pw[g * LDP + kk + t + 4], pw[(g + 8) * LDP + kk + t + 4]};
      const float b[2] = {vs[(kk + t) * LDQ + 8 * jn + g], vs[(kk + t + 4) * LDQ + 8 * jn + g]};
      mma_f32<MODE>(acc, a, b);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + g + 8 * (i >> 1);
      if (row < frames) o[base + row * DK + 8 * jn + 2 * t + (i & 1)] = acc[i];
    }
  }
}

template <int MODE>
cudaError_t launch(int rows, int frames, const float* q, const float* k, const float* v, float* o,
                   cudaStream_t stream) {
  const int qtiles = (frames + 15) / 16, krows = 8 * ((frames + 7) / 8);
  const int smem = static_cast<int>(sizeof(float)) *
                   (16 * qtiles * LDQ + 2 * krows * LDQ + qtiles * 16 * LDP);
  auto kernel = attention_kernel<MODE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<rows, 32 * qtiles, smem, stream>>>(q, k, v, o, frames);
  return cudaGetLastError();
}

}  // namespace probe_attn

// o [T, F, 24] = softmax(q k^T) v per row for q, k, v [T, F, 24], F <= 96;
// mode 1 (1xTF32) or 3 (3xTF32).  Returns 0 or the cudaError_t.
extern "C" int probe_attention(int device, int mode, int rows, int frames, int dk, const float* q,
                               const float* k, const float* v, float* o, void* stream) {
  if (rows < 1 || frames < 1 || frames > probe_attn::MAX_F || dk != probe_attn::DK ||
      q == nullptr || k == nullptr || v == nullptr || o == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == 1) return probe_attn::launch<1>(rows, frames, q, k, v, o, s);
  if (mode == 3) return probe_attn::launch<3>(rows, frames, q, k, v, o, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* probe_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
