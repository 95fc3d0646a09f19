// Host entry of the Chebyshev graph convolution kernel (cheb_kernel.cuh), with
// a plain C interface for ctypes.  Built by diffpose_tpu_torch/ops/_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC
#include <cuda_runtime.h>

#include <algorithm>

#include "cheb_kernel.cuh"

namespace {

template <int VC, int VD>
cudaError_t launch(const chebk::ChebArgs& a, int smem, cudaStream_t stream) {
  auto kernel = chebk::cheb_kernel<VC, VD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = (a.batch + a.tb - 1) / a.tb;
  kernel<<<grid, chebk::THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Samples a CTA takes for these widths (0 if one sample's mix does not fit).
extern "C" int cheb_tile(int n_pts, int c_in, int orders) {
  const long per_sample = 4L * n_pts * orders * c_in;
  if (per_sample > chebk::SMEM_MAX) return 0;
  return static_cast<int>(
      std::clamp<long>(chebk::SMEM_TARGET / per_sample, 1, chebk::TB_MAX));
}

// y [B, N, D] = sum_k T_k x W_k + bias for x [B, N, C], w [K1, C, D], with the
// Chebyshev terms (ptr, idx, val) of the basis, on `stream` of `device`.
// Takes N <= 32, K1 <= 8, any C, D >= 1 and any batch >= 1; pointers 16-byte
// aligned.  Returns 0 or the cudaError_t of the refused arguments or launch.
extern "C" int cheb_forward(int device, int batch, int n_pts, int c_in, int d_out, int orders,
                            const float* x, const float* w, const float* bias, float* y,
                            const int* ptr, const int* idx, const float* val, void* stream) {
  if (batch < 1 || n_pts < 1 || n_pts > chebk::MAX_PTS || c_in < 1 || d_out < 1 || orders < 1 ||
      orders > chebk::MAX_ORDERS || x == nullptr || w == nullptr || bias == nullptr ||
      y == nullptr || ptr == nullptr || idx == nullptr || val == nullptr)
    return cudaErrorInvalidValue;
  const int tb = cheb_tile(n_pts, c_in, orders);
  if (tb == 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const chebk::ChebArgs a{x, w, bias, y, ptr, idx, val, batch, n_pts, c_in, d_out, orders, tb};
  const int smem = 4 * tb * n_pts * orders * c_in;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vc = c_in % 4 == 0, vd = d_out % 4 == 0;
  if (vc && vd) return launch<4, 4>(a, smem, s);
  if (vc) return launch<4, 1>(a, smem, s);
  if (vd) return launch<1, 4>(a, smem, s);
  return launch<1, 1>(a, smem, s);
}

extern "C" const char* cheb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
