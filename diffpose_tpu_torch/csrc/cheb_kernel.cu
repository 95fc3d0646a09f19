// Host entry of the Chebyshev graph convolution kernels (cheb_kernel.cuh), with
// a plain C interface for ctypes.  Built by diffpose_tpu_torch/ops/_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC
#include <cuda_runtime.h>

#include <algorithm>

#include "cheb_kernel.cuh"

namespace {

enum Kind { WIDE = 0, MIX = 1, PROJ = 2 };

struct Plan {
  int kind, tb, tiles, chunks, smem, threads;
};

// CTAs the narrow kernels aim for on each SM.
constexpr int NARROW_CTAS_AN_SM = 4;

int div_up(long a, long b) { return static_cast<int>((a + b - 1) / b); }

// Which kernel takes these widths, its tile and its launch; false if none does.
bool make_plan(int sms, int batch, int n_pts, int c_in, int d_out, int orders, Plan& p) {
  if (c_in % 8 == 0 && d_out % 8 == 0) {
    // Samples a CTA: enough for one wave of CTAs over the SMs, at most WIDE_ROWS rows.
    const int tb = std::clamp(div_up(batch, sms), 1, chebk::WIDE_ROWS / n_pts);
    p = {WIDE, tb, div_up(batch, tb), div_up(d_out, chebk::CW), chebk::WIDE_SMEM,
         chebk::WIDE_THREADS};
    return true;
  }
  if (d_out < 8) {
    // One row a quad: the CTA's quads take a few whole samples at once.
    const int tb = std::max(1, chebk::QUADS / n_pts), kdp = chebk::proj_width(orders * d_out);
    const long smem = 4L * (div_up(c_in, 4) * (4 * kdp + 4) + tb * n_pts * kdp);
    if (smem <= chebk::SMEM_MAX) {
      p = {PROJ, tb, div_up(batch, tb), 1, static_cast<int>(smem), chebk::NARROW_THREADS};
      return true;
    }
  }
  // x and Z of a sample (x's floats rounded up to 16 bytes a tile)
  const long per_sample = 4L * n_pts * (orders + 1) * c_in;
  if (per_sample + 16 > chebk::SMEM_MAX) return false;
  const int tb = std::clamp(div_up(batch, NARROW_CTAS_AN_SM * sms), 1,
                            static_cast<int>((chebk::SMEM_MAX - 16) / per_sample));
  p = {MIX, tb, div_up(batch, tb), 1, static_cast<int>(tb * per_sample + 16),
       chebk::NARROW_THREADS};
  return true;
}

template <class Kernel>
cudaError_t launch(Kernel kernel, const chebk::ChebArgs& a, const Plan& p, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.tiles, p.chunks), p.threads, p.smem, stream>>>(a);
  return cudaGetLastError();
}

int sm_count(int device, cudaError_t& err) {
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms;
}

}  // namespace

// The launch cheb_forward makes for these widths on `device`: plan[0] the
// kernel (0 wide, 1 mix, 2 proj), [1] samples a CTA, [2] CTAs, [3] column
// chunks, [4] dynamic shared memory bytes, [5] threads a CTA.  Returns 0, or
// cudaErrorInvalidValue if no kernel takes the widths.
extern "C" int cheb_plan(int device, int batch, int n_pts, int c_in, int d_out, int orders,
                         int* plan) {
  if (batch < 1 || n_pts < 1 || n_pts > chebk::MAX_PTS || c_in < 1 || d_out < 1 ||
      orders < 1 || orders > chebk::MAX_ORDERS || plan == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err;
  const int sms = sm_count(device, err);
  if (err != cudaSuccess) return err;
  Plan p;
  if (!make_plan(sms, batch, n_pts, c_in, d_out, orders, p)) return cudaErrorInvalidValue;
  const int out[6] = {p.kind, p.tb, p.tiles, p.chunks, p.smem, p.threads};
  std::copy(out, out + 6, plan);
  return 0;
}

// y [B, N, D] = sum_k T_k x W_k + bias for x [B, N, C], w [K1, C, D], with the
// Chebyshev terms (ptr, idx, val) of the basis, on `stream` of `device`.
// Takes N <= 32, K1 <= 8, any batch >= 1, any C, D >= 1 but those whose mix
// of one sample outgrows shared memory off the wide path (C and D multiples
// of 8); pointers 16-byte aligned.  Returns 0 or the cudaError_t of the
// refused arguments or launch.
extern "C" int cheb_forward(int device, int batch, int n_pts, int c_in, int d_out, int orders,
                            const float* x, const float* w, const float* bias, float* y,
                            const int* ptr, const int* idx, const float* val, void* stream) {
  if (batch < 1 || n_pts < 1 || n_pts > chebk::MAX_PTS || c_in < 1 || d_out < 1 || orders < 1 ||
      orders > chebk::MAX_ORDERS || x == nullptr || w == nullptr || bias == nullptr ||
      y == nullptr || ptr == nullptr || idx == nullptr || val == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int sms = sm_count(device, err);
  if (err != cudaSuccess) return err;
  Plan p;
  if (!make_plan(sms, batch, n_pts, c_in, d_out, orders, p)) return cudaErrorInvalidValue;
  const chebk::ChebArgs a{x, w, bias, y, ptr, idx, val, batch, n_pts, c_in, d_out, orders, p.tb};
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vc = c_in % 4 == 0, vd = d_out % 4 == 0;
  switch (p.kind) {
    case WIDE:
      return launch(chebk::cheb_kernel_wide, a, p, s);
    case PROJ:
      return vc ? launch(chebk::cheb_kernel_proj<4>, a, p, s)
                : launch(chebk::cheb_kernel_proj<1>, a, p, s);
    default:
      if (vc && vd) return launch(chebk::cheb_kernel_mix<4, 4>, a, p, s);
      if (vc) return launch(chebk::cheb_kernel_mix<4, 1>, a, p, s);
      if (vd) return launch(chebk::cheb_kernel_mix<1, 4>, a, p, s);
      return launch(chebk::cheb_kernel_mix<1, 1>, a, p, s);
  }
}

extern "C" const char* cheb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
