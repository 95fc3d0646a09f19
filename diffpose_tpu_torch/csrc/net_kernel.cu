// Host entry of the whole-network forward kernel (net_kernel.cuh), with a
// plain C interface for ctypes.  Built by diffpose_tpu_torch/ops/_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC
#include <cuda_runtime.h>

#include "net_kernel.cuh"

namespace {

template <bool HAS_TEMB, bool HAS_IO, int C_IN, int C_OUT>
cudaError_t launch(const netk::NetArgs& a, cudaStream_t stream) {
  auto kernel = netk::net_forward_kernel<HAS_TEMB, HAS_IO, C_IN, C_OUT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(netk::SMEM_BYTES));
  if (err != cudaSuccess) return err;
  const int grid = (a.batch + netk::TB - 1) / netk::TB;
  kernel<<<grid, netk::THREADS, netk::SMEM_BYTES, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Launches one forward on `stream` (a cudaStream_t) of device `device`.
// Returns 0 or the cudaError_t of the refused configuration or launch.
// Supported: hid 96, 4 heads, 17 joints, Chebyshev order 2, any number of
// layers and any batch >= 1; (C_IN, C_OUT) = (5, 5) with timestep
// projections (GCNDiff) or (2, 3) without (GCNPose).
extern "C" int net_forward(int device, int has_temb, int c_in, int c_out, int hid, int heads,
                           int n_pts, int batch, int num_layers, const float* x, const float* tp,
                           float* out, const float* win, const float* bin, const float* ln1s,
                           const float* ln1b, const float* ln2s, const float* ln2b,
                           const float* wqkv, const float* bqkv, const float* wao,
                           const float* bao, const float* lap, const float* wfc1,
                           const float* bfc1, const float* wfc2, const float* bfc2,
                           const float* wg1, const float* bg1, const float* wg2, const float* bg2,
                           const float* wout, const float* bout, const int* cheb_ptr,
                           const int* cheb_idx, const float* cheb_val, int cheb_nnz,
                           void* stream) {
  if (hid != netk::HID || heads != netk::HEADS || n_pts != netk::N_PTS || batch < 1 ||
      num_layers < 0 || cheb_nnz < 0 || cheb_nnz > netk::MAX_TERMS || (has_temb && tp == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const netk::NetArgs a{x,    tp,   out,  win,  bin,  ln1s, ln1b,     ln2s,     ln2b,
                        wqkv, bqkv, wao,  bao,  lap,  wfc1, bfc1,     wfc2,     bfc2,
                        wg1,  bg1,  wg2,  bg2,  wout, bout, cheb_ptr, cheb_idx, cheb_val,
                        cheb_nnz, batch, num_layers};
  const auto s = static_cast<cudaStream_t>(stream);
  if (has_temb && c_in == 5 && c_out == 5) return launch<true, true, 5, 5>(a, s);
  if (!has_temb && c_in == 2 && c_out == 3) return launch<false, true, 2, 3>(a, s);
  return cudaErrorInvalidValue;
}

// Launches the bare layer stack (no input or output ChebConv) of the implicit
// model's fixed-point function: z [B, 17, HID] and the timestep projections
// tp [L, B, HID] in, out [B, 17, HID].  Same limits as net_forward.
extern "C" int net_backbone(int device, int hid, int heads, int n_pts, int batch, int num_layers,
                            const float* z, const float* tp, float* out, const float* ln1s,
                            const float* ln1b, const float* ln2s, const float* ln2b,
                            const float* wqkv, const float* bqkv, const float* wao,
                            const float* bao, const float* lap, const float* wfc1,
                            const float* bfc1, const float* wfc2, const float* bfc2,
                            const float* wg1, const float* bg1, const float* wg2, const float* bg2,
                            const int* cheb_ptr, const int* cheb_idx, const float* cheb_val,
                            int cheb_nnz, void* stream) {
  if (hid != netk::HID || heads != netk::HEADS || n_pts != netk::N_PTS || batch < 1 ||
      num_layers < 0 || cheb_nnz < 0 || cheb_nnz > netk::MAX_TERMS || tp == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const netk::NetArgs a{z,    tp,   out,     nullptr,  nullptr,  ln1s,     ln1b,     ln2s,
                        ln2b, wqkv, bqkv,    wao,      bao,      lap,      wfc1,     bfc1,
                        wfc2, bfc2, wg1,     bg1,      wg2,      bg2,      nullptr,  nullptr,
                        cheb_ptr, cheb_idx, cheb_val, cheb_nnz, batch, num_layers};
  return launch<true, false, netk::HID, netk::HID>(a, static_cast<cudaStream_t>(stream));
}

extern "C" const char* net_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
