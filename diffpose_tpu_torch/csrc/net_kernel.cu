// Host entry of the whole-network forward kernel (net_kernel.cuh) at the
// parity grade (3xTF32), with a plain C interface for ctypes.  Built by
// diffpose_tpu_torch/ops/_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC
// The one-pass tiers are built apart, into net_kernel_tiers.cu's library.
#include "net_entry.cuh"

// Launches one forward on `stream` (a cudaStream_t) of device `device`
// (net_entry.cuh: what it supports, what it returns).
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
  return netk::net_forward_entry<tf32::TIER_3XTF32>(
      device, has_temb, c_in, c_out, hid, heads, n_pts, batch, num_layers, x, tp, out, win, bin,
      ln1s, ln1b, ln2s, ln2b, wqkv, bqkv, wao, bao, lap, wfc1, bfc1, wfc2, bfc2, wg1, bg1, wg2,
      bg2, wout, bout, cheb_ptr, cheb_idx, cheb_val, cheb_nnz, stream);
}

// Launches the bare layer stack of the implicit model's fixed-point function.
extern "C" int net_backbone(int device, int hid, int heads, int n_pts, int batch, int num_layers,
                            const float* z, const float* tp, float* out, const float* ln1s,
                            const float* ln1b, const float* ln2s, const float* ln2b,
                            const float* wqkv, const float* bqkv, const float* wao,
                            const float* bao, const float* lap, const float* wfc1,
                            const float* bfc1, const float* wfc2, const float* bfc2,
                            const float* wg1, const float* bg1, const float* wg2, const float* bg2,
                            const int* cheb_ptr, const int* cheb_idx, const float* cheb_val,
                            int cheb_nnz, void* stream) {
  return netk::net_backbone_entry<tf32::TIER_3XTF32>(
      device, hid, heads, n_pts, batch, num_layers, z, tp, out, ln1s, ln1b, ln2s, ln2b, wqkv,
      bqkv, wao, bao, lap, wfc1, bfc1, wfc2, bfc2, wg1, bg1, wg2, bg2, cheb_ptr, cheb_idx,
      cheb_val, cheb_nnz, stream);
}

extern "C" const char* net_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
