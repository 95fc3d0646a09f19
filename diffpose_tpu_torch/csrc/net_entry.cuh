// Host side of the whole-network forward kernel (net_kernel.cuh), shared by
// the builds of its tiers: net_kernel.cu (3xTF32, the parity grade) and
// net_kernel_tiers.cu (the one-pass tiers).  Each entry checks what the
// kernel supports and launches the TIER build on the caller's stream:
// hid 96, 4 heads, 17 joints, Chebyshev order 2, any number of layers and
// any batch >= 1; (C_IN, C_OUT) = (5, 5) with timestep projections (GCNDiff)
// or (2, 3) without (GCNPose), or the bare stack.  They return 0 or the
// cudaError_t of the refused configuration or launch.
#pragma once

#include <cuda_runtime.h>

#include "net_kernel.cuh"

namespace netk {

template <bool HAS_TEMB, bool HAS_IO, int C_IN, int C_OUT, int TIER>
cudaError_t launch_net(const NetArgs& a, cudaStream_t stream) {
  auto kernel = net_forward_kernel<HAS_TEMB, HAS_IO, C_IN, C_OUT, 0, TIER>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  const int grid = (a.batch + TB - 1) / TB;
  kernel<<<grid, NET_THREADS, SMEM_BYTES, stream>>>(a);
  return cudaGetLastError();
}

template <int TIER>
int net_forward_entry(int device, int has_temb, int c_in, int c_out, int hid, int heads,
                      int n_pts, int batch, int num_layers, const float* x, const float* tp,
                      float* out, const float* win, const float* bin, const float* ln1s,
                      const float* ln1b, const float* ln2s, const float* ln2b, const float* wqkv,
                      const float* bqkv, const float* wao, const float* bao, const float* lap,
                      const float* wfc1, const float* bfc1, const float* wfc2, const float* bfc2,
                      const float* wg1, const float* bg1, const float* wg2, const float* bg2,
                      const float* wout, const float* bout, const int* cheb_ptr,
                      const int* cheb_idx, const float* cheb_val, int cheb_nnz, void* stream) {
  if (hid != HID || heads != HEADS || n_pts != N_PTS || batch < 1 || num_layers < 0 ||
      cheb_nnz < 0 || cheb_nnz > MAX_TERMS || (has_temb && tp == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const NetArgs a{x,    tp,   out,  win,  bin,  ln1s, ln1b,     ln2s,     ln2b,
                  wqkv, bqkv, wao,  bao,  lap,  wfc1, bfc1,     wfc2,     bfc2,
                  wg1,  bg1,  wg2,  bg2,  wout, bout, cheb_ptr, cheb_idx, cheb_val,
                  cheb_nnz, batch, num_layers};
  const auto s = static_cast<cudaStream_t>(stream);
  if (has_temb && c_in == 5 && c_out == 5) return launch_net<true, true, 5, 5, TIER>(a, s);
  if (!has_temb && c_in == 2 && c_out == 3) return launch_net<false, true, 2, 3, TIER>(a, s);
  return cudaErrorInvalidValue;
}

// The bare layer stack (no input or output ChebConv) of the implicit model's
// fixed-point function: z [B, 17, HID] and the timestep projections tp
// [L, B, HID] in, out [B, 17, HID].
template <int TIER>
int net_backbone_entry(int device, int hid, int heads, int n_pts, int batch, int num_layers,
                       const float* z, const float* tp, float* out, const float* ln1s,
                       const float* ln1b, const float* ln2s, const float* ln2b, const float* wqkv,
                       const float* bqkv, const float* wao, const float* bao, const float* lap,
                       const float* wfc1, const float* bfc1, const float* wfc2, const float* bfc2,
                       const float* wg1, const float* bg1, const float* wg2, const float* bg2,
                       const int* cheb_ptr, const int* cheb_idx, const float* cheb_val,
                       int cheb_nnz, void* stream) {
  if (hid != HID || heads != HEADS || n_pts != N_PTS || batch < 1 || num_layers < 0 ||
      cheb_nnz < 0 || cheb_nnz > MAX_TERMS || tp == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const NetArgs a{z,    tp,   out,     nullptr,  nullptr,  ln1s,     ln1b,     ln2s,
                  ln2b, wqkv, bqkv,    wao,      bao,      lap,      wfc1,     bfc1,
                  wfc2, bfc2, wg1,     bg1,      wg2,      bg2,      nullptr,  nullptr,
                  cheb_ptr, cheb_idx, cheb_val, cheb_nnz, batch, num_layers};
  return launch_net<true, false, HID, HID, TIER>(a, static_cast<cudaStream_t>(stream));
}

}  // namespace netk
