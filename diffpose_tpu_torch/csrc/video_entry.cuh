// Host side of the video layer kernels (video_kernel.cuh), shared by the
// builds of their tiers: video_kernel.cu (3xTF32, the parity grade) and
// video_kernel_tiers.cu (the one-pass tiers).  Both kernels are cooperative
// launches of as many CTAs as can be co-resident (at most the work items);
// where none can, or the device has no cooperative launch, an entry returns
// the error and launches nothing.  Entries return 0 or the cudaError_t.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>

#include "video_kernel.cuh"

namespace vidk {

inline bool weights_given(const TemporalArgs& w) {
  for (const float* p : {w.ln1s, w.ln1b, w.ln2s, w.ln2b, w.wqkv, w.bqkv, w.wao, w.bao, w.wff1,
                         w.bff1, w.wff2, w.bff2})
    if (p == nullptr) return false;
  return true;
}

inline bool flow_given(const Flow& f) {
  return f.windows >= 1 && f.frames >= 1 && f.x != nullptr && f.qkv != nullptr &&
         f.att != nullptr && f.out != nullptr;
}

// Kernel 0: temporal_kernel (row 10); 1: st_layer_kernel (row 9).
template <int TIER>
const void* kernel_of(int which) {
  return which == 0 ? reinterpret_cast<const void*>(temporal_kernel<TIER>)
                    : reinterpret_cast<const void*>(st_layer_kernel<TIER>);
}

inline int threads_of(int which) { return which == 0 ? TEMPORAL_THREADS : THREADS; }

inline size_t smem_of(int which) { return which == 0 ? SMEM_BYTES : ST_SMEM_BYTES; }

// The kernel's dynamic shared memory set, and its co-resident CTAs an SM.
template <int TIER>
cudaError_t configure(int which, int* per_sm) {
  const void* fn = kernel_of<TIER>(which);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_of(which)));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, threads_of(which),
                                                       smem_of(which));
}

// The work items of the widest phase, in CTAs: the tiles of 68 vectors of
// T1 and T3 (row 9: of TB frames, the same number), the T2 tasks over the
// CTA's warps.
inline int work_items(int which, const Flow& f) {
  const int vectors = f.windows * f.joints * f.frames;
  const int tiles = (vectors + netk::ROWS - 1) / netk::ROWS;
  const int tasks = f.windows * f.joints * netk::HEADS * ((f.frames + 15) / 16);
  const int warps = threads_of(which) / 32;
  return std::max(tiles, (tasks + warps - 1) / warps);
}

template <int TIER>
cudaError_t launch(int which, int device, const Flow& f, void** args, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int coop = 0, sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = configure<TIER>(which, &per_sm)) != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int grid = std::min(per_sm * sms, work_items(which, f));
  err = cudaLaunchCooperativeKernel(kernel_of<TIER>(which), dim3(grid), dim3(threads_of(which)),
                                    args, smem_of(which), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// One TemporalBlock (row 10) on x [rows, frames, 96] -> out; qkv
// [rows * frames, 288] and att [rows * frames, 96] are scratch; the four
// products' weights are TF32 parts [2, K, N] (a one-pass tier: [K, N]).
template <int TIER>
int temporal_entry(int device, int rows, int frames, const float* x, float* out, float* qkv,
                   float* att, const float* ln1s, const float* ln1b, const float* ln2s,
                   const float* ln2b, const float* wqkv, const float* bqkv, const float* wao,
                   const float* bao, const float* wff1, const float* bff1, const float* wff2,
                   const float* bff2, void* stream) {
  const TemporalArgs w{ln1s, ln1b, ln2s, ln2b, wqkv, bqkv, wao, bao, wff1, bff1, wff2, bff2};
  Flow f{x, qkv, att, out, rows, 1, frames};
  if (!flow_given(f) || !weights_given(w)) return cudaErrorInvalidValue;
  void* args[] = {const_cast<TemporalArgs*>(&w), &f};
  return launch<TIER>(0, device, f, args, stream);
}

// One whole video layer (row 9): the spatial block of every frame of h
// [windows, frames, 17, 96] (one-layer bare-stack weights, timestep
// projections tp [1, windows * frames, 96]) into `spatial`, then the
// temporal block of every (window, joint) into out; qkv [windows * frames *
// 17, 288] and att [windows * frames * 17, 96] are scratch.
template <int TIER>
int st_layer_entry(int device, int windows, int frames, const float* h, const float* tp,
                   float* spatial, float* out, float* qkv, float* att, const float* ln1s,
                   const float* ln1b, const float* ln2s, const float* ln2b, const float* wqkv,
                   const float* bqkv, const float* wao, const float* bao, const float* lap,
                   const float* wfc1, const float* bfc1, const float* wfc2, const float* bfc2,
                   const float* wg1, const float* bg1, const float* wg2, const float* bg2,
                   const int* cheb_ptr, const int* cheb_idx, const float* cheb_val, int cheb_nnz,
                   const float* tln1s, const float* tln1b, const float* tln2s,
                   const float* tln2b, const float* twqkv, const float* tbqkv, const float* twao,
                   const float* tbao, const float* tff1, const float* tbff1, const float* tff2,
                   const float* tbff2, void* stream) {
  const TemporalArgs w{tln1s, tln1b, tln2s, tln2b, twqkv, tbqkv,
                       twao,  tbao,  tff1,  tbff1, tff2,  tbff2};
  Flow f{spatial, qkv, att, out, windows, netk::N_PTS, frames};
  if (!flow_given(f) || h == nullptr || tp == nullptr || cheb_nnz < 0 ||
      cheb_nnz > netk::MAX_TERMS || !weights_given(w))
    return cudaErrorInvalidValue;
  netk::NetArgs a{h,    tp,   spatial, nullptr, nullptr, ln1s,     ln1b,     ln2s,
                  ln2b, wqkv, bqkv,    wao,     bao,     lap,      wfc1,     bfc1,
                  wfc2, bfc2, wg1,     bg1,     wg2,     bg2,      nullptr,  nullptr,
                  cheb_ptr, cheb_idx, cheb_val, cheb_nnz, windows * frames, 1};
  void* args[] = {&a, const_cast<TemporalArgs*>(&w), &f};
  return launch<TIER>(1, device, f, args, stream);
}

// The co-resident CTAs per SM, the dynamic shared memory in bytes, the
// registers a thread and the threads a CTA of temporal_kernel (kernel 0) or
// st_layer_kernel (kernel 1), as their launches configure them.
template <int TIER>
int occupancy_entry(int device, int kernel, int* per_sm, int* smem_bytes, int* regs,
                    int* threads) {
  if (kernel != 0 && kernel != 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((err = configure<TIER>(kernel, per_sm)) != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kernel_of<TIER>(kernel))) != cudaSuccess) return err;
  *smem_bytes = static_cast<int>(smem_of(kernel));
  *regs = attr.numRegs;
  *threads = threads_of(kernel);
  return cudaSuccess;
}

}  // namespace vidk
