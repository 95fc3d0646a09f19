// Host entries of the video layer kernels (video_kernel.cuh), with a plain C
// interface for ctypes.  Built by diffpose_tpu_torch/ops/_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC
#include <cuda_runtime.h>

#include <algorithm>

#include "video_kernel.cuh"

namespace {

bool weights_given(const vidk::TemporalArgs& w) {
  for (const float* p : {w.ln1s, w.ln1b, w.ln2s, w.ln2b, w.wqkv, w.bqkv, w.wao, w.bao, w.wff1,
                         w.bff1, w.wff2, w.bff2})
    if (p == nullptr) return false;
  return true;
}

}  // namespace

// One TemporalBlock (row 10) on x [rows, frames, 96] -> out, one CTA a row;
// kv is a [rows, frames, 192] scratch.  Returns 0 or the cudaError_t.
extern "C" int temporal_forward(int device, int rows, int frames, const float* x, float* out,
                                float* kv, const float* ln1s, const float* ln1b,
                                const float* ln2s, const float* ln2b, const float* wqkv,
                                const float* bqkv, const float* wao, const float* bao,
                                const float* wff1, const float* bff1, const float* wff2,
                                const float* bff2, void* stream) {
  const vidk::TemporalArgs w{ln1s, ln1b, ln2s, ln2b, wqkv, bqkv, wao, bao, wff1, bff1, wff2, bff2};
  if (rows < 1 || frames < 1 || x == nullptr || out == nullptr || kv == nullptr ||
      !weights_given(w))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(vidk::temporal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(vidk::SMEM_BYTES));
  if (err != cudaSuccess) return err;
  vidk::temporal_kernel<<<rows, vidk::THREADS, vidk::SMEM_BYTES,
                          static_cast<cudaStream_t>(stream)>>>(w, x, out, kv, frames);
  return cudaGetLastError();
}

// One whole video layer (row 9): the spatial block of every frame of h
// [windows, frames, 17, 96] (one-layer bare-stack weights, timestep
// projections tp [1, windows * frames, 96]) into `spatial`, then the
// temporal block of every (window, joint) into out; kv is a
// [windows * 17, frames, 192] scratch.  One cooperative launch of as many
// CTAs as can be co-resident (at most the work items); if none can, or the
// device has no cooperative launch, returns the error and launches nothing.
extern "C" int st_layer_forward(int device, int windows, int frames, const float* h,
                                const float* tp, float* spatial, float* out, float* kv,
                                const float* ln1s, const float* ln1b, const float* ln2s,
                                const float* ln2b, const float* wqkv, const float* bqkv,
                                const float* wao, const float* bao, const float* lap,
                                const float* wfc1, const float* bfc1, const float* wfc2,
                                const float* bfc2, const float* wg1, const float* bg1,
                                const float* wg2, const float* bg2, const int* cheb_ptr,
                                const int* cheb_idx, const float* cheb_val, int cheb_nnz,
                                const float* tln1s, const float* tln1b, const float* tln2s,
                                const float* tln2b, const float* twqkv, const float* tbqkv,
                                const float* twao, const float* tbao, const float* tff1,
                                const float* tbff1, const float* tff2, const float* tbff2,
                                void* stream) {
  const vidk::TemporalArgs w{tln1s, tln1b, tln2s, tln2b, twqkv, tbqkv,
                             twao,  tbao,  tff1,  tbff1, tff2,  tbff2};
  if (windows < 1 || frames < 1 || h == nullptr || tp == nullptr || spatial == nullptr ||
      out == nullptr || kv == nullptr || cheb_nnz < 0 || cheb_nnz > netk::MAX_TERMS ||
      !weights_given(w))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int coop = 0, sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const size_t smem = std::max(netk::SMEM_BYTES, vidk::SMEM_BYTES);
  auto kernel = vidk::st_layer_kernel;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, vidk::THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int batch = windows * frames;
  const int work = std::max((batch + netk::TB - 1) / netk::TB, windows * netk::N_PTS);
  const int grid = std::min(per_sm * sms, work);

  netk::NetArgs a{h,    tp,   spatial, nullptr, nullptr, ln1s,     ln1b,     ln2s,
                  ln2b, wqkv, bqkv,    wao,     bao,     lap,      wfc1,     bfc1,
                  wfc2, bfc2, wg1,     bg1,     wg2,     bg2,      nullptr,  nullptr,
                  cheb_ptr, cheb_idx, cheb_val, cheb_nnz, batch, 1};
  void* args[] = {&a, const_cast<vidk::TemporalArgs*>(&w), &out, &kv, &windows, &frames};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(vidk::THREADS), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The co-resident CTAs per SM, the dynamic shared memory in bytes and the
// registers a thread of temporal_kernel (kernel 0) or st_layer_kernel
// (kernel 1), as their launches configure them, for the wrapper's report.
extern "C" int video_occupancy(int device, int kernel, int* per_sm, int* smem_bytes, int* regs) {
  if (kernel != 0 && kernel != 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const void* fn = kernel == 0 ? reinterpret_cast<const void*>(vidk::temporal_kernel)
                               : reinterpret_cast<const void*>(vidk::st_layer_kernel);
  const size_t smem = kernel == 0 ? vidk::SMEM_BYTES : std::max(netk::SMEM_BYTES, vidk::SMEM_BYTES);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, fn)) != cudaSuccess) return err;
  *smem_bytes = static_cast<int>(smem);
  *regs = attr.numRegs;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, vidk::THREADS, smem);
}

extern "C" const char* video_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
