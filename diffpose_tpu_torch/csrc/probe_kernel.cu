// Cost-split probe of the whole-network kernel (kernel row 11): the GCNDiff
// eval forward of net_kernel.cuh with parts left out at compile time, timed
// against the full build to attribute its time.  Counterpart of
// scripts/probe_ablate.py:_kernel; its results carry no meaning beyond the
// cost split.  SKIP = 0 is the production net_forward_kernel<true, true, 5, 5>
// built in this translation unit.  Plain C interface for ctypes, built by
// diffpose_tpu_torch/ops/_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC
#include <cuda_runtime.h>

#include "net_kernel.cuh"

namespace {

template <int SKIP>
cudaError_t launch(const netk::NetArgs& a, cudaStream_t stream) {
  auto kernel = netk::net_forward_kernel<true, true, 5, 5, SKIP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(netk::SMEM_BYTES));
  if (err != cudaSuccess) return err;
  const int grid = (a.batch + netk::TB - 1) / netk::TB;
  kernel<<<grid, netk::NET_THREADS, netk::SMEM_BYTES, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One GCNDiff forward (hid 96, 4 heads, 17 joints, x and out [B, 17, 5], the
// timestep projections tp [L, B, 96]) with the parts in `skip` left out: 0 or
// one of netk::Skip's bits.  Arguments as net_forward's (net_kernel.cu).
// Returns 0 or the cudaError_t of the refused arguments or launch.
extern "C" int probe_forward(int device, int skip, int batch, int num_layers, const float* x,
                             const float* tp, float* out, const float* win, const float* bin,
                             const float* ln1s, const float* ln1b, const float* ln2s,
                             const float* ln2b, const float* wqkv, const float* bqkv,
                             const float* wao, const float* bao, const float* lap,
                             const float* wfc1, const float* bfc1, const float* wfc2,
                             const float* bfc2, const float* wg1, const float* bg1,
                             const float* wg2, const float* bg2, const float* wout,
                             const float* bout, const int* cheb_ptr, const int* cheb_idx,
                             const float* cheb_val, int cheb_nnz, void* stream) {
  if (batch < 1 || num_layers < 0 || cheb_nnz < 0 || cheb_nnz > netk::MAX_TERMS || tp == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const netk::NetArgs a{x,    tp,   out,  win,  bin,  ln1s, ln1b,     ln2s,     ln2b,
                        wqkv, bqkv, wao,  bao,  lap,  wfc1, bfc1,     wfc2,     bfc2,
                        wg1,  bg1,  wg2,  bg2,  wout, bout, cheb_ptr, cheb_idx, cheb_val,
                        cheb_nnz, batch, num_layers};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (skip) {
    case 0: return launch<0>(a, s);
    case netk::kSkipAttn: return launch<netk::kSkipAttn>(a, s);
    case netk::kSkipGnetCheb: return launch<netk::kSkipGnetCheb>(a, s);
    case netk::kSkipLap: return launch<netk::kSkipLap>(a, s);
    case netk::kSkipChebMix: return launch<netk::kSkipChebMix>(a, s);
    case netk::kSkipLn: return launch<netk::kSkipLn>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// The dynamic shared memory of every build of net_forward_kernel, production
// and probe alike (netk::SMEM_BYTES).
extern "C" int probe_smem_bytes() { return static_cast<int>(netk::SMEM_BYTES); }

extern "C" const char* probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
