// Host entries of the train-stack forward and backward kernels
// (train_kernel.cuh), with a plain C interface for ctypes.  Built by
// diffpose_tpu_torch/ops/_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC
#include <cuda_runtime.h>

#include "train_kernel.cuh"

namespace {

template <typename Kernel, typename Args>
cudaError_t launch(Kernel kernel, const Args& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (a.batch + netk::TB - 1) / netk::TB;
  kernel<<<grid, netk::THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

bool supported(int hid, int heads, int n_pts, int batch, int num_layers, int nnz) {
  return hid == netk::HID && heads == netk::HEADS && n_pts == netk::N_PTS && batch >= 1 &&
         num_layers >= 0 && nnz >= 0 && nnz <= netk::MAX_TERMS;
}

}  // namespace

// Each entry launches one kernel on `stream` (a cudaStream_t) of device
// `device` and returns 0 or the cudaError_t of the refused configuration or
// launch.  Supported: hid 96, 4 heads, 17 joints, Chebyshev order 2, any
// number of layers and any batch >= 1.  ikp, iks, ikc are 1/keep of the
// attention-probability, sublayer and Chebyshev dropout.
//
// The dropout decisions are either explicit uint8 masks (mp, m1..m4) or, for
// seeded = 1, drawn in the kernel from `seed` (one int32 in device memory, so
// that no launch waits for the host to read it) with the thresholds
// ceil(keep * 2^23) thp, ths, thc (philox.cuh); the masks are then not read,
// and the forward writes what it drew to those of dmp, dm1..dm4 that are not
// null.

namespace {

traink::DropArgs drop_args(const unsigned char* mp, const unsigned char* m1,
                           const unsigned char* m2, const unsigned char* m3,
                           const unsigned char* m4, unsigned char* dmp, unsigned char* dm1,
                           unsigned char* dm2, unsigned char* dm3, unsigned char* dm4,
                           const unsigned* seed, unsigned thp, unsigned ths, unsigned thc) {
  return traink::DropArgs{{mp, m1, m2, m3, m4}, {dmp, dm1, dm2, dm3, dm4},
                          {thp, ths, ths, thc, thc}, seed};
}

}  // namespace

extern "C" int train_stack_forward(
    int device, int hid, int heads, int n_pts, int batch, int num_layers, float ikp, float iks,
    float ikc, int seeded, const unsigned* seed, unsigned thp, unsigned ths, unsigned thc,
    const float* h0, const float* tp, const unsigned char* mp, const unsigned char* m1,
    const unsigned char* m2, const unsigned char* m3, const unsigned char* m4,
    unsigned char* dmp, unsigned char* dm1, unsigned char* dm2, unsigned char* dm3,
    unsigned char* dm4, const float* ln1s,
    const float* ln1b, const float* ln2s, const float* ln2b, const float* wqkv, const float* bqkv,
    const float* wao, const float* bao, const float* lap, const float* wfc1, const float* bfc1,
    const float* wfc2, const float* bfc2, const float* wg1, const float* bg1, const float* wg2,
    const float* bg2, const int* cheb_ptr, const int* cheb_idx, const float* cheb_val,
    int cheb_nnz, float* d5, float* ha, float* hb, float* hc, float* y1, float* att, float* r1,
    float* rc1, float* u, float* rd1, void* stream) {
  if (!supported(hid, heads, n_pts, batch, num_layers, cheb_nnz)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const traink::FwdArgs a{
      h0,   tp,   drop_args(mp, m1, m2, m3, m4, dmp, dm1, dm2, dm3, dm4, seed, thp, ths, thc),
      ln1s, ln1b, ln2s, ln2b, wqkv, bqkv, wao,      bao,      lap,      wfc1,     bfc1,
      wfc2, bfc2, wg1,  bg1,  wg2,  bg2,  cheb_ptr, cheb_idx, cheb_val, cheb_nnz, d5,
      ha,   hb,   hc,   y1,   att,  r1,   rc1,      u,        rd1,      batch,    num_layers,
      ikp,  iks,  ikc};
  const auto s = static_cast<cudaStream_t>(stream);
  return seeded ? launch(traink::train_forward_kernel<true>, a, netk::SMEM_BYTES, s)
                : launch(traink::train_forward_kernel<false>, a, netk::SMEM_BYTES, s);
}

extern "C" int train_stack_backward(
    int device, int hid, int heads, int n_pts, int batch, int num_layers, float ikp, float iks,
    float ikc, int seeded, const unsigned* seed, unsigned thp, unsigned ths, unsigned thc,
    const float* dd5, const unsigned char* mp, const unsigned char* m1,
    const unsigned char* m2, const unsigned char* m3, const unsigned char* m4, const float* ha,
    const float* hb, const float* y1, const float* r1, const float* rc1, const float* rd1,
    const float* ln1s, const float* ln2s, const float* wqkv, const float* bqkv,
    const float* wqkvt, const float* waot, const float* lap, const float* wfc1t,
    const float* wfc2t, const float* wg1t, const float* wg2t, const int* tptr, const int* tidx,
    const float* tval, int tnnz, float* da0, float* dtp, float* dqkv, float* do1, float* df1,
    float* df2, float* dc1, float* dc2, void* stream) {
  if (!supported(hid, heads, n_pts, batch, num_layers, tnnz)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const traink::BwdArgs a{
      dd5,  drop_args(mp, m1, m2, m3, m4, nullptr, nullptr, nullptr, nullptr, nullptr, seed, thp,
                      ths, thc),
      ha,   hb,   y1,   r1,   rc1,  rd1,  ln1s, ln2s, wqkv, bqkv, wqkvt, waot,  lap,
      wfc1t, wfc2t, wg1t, wg2t, tptr, tidx, tval, tnnz, da0,  dtp,  dqkv,  do1,   df1,
      df2,  dc1,  dc2,  batch, num_layers, ikp, iks, ikc};
  const auto s = static_cast<cudaStream_t>(stream);
  return seeded ? launch(traink::train_backward_kernel<true>, a, traink::BWD_SMEM_BYTES, s)
                : launch(traink::train_backward_kernel<false>, a, traink::BWD_SMEM_BYTES, s);
}

extern "C" const char* train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
