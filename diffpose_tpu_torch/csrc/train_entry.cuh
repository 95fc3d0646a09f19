// Host side of the train-stack forward and backward kernels
// (train_kernel.cuh), shared by the builds of their tiers: train_kernel.cu
// (3xTF32, the parity grade) and train_kernel_tiers.cu (the one-pass
// tiers).  Each entry checks what the kernels support and launches the
// TIER build on the caller's stream: hid 96, 4 heads, 17 joints, Chebyshev
// order 2, any number of layers and any batch >= 1.  They return 0 or the
// cudaError_t of the refused configuration or launch.
#pragma once

#include <cuda_runtime.h>

#include "train_kernel.cuh"

namespace traink {

template <typename Kernel, typename Args>
cudaError_t launch(Kernel kernel, const Args& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (a.batch + netk::TB - 1) / netk::TB;
  kernel<<<grid, netk::THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

inline bool supported(int hid, int heads, int n_pts, int batch, int num_layers, int nnz) {
  return hid == netk::HID && heads == netk::HEADS && n_pts == netk::N_PTS && batch >= 1 &&
         num_layers >= 0 && nnz >= 0 && nnz <= netk::MAX_TERMS;
}

// The dropout decisions are either explicit uint8 masks (mp, m1..m4) or, for
// seeded = 1, drawn in the kernel from `seed` (one int32 in device memory, so
// that no launch waits for the host to read it) with the thresholds
// ceil(keep * 2^23) thp, ths, thc (philox.cuh); the masks are then not read,
// and the forward writes what it drew to those of dmp, dm1..dm4 that are not
// null.
inline DropArgs drop_args(const unsigned char* mp, const unsigned char* m1,
                          const unsigned char* m2, const unsigned char* m3,
                          const unsigned char* m4, unsigned char* dmp, unsigned char* dm1,
                          unsigned char* dm2, unsigned char* dm3, unsigned char* dm4,
                          const unsigned* seed, unsigned thp, unsigned ths, unsigned thc) {
  return DropArgs{{mp, m1, m2, m3, m4}, {dmp, dm1, dm2, dm3, dm4}, {thp, ths, ths, thc, thc}, seed};
}

// The forward at TIER.  ikp, iks, ikc are 1/keep of the attention-probability,
// sublayer and Chebyshev dropout.  The products' weights are [L, K, N]: f32
// at the parity grade (each CTA splits them), rounded to the tier on the
// host at a one-pass tier.
template <int TIER>
int train_forward_entry(
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
  const FwdArgs a{
      h0,   tp,   drop_args(mp, m1, m2, m3, m4, dmp, dm1, dm2, dm3, dm4, seed, thp, ths, thc),
      ln1s, ln1b, ln2s, ln2b, wqkv, bqkv, wao,      bao,      lap,      wfc1,     bfc1,
      wfc2, bfc2, wg1,  bg1,  wg2,  bg2,  cheb_ptr, cheb_idx, cheb_val, cheb_nnz, d5,
      ha,   hb,   hc,   y1,   att,  r1,   rc1,      u,        rd1,      batch,    num_layers,
      ikp,  iks,  ikc};
  const auto s = static_cast<cudaStream_t>(stream);
  return seeded ? launch(train_forward_kernel<true, TIER>, a, FWD_SMEM_BYTES, s)
                : launch(train_forward_kernel<false, TIER>, a, FWD_SMEM_BYTES, s);
}

// The backward at TIER; the products' weights transposed, [L, N, K] (wqkv,
// for the QKV recompute, [L, K, N]), as train_forward_entry's.
template <int TIER>
int train_backward_entry(
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
  const BwdArgs a{
      dd5,  drop_args(mp, m1, m2, m3, m4, nullptr, nullptr, nullptr, nullptr, nullptr, seed, thp,
                      ths, thc),
      ha,   hb,   y1,   r1,   rc1,  rd1,  ln1s, ln2s, wqkv, bqkv, wqkvt, waot,  lap,
      wfc1t, wfc2t, wg1t, wg2t, tptr, tidx, tval, tnnz, da0,  dtp,  dqkv,  do1,   df1,
      df2,  dc1,  dc2,  batch, num_layers, ikp, iks, ikc};
  const auto s = static_cast<cudaStream_t>(stream);
  return seeded ? launch(train_backward_kernel<true, TIER>, a, BWD_SMEM_BYTES, s)
                : launch(train_backward_kernel<false, TIER>, a, BWD_SMEM_BYTES, s);
}

}  // namespace traink

// The entries' parameter lists and arguments, for the extern "C" functions
// of each build.
#define TRAIN_FORWARD_PARAMS                                                                     \
  int device, int hid, int heads, int n_pts, int batch, int num_layers, float ikp, float iks,   \
      float ikc, int seeded, const unsigned *seed, unsigned thp, unsigned ths, unsigned thc,    \
      const float *h0, const float *tp, const unsigned char *mp, const unsigned char *m1,       \
      const unsigned char *m2, const unsigned char *m3, const unsigned char *m4,               \
      unsigned char *dmp, unsigned char *dm1, unsigned char *dm2, unsigned char *dm3,          \
      unsigned char *dm4, const float *ln1s, const float *ln1b, const float *ln2s,             \
      const float *ln2b, const float *wqkv, const float *bqkv, const float *wao,               \
      const float *bao, const float *lap, const float *wfc1, const float *bfc1,                \
      const float *wfc2, const float *bfc2, const float *wg1, const float *bg1,                \
      const float *wg2, const float *bg2, const int *cheb_ptr, const int *cheb_idx,            \
      const float *cheb_val, int cheb_nnz, float *d5, float *ha, float *hb, float *hc,         \
      float *y1, float *att, float *r1, float *rc1, float *u, float *rd1, void *stream
#define TRAIN_FORWARD_ARGS                                                                     \
  device, hid, heads, n_pts, batch, num_layers, ikp, iks, ikc, seeded, seed, thp, ths, thc, h0, \
      tp, mp, m1, m2, m3, m4, dmp, dm1, dm2, dm3, dm4, ln1s, ln1b, ln2s, ln2b, wqkv, bqkv, wao,  \
      bao, lap, wfc1, bfc1, wfc2, bfc2, wg1, bg1, wg2, bg2, cheb_ptr, cheb_idx, cheb_val,        \
      cheb_nnz, d5, ha, hb, hc, y1, att, r1, rc1, u, rd1, stream
#define TRAIN_BACKWARD_PARAMS                                                                    \
  int device, int hid, int heads, int n_pts, int batch, int num_layers, float ikp, float iks,   \
      float ikc, int seeded, const unsigned *seed, unsigned thp, unsigned ths, unsigned thc,    \
      const float *dd5, const unsigned char *mp, const unsigned char *m1,                      \
      const unsigned char *m2, const unsigned char *m3, const unsigned char *m4,               \
      const float *ha, const float *hb, const float *y1, const float *r1, const float *rc1,    \
      const float *rd1, const float *ln1s, const float *ln2s, const float *wqkv,               \
      const float *bqkv, const float *wqkvt, const float *waot, const float *lap,              \
      const float *wfc1t, const float *wfc2t, const float *wg1t, const float *wg2t,            \
      const int *tptr, const int *tidx, const float *tval, int tnnz, float *da0, float *dtp,   \
      float *dqkv, float *do1, float *df1, float *df2, float *dc1, float *dc2, void *stream
#define TRAIN_BACKWARD_ARGS                                                                    \
  device, hid, heads, n_pts, batch, num_layers, ikp, iks, ikc, seeded, seed, thp, ths, thc,     \
      dd5, mp, m1, m2, m3, m4, ha, hb, y1, r1, rc1, rd1, ln1s, ln2s, wqkv, bqkv, wqkvt, waot,    \
      lap, wfc1t, wfc2t, wg1t, wg2t, tptr, tidx, tval, tnnz, da0, dtp, dqkv, do1, df1, df2, dc1, \
      dc2, stream
