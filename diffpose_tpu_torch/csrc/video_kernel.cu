// Host entries of the video layer kernels (video_kernel.cuh) at the parity
// grade (3xTF32), with a plain C interface for ctypes.  Built by
// diffpose_tpu_torch/ops/_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared -Xcompiler -fPIC
// The one-pass tiers are built apart, into video_kernel_tiers.cu's library;
// video_entry.cuh has the launches and what the entries return.
#include "video_entry.cuh"

// One TemporalBlock (row 10) on x [rows, frames, 96] -> out.
extern "C" int temporal_forward(int device, int rows, int frames, const float* x, float* out,
                                float* qkv, float* att, const float* ln1s, const float* ln1b,
                                const float* ln2s, const float* ln2b, const float* wqkv,
                                const float* bqkv, const float* wao, const float* bao,
                                const float* wff1, const float* bff1, const float* wff2,
                                const float* bff2, void* stream) {
  return vidk::temporal_entry<tf32::TIER_3XTF32>(device, rows, frames, x, out, qkv, att, ln1s,
                                                 ln1b, ln2s, ln2b, wqkv, bqkv, wao, bao, wff1,
                                                 bff1, wff2, bff2, stream);
}

// One whole video layer (row 9) on h [windows, frames, 17, 96] -> out.
extern "C" int st_layer_forward(int device, int windows, int frames, const float* h,
                                const float* tp, float* spatial, float* out, float* qkv,
                                float* att, const float* ln1s, const float* ln1b,
                                const float* ln2s, const float* ln2b, const float* wqkv,
                                const float* bqkv, const float* wao, const float* bao,
                                const float* lap, const float* wfc1, const float* bfc1,
                                const float* wfc2, const float* bfc2, const float* wg1,
                                const float* bg1, const float* wg2, const float* bg2,
                                const int* cheb_ptr, const int* cheb_idx, const float* cheb_val,
                                int cheb_nnz, const float* tln1s, const float* tln1b,
                                const float* tln2s, const float* tln2b, const float* twqkv,
                                const float* tbqkv, const float* twao, const float* tbao,
                                const float* tff1, const float* tbff1, const float* tff2,
                                const float* tbff2, void* stream) {
  return vidk::st_layer_entry<tf32::TIER_3XTF32>(
      device, windows, frames, h, tp, spatial, out, qkv, att, ln1s, ln1b, ln2s, ln2b, wqkv, bqkv,
      wao, bao, lap, wfc1, bfc1, wfc2, bfc2, wg1, bg1, wg2, bg2, cheb_ptr, cheb_idx, cheb_val,
      cheb_nnz, tln1s, tln1b, tln2s, tln2b, twqkv, tbqkv, twao, tbao, tff1, tbff1, tff2, tbff2,
      stream);
}

// Occupancy of temporal_kernel (kernel 0) or st_layer_kernel (kernel 1).
extern "C" int video_occupancy(int device, int kernel, int* per_sm, int* smem_bytes, int* regs,
                               int* threads) {
  return vidk::occupancy_entry<tf32::TIER_3XTF32>(device, kernel, per_sm, smem_bytes, regs,
                                                  threads);
}

extern "C" const char* video_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef VIDK_STAMPS
// Block 0's cycles by phase since the last reset (video_kernel.cuh), and the reset.
extern "C" int video_cycles(long long* out) {
  return cudaMemcpyFromSymbol(out, vidk_cycles, sizeof(vidk_cycles));
}
extern "C" int video_cycles_reset() {
  const long long zero[8] = {};
  return cudaMemcpyToSymbol(vidk_cycles, zero, sizeof(zero));
}
#endif
