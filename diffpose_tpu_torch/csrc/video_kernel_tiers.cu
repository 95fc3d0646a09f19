// Host entries of the video layer kernels (video_kernel.cuh) at the one-pass
// tiers of --kernel_precision, with a plain C interface for ctypes: tier 1
// bf16, tier 2 default (1xTF32) (mma_tf32.cuh: TIER_BF16, TIER_1XTF32).  A
// library of its own, built by diffpose_tpu_torch/ops/_build.py at the first
// use of a tier, so that the parity build (video_kernel.cu) does not grow.
// The products' weights are [K, N] a layer, rounded to the tier on the host
// (ops/fused_video_full.py:video_tier_weights); the arguments are otherwise
// video_kernel.cu's, after the tier.
#include "video_entry.cuh"

extern "C" int temporal_forward_tier(int tier, int device, int rows, int frames, const float* x,
                                     float* out, float* qkv, float* att, const float* ln1s,
                                     const float* ln1b, const float* ln2s, const float* ln2b,
                                     const float* wqkv, const float* bqkv, const float* wao,
                                     const float* bao, const float* wff1, const float* bff1,
                                     const float* wff2, const float* bff2, void* stream) {
#define TEMPORAL_ARGS                                                                         \
  device, rows, frames, x, out, qkv, att, ln1s, ln1b, ln2s, ln2b, wqkv, bqkv, wao, bao, wff1, \
      bff1, wff2, bff2, stream
  if (tier == tf32::TIER_BF16) return vidk::temporal_entry<tf32::TIER_BF16>(TEMPORAL_ARGS);
  if (tier == tf32::TIER_1XTF32) return vidk::temporal_entry<tf32::TIER_1XTF32>(TEMPORAL_ARGS);
#undef TEMPORAL_ARGS
  return cudaErrorInvalidValue;
}

extern "C" int st_layer_forward_tier(
    int tier, int device, int windows, int frames, const float* h, const float* tp,
    float* spatial, float* out, float* qkv, float* att, const float* ln1s, const float* ln1b,
    const float* ln2s, const float* ln2b, const float* wqkv, const float* bqkv, const float* wao,
    const float* bao, const float* lap, const float* wfc1, const float* bfc1, const float* wfc2,
    const float* bfc2, const float* wg1, const float* bg1, const float* wg2, const float* bg2,
    const int* cheb_ptr, const int* cheb_idx, const float* cheb_val, int cheb_nnz,
    const float* tln1s, const float* tln1b, const float* tln2s, const float* tln2b,
    const float* twqkv, const float* tbqkv, const float* twao, const float* tbao,
    const float* tff1, const float* tbff1, const float* tff2, const float* tbff2, void* stream) {
#define ST_ARGS                                                                                \
  device, windows, frames, h, tp, spatial, out, qkv, att, ln1s, ln1b, ln2s, ln2b, wqkv, bqkv,  \
      wao, bao, lap, wfc1, bfc1, wfc2, bfc2, wg1, bg1, wg2, bg2, cheb_ptr, cheb_idx, cheb_val, \
      cheb_nnz, tln1s, tln1b, tln2s, tln2b, twqkv, tbqkv, twao, tbao, tff1, tbff1, tff2,      \
      tbff2, stream
  if (tier == tf32::TIER_BF16) return vidk::st_layer_entry<tf32::TIER_BF16>(ST_ARGS);
  if (tier == tf32::TIER_1XTF32) return vidk::st_layer_entry<tf32::TIER_1XTF32>(ST_ARGS);
#undef ST_ARGS
  return cudaErrorInvalidValue;
}

// Occupancy of a tier's temporal_kernel (kernel 0) or st_layer_kernel (kernel 1).
extern "C" int video_tier_occupancy(int tier, int device, int kernel, int* per_sm,
                                    int* smem_bytes, int* regs, int* threads) {
  if (tier == tf32::TIER_BF16)
    return vidk::occupancy_entry<tf32::TIER_BF16>(device, kernel, per_sm, smem_bytes, regs,
                                                  threads);
  if (tier == tf32::TIER_1XTF32)
    return vidk::occupancy_entry<tf32::TIER_1XTF32>(device, kernel, per_sm, smem_bytes, regs,
                                                    threads);
  return cudaErrorInvalidValue;
}

extern "C" const char* video_tier_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
