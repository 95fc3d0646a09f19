// Host entries of the whole-network forward kernel (net_kernel.cuh) at the
// one-pass tiers of --kernel_precision, with a plain C interface for ctypes:
// tier 1 bf16, tier 2 default (1xTF32) (mma_tf32.cuh: TIER_BF16,
// TIER_1XTF32).  A library of its own, built by
// diffpose_tpu_torch/ops/_build.py at the first use of a tier, so that the
// parity build (net_kernel.cu) does not grow.  The weights of the products
// are [L, K, N], rounded to the tier on the host
// (ops/fused_denoiser.py:tier_weights); the arguments are otherwise
// net_kernel.cu's.
#include "net_entry.cuh"

extern "C" int net_forward_tier(int tier, int device, int has_temb, int c_in, int c_out, int hid,
                                int heads, int n_pts, int batch, int num_layers, const float* x,
                                const float* tp, float* out, const float* win, const float* bin,
                                const float* ln1s, const float* ln1b, const float* ln2s,
                                const float* ln2b, const float* wqkv, const float* bqkv,
                                const float* wao, const float* bao, const float* lap,
                                const float* wfc1, const float* bfc1, const float* wfc2,
                                const float* bfc2, const float* wg1, const float* bg1,
                                const float* wg2, const float* bg2, const float* wout,
                                const float* bout, const int* cheb_ptr, const int* cheb_idx,
                                const float* cheb_val, int cheb_nnz, void* stream) {
#define NET_FORWARD_ARGS                                                                        \
  device, has_temb, c_in, c_out, hid, heads, n_pts, batch, num_layers, x, tp, out, win, bin,   \
      ln1s, ln1b, ln2s, ln2b, wqkv, bqkv, wao, bao, lap, wfc1, bfc1, wfc2, bfc2, wg1, bg1, wg2, \
      bg2, wout, bout, cheb_ptr, cheb_idx, cheb_val, cheb_nnz, stream
  if (tier == tf32::TIER_BF16) return netk::net_forward_entry<tf32::TIER_BF16>(NET_FORWARD_ARGS);
  if (tier == tf32::TIER_1XTF32)
    return netk::net_forward_entry<tf32::TIER_1XTF32>(NET_FORWARD_ARGS);
#undef NET_FORWARD_ARGS
  return cudaErrorInvalidValue;
}

extern "C" int net_backbone_tier(int tier, int device, int hid, int heads, int n_pts, int batch,
                                 int num_layers, const float* z, const float* tp, float* out,
                                 const float* ln1s, const float* ln1b, const float* ln2s,
                                 const float* ln2b, const float* wqkv, const float* bqkv,
                                 const float* wao, const float* bao, const float* lap,
                                 const float* wfc1, const float* bfc1, const float* wfc2,
                                 const float* bfc2, const float* wg1, const float* bg1,
                                 const float* wg2, const float* bg2, const int* cheb_ptr,
                                 const int* cheb_idx, const float* cheb_val, int cheb_nnz,
                                 void* stream) {
#define NET_BACKBONE_ARGS                                                                      \
  device, hid, heads, n_pts, batch, num_layers, z, tp, out, ln1s, ln1b, ln2s, ln2b, wqkv,     \
      bqkv, wao, bao, lap, wfc1, bfc1, wfc2, bfc2, wg1, bg1, wg2, bg2, cheb_ptr, cheb_idx,    \
      cheb_val, cheb_nnz, stream
  if (tier == tf32::TIER_BF16) return netk::net_backbone_entry<tf32::TIER_BF16>(NET_BACKBONE_ARGS);
  if (tier == tf32::TIER_1XTF32)
    return netk::net_backbone_entry<tf32::TIER_1XTF32>(NET_BACKBONE_ARGS);
#undef NET_BACKBONE_ARGS
  return cudaErrorInvalidValue;
}

extern "C" const char* net_tier_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
