// Host entries of the train-stack forward and backward kernels
// (train_kernel.cuh) at the one-pass tiers of --kernel_precision, with a
// plain C interface for ctypes: tier 1 bf16, tier 2 default (1xTF32)
// (mma_tf32.cuh: TIER_BF16, TIER_1XTF32).  A library of its own, built by
// diffpose_tpu_torch/ops/_build.py at the first use of a tier, so that the
// parity build (train_kernel.cu) does not grow.  The products' weights are
// rounded to the tier on the host (ops/fused_train.py:rounded_stacks); the
// arguments are otherwise train_kernel.cu's, after the tier.
#include "train_entry.cuh"

extern "C" int train_stack_forward_tier(int tier, TRAIN_FORWARD_PARAMS) {
  if (tier == tf32::TIER_BF16)
    return traink::train_forward_entry<tf32::TIER_BF16>(TRAIN_FORWARD_ARGS);
  if (tier == tf32::TIER_1XTF32)
    return traink::train_forward_entry<tf32::TIER_1XTF32>(TRAIN_FORWARD_ARGS);
  return cudaErrorInvalidValue;
}

extern "C" int train_stack_backward_tier(int tier, TRAIN_BACKWARD_PARAMS) {
  if (tier == tf32::TIER_BF16)
    return traink::train_backward_entry<tf32::TIER_BF16>(TRAIN_BACKWARD_ARGS);
  if (tier == tf32::TIER_1XTF32)
    return traink::train_backward_entry<tf32::TIER_1XTF32>(TRAIN_BACKWARD_ARGS);
  return cudaErrorInvalidValue;
}

extern "C" const char* train_tier_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
