"""Fused forwards over hand-written CUDA kernels (``fused_denoiser``), the
eval pipeline built on them (``fused_pipeline``), and the fused train stack
(``fused_train``) with its plain reference (``train_ref``); the BigW
inference form (``fast_eval``, plain large matrix products)."""

from diffpose_tpu_torch.ops.fast_eval import (
    make_fast_denoiser,
    make_fast_lifter,
    precompute_fast_params,
)

__all__ = ["make_fast_denoiser", "make_fast_lifter", "precompute_fast_params"]
