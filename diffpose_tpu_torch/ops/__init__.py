"""Fused forwards over hand-written CUDA kernels (``fused_denoiser``) and the
eval pipeline built on them (``fused_pipeline``)."""
