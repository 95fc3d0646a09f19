"""Fused forwards over hand-written CUDA kernels (``fused_denoiser``), the
eval pipeline built on them (``fused_pipeline``), and the fused train stack
(``fused_train``) with its plain reference (``train_ref``)."""
