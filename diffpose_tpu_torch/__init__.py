"""PyTorch/CUDA port of diffpose_tpu.

The frame family from its command line down (``cli/main_frame.py`` →
``train/trainer.py:DiffposeRunner`` → loader, steps, metrics, checkpoints):
the eval path (GCNPose lift + DDIM with GCNDiff) with both network forwards
as one hand-written CUDA kernel each, and the training path (GMM draw,
ε-MSE, clipped Adam, EMA) with the denoiser's layer stack forward and
backward as a pair of hand-written CUDA kernels, the dropout masks given or
drawn in the kernels (``ops/``, ``csrc/``, ``train/``).  The package imports
torch, numpy and yaml only; its entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

from diffpose_tpu_torch.version import __version__

__all__ = ["__version__"]
