"""PyTorch/CUDA port of diffpose_tpu.

The frame family's eval path (GCNPose lift + DDIM with GCNDiff) with both
network forwards as one hand-written CUDA kernel each, and its training
path (GMM draw, ε-MSE, clipped Adam, EMA) with the denoiser's layer stack
forward and backward as a pair of hand-written CUDA kernels (``ops/``,
``csrc/``, ``train/``).  The package imports torch and numpy only; its
entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from diffpose_tpu_torch.version import __version__

__all__ = ["__version__"]
