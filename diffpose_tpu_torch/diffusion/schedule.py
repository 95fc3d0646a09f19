"""Diffusion noise schedules (host-side, float64) and ᾱ accumulation.

Semantics of the reference ``common/utils_diff.py:7-43``: five β schedules
in float64 numpy, and ``compute_alpha``, which prepends a zero β so that
``t = −1`` maps to ``ᾱ = 1`` (the DDIM final step).  The shipped configs
use linear β ∈ [1e-4, 1e-3], T=51.
"""

from __future__ import annotations

import numpy as np
import torch


def get_beta_schedule(
    beta_schedule: str, *, beta_start: float, beta_end: float, num_diffusion_timesteps: int
) -> np.ndarray:
    t = num_diffusion_timesteps
    if beta_schedule == "quad":
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, t, dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, t, dtype=np.float64)
    elif beta_schedule == "const":
        betas = beta_end * np.ones(t, dtype=np.float64)
    elif beta_schedule == "jsd":
        # 1/T, 1/(T−1), …, 1
        betas = 1.0 / np.linspace(t, 1, t, dtype=np.float64)
    elif beta_schedule == "sigmoid":
        x = np.linspace(-6, 6, t)
        betas = 1.0 / (np.exp(-x) + 1.0) * (beta_end - beta_start) + beta_start
    elif beta_schedule == "cosine":
        # Improved-DDPM cosine ᾱ as in the reference's alternative sampler
        # (common/utils_diff_b.py:17-26), including its double 0.008
        # offset; β clipped at 0.999.
        steps = np.arange(t + 1, dtype=np.float64) / t + 0.008
        alphas = np.cos((steps + 0.008) / 1.008 * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = 1.0 - alphas[1:] / alphas[:-1]
        betas = np.minimum(betas, 0.999)
    else:
        raise NotImplementedError(beta_schedule)
    assert betas.shape == (t,)
    return betas


def alphas_cumprod(betas) -> torch.Tensor:
    """``ᾱ_t = Π_{s≤t} (1 − β_s)`` for t = 0..T−1: the float64 product
    rounded once to float32."""
    return torch.as_tensor(np.cumprod(1.0 - np.asarray(betas, np.float64)), dtype=torch.float32)


def padded_alphas_cumprod(betas) -> torch.Tensor:
    """ᾱ with a leading 1, so that ``padded[t+1] = ᾱ_t`` and ``padded[0] = 1``
    (the reference's zero-β prepend, ``common/utils_diff.py:40-43``)."""
    return torch.cat([torch.ones(1), alphas_cumprod(betas)])


def compute_alpha(betas, t) -> torch.Tensor:
    """``ᾱ_t`` with t = −1 → 1, shaped ``[B, 1, 1]``."""
    padded = padded_alphas_cumprod(betas)
    t = torch.as_tensor(t, dtype=torch.long)
    return padded[t + 1].reshape(-1, 1, 1)
