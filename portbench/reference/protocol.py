"""The evaluation protocol of DiffPose, in plain PyTorch and numpy.

What the program derives from the benchmark's inputs, worked out again:
the batches' rows and per-sample ids (the loader's order), the GMM kernel
draw, the diffusion schedule, DDIM, the hypothesis mean, MPJPE and
P-MPJPE.  The draws are frozen copies of the program's, since the check
compares outputs sample by sample; everything after them is written from
the reference protocol (``runners/diffpose_frame.py``, ``common/loss.py``,
``common/utils_diff.py`` of DiffPose).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


# ----------------------------------------------------------------------------
# The loader's order and per-sample ids
# ----------------------------------------------------------------------------

def batch_rows(index: int, batch: int, n: int) -> np.ndarray:
    """Dataset rows of batch ``index`` of an unshuffled pass, the tail batch
    wrapped around."""
    return np.arange(index * batch, (index + 1) * batch) % n


def sample_ids(rows: np.ndarray, *, seed: int, epoch: int = 0) -> np.ndarray:
    """Per-sample ids keyed by dataset row, epoch and loader seed (int32)."""
    return (np.asarray(rows, np.int64) * 2654435761 + np.int64(epoch) * 97531
            + np.int64(seed) * 1000003).astype(np.uint32).astype(np.int32)


# ----------------------------------------------------------------------------
# GMM kernels
# ----------------------------------------------------------------------------

def _hash_uniform(x: torch.Tensor) -> torch.Tensor:
    m = 0xFFFFFFFF
    x = x & m
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & m
    x = ((x ^ (x >> 15)) * 0x846CA68B) & m
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def gmm_choice_per_sample(base_seed: int, ids: torch.Tensor, gmm: torch.Tensor) -> torch.Tensor:
    """Evaluation's kernel per (sample, joint): one uniform from a hash of
    ``(base_seed, id, joint)``, the inverse CDF of the float32 weights."""
    b, j, k, _ = gmm.shape
    joint = torch.arange(j, device=ids.device, dtype=torch.int64)
    counter = (ids.to(torch.int64)[:, None] * 1_000_003 + joint[None, :]) ^ (int(base_seed) * 0x9E3779B1)
    u = _hash_uniform(counter)
    w = gmm[..., 0].clamp_min(1e-12)
    cdf = torch.cumsum(w, dim=-1)
    cdf = cdf / cdf[..., -1:]
    return (u[..., None] >= cdf).sum(dim=-1).clamp_max(k - 1)


def gmm_kernels(gmm: torch.Tensor, choice: torch.Tensor):
    """``(mean_uv, var_uv)`` of the chosen kernels, ``[B, J, 2]`` each."""
    kernel = torch.gather(gmm, 2, choice[..., None, None].expand(-1, -1, 1, 5))[:, :, 0, :]
    return kernel[..., 1:3], kernel[..., 3:5]


# ----------------------------------------------------------------------------
# Diffusion
# ----------------------------------------------------------------------------

def linear_betas(start: float, end: float, steps: int) -> np.ndarray:
    return np.linspace(start, end, steps, dtype=np.float64)


def uniform_seq(test_timesteps: int, test_num_diffusion_timesteps: int) -> list:
    return list(range(0, test_num_diffusion_timesteps,
                      test_num_diffusion_timesteps // test_timesteps))


def ddim(denoise, x: torch.Tensor, seq: Sequence[int], betas: np.ndarray) -> torch.Tensor:
    """Deterministic DDIM (η = 0) from ``x`` over ``seq`` in reverse:
    ``x0 = (x − ε̂√(1−ᾱ_t))/√ᾱ_t``, ``x ← √ᾱ_next·x0 + √(1−ᾱ_next)·ε̂``; the
    coefficients rounded to float32, as the reference casts them."""
    ab = np.concatenate([[1.0], np.cumprod(1.0 - betas)])
    ts = list(reversed(list(seq)))
    ts_next = list(reversed([-1] + list(seq)[:-1]))
    for t, tn in zip(ts, ts_next):
        a, an = ab[t + 1], ab[tn + 1]
        s_a, s_1ma, s_an, c2 = (float(np.float32(v)) for v in
                                (np.sqrt(a), np.sqrt(1 - a), np.sqrt(an), np.sqrt(1 - an)))
        t_vec = torch.full((x.shape[0],), float(t), dtype=x.dtype, device=x.device)
        eps = denoise(x, t_vec)
        x = s_an * ((x - eps * s_1ma) / s_a) + c2 * eps
    return x


# ----------------------------------------------------------------------------
# Errors
# ----------------------------------------------------------------------------

def mpjpe(pred: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Per-sample mean joint distance, ``[..., J, 3] -> [...]``."""
    return np.linalg.norm(pred - target, axis=-1).mean(axis=-1)


def p_mpjpe(pred: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Per-sample MPJPE after the optimal similarity alignment of ``pred`` to
    ``target`` (``common/loss.py:p_mpjpe``: SVD with the reflection fixed)."""
    mu_x = target.mean(axis=1, keepdims=True)
    mu_y = pred.mean(axis=1, keepdims=True)
    x0, y0 = target - mu_x, pred - mu_y
    norm_x = np.sqrt((x0 ** 2).sum(axis=(1, 2), keepdims=True))
    norm_y = np.sqrt((y0 ** 2).sum(axis=(1, 2), keepdims=True))
    x0, y0 = x0 / norm_x, y0 / norm_y
    u, s, vt = np.linalg.svd(np.matmul(x0.transpose(0, 2, 1), y0))
    v = vt.transpose(0, 2, 1)
    r = np.matmul(v, u.transpose(0, 2, 1))
    sign = np.expand_dims(np.sign(np.expand_dims(np.linalg.det(r), axis=1)), axis=1)
    v[:, :, -1] *= sign[:, 0]
    s[:, -1] *= sign.flatten()
    r = np.matmul(v, u.transpose(0, 2, 1))
    tr = np.expand_dims(np.sum(s, axis=1, keepdims=True), axis=2)
    a = tr * norm_x / norm_y
    t = mu_x - a * np.matmul(mu_y, r)
    return np.linalg.norm(a * np.matmul(pred, r) + t - target, axis=-1).mean(axis=-1)
