"""DDIM sampling and the forward (noising) process.

The reverse loop is a Python loop over the step sequence, one denoiser
call per step, as in the reference sampler (``common/utils_diff.py:46-67``).
All per-step mixing coefficients depend only on (betas, seq, eta), so they
are computed once on the host in float64 and enter the loop as float32
scalars::

    x0_t   = (x_t − ε̂·√(1−ᾱ_t)) / √ᾱ_t
    c1     = η·√((1 − ᾱ_t/ᾱ_next)(1 − ᾱ_next)/(1 − ᾱ_t))
    c2     = √(1 − ᾱ_next − c1²)
    x_next = √ᾱ_next·x0_t + c1·N(0,I) + c2·ε̂
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch


def make_skip_sequence(
    skip_type: str, test_timesteps: int, test_num_diffusion_timesteps: int
) -> Tuple[int, ...]:
    """Timestep subsequence for accelerated sampling.

    ``uniform``: ``range(0, T_test, T_test // K)``; ``quad``:
    ``linspace(0, √(0.8·T_test), K)²`` (reference
    ``runners/diffpose_frame.py:310-317``).
    """
    if skip_type == "uniform":
        skip = test_num_diffusion_timesteps // test_timesteps
        return tuple(range(0, test_num_diffusion_timesteps, skip))
    if skip_type == "quad":
        seq = np.linspace(0, np.sqrt(test_num_diffusion_timesteps * 0.8), test_timesteps) ** 2
        return tuple(int(s) for s in seq)
    raise NotImplementedError(skip_type)


def antithetic_timesteps(generator: torch.Generator, n: int, num_timesteps: int) -> torch.Tensor:
    """Antithetic timestep pairs: ⌈n/2⌉ uniform draws ``t`` from
    ``generator`` (on its device), mirrored as ``T−1−t`` and cut to ``n``
    (reference training loop, ``runners/diffpose_frame.py:216-218``)."""
    t = torch.randint(0, num_timesteps, (n // 2 + 1,), generator=generator,
                      device=generator.device)
    return torch.cat([t, num_timesteps - t - 1])[:n]


def q_sample_tables(betas, dtype=torch.float32, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(√ᾱ, √(1−ᾱ))`` as tensors, computed in float64 on the host, which
    avoids the float32 ``1−ᾱ`` cancellation."""
    ab = np.cumprod(1.0 - np.asarray(betas, np.float64))
    return (torch.as_tensor(np.sqrt(ab), dtype=dtype, device=device),
            torch.as_tensor(np.sqrt(1.0 - ab), dtype=dtype, device=device))


def q_sample(x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor, betas,
             tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Forward process ``x_t = √ᾱ_t·x0 + √(1−ᾱ_t)·noise``.

    ``noise`` is already scaled per coordinate (the reference multiplies
    by ``targets_noise_scale`` first, ``runners/diffpose_frame.py:219-222``);
    ``t`` indexes the unpadded ᾱ.  ``tables``: :func:`q_sample_tables` of
    ``betas`` made once by a caller that samples every step; ``betas`` is
    then not read.
    """
    sqrt_ab, sqrt_1mab = tables if tables is not None else q_sample_tables(
        betas, x0.dtype, x0.device)
    t = torch.as_tensor(t, dtype=torch.long, device=x0.device)
    bshape = (-1,) + (1,) * (x0.ndim - 1)
    return x0 * sqrt_ab[t].reshape(bshape) + noise * sqrt_1mab[t].reshape(bshape)


def ddim_sample(
    denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    seq: Sequence[int],
    betas,
    eta: float = 0.0,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Sequence[torch.Tensor]] = None,
    return_x0_preds: bool = False,
):
    """Run the reverse DDIM trajectory over ``seq``.

    ``denoise_fn(x_t, t_vec) -> ε̂`` with ``t_vec`` a float ``[B]`` vector
    holding the step's timestep.  With ``eta != 0`` each step adds
    ``c1·z``, ``z ~ N(0, I)`` drawn from ``generator``, or taken from
    ``noise[i]`` for step ``i`` when the caller supplies the draws.

    Returns the final sample, and with ``return_x0_preds`` also the
    per-step x0 predictions stacked on a leading axis.
    """
    ab = np.concatenate([[1.0], np.cumprod(1.0 - np.asarray(betas, np.float64))])
    seq = [int(s) for s in seq]
    ts = list(reversed(seq))
    ts_next = list(reversed([-1] + seq[:-1]))

    at = ab[np.asarray(ts) + 1]
    at_next = ab[np.asarray(ts_next) + 1]
    stochastic = eta != 0.0
    if stochastic:
        if generator is None and noise is None:
            raise ValueError("eta != 0 needs a generator or the noise draws")
        c1 = eta * np.sqrt((1.0 - at / at_next) * (1.0 - at_next) / (1.0 - at))
        c2 = np.sqrt((1.0 - at_next) - c1 ** 2)
    else:
        c1 = np.zeros(len(seq))
        c2 = np.sqrt(1.0 - at_next)
    # The coefficients enter the loop as float32 values, as the reference
    # casts them to the sample's type.
    consts = np.stack(
        [np.asarray(ts, np.float64), np.sqrt(at), np.sqrt(1.0 - at), np.sqrt(at_next), c1, c2],
        axis=1,
    ).astype(np.float32)

    x0_preds = []
    for i, row in enumerate(consts):
        t, s_at, s_1m_at, s_at_next, c1_t, c2_t = (float(c) for c in row)
        t_vec = torch.full((x.shape[0],), t, dtype=x.dtype, device=x.device)
        et = denoise_fn(x, t_vec)
        x0_t = (x - et * s_1m_at) / s_at
        x_next = s_at_next * x0_t + c2_t * et
        if stochastic:
            z = noise[i] if noise is not None else torch.randn(
                x.shape, generator=generator, dtype=x.dtype, device=x.device)
            x_next = x_next + c1_t * z
        if return_x0_preds:
            x0_preds.append(x0_t)
        x = x_next
    if return_x0_preds:
        return x, torch.stack(x0_preds)
    return x
