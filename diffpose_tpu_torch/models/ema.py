"""Exponential moving average of a module's parameters.

The reference ``EMAHelper`` rule ``shadow = (1−μ)·param + μ·shadow``
(``models/ema.py:16-22``), applied after every optimizer step.  The shadow
is a dict of tensors named like ``module.named_parameters()``.
Counterpart of ``diffpose_tpu/models/ema.py``; unlike it, the update is in
place.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

Shadow = Dict[str, torch.Tensor]


def ema_register(model: nn.Module) -> Shadow:
    """The EMA shadow as a real copy of the live parameters (no aliasing)."""
    return {name: p.detach().clone() for name, p in model.named_parameters()}


@torch.no_grad()
def ema_update(shadow: Shadow, model: nn.Module, mu: float = 0.999) -> Shadow:
    """One EMA step, in place on ``shadow``: ``(1−μ)·param + μ·shadow``."""
    params = dict(model.named_parameters())
    names = list(shadow)
    shadows = [shadow[n] for n in names]
    torch._foreach_mul_(shadows, mu)
    torch._foreach_add_(shadows, [params[n].detach() for n in names], alpha=1.0 - mu)
    return shadow
