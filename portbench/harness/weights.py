"""Weights made from the run's seed on the device, in a few large calls.

One normal draw from a ``torch.Generator`` of the device covers every
parameter of a model; each parameter takes its slice, scaled by a fixed rule
by name so that every term of the network is live: linear and Chebyshev
weights at ``1/sqrt(fan-in)``, LayerNorm gains ``1 + 0.1 z``, biases
``0.1 z``, the learned adjacency ``I + 0.1 |z|`` (positive column sums), the
positional embedding ``0.02 z``.  The same dict goes to the program (copied
into its modules) and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def _scaled(name: str, z: torch.Tensor) -> torch.Tensor:
    if name.endswith("A_hat"):
        return torch.eye(z.shape[-1], dtype=z.dtype, device=z.device) + 0.1 * z.abs()
    if name.endswith("a_2"):
        return 1.0 + 0.1 * z
    if name.endswith(("b_2", "bias")):
        return 0.1 * z
    if name.endswith("pos_embed"):
        return 0.02 * z
    if z.ndim == 4:                       # ChebConv [K+1, 1, in, out]
        return z / math.sqrt(z.shape[0] * z.shape[2])
    if z.ndim == 2:                       # Linear [out, in]
        return z / math.sqrt(z.shape[1])
    return z


def make(shapes: Dict[str, torch.Size], seed: int, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` for a ``state_dict``'s names and shapes, from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    sizes = [math.prod(s) for s in shapes.values()]
    z = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    return {name: _scaled(name, part.reshape(shape)).contiguous()
            for (name, shape), part in zip(shapes.items(), torch.split(z, sizes))}


def shapes_of(module) -> Dict[str, torch.Size]:
    return {k: v.shape for k, v in module.state_dict().items()}
