"""Device-memory-aware batch sizing.

Counterpart of ``diffpose_tpu/utils/memory.py`` (the reference's dynamic
chunk sizing, ``common/memory_utils.py``): pick a batch size up front from
the device's memory budget instead of chunking after an out-of-memory error.
On a CUDA device the budget comes from ``torch.cuda.mem_get_info`` (free and
total bytes: the limit is the total, the bytes in use total minus free); a
device without memory statistics (``device="cpu"``) gets the JAX function's
16 GiB default.  The device is the card unless the caller names another;
without a card that raises.
"""

from __future__ import annotations

import torch

from diffpose_tpu_torch.ops.fused_denoiser import resolve_device

DEFAULT_LIMIT = 16 * 1024 ** 3   # bytes, where the device reports none


def device_memory_budget(device="cuda", fraction: float = 0.9) -> int:
    """Usable bytes on ``device``: ``fraction`` of its limit less the bytes
    in use."""
    device = resolve_device(device)
    if device.type == "cuda":
        free, total = torch.cuda.mem_get_info(device)
        limit, in_use = total, total - free
    else:
        limit, in_use = DEFAULT_LIMIT, 0
    return max(int(limit * fraction) - int(in_use), 0)


def suggest_batch_size(
    per_sample_bytes: int,
    *,
    fixed_bytes: int = 0,
    device="cuda",
    target_fraction: float = 0.9,
    min_batch: int = 8,
    max_batch: int = 65536,
    multiple_of: int = 8,
) -> int:
    """Largest batch that fits the memory budget, rounded to ``multiple_of``.

    ``per_sample_bytes`` should cover activations (+grads for training);
    ``fixed_bytes`` covers parameters/optimizer state.  Equivalent role to
    ``get_dynamic_chunk_size`` (``memory_utils.py:30-110``) but decided
    once, up front.
    """
    budget = device_memory_budget(device, target_fraction) - fixed_bytes
    if per_sample_bytes <= 0:
        return max_batch
    n = budget // per_sample_bytes
    n = (n // multiple_of) * multiple_of
    return int(min(max(n, min_batch), max_batch))


def estimate_per_sample_bytes(
    n_joints: int = 17,
    hid_dim: int = 96,
    num_layers: int = 5,
    dtype_bytes: int = 4,
    train: bool = True,
) -> int:
    """Rough per-sample activation footprint of the denoiser forward(+bwd)."""
    # ~6 live [J, hid] tensors per layer block, doubled for backward.
    per_layer = 6 * n_joints * hid_dim * dtype_bytes
    total = per_layer * num_layers * (2 if train else 1)
    return int(total * 1.5)  # fudge for attention scores and fusion slack
