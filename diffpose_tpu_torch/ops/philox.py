"""Philox4x32-10 and the dropout masks the seeded train kernels draw.

The plain version of the in-kernel dropout of ``csrc/train_kernel.cuh``
(``PRNG = true``): the same generator with the same keying, computed with
numpy ``uint64`` on the host, so that :func:`philox_masks` gives bit for bit
the masks the kernels draw from a step seed.  The (key, counter) layout is
written down once, in ``csrc/philox.cuh``; in short:

* key ``(seed as uint32, layer·8 + stream)``, counter ``(group, global
  sample index, 0, 0)``;
* stream 0, attention probabilities: group ``((head·N + query) << 3) + j``,
  word ``i`` decides key ``4j + i``;
* streams 1–4, the sites ``attn_out gnet_out cheb1 cheb2``: group
  ``joint·(H/4) + column/4``, word ``i`` decides column ``4·(column/4) + i``;
* keep where ``(word >> 9) < ceil(keep·2²³)``, with ``keep`` rounded to
  float32: the integer form of ``(word >> 9)·2⁻²³ < keep``, the test of
  ``diffpose_tpu/ops/pallas_train.py:_uniform_01``.

Counterpart of ``_gen_masks`` there, which draws from the TPU's generator and
keys on the batch chunk; here the key is the sample, so no tiling shows.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from diffpose_tpu_torch.ops.train_ref import DropoutMasks, resolve_rates

M0, M1 = 0xD2511F53, 0xCD9E8D57      # round multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85      # Weyl key increments
STREAMS = 8                          # key slots per layer; 0 probs, 1..4 the sites
_LOW = np.uint64(0xFFFFFFFF)
_32 = np.uint64(32)


def philox4x32_10(counter: np.ndarray, key) -> np.ndarray:
    """Ten rounds of Philox4x32 over ``counter [..., 4]`` (uint32 values) with
    ``key = (k0, k1)``; returns ``[..., 4]`` uint32."""
    c = [np.asarray(counter[..., i], dtype=np.uint64) & _LOW for i in range(4)]
    k0, k1 = int(key[0]) & 0xFFFFFFFF, int(key[1]) & 0xFFFFFFFF
    m0, m1 = np.uint64(M0), np.uint64(M1)
    for _ in range(10):
        p0, p1 = m0 * c[0], m1 * c[2]            # 32 × 32 bits: fits 64 without wrapping
        c = [(p1 >> _32) ^ c[1] ^ np.uint64(k0), p1 & _LOW,
             (p0 >> _32) ^ c[3] ^ np.uint64(k1), p0 & _LOW]
        k0, k1 = (k0 + W0) & 0xFFFFFFFF, (k1 + W1) & 0xFFFFFFFF
    return np.stack(c, axis=-1).astype(np.uint32)


def keep_threshold(keep: float) -> int:
    """``ceil(float32(keep)·2²³)``: a 23-bit draw below it is kept."""
    return math.ceil(float(np.float32(keep)) * (1 << 23))


def keep_thresholds(rates=None) -> Tuple[int, int, int]:
    """Thresholds of the attention-probability, sublayer and Chebyshev dropout."""
    return tuple(keep_threshold(1.0 - r) for r in resolve_rates(rates))


def seed_to_u32(seed) -> int:
    """A step seed (an int or a one-element integer tensor, any sign) as the
    uint32 the key holds."""
    if isinstance(seed, torch.Tensor):
        seed = int(seed.reshape(-1)[0])
    return int(seed) & 0xFFFFFFFF


def _draw(seed: int, layer: int, stream: int, groups: np.ndarray, batch: int,
          thresh: int) -> np.ndarray:
    """Keep decisions ``[batch, len(groups), 4]`` of one stream of one layer."""
    counter = np.zeros((batch, len(groups), 4), np.uint64)
    counter[..., 0] = groups[None, :]
    counter[..., 1] = np.arange(batch, dtype=np.uint64)[:, None]
    words = philox4x32_10(counter, (seed, layer * STREAMS + stream))
    return (words >> np.uint32(9)) < np.uint32(thresh)


def philox_masks(seed, *, num_layers: int, batch: int, n_pts: int = 17, num_heads: int = 4,
                 hid_dim: int = 96, rates=None, device="cpu",
                 dtype=torch.uint8) -> DropoutMasks:
    """The masks of one step drawn from ``seed`` as the seeded kernels draw
    them, as 0/1 tensors of ``dtype`` on ``device``."""
    if hid_dim % 4:
        raise ValueError(f"hid_dim must be a multiple of 4, got {hid_dim}")
    seed = seed_to_u32(seed)
    thp, ths, thc = keep_thresholds(rates)
    per_row = (n_pts + 3) // 4
    rows = np.arange(num_heads * n_pts, dtype=np.uint64)
    prob_groups = ((rows << np.uint64(3))[:, None] + np.arange(per_row, dtype=np.uint64)).reshape(-1)
    site_groups = np.arange(n_pts * hid_dim // 4, dtype=np.uint64)
    out = [[] for _ in range(5)]
    for l in range(num_layers):
        kept = _draw(seed, l, 0, prob_groups, batch, thp)
        kept = kept.reshape(batch, num_heads, n_pts, per_row * 4)[..., :n_pts]
        out[0].append(kept)
        for s, th in zip(range(1, 5), (ths, ths, thc, thc)):
            kept = _draw(seed, l, s, site_groups, batch, th)
            out[s].append(kept.reshape(batch, n_pts, hid_dim))
    return DropoutMasks(*(torch.from_numpy(np.stack(m).astype(np.uint8)).to(device=device,
                                                                             dtype=dtype)
                          for m in out))
