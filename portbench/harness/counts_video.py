"""Operations and bytes of the video family's MixSTE eval, from shapes alone.

In ``counts.py``'s terms: the work the function needs, counted once (a
multiply-add is two operations), the model's operations being its matrix
products: the linear layers and the attention's two products (scores and
their weighting of the values).  LayerNorm, GELU, the softmax and the
reshapes between the two token orders move bytes, not operations.  Bytes
are each weight read once and each block's activations read once and
written once (``[tokens, D]`` in and out, float32).
"""

from __future__ import annotations

from typing import NamedTuple

from portbench.harness import counts


class Mix(NamedTuple):
    """The MixSTE denoiser as the eval sees it."""

    frames: int
    joints: int
    dim: int
    depth: int          # spatial blocks; as many temporal ones
    hidden: int         # the MLP's units
    c_in: int
    c_out: int


def block_flops(m: Mix, windows: int, seq: int) -> int:
    """One block over ``windows × F × J`` tokens, attending over ``seq`` of
    them: ``qkv``, ``proj``, ``fc1``, ``fc2``, and ``QKᵀ`` and ``PV``."""
    tokens = windows * m.frames * m.joints
    return 2 * tokens * (4 * m.dim * m.dim + 2 * m.dim * m.hidden) + 4 * tokens * seq * m.dim


def block_weights(m: Mix) -> int:
    """Values of one block's weights: two LayerNorms, ``qkv``, ``proj``, the MLP."""
    d, h = m.dim, m.hidden
    return 4 * d + 3 * d * d + 3 * d + d * d + d + 2 * d * h + h + d


def embed_flops(m: Mix, windows: int) -> int:
    """The input embedding, the timestep MLP (one a window) and the head."""
    tokens = windows * m.frames * m.joints
    return 2 * tokens * m.dim * (m.c_in + m.c_out) + 2 * windows * 8 * m.dim * m.dim


def end_weights(m: Mix) -> int:
    """Values of the weights outside the blocks: the input embedding, both
    positional embeddings, the timestep MLP, the two shared norms, the head."""
    d = m.dim
    return ((m.c_in + 1) * d + (m.joints + m.frames) * d + 8 * d * d + 5 * d + 4 * d
            + 2 * d + (d + 1) * m.c_out)


def forward_flops(m: Mix, windows: int) -> int:
    """One forward of ``windows`` windows."""
    return (embed_flops(m, windows) + m.depth * (block_flops(m, windows, m.joints)
                                                 + block_flops(m, windows, m.frames)))


def forward_least_seconds(m: Mix, windows: int) -> float:
    """Σ of each piece's least time (``counts.least_seconds``): each block with
    its weights once and its activations in and out; the embedding and the
    head with theirs."""
    act = 4 * windows * m.frames * m.joints * m.dim
    tokens = windows * m.frames * m.joints
    ends = counts.least_seconds(embed_flops(m, windows),
                                4 * (end_weights(m) + tokens * (m.c_in + m.c_out)) + 2 * act)
    blocks = sum(counts.least_seconds(block_flops(m, windows, seq), 4 * block_weights(m) + 2 * act)
                 for seq in (m.joints, m.frames))
    return ends + m.depth * blocks


def batch_flops(m: Mix, windows: int, test_times: int, ddim_steps: int) -> int:
    """An eval batch of ``windows`` windows: each DDIM step a forward of every
    hypothesis of every window."""
    return ddim_steps * forward_flops(m, windows * test_times)


def batch_least_seconds(m: Mix, windows: int, test_times: int, ddim_steps: int) -> float:
    return ddim_steps * forward_least_seconds(m, windows * test_times)
