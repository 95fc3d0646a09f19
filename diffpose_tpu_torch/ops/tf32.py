"""TF32 operand splits and the tensor cores' 3xTF32 products in plain PyTorch.

The plain model of how the train kernels (``csrc/train_kernel.cuh:tc_gemm``,
helpers in ``csrc/mma_tf32.cuh``) compute every channel product on the
tensor cores:

* each f32 operand is split into TF32 parts, ``big = tf32(x)`` and
  ``small = tf32(x - big)`` (:func:`split_tf32`, ``cvt.rna.tf32.f32``);
* one ``mma.sync`` m16n8k8 adds 8 exact products to its accumulator in one
  fused sum that truncates (:func:`mma_chain`): the terms are aligned to
  the largest of the accumulator's exponent and the 8 operand exponent
  sums, each cut toward zero to 26 bits below that exponent, and the exact
  sum cut toward zero to f32;
* ``tc_gemm`` gives each k-step of 8 a fresh partial sum of the three passes
  ``a_small·w_big``, ``a_big·w_small`` and ``a_big·w_big`` (the
  ``small·small`` term, about 2⁻²² relative, is dropped) and adds it to its
  f32 accumulator with round-to-nearest (``accumulate="kstep"``); the
  design it replaced fed all three passes over the whole K into the one
  accumulator (``"whole_k"``), where the truncation's bias grows with K.

``probes/tf32_gemm.py`` holds this model bit for bit against the card (the
alignment and the widths were fitted to its outputs on an H100).  The
TPU kernels' counterpart is the ``bf16x3`` product of
``diffpose_tpu/ops/pallas_denoiser.py:_dot``.  ``layers_forward`` and
``stack_bwd_plain`` take ``matmul=matmul_3xtf32`` to run the plain stack
with these products on the CPU; no main path passes it.
"""

from __future__ import annotations

from typing import Optional

import torch

_ROUND, _KEEP = 0x1000, 0xFFFFE000
MMA_K = 8          # products an mma.sync m16n8k8 adds
EXTRA_BITS = 2     # bits the fused sum keeps past f32's 24 below the largest exponent
_NONE = -(1 << 20)  # the exponent given to a zero


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32 as ``cvt.rna.tf32.f32`` does it: to
    nearest, ties away from zero, on the int32 view ``(bits + 0x1000) &
    0xFFFFE000`` (10 stored mantissa bits; the same bits for every finite x)."""
    if x.dtype != torch.float32:
        raise ValueError(f"round_tf32 takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (bits + _ROUND) & _KEEP
    r = torch.where(r >= 1 << 31, r - (1 << 32), r)
    return r.to(torch.int32).view(torch.float32).reshape(x.shape)


def split_tf32(x: torch.Tensor):
    """``(big, small)`` with ``big = tf32(x)`` and ``small = tf32(x - big)``."""
    big = round_tf32(x)
    return big, round_tf32(x - big)


def _exponent(x: torch.Tensor) -> torch.Tensor:
    """``floor(log2 |x|)`` of float64 ``x``; far below every other for 0."""
    _, e = torch.frexp(x)
    return torch.where(x == 0, torch.full_like(e, _NONE), e - 1)


def _mma(c: torch.Tensor, p: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """One fused sum ``c + Σ_k p_k`` (float64 holding f32 ``c [..., N]``, the
    exact products ``p [..., 8, N]`` and their operands' exponent sums ``e``):
    every term cut toward zero to a multiple of ``2^(top - 23 - EXTRA_BITS)``,
    ``top`` the largest of ``c``'s exponent and the sums, then the exact
    sum cut toward zero to f32's 24 bits."""
    terms = torch.cat([c.unsqueeze(-2), p], dim=-2)
    top = torch.maximum(_exponent(c), e.amax(dim=-2)).clamp_min(-300).unsqueeze(-2)
    q = torch.ldexp(torch.ones_like(terms), (top - 23 - EXTRA_BITS).expand_as(terms))
    s = (torch.trunc(terms / q) * q).sum(dim=-2)
    _, se = torch.frexp(s)
    q = torch.ldexp(torch.ones_like(s), se - 24)
    return torch.trunc(s / q) * q


def _products(a: torch.Tensor, b: torch.Tensor):
    """``a [..., M, S, 8]`` times ``b [S, 8, N]`` (or ``b [..., S, 8, N]``,
    batched as ``a``) term by term, exact (TF32 operands), and the exponent
    sums: each ``[..., M, S, 8, N]``."""
    a, b = a.double(), b.double()
    if b.dim() > 3:
        b = b.unsqueeze(-4)
    return a.unsqueeze(-1) * b, _exponent(a).unsqueeze(-1) + _exponent(b)


def _steps(x: torch.Tensor, dim: int) -> torch.Tensor:
    k = x.shape[dim]
    if k % MMA_K:
        raise ValueError(f"K must be a multiple of {MMA_K}, got {k}")
    return x.unflatten(dim, (k // MMA_K, MMA_K))


def mma_chain(c0: Optional[torch.Tensor], a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``c0 + a [..., M, K] @ b [K, N]`` (TF32 operands, K % 8 == 0) as one
    accumulator through K / 8 ``mma.sync`` m16n8k8 in order."""
    p, e = _products(_steps(a, -1), _steps(b, 0))
    c = p.new_zeros(p.shape[:-3] + p.shape[-1:]) if c0 is None else c0.double()
    for s in range(p.shape[-3]):
        c = _mma(c, p[..., s, :, :], e[..., s, :, :])
    return c.float()


def _chain(passes) -> torch.Tensor:
    """Every pass's k-steps into one accumulator, k-step by k-step, the
    passes in turn within a k-step."""
    p0 = passes[0][0]
    c = p0.new_zeros(p0.shape[:-3] + p0.shape[-1:])
    for s in range(p0.shape[-3]):
        for p, e in passes:
            c = _mma(c, p[..., s, :, :], e[..., s, :, :])
    return c.float()


def matmul_3xtf32(a: torch.Tensor, w: torch.Tensor, accumulate: str = "kstep") -> torch.Tensor:
    """``a [..., M, K] @ w [K, N]`` (or ``w [..., K, N]`` with ``a``'s batch
    dimensions; float32, K % 8 == 0) at 3xTF32 as the kernels' tensor cores
    compute it (``accumulate="kstep"``), or as the design they replaced did
    (``"whole_k"``); see the module's text."""
    if accumulate not in ("kstep", "whole_k"):
        raise ValueError(f"accumulate must be 'kstep' or 'whole_k', got {accumulate!r}")
    (ab, as_), (wb, ws) = split_tf32(_steps(a, -1)), split_tf32(_steps(w, -2))
    passes = [_products(x, y) for x, y in ((as_, wb), (ab, ws), (ab, wb))]
    if accumulate == "whole_k":
        return _chain(passes)
    part = passes[0][0].new_zeros(passes[0][0].shape[:-2] + passes[0][0].shape[-1:])
    for p, e in passes:   # every k-step's partial at once: [..., M, K / 8, N]
        part = _mma(part, p, e)
    part = part.float()
    acc = torch.zeros_like(part[..., 0, :])
    for s in range(part.shape[-2]):
        acc = acc + part[..., s, :]
    return acc


def matmul_1xtf32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` (shapes as :func:`matmul_3xtf32`) with both operands rounded
    to TF32 and one accumulator through K / 8 ``mma.sync`` in order: the
    1xTF32 mode of the attention probe (``csrc/probe_attention.cu``)."""
    return _chain([_products(_steps(round_tf32(a), -1), _steps(round_tf32(w), -2))])


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to bf16 and held in float32: to nearest, ties to
    even, as the TPU kernels' ``.astype(bfloat16)`` and ``csrc/mma_tf32.cuh:
    to_bf16`` round (a bf16 value is exact in TF32 and in float32)."""
    if x.dtype != torch.float32:
        raise ValueError(f"round_bf16 takes float32, got {x.dtype}")
    return x.to(torch.bfloat16).to(torch.float32)


def matmul_1xbf16(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` (shapes as :func:`matmul_3xtf32`) with both operands rounded
    to bf16 and one accumulator through K / 8 ``mma.sync`` in order: how the
    one-pass ``tc_gemm`` of the bf16 tier computes it (``csrc/tc_gemm.cuh``,
    the TF32 ``mma.sync`` on bf16 values, whose products are exact)."""
    return _chain([_products(_steps(round_bf16(a), -1), _steps(round_bf16(w), -2))])


# --kernel_precision's tiers (the JAX kernels' `precision`), and the code each
# one-pass tier has in the CUDA sources (csrc/mma_tf32.cuh: TIER_BF16, TIER_1XTF32).
KERNEL_TIERS = ("bf16x3", "bf16", "default")
PARITY_TIER = "bf16x3"
TIER_CODES = {"bf16": 1, "default": 2}


def check_tier(tier: str) -> str:
    if tier not in KERNEL_TIERS:
        raise ValueError(f"kernel tier must be one of {KERNEL_TIERS}, got {tier!r}")
    return tier


def held(rnd, x: torch.Tensor) -> torch.Tensor:
    """``rnd(x)``, a rounding, as a fixed function of ``x``: its value, and
    under autograd the gradient passed straight through (``x - x.detach()``
    is an exact zero that carries it), since no kernel rounds a gradient."""
    return rnd(x.detach()) + (x - x.detach())


def matmul_bf16(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The bf16 tier's product in plain PyTorch: both operands rounded to
    bf16 (:func:`held`), the exact products summed in float32 (``jnp.dot`` of
    bf16 operands with ``preferred_element_type=float32``;
    :func:`matmul_1xbf16` is the card's order of the sum)."""
    return torch.matmul(held(round_bf16, a), held(round_bf16, w))


def matmul_tf32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The default tier's product in plain PyTorch: both operands rounded to
    TF32 (:func:`held`), the exact products summed in float32
    (:func:`matmul_1xtf32` is the card's order and truncation of the sum)."""
    return torch.matmul(held(round_tf32, a), held(round_tf32, w))


def tier_matmul(tier: str):
    """The channel product of a tier's plain versions."""
    return {"bf16x3": torch.matmul, "bf16": matmul_bf16, "default": matmul_tf32}[check_tier(tier)]


def round_weight(tier: str, w: torch.Tensor) -> torch.Tensor:
    """A product's weight as a one-pass tier's kernel takes it, rounded once
    on the host (``tc_gemm``'s one-pass weights)."""
    return {"bf16": round_bf16, "default": round_tf32}[tier](w).contiguous()
