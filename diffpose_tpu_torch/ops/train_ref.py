"""Plain PyTorch reference of the GCNDiff TRAIN forward with explicit dropout masks.

Dropout makes the training forward stochastic.  To keep the fused train
kernels (``ops/fused_train.py``, ``csrc/train_kernel.cu``) testable, the
masks are explicit inputs, drawn once per step with ``nn.Dropout``'s
semantics (``mask ~ Bernoulli(keep); y = mask · x / keep``).  This module
is the plain version of both kernels: the forward kernel is held against
:func:`layers_forward`, the backward kernel against ``torch.autograd.grad``
of it.  Counterpart of ``diffpose_tpu/ops/train_ref.py``.

At a reduced ``--kernel_precision`` tier (``tier="bf16"`` or ``"default"``)
:func:`layers_forward` rounds where the train kernels round at that tier,
which is where ``diffpose_tpu/ops/pallas_train.py`` rounds at its
``precision``: the operands of every channel product (``_dot``: bf16, or
TF32 for the one-pass default tier), and at bf16 also the attention's
segment products (``_dot_exact_w``): each product ``q_d·k_d`` before the
per-head sum, and each probability before the dropout and the sum over V.
Stashes, activations, LayerNorm parameters and biases stay float32.  Each
rounding is a fixed function of its input (``ops/tf32.py:held``): under autograd its
gradient passes through unrounded, since no kernel rounds a gradient; the
tiers' backward is ``ops/fused_train.py:stack_bwd_plain``, not autograd.

Weight layout: :func:`~diffpose_tpu_torch.ops.fused_denoiser.prepare_weights`
(stacked per-layer tensors, 1/√d_k folded into the q projection).
Activations are batch-major ``[B, N=17, C]``, as everywhere in this package.

Dropout sites (reference file:line):

* attention probabilities, rate 0.1 — ``models/GraFormer.py:99-140``
* after each sublayer, rate 0.25    — ``models/GraFormer.py:73-96``
* Chebyshev blocks, rate 0.1        — ``models/ChebConv.py:145-151`` via
  ``models/gcndiff.py:84`` (relu → dropout → relu; the second relu is a
  no-op since dropout keeps the sign, and is left out).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from diffpose_tpu_torch.ops.fused_denoiser import (
    Weights,
    _cheb,
    _layer_norm,
    prepare_weights,
    timestep_projections,
)
from diffpose_tpu_torch.ops.tf32 import PARITY_TIER, held, round_bf16, tier_matmul

RATE_ATTN_PROBS = 0.1
RATE_SUBLAYER = 0.25
RATE_CHEB = 0.1

# What the forward keeps for the backward and for the weight gradients,
# each [L, B, N, width]; r1 is 2·H wide, the others H.
STASH_KEYS = ("ha", "hb", "hc", "y1", "att", "r1", "rc1", "u", "rd1")


class DropoutMasks(NamedTuple):
    """0/1 masks for every dropout site, batch-major, stacked over layers."""

    probs: torch.Tensor      # [L, B, heads, N, N]  (query, key)
    attn_out: torch.Tensor   # [L, B, N, H]
    gnet_out: torch.Tensor   # [L, B, N, H]
    cheb1: torch.Tensor      # [L, B, N, H]
    cheb2: torch.Tensor      # [L, B, N, H]


def resolve_rates(rates) -> Tuple[float, float, float]:
    p_probs, p_sub, p_cheb = rates or (RATE_ATTN_PROBS, RATE_SUBLAYER, RATE_CHEB)
    return float(p_probs), float(p_sub), float(p_cheb)


def make_dropout_masks(
    generator: torch.Generator, *, num_layers: int, n_pts: int, batch: int,
    num_heads: int, hid_dim: int, dtype=torch.float32, rates=None,
) -> DropoutMasks:
    """Draw all masks of one step, Bernoulli(keep) each, on the generator's
    device.  ``rates``: optional ``(p_attn_probs, p_sublayer, p_cheb)``
    override.  ``dtype=torch.uint8`` gives the kernels' type directly."""
    p_probs, p_sub, p_cheb = resolve_rates(rates)
    l, n, b, h, hd = num_layers, n_pts, batch, num_heads, hid_dim

    def bern(rate, shape):
        u = torch.rand(shape, generator=generator, device=generator.device)
        return (u < 1.0 - rate).to(dtype)

    return DropoutMasks(
        probs=bern(p_probs, (l, b, h, n, n)),
        attn_out=bern(p_sub, (l, b, n, hd)),
        gnet_out=bern(p_sub, (l, b, n, hd)),
        cheb1=bern(p_cheb, (l, b, n, hd)),
        cheb2=bern(p_cheb, (l, b, n, hd)),
    )


def attention_scores(q: torch.Tensor, k: torch.Tensor, bf16: bool) -> torch.Tensor:
    """``q @ kᵀ`` per head (``[..., n, dk]`` each); ``bf16``: each product
    ``q_d·k_d`` rounded to bf16 before the float32 sum over ``d``, as
    ``pallas_train.py:_attention_fwd`` sums them through ``_dot_exact_w``."""
    if not bf16:
        return q @ k.transpose(-1, -2)
    return held(round_bf16, q.unsqueeze(-2) * k.unsqueeze(-3)).sum(dim=-1)


def layers_forward(
    weights: Weights,
    h: torch.Tensor,          # [B, N, H]: the input ChebConv's output
    tp: torch.Tensor,         # [L, B, H]: per-layer timestep projections
    masks: DropoutMasks,
    *,
    rates=None,
    return_stashes: bool = False,
    matmul=None,
    tier: str = PARITY_TIER,
):
    """The L-layer GraAttenLayer + ResChebGCDiff stack in training mode.

    Returns the stack's output ``[B, N, H]``, and with ``return_stashes``
    also the dict of per-layer intermediates ``STASH_KEYS``.  ``matmul``
    computes the channel products (by default the tier's,
    ``ops/tf32.py:tier_matmul``; ``ops/tf32.py:matmul_3xtf32`` gives the parity
    kernels' tensor-core products).  ``tier``: the kernels'
    ``--kernel_precision`` (the module's text).
    """
    mm = matmul or tier_matmul(tier)
    bf16 = tier == "bf16"
    p_probs, p_sub, p_cheb = resolve_rates(rates)
    ikp, iks, ikc = 1.0 / (1.0 - p_probs), 1.0 / (1.0 - p_sub), 1.0 / (1.0 - p_cheb)
    w = weights
    hid, heads, basis = w["hid_dim"], w["num_heads"], w["basis"]
    bsz, n = h.shape[:2]
    stash: Dict[str, list] = {k: [] for k in STASH_KEYS}
    f = h.dtype

    for l in range(w["num_layers"]):
        stash["ha"].append(h)
        # attention sublayer (q carries 1/√d_k)
        y1 = _layer_norm(h, w["ln1s"][l], w["ln1b"][l])
        qkv = mm(y1, w["wqkv"][l]) + w["bqkv"][l]
        q, k, v = (z.reshape(bsz, n, heads, -1).transpose(1, 2) for z in qkv.split(hid, dim=-1))
        p = torch.softmax(attention_scores(q, k, bf16), dim=-1)
        if bf16:
            p = held(round_bf16, p)
        pd = p * (masks.probs[l].to(f) * ikp)
        att = (pd @ v).transpose(1, 2).reshape(bsz, n, hid)
        o1 = mm(att, w["wao"][l]) + w["bao"][l]
        h = h + o1 * (masks.attn_out[l].to(f) * iks)
        stash["y1"].append(y1)
        stash["att"].append(att)
        stash["hb"].append(h)

        # GraphNet sublayer (fc2 mixes lap . r1 first, as the TPU kernel and the
        # one-pass kernels do; the parity kernel's lap . (r1 @ W_fc2) is this
        # function to float32 rounding)
        lap = w["lap"][l]
        y2 = _layer_norm(h, w["ln2s"][l], w["ln2b"][l])
        r1 = F.relu(mm(lap @ y2, w["wfc1"][l]) + w["bfc1"][l])
        f2 = mm(lap @ r1, w["wfc2"][l]) + w["bfc2"][l]
        h = h + f2 * (masks.gnet_out[l].to(f) * iks)
        stash["r1"].append(r1)
        stash["hc"].append(h)

        # residual Chebyshev block, the timestep projection added after the
        # first conv's dropout
        rc1 = F.relu(_cheb(h, w["wg1"][l], w["bg1"][l], basis, mm))
        u = rc1 * (masks.cheb1[l].to(f) * ikc) + tp[l][:, None, :]
        rd1 = F.relu(_cheb(u, w["wg2"][l], w["bg2"][l], basis, mm))
        h = h + rd1 * (masks.cheb2[l].to(f) * ikc)
        stash["rc1"].append(rc1)
        stash["u"].append(u)
        stash["rd1"].append(rd1)
    if return_stashes:
        return h, {k: torch.stack(v) for k, v in stash.items()}
    return h


def train_forward(model, x: torch.Tensor, t: torch.Tensor, masks: DropoutMasks, *,
                  rates=None) -> torch.Tensor:
    """Full GCNDiff training forward ``ε̂(x [B, N, 5], t [B])`` from the
    module's parameters, differentiable with respect to them."""
    w = prepare_weights(model, device=x.device, differentiable=True)
    tp = timestep_projections(w, t)
    h = _cheb(x, w["win"], w["bin"], w["basis"])
    h = layers_forward(w, h, tp, masks, rates=rates)
    return _cheb(h, w["wout"], w["bout"], w["basis"])
