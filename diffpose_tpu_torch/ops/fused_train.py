"""Fused train step: the GCNDiff layer stack forward and backward as two CUDA kernels.

Replaces the TPU kernels ``diffpose_tpu/ops/pallas_train.py:215
_stack_fwd_kernel`` and ``:531 _stack_bwd_kernel`` (the explicit-mask
dropout mode) and ``:314 _stack_fwd_kernel_prng`` and ``:581
_stack_bwd_kernel_prng`` (dropout drawn in the kernels from a step seed).
The CUDA source is ``csrc/train_kernel.cuh`` (device code, templated on the
dropout's source and the tier), ``csrc/philox.cuh`` (the generator and its
keying), ``csrc/train_entry.cuh`` (checks and launches) and the entries of the
parity and the tier builds, ``csrc/train_kernel.cu`` and
``csrc/train_kernel_tiers.cu``.

* **forward** (:func:`stack_fwd`): the training forward of all L layers
  including dropout, one launch; writes the stack's output and the
  per-layer intermediates ("stashes") the backward needs.
* **backward** (:func:`stack_bwd`): all layers in reverse, one launch;
  recomputes QKV and the attention probabilities from the stashed
  LayerNorm output and emits the data gradients ``dA0``, ``dtp`` and the
  per-layer pre-activation gradients ("d-stashes").
* :func:`weight_grads`: every weight gradient from stashes and d-stashes
  as plain ``torch`` products, one batched GEMM per weight (the JAX
  package leaves the same products to XLA, outside its kernels).

Bound on the H100: operations, for both kernels.  Per sample and layer the
forward does about 4.7 MFLOP and the backward 5.3 (five transposed products
plus the QKV recompute), 92–94% of it channel products; the stashes
(about 65 KB per sample and layer written, 46 KB read back) and the
``uint8`` masks come second.

Design, and where it differs from the TPU kernels:

* one CTA of 288 threads (9 warps) owns a tile of 4 samples; the residual
  stream (forward) or its gradient (backward) stays in shared memory across
  all layers;
* every channel product runs on the tensor cores, ``mma.sync`` m16n8k8 at
  3xTF32 (``big·big + big·small + small·big`` of the TF32 splits, f32
  accumulation; the TPU kernels' ``bf16x3``); :mod:`ops.tf32` is its plain
  model, and ``layers_forward`` / :func:`stack_bwd_plain` take
  ``matmul=ops.tf32.matmul_3xtf32`` to run with it on the CPU;
* weights stream from L2 through a ring of K-slabs in shared memory, filled
  by ``cp.async`` while the previous slab multiplies and split into TF32
  parts once per CTA; the next product's first slabs are requested before
  the stages that precede it;
* LayerNorms and their backward take a warp a row; dropout, ReLU gates and
  stashes run in the epilogue of the product or mix that feeds them;
* everything is batch-major: stashes and d-stashes are ``[L, B·17, C]``,
  so the kernels' stores are contiguous and each weight gradient is one
  ``bmm``;
* masks are ``uint8``; the attention mask is per head,
  ``[L, B, heads, 17, 17]`` — no head-expanded copy, no segment matrices;
* the forward also stashes ``hc`` and ``u``, which the TPU masks-mode
  kernel leaves to a recomputation: device memory is not scarce here;
* backward shared memory (227 KB): the gradient, two H-wide buffers, one
  3H-wide buffer that holds in turn the Chebyshev partial mixes, ``df1``,
  and the recomputed QKV overwritten in place by ``dqkv``, and one region
  that is the weight ring during the products and a 17×17 scratch per
  (sample, head) during the attention backward;
* the last tile masks its absent samples itself: any batch ≥ 1;
* seeded dropout (:func:`stack_fwd_prng`, :func:`stack_bwd_prng`): the TPU's
  generator has no counterpart, so the kernels carry Philox4x32-10, keyed on
  (seed, layer, stream, global sample, place in the sample) and not on the
  tile; the backward regenerates the forward's decisions, the attention row
  once per (sample, head, query); no mask lies in device memory (39 MB a
  step at B=1024 with explicit masks) and the per-step draw disappears.  The
  seed is an ``int32[1]`` on the device, read by the kernel, so no launch
  waits for the host.  About 2,000 Philox calls per sample and layer in each
  kernel add integer work; the bound stays the float operations' one.

Reduced tiers (``--kernel_precision bf16|default``, ``tier=`` on the
wrappers and :func:`build_train_stack`): the same kernels built at a
one-pass TIER (``csrc/train_kernel_tiers.cu``, a library of its own, built at
a tier's first use): every channel product one tensor-core pass on operands
rounded to bf16 or TF32, the weights rounded once a snapshot on the host
(:func:`rounded_stacks`), at bf16 also the attention's segment products
rounded where ``pallas_train.py`` rounds them (``csrc/train_kernel.cuh``'s
text); their plain versions are ``layers_forward`` and
:func:`stack_bwd_plain` at ``tier=``.

On CPU tensors the wrappers run the plain versions (:func:`plain_fwd` and its
siblings): ``layers_forward`` and :func:`stack_bwd_plain`, the hand-written
backward in tensor operations (the formulas the CUDA kernel implements), the
seeded ones with ``ops/philox.py:philox_masks``, which gives the kernels'
bits.  On CUDA tensors they launch the kernels or raise.
``stack_fwd.launches``, ``stack_bwd.launches``, ``stack_fwd_prng.launches``
and ``stack_bwd_prng.launches`` count the parity build's launches,
``<wrapper>.tier_launches[tier]`` a tier build's.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from diffpose_tpu_torch.ops import _build
from diffpose_tpu_torch.ops.fused_denoiser import (
    KERNEL_CHEB_TERMS,
    KERNEL_HEADS,
    KERNEL_HID,
    KERNEL_PTS,
    Weights,
    _check_tensor,
    _cheb,
    count_launch,
    prepare_weights,
    reset_counts,
    timestep_projections,
)
from diffpose_tpu_torch.ops.philox import keep_thresholds, philox_masks
from diffpose_tpu_torch.ops.tf32 import (
    PARITY_TIER,
    TIER_CODES,
    check_tier,
    round_bf16,
    round_weight,
    tier_matmul,
)
from diffpose_tpu_torch.ops.train_ref import (
    STASH_KEYS,
    DropoutMasks,
    attention_scores,
    layers_forward,
    resolve_rates,
)

# Per-layer weight stacks the kernels and weight_grads work on.
STACK_KEYS = (
    "ln1s", "ln1b", "ln2s", "ln2b", "wqkv", "bqkv", "wao", "bao", "lap",
    "wfc1", "bfc1", "wfc2", "bfc2", "wg1", "bg1", "wg2", "bg2",
)
MASK_KEYS = ("probs", "attn_out", "gnet_out", "cheb1", "cheb2")
# Stashes the backward kernel reads; weight_grads reads the others too.
BWD_STASH_KEYS = ("ha", "hb", "y1", "r1", "rc1", "rd1")
DSTASH_KEYS = ("dqkv", "do1", "df1", "df2", "dc1", "dc2")
_STASH_WIDTH = {"r1": 2}                 # in units of H; default 1
_DSTASH_WIDTH = {"dqkv": 3, "df1": 2}
# Weights the backward kernel takes transposed ([L, out, in]).
_BWD_TRANSPOSED = ("wqkv", "wao", "wfc1", "wfc2", "wg1", "wg2")

Rates = Tuple[float, float, float]


def kernel_masks(masks: DropoutMasks) -> Dict[str, torch.Tensor]:
    """``DropoutMasks`` → the kernels' layout: the same batch-major shapes
    as contiguous ``uint8`` (probs per head ``[L, B, heads, N, N]``, the
    four site masks ``[L, B, N, H]``)."""
    return {k: getattr(masks, k).to(torch.uint8).contiguous() for k in MASK_KEYS}


def masks_from_kernel(km: Dict[str, torch.Tensor], dtype=torch.float32) -> DropoutMasks:
    """The inverse of :func:`kernel_masks`."""
    return DropoutMasks(*(km[k].to(dtype) for k in MASK_KEYS))


def _inv_keep(rates) -> Rates:
    p_probs, p_sub, p_cheb = resolve_rates(rates)
    return 1.0 / (1.0 - p_probs), 1.0 / (1.0 - p_sub), 1.0 / (1.0 - p_cheb)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _ln_bwd(g, x, scale):
    """Gradient of ``scale·(x−μ)/(σ+1e-6)+shift`` (Bessel σ, eps outside the
    root) with respect to ``x``, given the output's gradient ``g``."""
    hid = x.shape[-1]
    c = x - x.mean(dim=-1, keepdim=True)
    sd = torch.sqrt((c * c).sum(dim=-1, keepdim=True) / (hid - 1))
    r = 1.0 / (sd + 1e-6)
    gs = g * scale
    s1 = (gs * c).sum(dim=-1, keepdim=True)
    dc = gs * r - c * (s1 * r * r / ((hid - 1) * sd.clamp_min(1e-20)))
    return dc - dc.mean(dim=-1, keepdim=True)


def _cheb_bwd_data(dy, wcat, basis, mm=torch.matmul):
    """Input gradient of ``y = Σ_k T_k·(x @ W_k)``: the transposed mixes
    ``T_kᵀ·dy`` side by side, times ``[W_0 | W_1 | W_2]ᵀ``."""
    v = torch.einsum("knm,bnd->bmkd", basis, dy).flatten(-2)
    return mm(v, wcat.t())


def stack_bwd_plain(w: Weights, masks: DropoutMasks, st: Dict[str, torch.Tensor],
                    dd5: torch.Tensor, *, rates=None, matmul=None, tier: str = PARITY_TIER):
    """The backward kernel's function in tensor operations.

    From the gradient ``dd5 [B, N, H]`` of the stack's output: ``dA0``
    (gradient of the stack's input), ``dtp [L, B, H]`` and the d-stashes
    ``DSTASH_KEYS``, each ``[L, B, N, width]``.  ``matmul`` computes the
    channel products (by default the tier's, ``ops/tf32.py:tier_matmul``;
    ``ops/tf32.py:matmul_3xtf32`` gives the parity kernel's tensor-core
    products).  ``tier``: the kernels' ``--kernel_precision``.  At a one-pass
    tier the fc2 backward multiplies ``df2 @ W_fc2ᵀ`` first and mixes with
    ``lapᵀ`` after, as ``pallas_train.py:_layer_bwd_math`` does (a rounding
    of the operands does not commute with the mix; the parity kernel mixes
    first); at bf16 the attention backward rounds where
    ``pallas_train.py:_attention_bwd`` does: the recomputed scores and
    probabilities as the forward, each ``v_d·datt_d·mask/keep`` before its
    per-head sum, and the softmax gradient before it multiplies k and q.
    """
    mm = matmul or tier_matmul(tier)
    bf16 = tier == "bf16"
    ikp, iks, ikc = _inv_keep(rates)
    hid, heads, basis = w["hid_dim"], w["num_heads"], w["basis"]
    bsz, n = dd5.shape[:2]
    f = dd5.dtype
    num_layers = w["num_layers"]
    ds = {k: [None] * num_layers for k in DSTASH_KEYS}
    dtp = [None] * num_layers
    dh = dd5

    def split_heads(z):
        return z.reshape(bsz, n, heads, -1).transpose(1, 2)

    def merge_heads(z):
        return z.transpose(1, 2).reshape(bsz, n, hid)

    for l in reversed(range(num_layers)):
        # Chebyshev block: h_out = hc + rd1·m4·ikc, u = rc1·m3·ikc + tp
        dc2 = dh * (masks.cheb2[l].to(f) * ikc) * (st["rd1"][l] > 0)
        du = _cheb_bwd_data(dc2, w["wg2"][l], basis, mm)
        dtp[l] = du.sum(dim=1)
        dc1 = du * (masks.cheb1[l].to(f) * ikc) * (st["rc1"][l] > 0)
        d_hc = dh + _cheb_bwd_data(dc1, w["wg1"][l], basis, mm)

        # GraphNet: hc = hb + f2·m2·iks
        lap_t = w["lap"][l].t()
        df2 = d_hc * (masks.gnet_out[l].to(f) * iks)
        if tier == PARITY_TIER:
            df1 = mm(lap_t @ df2, w["wfc2"][l].t()) * (st["r1"][l] > 0)
        else:
            df1 = (lap_t @ mm(df2, w["wfc2"][l].t())) * (st["r1"][l] > 0)
        dy2 = lap_t @ mm(df1, w["wfc1"][l].t())
        d_hb = d_hc + _ln_bwd(dy2, st["hb"][l], w["ln2s"][l])

        # attention: hb = ha + o1·m1·iks; the probabilities are recomputed
        do1 = d_hb * (masks.attn_out[l].to(f) * iks)
        datt = split_heads(mm(do1, w["wao"][l].t()))
        qkv = mm(st["y1"][l], w["wqkv"][l]) + w["bqkv"][l]
        q, k, v = (split_heads(z) for z in qkv.split(hid, dim=-1))
        p = torch.softmax(attention_scores(q, k, bf16), dim=-1)
        mp = masks.probs[l].to(f) * ikp
        if bf16:
            dv = (round_bf16(p) * mp).transpose(-1, -2) @ datt
            # dp[n, m] = Σ_d bf16(v[m, d]·datt[n, d]·mp[n, m])
            dp = round_bf16(v.unsqueeze(-3) * datt.unsqueeze(-2) * mp.unsqueeze(-1)).sum(dim=-1)
        else:
            dv = (p * mp).transpose(-1, -2) @ datt
            dp = (datt @ v.transpose(-1, -2)) * mp
        dsc = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
        if bf16:
            dsc = round_bf16(dsc)
        dq, dk = dsc @ k, dsc.transpose(-1, -2) @ q
        dqkv = torch.cat([merge_heads(dq), merge_heads(dk), merge_heads(dv)], dim=-1)
        dh = d_hb + _ln_bwd(mm(dqkv, w["wqkv"][l].t()), st["ha"][l], w["ln1s"][l])

        for key, val in zip(DSTASH_KEYS, (dqkv, do1, df1, df2, dc1, dc2)):
            ds[key][l] = val
    return dh, torch.stack(dtp), {k: torch.stack(v) for k, v in ds.items()}


def weight_grads(w: Weights, st: Dict[str, torch.Tensor],
                 ds: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every stacked weight's gradient from stashes and d-stashes, as
    batched ``torch`` products over all ``B·N`` rows of a layer.

    A weight gradient is a small matrix (at most 96×288) summed over 17,408
    rows at B=1024; as one product per layer it leaves the card almost idle,
    so the rows are cut into up to 32 slices that run as extra batches and
    are added up afterwards.
    """
    L, hid, basis = w["num_layers"], w["hid_dim"], w["basis"]
    n_rows = st["ha"].shape[1] * st["ha"].shape[2]
    slices = math.gcd(n_rows, 32)

    def rows(z):  # [L, B, N, C] -> [L, B·N, C]
        return z.reshape(L, n_rows, z.shape[-1])

    def gemm(a, d):  # Σ_rows a[:, c]·d[:, e] -> [L, C, E]
        a = rows(a).reshape(L * slices, n_rows // slices, -1)
        d = rows(d).reshape(L * slices, n_rows // slices, -1)
        return torch.bmm(a.transpose(1, 2), d).reshape(L, slices, a.shape[-1], -1).sum(dim=1)

    def times(d, wt):  # d [L, B, N, E] @ wt [L, E, C] over all rows of a layer
        return torch.bmm(rows(d), wt).reshape(*d.shape[:-1], -1)

    def pair_sum(a, b):  # Σ_{batch, c} a[l, ·, n, c]·b[l, ·, m, c] -> [L, N, N]
        return (a @ b.transpose(-1, -2)).sum(dim=1)

    def colsum(z):
        return z.sum(dim=(1, 2))

    def xhat(x):
        c = x - x.mean(dim=-1, keepdim=True)
        sd = torch.sqrt((c * c).sum(dim=-1, keepdim=True) / (hid - 1))
        return c / (sd + 1e-6)

    def cheb_w(z, d):  # gradient of [W_0 | W_1 | W_2]: zᵀ · (T_kᵀ·d side by side)
        return gemm(z, torch.einsum("knm,lbnd->lbmkd", basis, d).flatten(-2))

    lap = w["lap"][:, None]                        # [L, 1, N, N]
    xhat1, xhat2 = xhat(st["ha"]), xhat(st["hb"])
    y2 = xhat2 * w["ln2s"][:, None, None] + w["ln2b"][:, None, None]
    g1, g2 = lap @ y2, lap @ st["r1"]
    dg1 = times(ds["df1"], w["wfc1"].transpose(1, 2))
    dg2 = times(ds["df2"], w["wfc2"].transpose(1, 2))
    dy1 = times(ds["dqkv"], w["wqkv"].transpose(1, 2))
    dy2 = lap.transpose(-1, -2) @ dg1
    return {
        "ln1s": colsum(dy1 * xhat1), "ln1b": colsum(dy1),
        "ln2s": colsum(dy2 * xhat2), "ln2b": colsum(dy2),
        "wqkv": gemm(st["y1"], ds["dqkv"]), "bqkv": colsum(ds["dqkv"]),
        "wao": gemm(st["att"], ds["do1"]), "bao": colsum(ds["do1"]),
        "lap": pair_sum(dg1, y2) + pair_sum(dg2, st["r1"]),
        "wfc1": gemm(g1, ds["df1"]), "bfc1": colsum(ds["df1"]),
        "wfc2": gemm(g2, ds["df2"]), "bfc2": colsum(ds["df2"]),
        "wg1": cheb_w(st["hc"], ds["dc1"]), "bg1": colsum(ds["dc1"]),
        "wg2": cheb_w(st["u"], ds["dc2"]), "bg2": colsum(ds["dc2"]),
    }


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_FWD_WEIGHTS = STACK_KEYS + ("cheb_ptr", "cheb_idx", "cheb_val")
_BWD_WEIGHTS = ("ln1s", "ln2s", "wqkv", "bqkv", "wqkv_t", "wao_t", "lap",
                "wfc1_t", "wfc2_t", "wg1_t", "wg2_t")


def _entry_types():
    """The argument types of the forward and the backward entry."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    u32 = ctypes.c_uint
    drop = [i32, ptr] + [u32] * 3          # seeded, seed, three thresholds
    fwd = ([i32] * 6 + [f32] * 3 + drop + [ptr] * (2 + 2 * len(MASK_KEYS) + len(_FWD_WEIGHTS))
           + [i32] + [ptr] * (1 + len(STASH_KEYS)) + [ptr])
    bwd = ([i32] * 6 + [f32] * 3 + drop + [ptr] * (1 + len(MASK_KEYS) + len(BWD_STASH_KEYS)
                                                    + len(_BWD_WEIGHTS) + 3) + [i32]
           + [ptr] * (2 + len(DSTASH_KEYS)) + [ptr])
    return fwd, bwd


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("train_kernel")
    fwd, bwd = _entry_types()
    lib.train_stack_forward.argtypes, lib.train_stack_forward.restype = fwd, ctypes.c_int
    lib.train_stack_backward.argtypes, lib.train_stack_backward.restype = bwd, ctypes.c_int
    lib.train_error_string.argtypes = [ctypes.c_int]
    lib.train_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _tier_library() -> ctypes.CDLL:
    """The one-pass tiers' build (``csrc/train_kernel_tiers.cu``), at first
    use: the parity library's entries after a leading tier code."""
    lib = _build.load("train_kernel_tiers")
    fwd, bwd = _entry_types()
    i32 = ctypes.c_int
    lib.train_stack_forward_tier.argtypes, lib.train_stack_forward_tier.restype = [i32] + fwd, i32
    lib.train_stack_backward_tier.argtypes, lib.train_stack_backward_tier.restype = [i32] + bwd, i32
    lib.train_tier_error_string.argtypes = [i32]
    lib.train_tier_error_string.restype = ctypes.c_char_p
    return lib


def rounded_stacks(w: Weights, tier: str) -> Dict[str, torch.Tensor]:
    """The channel products' weights as a one-pass tier's kernels take them:
    each of ``_BWD_TRANSPOSED`` rounded to the tier once (``"<k>"``, and
    transposed for the backward, ``"<k>_t"``), without gradient.  Kept in
    ``w`` under ``"rounded_<tier>"``, so that a weight snapshot (one train
    step's) is rounded once however many launches take it."""
    key = f"rounded_{tier}"
    if key not in w:
        with torch.no_grad():
            out = {k: round_weight(tier, w[k].detach()) for k in _BWD_TRANSPOSED}
            out.update({f"{k}_t": v.transpose(1, 2).contiguous() for k, v in list(out.items())})
        w[key] = out
    return w[key]


def _stack_shapes(w: Weights) -> Dict[str, tuple]:
    L, H, n, k1 = w["num_layers"], w["hid_dim"], w["n_pts"], KERNEL_CHEB_TERMS
    return dict(
        ln1s=(L, H), ln1b=(L, H), ln2s=(L, H), ln2b=(L, H),
        wqkv=(L, H, 3 * H), bqkv=(L, 3 * H), wao=(L, H, H), bao=(L, H), lap=(L, n, n),
        wfc1=(L, H, 2 * H), bfc1=(L, 2 * H), wfc2=(L, 2 * H, H), bfc2=(L, H),
        wg1=(L, H, k1 * H), bg1=(L, H), wg2=(L, H, k1 * H), bg2=(L, H),
    )


class _Drop(NamedTuple):
    """The dropout arguments of one launch: explicit masks (``km``) or a seed."""

    km: Optional[Dict[str, torch.Tensor]]
    seed: Optional[torch.Tensor]
    thresholds: Tuple[int, int, int]

    def args(self):
        """(seeded, seed pointer, thresholds, the five mask pointers)."""
        if self.seed is not None:
            return (1, self.seed.data_ptr(), *self.thresholds, *[None] * len(MASK_KEYS))
        return (0, None, 0, 0, 0, *[self.km[k].data_ptr() for k in MASK_KEYS])


def _check_common(w: Weights, drop: _Drop, ref: torch.Tensor):
    """Checks shared by both launches; returns ``(B, L, H, n, device)``."""
    cfg = (w["hid_dim"], w["num_heads"], w["n_pts"])
    if cfg != (KERNEL_HID, KERNEL_HEADS, KERNEL_PTS):
        raise ValueError(f"the kernels are built for hid/heads/joints "
                         f"{(KERNEL_HID, KERNEL_HEADS, KERNEL_PTS)}, got {cfg}")
    if w["basis"].shape[0] != KERNEL_CHEB_TERMS:
        raise ValueError(f"the kernels take a Chebyshev basis of {KERNEL_CHEB_TERMS} terms")
    if ref.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {ref.device}")
    bsz, L, H, n, dev = ref.shape[0], w["num_layers"], w["hid_dim"], w["n_pts"], ref.device
    if bsz < 1:
        raise ValueError("the kernels take a batch of at least 1")
    if drop.seed is not None:
        _check_tensor("seed", drop.seed, (1,), torch.int32, dev)
    else:
        for k, shape in _mask_shapes(L, bsz, w["num_heads"], n, H).items():
            _check_tensor(f"masks.{k}", drop.km[k], shape, torch.uint8, dev)
    return bsz, L, H, n, dev


def _mask_shapes(L, bsz, heads, n, H) -> Dict[str, tuple]:
    return {"probs": (L, bsz, heads, n, n), **{k: (L, bsz, n, H) for k in MASK_KEYS[1:]}}


def _raise_on(code: int, what: str, tier: str = PARITY_TIER):
    if code != 0:
        msg = (_library().train_error_string(code) if tier == PARITY_TIER
               else _tier_library().train_tier_error_string(code)).decode()
        raise RuntimeError(f"{what} kernel (tier {tier}): {msg} (cudaError {code})")


def _launch_fwd(w: Weights, h0, tp, drop, ikeep: Rates, *, dump: bool = False,
                tier: str = PARITY_TIER):
    """One launch of the forward kernel; every input is checked first.
    ``drop``: the masks' dict, or a :class:`_Drop`.  With ``dump`` (seeded
    dropout only) also returns the masks the kernel drew, in
    :func:`kernel_masks`' layout.  ``tier``: the parity build, or a one-pass
    tier's (``csrc/train_kernel_tiers.cu``) on :func:`rounded_stacks`."""
    check_tier(tier)
    if not isinstance(drop, _Drop):
        drop = _Drop(drop, None, (0, 0, 0))
    if dump and drop.seed is None:
        raise ValueError("only the seeded forward can dump its masks")
    bsz, L, H, n, dev = _check_common(w, drop, h0)
    _check_tensor("h0", h0, (bsz, n, H), torch.float32, dev)
    _check_tensor("tp", tp, (L, bsz, H), torch.float32, dev)
    for name, shape in _stack_shapes(w).items():
        _check_tensor(name, w[name], shape, torch.float32, dev)
    _check_tensor("cheb_ptr", w["cheb_ptr"], (n + 1,), torch.int32, dev)
    for name, dtype in (("cheb_idx", torch.int32), ("cheb_val", torch.float32)):
        _check_tensor(name, w[name], (w["cheb_nnz"],), dtype, dev)

    d5 = torch.empty((bsz, n, H), dtype=torch.float32, device=dev)
    st = {k: torch.empty((L, bsz, n, _STASH_WIDTH.get(k, 1) * H), dtype=torch.float32, device=dev)
          for k in STASH_KEYS}
    dumped = {k: torch.empty(shape, dtype=torch.uint8, device=dev)
              for k, shape in _mask_shapes(L, bsz, w["num_heads"], n, H).items()} if dump else {}
    prods = w if tier == PARITY_TIER else {**w, **rounded_stacks(w, tier)}
    seeded, seed_ptr, thp, ths, thc, *mask_ptrs = drop.args()
    args = (dev.index, H, w["num_heads"], n, bsz, L, *ikeep, seeded, seed_ptr, thp, ths, thc,
            h0.data_ptr(), tp.data_ptr(), *mask_ptrs,
            *[dumped[k].data_ptr() if dump else None for k in MASK_KEYS],
            *[prods[k].data_ptr() for k in _FWD_WEIGHTS], w["cheb_nnz"],
            d5.data_ptr(), *[st[k].data_ptr() for k in STASH_KEYS],
            torch.cuda.current_stream(dev).cuda_stream)
    if tier == PARITY_TIER:
        code = _library().train_stack_forward(*args)
    else:
        code = _tier_library().train_stack_forward_tier(TIER_CODES[tier], *args)
    _raise_on(code, "train_stack_forward", tier)
    return (d5, st, dumped) if dump else (d5, st)


def _launch_bwd(w: Weights, drop, st, dd5, ikeep: Rates, *, tier: str = PARITY_TIER):
    """One launch of the backward kernel; every input is checked first.
    ``drop``: the masks' dict, or a :class:`_Drop`; ``tier`` as
    :func:`_launch_fwd`'s."""
    check_tier(tier)
    if not isinstance(drop, _Drop):
        drop = _Drop(drop, None, (0, 0, 0))
    bsz, L, H, n, dev = _check_common(w, drop, dd5)
    _check_tensor("dd5", dd5, (bsz, n, H), torch.float32, dev)
    for k in BWD_STASH_KEYS:
        _check_tensor(k, st[k], (L, bsz, n, _STASH_WIDTH.get(k, 1) * H), torch.float32, dev)
    shapes = _stack_shapes(w)
    wb = {k: w[k] for k in ("ln1s", "ln2s", "wqkv", "bqkv", "lap")}
    for k in wb:
        _check_tensor(k, wb[k], shapes[k], torch.float32, dev)
    for k in _BWD_TRANSPOSED:
        _check_tensor(k, w[k], shapes[k], torch.float32, dev)
    if tier == PARITY_TIER:
        wb.update({k + "_t": w[k].transpose(1, 2).contiguous() for k in _BWD_TRANSPOSED})
    else:
        rw = rounded_stacks(w, tier)
        wb.update(wqkv=rw["wqkv"], **{k + "_t": rw[k + "_t"] for k in _BWD_TRANSPOSED})
    tptr, tidx, tval = w["chebt_ptr"], w["chebt_idx"], w["chebt_val"]
    _check_tensor("chebt_ptr", tptr, (KERNEL_CHEB_TERMS * n + 1,), torch.int32, dev)
    _check_tensor("chebt_idx", tidx, (tval.numel(),), torch.int32, dev)
    _check_tensor("chebt_val", tval, (tval.numel(),), torch.float32, dev)

    da0 = torch.empty((bsz, n, H), dtype=torch.float32, device=dev)
    dtp = torch.empty((L, bsz, H), dtype=torch.float32, device=dev)
    ds = {k: torch.empty((L, bsz, n, _DSTASH_WIDTH.get(k, 1) * H), dtype=torch.float32,
                         device=dev) for k in DSTASH_KEYS}
    args = (dev.index, H, w["num_heads"], n, bsz, L, *ikeep, *drop.args()[:5],
            dd5.data_ptr(), *drop.args()[5:],
            *[st[k].data_ptr() for k in BWD_STASH_KEYS], *[wb[k].data_ptr() for k in _BWD_WEIGHTS],
            tptr.data_ptr(), tidx.data_ptr(), tval.data_ptr(), tval.numel(),
            da0.data_ptr(), dtp.data_ptr(), *[ds[k].data_ptr() for k in DSTASH_KEYS],
            torch.cuda.current_stream(dev).cuda_stream)
    if tier == PARITY_TIER:
        code = _library().train_stack_backward(*args)
    else:
        code = _tier_library().train_stack_backward_tier(TIER_CODES[tier], *args)
    _raise_on(code, "train_stack_backward", tier)
    return da0, dtp, ds


def plain_fwd(w: Weights, h0, tp, km: Dict[str, torch.Tensor], *, rates=None,
              tier: str = PARITY_TIER):
    """:func:`stack_fwd`'s function in tensor operations, on any device."""
    return layers_forward(w, h0, tp, masks_from_kernel(km, h0.dtype), rates=rates,
                          return_stashes=True, tier=tier)


def plain_bwd(w: Weights, km: Dict[str, torch.Tensor], st, dd5, *, rates=None,
              tier: str = PARITY_TIER):
    """:func:`stack_bwd`'s function in tensor operations, on any device."""
    return stack_bwd_plain(w, masks_from_kernel(km, dd5.dtype), st, dd5, rates=rates, tier=tier)


def stack_fwd(w: Weights, h0: torch.Tensor, tp: torch.Tensor, km: Dict[str, torch.Tensor], *,
              rates=None, tier: str = PARITY_TIER):
    """Training forward of the layer stack: ``(d5 [B, N, H], stashes)``.
    ``km`` is :func:`kernel_masks`' dict.  One kernel launch for CUDA
    tensors (the parity build, or ``tier``'s), :func:`plain_fwd` for CPU
    tensors."""
    if h0.device.type == "cpu":
        return plain_fwd(w, h0, tp, km, rates=rates, tier=tier)
    out = _launch_fwd(w, h0, tp, km, _inv_keep(rates), tier=tier)
    count_launch(stack_fwd, tier)
    return out


def stack_bwd(w: Weights, km: Dict[str, torch.Tensor], st: Dict[str, torch.Tensor],
              dd5: torch.Tensor, *, rates=None, tier: str = PARITY_TIER):
    """Backward of the layer stack: ``(dA0, dtp, d-stashes)``.  One kernel
    launch for CUDA tensors, :func:`plain_bwd` for CPU tensors."""
    if dd5.device.type == "cpu":
        return plain_bwd(w, km, st, dd5, rates=rates, tier=tier)
    out = _launch_bwd(w, km, st, dd5, _inv_keep(rates), tier=tier)
    count_launch(stack_bwd, tier)
    return out


def _seeded(seed: torch.Tensor, rates) -> _Drop:
    return _Drop(None, seed, keep_thresholds(rates))


def _masks_of_seed(w: Weights, seed, batch: int, device, dtype, rates) -> DropoutMasks:
    return philox_masks(seed, num_layers=w["num_layers"], batch=batch, n_pts=w["n_pts"],
                        num_heads=w["num_heads"], hid_dim=w["hid_dim"], rates=rates,
                        device=device, dtype=dtype)


def plain_fwd_prng(w: Weights, h0, tp, seed, *, rates=None, dump: bool = False,
                   tier: str = PARITY_TIER):
    """:func:`stack_fwd_prng`'s function in tensor operations, on any device:
    ``layers_forward`` over :func:`philox_masks` (the kernels' bits)."""
    masks = _masks_of_seed(w, seed, h0.shape[0], h0.device, h0.dtype, rates)
    out = layers_forward(w, h0, tp, masks, rates=rates, return_stashes=True, tier=tier)
    return (*out, kernel_masks(masks)) if dump else out


def plain_bwd_prng(w: Weights, seed, st, dd5, *, rates=None, tier: str = PARITY_TIER):
    """:func:`stack_bwd_prng`'s function in tensor operations, on any device."""
    masks = _masks_of_seed(w, seed, dd5.shape[0], dd5.device, dd5.dtype, rates)
    return stack_bwd_plain(w, masks, st, dd5, rates=rates, tier=tier)


def stack_fwd_prng(w: Weights, h0: torch.Tensor, tp: torch.Tensor, seed: torch.Tensor, *,
                   rates=None, dump: bool = False, tier: str = PARITY_TIER):
    """:func:`stack_fwd` with the dropout drawn from ``seed`` (``int32[1]`` on
    ``h0``'s device) as ``csrc/philox.cuh`` sets out: one launch of the seeded
    forward kernel for CUDA tensors, :func:`plain_fwd_prng` (the same bits)
    for CPU tensors.  With ``dump`` also returns the masks that were drawn,
    in :func:`kernel_masks`' layout."""
    if h0.device.type == "cpu":
        return plain_fwd_prng(w, h0, tp, seed, rates=rates, dump=dump, tier=tier)
    out = _launch_fwd(w, h0, tp, _seeded(seed, rates), _inv_keep(rates), dump=dump, tier=tier)
    count_launch(stack_fwd_prng, tier)
    return out


def stack_bwd_prng(w: Weights, seed: torch.Tensor, st: Dict[str, torch.Tensor],
                   dd5: torch.Tensor, *, rates=None, tier: str = PARITY_TIER):
    """:func:`stack_bwd` regenerating the masks :func:`stack_fwd_prng` drew
    from the same ``seed``: one launch of the seeded backward kernel for CUDA
    tensors, :func:`plain_bwd_prng` for CPU tensors."""
    if dd5.device.type == "cpu":
        return plain_bwd_prng(w, seed, st, dd5, rates=rates, tier=tier)
    out = _launch_bwd(w, _seeded(seed, rates), st, dd5, _inv_keep(rates), tier=tier)
    count_launch(stack_bwd_prng, tier)
    return out


# launches / tier_launches[tier]: the parity build's and each tier build's
reset_counts(stack_fwd, stack_bwd, stack_fwd_prng, stack_bwd_prng)


class _TrainStack(torch.autograd.Function):
    """``d5 = stack(h0, tp, weights)`` with the kernel pair (or its plain
    versions) as forward and backward; gradients for ``h0``, ``tp`` and every
    stacked weight."""

    @staticmethod
    def forward(ctx, cfg, km, h0, tp, *stack):
        """``km``: the masks' dict, or the step seed (a tensor) of the seeded
        pair; ``cfg["pair"]``: the forward and the backward to run."""
        w = dict(cfg, **dict(zip(STACK_KEYS, stack)))
        d5, st = cfg["pair"][0](w, h0.contiguous(), tp.contiguous(), km)
        ctx.cfg, ctx.km = cfg, km
        # the stashes as saved tensors, so that torch.utils.checkpoint can
        # drop them and replay this forward in the backward
        ctx.save_for_backward(*stack, *[st[k] for k in STASH_KEYS])
        return d5

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dd5):
        saved = ctx.saved_tensors
        w = dict(ctx.cfg, **dict(zip(STACK_KEYS, saved)))
        st = dict(zip(STASH_KEYS, saved[len(STACK_KEYS):]))
        da0, dtp, ds = ctx.cfg["pair"][1](w, ctx.km, st, dd5.contiguous())
        grads = weight_grads(w, st, ds)
        return (None, None, da0, dtp, *[grads[k] for k in STACK_KEYS])


def build_train_stack(basis: np.ndarray, *, num_layers: int = 5, num_heads: int = 4,
                      hid_dim: int = 96, rates=None, dropout: str = "masks",
                      tier: str = PARITY_TIER, plain: bool = False):
    """Build ``stack_apply(weights, h0, tp, masks_or_seed) → d5``,
    differentiable through the kernel pair.

    ``dropout="masks"``: the fourth argument holds explicit masks;
    ``dropout="prng"``: it is the step seed, an ``int32[1]`` tensor on
    ``h0``'s device, and the seeded kernel pair draws the masks (the autograd
    node keeps the seed, no mask).  The function then also carries
    ``run_fwd_dump(w, h0, tp, seed) → (d5, stashes, masks)``.

    ``weights``: :func:`prepare_weights`' dict (made with
    ``differentiable=True`` for gradients to reach the module); ``h0``
    ``[B, N, H]``; ``tp`` ``[L, B, H]``; ``masks``: a ``DropoutMasks`` or
    :func:`kernel_masks`' dict.  ``rates`` overrides the dropout rates
    ``(p_attn_probs, p_sublayer, p_cheb)``.  ``tier``: the kernels'
    ``--kernel_precision`` (a one-pass tier launches its own build, on the
    weights rounded once a snapshot, :func:`rounded_stacks`; the gradients
    reach the float32 stacks).  ``plain``: the pair's plain versions on any
    device (:func:`plain_fwd` and its siblings), the plain train step's
    stack at a reduced tier.  The returned function carries ``run_fwd`` /
    ``run_bwd``, the pair it runs with these rates and tier.
    """
    if dropout not in ("masks", "prng"):
        raise ValueError(f"dropout must be 'masks' or 'prng', got {dropout!r}")
    check_tier(tier)
    prng = dropout == "prng"
    basis = np.asarray(basis, np.float32)
    rates = resolve_rates(rates)
    expect = (num_layers, num_heads, hid_dim)

    def stack_apply(w: Weights, h0, tp, masks):
        if (w["num_layers"], w["num_heads"], w["hid_dim"]) != expect:
            raise ValueError(f"weights are for (layers, heads, hid) "
                             f"{(w['num_layers'], w['num_heads'], w['hid_dim'])}, "
                             f"the stack was built for {expect}")
        if not np.array_equal(w["basis_host"], basis):
            raise ValueError("weights were prepared for another Chebyshev basis")
        if prng != isinstance(masks, torch.Tensor):
            raise ValueError(f"a stack built with dropout={dropout!r} takes "
                             f"{'a seed tensor' if prng else 'masks'}, got {type(masks).__name__}")
        km = kernel_masks(masks) if isinstance(masks, DropoutMasks) else masks
        if tier != PARITY_TIER and not plain:
            rounded_stacks(w, tier)
        cfg = {k: v for k, v in w.items() if k not in STACK_KEYS}
        cfg["pair"] = pair
        return _TrainStack.apply(cfg, km, h0, tp, *[w[k] for k in STACK_KEYS])

    if plain:
        fwd, bwd = (plain_fwd_prng, plain_bwd_prng) if prng else (plain_fwd, plain_bwd)
    else:
        fwd, bwd = (stack_fwd_prng, stack_bwd_prng) if prng else (stack_fwd, stack_bwd)
    pair = tuple(functools.partial(f, rates=rates, tier=tier) for f in (fwd, bwd))
    stack_apply.run_fwd, stack_apply.run_bwd = pair
    stack_apply.run_fwd_dump = (functools.partial(fwd, rates=rates, tier=tier, dump=True)
                                if prng else None)
    return stack_apply


def fused_train_forward(model, x: torch.Tensor, t: torch.Tensor, masks, stack_fn) -> torch.Tensor:
    """GCNDiff training forward ``ε̂(x [B, N, 5], t [B])`` with the fused
    stack, differentiable with respect to the module's parameters: the
    weight prep, the timestep MLP and the input and output ChebConv are
    plain PyTorch under autograd; the L layers run through ``stack_fn``
    (from :func:`build_train_stack`), which takes ``masks``: explicit masks
    or, built with ``dropout="prng"``, the step seed."""
    w = prepare_weights(model, device=x.device, differentiable=True)
    tp = timestep_projections(w, t)
    h0 = _cheb(x, w["win"], w["bin"], w["basis"])
    d5 = stack_fn(w, h0, tp, masks)
    return _cheb(d5, w["wout"], w["bout"], w["basis"])


def make_train_step(model, optimizer, betas, *, impl: str = "fused", ema_mu=0.999, device="cuda",
                    dropout: str = "masks", tier: str = PARITY_TIER):
    """The fused drop-in for the module train step: ``train.steps.make_train_step``
    with the kernel pair as the denoiser's forward and backward."""
    from diffpose_tpu_torch.train import steps  # steps imports this module

    return steps.make_train_step(model, optimizer, betas, impl=impl, ema_mu=ema_mu, device=device,
                                 dropout=dropout, tier=tier)
