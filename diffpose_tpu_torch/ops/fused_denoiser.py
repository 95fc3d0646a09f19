"""Whole-network GCNDiff / GCNPose eval forward as one hand-written CUDA kernel.

Replaces the TPU kernel ``diffpose_tpu/ops/pallas_denoiser.py:276
_net_kernel``, as built by ``make_pallas_denoiser_fn`` (GCNDiff, with the
per-layer timestep projections), ``make_pallas_lifter_fn`` (GCNPose) and
``make_pallas_backbone_fn`` (``has_io=False``: the bare layer stack of the
implicit model's fixed-point function, :func:`fused_backbone`).
The CUDA source is ``csrc/net_kernel.cuh`` (device code) and
``csrc/net_kernel.cu`` (launch).

Bound on the H100: operations.  One forward at hid 96 / 5 layers / 17
joints costs about 23 MFLOP per sample, 94% of it the channel products
(QKV, out-projection, fc1/fc2 and the residual Chebyshev products), against
about 22 input and output bytes per joint plus 2.6 MB of weights for the
whole batch: at B=1024 the products at the 495 TFLOP/s TF32 tensor-core
peak (three passes) and the rest at 67 TFLOP/s FP32 take 0.16 ms, while the
bytes take microseconds.

Design: one CTA of 384 threads (12 warps) takes a tile of 4 samples and
keeps their activations in shared memory through every layer, as the TPU
kernel keeps them in VMEM.  Every channel product runs on the tensor cores at 3xTF32
(``csrc/tc_gemm.cuh``, shared with the train kernels; the parity grade the
TPU reaches with bf16x3), its weights split into TF32 parts once here
(:func:`prepare_weights`) and streamed from L2 through a ``cp.async`` ring.
Attention computes each sample's 17x17 scores per head directly (no segment
matrices), with a max-subtracted softmax in f32; the all-ones mask is left
out.  The last tile masks its absent samples itself (no padding of the
batch).

Outside the kernel, as in the JAX wrapper: the weight prep
(:func:`prepare_weights`: stacking, the learned Laplacian of each layer,
1/√d_k folded into q's weights and bias) and the timestep MLP with its
per-layer projections ``tp [L, B, H]`` (:func:`timestep_projections`).

Each wrapper (:func:`fused_denoiser`, :func:`fused_lifter`,
:func:`fused_backbone`) launches the kernel for CUDA tensors and raises on
what the kernel does not take; for CPU tensors it runs the plain PyTorch
version of the same function (:func:`net_plain`, :func:`backbone_plain`),
which shares the weight prep and the folded-q arithmetic.
``wrapper.launches`` counts the kernel launches.

The bare stack does the same work as the whole network less the two
ChebConvs, again bound by the operations; its input and output are 96
wide, 13 MB in all at B=1024, microseconds of bandwidth.

The reduced tiers of ``--kernel_precision`` (``pallas_denoiser.py:_dot``
and ``act``): :func:`tier_weights` gives a snapshot for ``"bf16"`` or
``"default"`` (each product's weights rounded to the tier once, ``[L, K, N]``
under ``"<name>_1p"``; under bf16 every other weight but the learned
Laplacian rounded too, as the TPU wrappers cast them).  The wrappers
launch that tier's build of the kernel (``csrc/net_kernel_tiers.cu``, built
at the first use of a tier; a failed build or launch raises) and round
their inputs as the TPU wrappers cast them; on the CPU the plain versions
compute the same tier (``ops/tf32.py:tier_matmul``, rounded where the
kernel rounds).  ``wrapper.tier_launches[tier]`` counts those launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from diffpose_tpu_torch.graph import learned_adjacency_laplacian
from diffpose_tpu_torch.models.layers import timestep_embedding
from diffpose_tpu_torch.ops import _build
from diffpose_tpu_torch.ops.tf32 import (
    PARITY_TIER,
    TIER_CODES,
    check_tier,
    round_bf16,
    round_weight,
    split_tf32,
    tier_matmul,
)

Weights = Dict[str, Any]

# What the kernel is compiled for (csrc/net_kernel.cuh).
KERNEL_HID, KERNEL_HEADS, KERNEL_PTS, KERNEL_CHEB_TERMS = 96, 4, 17, 3
KERNEL_IO = {True: (5, 5), False: (2, 3)}  # has_temb -> (c_in, c_out)

# The channel products' weights [L, K, N], which the kernel takes split into
# their TF32 parts, [L, 2, K, N] under "<name>_tf32" (prepare_weights).
SPLIT_KEYS = ("wqkv", "wao", "wfc1", "wfc2", "wg1", "wg2")

# Weight tensors in the order of net_forward's arguments.
_KERNEL_WEIGHTS = (
    "win", "bin", "ln1s", "ln1b", "ln2s", "ln2b", "wqkv_tf32", "bqkv", "wao_tf32", "bao", "lap",
    "wfc1_tf32", "bfc1", "wfc2_tf32", "bfc2", "wg1_tf32", "bg1", "wg2_tf32", "bg2", "wout", "bout",
    "cheb_ptr", "cheb_idx", "cheb_val",
)
# Those of net_backbone's arguments: no input or output ChebConv.
_BACKBONE_WEIGHTS = tuple(k for k in _KERNEL_WEIGHTS if k not in ("win", "bin", "wout", "bout"))
# What the bf16 tier rounds besides the products' weights: everything the
# TPU wrappers cast to act but the learned Laplacian (pallas_denoiser.py:475);
# the input and output ChebConvs' only where they are inside the kernel.
_ENDS_ROUNDED = ("win", "bin", "wout", "bout")
_BF16_ROUNDED = ("ln1s", "ln1b", "ln2s", "ln2b", "wqkv", "bqkv", "wao", "bao",
                 "wfc1", "bfc1", "wfc2", "bfc2", "wg1", "bg1", "wg2", "bg2")


def kernel_names(names, tier: str) -> tuple:
    """``names`` as the kernel of ``tier`` takes them: the products' weights as
    TF32 parts (``"<k>_tf32"``) or rounded to a one-pass tier (``"<k>_1p"``)."""
    if tier == PARITY_TIER:
        return tuple(names)
    return tuple(k[:-len("_tf32")] + "_1p" if k.endswith("_tf32") else k for k in names)


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises if it is a CUDA device and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return device


def sparse_terms(basis: np.ndarray):
    """The Chebyshev stack ``[K+1, N, N]`` as a term list per output joint.

    Returns ``(ptr [N+1], idx [nnz], val [nnz])``: the terms of joint ``n``
    are ``ptr[n]..ptr[n+1]``, each ``T_k[n, m]`` with ``idx = (k << 8) | m``.
    Zeros are dropped, as ``pallas_cheb._sparse_terms`` drops them.
    """
    k1, n, _ = basis.shape
    ptr, idx, val = [0], [], []
    for j in range(n):
        for k in range(k1):
            for m in range(n):
                c = float(basis[k, j, m])
                if abs(c) > 1e-12:
                    idx.append((k << 8) | m)
                    val.append(c)
        ptr.append(len(idx))
    return (np.asarray(ptr, np.int32), np.asarray(idx, np.int32),
            np.asarray(val, np.float32))


def sparse_terms_transposed(basis: np.ndarray):
    """Term list of the transposed Chebyshev mixes, one list per (order k,
    output joint m): ``v_k[m] = Σ_j T_k[j, m] · dy[j]``, as the backward
    of a ChebConv needs them.

    Returns ``(ptr [K1·N + 1], idx [nnz], val [nnz])`` with the terms of
    ``(k, m)`` at ``ptr[k·N + m] .. ptr[k·N + m + 1]`` and ``idx = j``.
    """
    k1, n, _ = basis.shape
    ptr, idx, val = [0], [], []
    for k in range(k1):
        for m in range(n):
            for j in range(n):
                c = float(basis[k, j, m])
                if abs(c) > 1e-12:
                    idx.append(j)
                    val.append(c)
            ptr.append(len(idx))
    return (np.asarray(ptr, np.int32), np.asarray(idx, np.int32),
            np.asarray(val, np.float32))


@functools.lru_cache(maxsize=16)
def _graph_constants(basis_bytes: bytes, shape: tuple, device: torch.device) -> Dict[str, Any]:
    """What depends on the Chebyshev basis alone, on ``device``: the dense
    stack and both term lists.  Cached, so that preparing weights every
    train step uploads nothing; the tensors are shared and never written."""
    basis = np.frombuffer(basis_bytes, np.float32).reshape(shape)
    ptr, idx, val = sparse_terms(basis.astype(np.float64))
    tptr, tidx, tval = sparse_terms_transposed(basis.astype(np.float64))
    return dict(
        basis=torch.as_tensor(basis.copy(), device=device),
        basis_host=basis,
        cheb_ptr=torch.as_tensor(ptr, device=device),
        cheb_idx=torch.as_tensor(idx, device=device),
        cheb_val=torch.as_tensor(val, device=device),
        cheb_nnz=len(val),
        chebt_ptr=torch.as_tensor(tptr, device=device),
        chebt_idx=torch.as_tensor(tidx, device=device),
        chebt_val=torch.as_tensor(tval, device=device),
    )


def prepare_weights(model, device="cuda", *, differentiable: bool = False) -> Weights:
    """Stack a GCNDiff or GCNPose module's weights for the fused forward.

    The returned dict holds, on ``device``: per-layer stacks ``[L, ...]`` in
    ``[in, out]`` layout; each ChebConv's three weights side by side
    (``[in, 3·out]``); the learned Laplacian of each layer; QKV in one
    ``[H, 3H]`` matrix with 1/√d_k folded into q's weight and bias; the
    timestep MLP (denoiser only); the Chebyshev basis, dense and as a term
    list.  Also the configuration (``has_temb``, ``num_layers``, ...).

    By default the tensors are a detached snapshot (eval), and each channel
    product's stack ``SPLIT_KEYS`` is also given split into its TF32 parts,
    ``[L, 2, K, N]`` (``ops/tf32.py:split_tf32``: big, then small), once an
    evaluation, for the kernel (the plain versions read the f32 stacks).
    With ``differentiable=True`` (training; the module already lies on
    ``device``) the same arithmetic stays in the autograd graph, so that
    gradients of the stacks reach the module's parameters: ``A_hat``
    through the learned Laplacian, q's weight and bias through the fold;
    no split stacks are made.
    """
    device = resolve_device(device)
    has_temb = hasattr(model.gconv_layers[0], "temb_proj")
    num_layers, hid, heads = model.num_layers, model.hid_dim, model.num_heads
    att, res = model.atten_layers, model.gconv_layers

    def f32(t):
        if differentiable:
            return t.to(device=device, dtype=torch.float32)
        # a copy: the weights are a snapshot of the module
        return t.detach().to(device=device, dtype=torch.float32, copy=True)

    def stack(fn):
        return torch.stack([f32(fn(i)) for i in range(num_layers)]).contiguous()

    def cheb_cat(w):  # [K+1, 1, C, D] -> [C, (K+1)·D]: W_0 | W_1 | W_2
        return w[:, 0].permute(1, 0, 2).reshape(w.shape[2], -1)

    def lin(m):  # torch Linear [out, in] -> [in, out]
        return m.weight.t()

    with torch.enable_grad() if differentiable else torch.no_grad():
        w = dict(
            win=f32(cheb_cat(model.gconv_input.weight)).contiguous(),
            bin=f32(model.gconv_input.bias.reshape(-1)),
            ln1s=stack(lambda i: att[i].sublayer[0].norm.a_2),
            ln1b=stack(lambda i: att[i].sublayer[0].norm.b_2),
            ln2s=stack(lambda i: att[i].sublayer[1].norm.a_2),
            ln2b=stack(lambda i: att[i].sublayer[1].norm.b_2),
            wqkv=stack(lambda i: torch.cat(
                [lin(att[i].self_attn.linears[j]) for j in range(3)], dim=1)),
            bqkv=stack(lambda i: torch.cat(
                [att[i].self_attn.linears[j].bias for j in range(3)])),
            wao=stack(lambda i: lin(att[i].self_attn.linears[3])),
            bao=stack(lambda i: att[i].self_attn.linears[3].bias),
            lap=stack(lambda i: learned_adjacency_laplacian(f32(att[i].feed_forward.A_hat))),
            wfc1=stack(lambda i: lin(att[i].feed_forward.gconv1.fc)),
            bfc1=stack(lambda i: att[i].feed_forward.gconv1.fc.bias),
            wfc2=stack(lambda i: lin(att[i].feed_forward.gconv2.fc)),
            bfc2=stack(lambda i: att[i].feed_forward.gconv2.fc.bias),
            wg1=stack(lambda i: cheb_cat(res[i].gconv1.gconv.weight)),
            bg1=stack(lambda i: res[i].gconv1.gconv.bias.reshape(-1)),
            wg2=stack(lambda i: cheb_cat(res[i].gconv2.gconv.weight)),
            bg2=stack(lambda i: res[i].gconv2.gconv.bias.reshape(-1)),
            wout=f32(cheb_cat(model.gconv_output.weight)).contiguous(),
            bout=f32(model.gconv_output.bias.reshape(-1)),
        )
        # Fold the attention score scale into the q projection, weight AND
        # bias, as _weight_stacks does (pallas_denoiser.py:396-400).
        fold = torch.ones(3 * hid, device=device)
        fold[:hid] = 1.0 / math.sqrt(hid // heads)
        w["wqkv"] = w["wqkv"] * fold
        w["bqkv"] = w["bqkv"] * fold
        if not differentiable:
            for k in SPLIT_KEYS:
                w[f"{k}_tf32"] = torch.stack(split_tf32(w[k]), dim=1).contiguous()
        if has_temb:
            dense = model.temb.dense
            w.update(
                t0k=f32(lin(dense[0])).contiguous(), t0b=f32(dense[0].bias),
                t1k=f32(lin(dense[1])).contiguous(), t1b=f32(dense[1].bias),
                wtp=stack(lambda i: lin(res[i].temb_proj)),
                btp=stack(lambda i: res[i].temb_proj.bias),
            )

    basis = model.gconv_input.basis.detach().cpu().numpy().astype(np.float32)
    w.update(_graph_constants(basis.tobytes(), basis.shape, device))
    w.update(
        has_temb=has_temb,
        num_layers=num_layers,
        num_heads=heads,
        hid_dim=hid,
        n_pts=basis.shape[1],
        c_in=model.gconv_input.weight.shape[2],
        c_out=model.gconv_output.weight.shape[3],
    )
    return w


def tier_of(w: Weights) -> str:
    """The kernel tier a weight snapshot was made for (prepare_weights: the
    parity grade, ``"bf16x3"``)."""
    return w.get("tier", PARITY_TIER)


def tier_weights(w: Weights, tier: str, split_keys=SPLIT_KEYS, rounded=_BF16_ROUNDED, *,
                 ends: bool = True) -> Weights:
    """An eval snapshot ``w`` (parity grade) at kernel tier ``tier``: each
    product's stack of ``split_keys`` rounded to the tier once,
    ``"<k>_1p"`` (the one-pass kernels' weights, ``[L, K, N]``); under
    ``"bf16"`` also every weight of ``rounded`` (the TPU wrappers' cast to
    bf16: all but the learned Laplacian and what stays outside the kernel)
    and, with ``ends``, the input and output ChebConvs' (rows 1-2 hold them;
    ``ends=False`` for the bare stack, whose callers run them in f32 outside).
    ``"bf16x3"`` gives ``w``."""
    check_tier(tier)
    if tier_of(w) != PARITY_TIER:
        raise ValueError(f"tier_weights takes parity-grade weights, got tier {tier_of(w)!r}")
    if tier == PARITY_TIER:
        return w
    missing = [k for k in split_keys if f"{k}_tf32" not in w]
    if missing:
        raise ValueError(f"tier_weights takes an eval snapshot (prepare_weights(..., "
                         f"differentiable=False)); these weights have no TF32 parts of {missing}")
    out = {k: v for k, v in w.items() if not k.endswith("_tf32")}
    with torch.no_grad():
        if tier == "bf16":
            keys = (*rounded, *_ENDS_ROUNDED) if ends else rounded
            out.update({k: round_bf16(w[k]) for k in keys if k in w})
        out.update({f"{k}_1p": round_weight(tier, out[k]) for k in split_keys})
    out["tier"] = tier
    return out


def at_tier(w: Weights, tier: Optional[str], *, ends: bool = True) -> Weights:
    """``w`` for a wrapper called with ``tier=``: ``None`` or ``w``'s own tier
    gives ``w``; parity weights are rounded to the tier here, at every call
    (prepare them once with :func:`tier_weights` instead)."""
    if tier is None or tier == tier_of(w):
        return w
    if tier_of(w) != PARITY_TIER:
        raise ValueError(f"weights prepared for tier {tier_of(w)!r} called at tier {tier!r}")
    return tier_weights(w, tier, ends=ends)


def round_inputs(tier: str, *xs):
    """The inputs of a kernel as the TPU wrappers cast them: to bf16 under the
    bf16 tier (``x.astype(act)``), unchanged otherwise; ``None`` stays."""
    if tier != "bf16":
        return xs
    return tuple(None if x is None else round_bf16(x) for x in xs)


def timestep_projections(w: Weights, t: torch.Tensor) -> torch.Tensor:
    """Timestep MLP and every layer's projection of it: ``[L, B, H]``."""
    temb = timestep_embedding(t, w["hid_dim"])
    temb = F.silu(temb @ w["t0k"] + w["t0b"]) @ w["t1k"] + w["t1b"]
    return (torch.matmul(F.silu(temb), w["wtp"]) + w["btp"][:, None, :]).contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _cheb(z, wcat, bias, basis, mm=torch.matmul):
    """``Σ_k T_k·(z @ W_k) + b`` from the side-by-side weights ``[C, (K+1)·D]``,
    the channel product ``z @ W`` through ``mm``."""
    u = mm(z, wcat).unflatten(-1, (basis.shape[0], -1))  # [B, N, K+1, D]
    return torch.einsum("knm,bmkd->bnd", basis, u) + bias


def _layer_norm(z, scale, shift):
    mean = z.mean(dim=-1, keepdim=True)
    c = z - mean
    var = (c * c).sum(dim=-1, keepdim=True) / (z.shape[-1] - 1)
    return scale * c / (torch.sqrt(var) + 1e-6) + shift


def net_plain(w: Weights, x: torch.Tensor, tp: Optional[torch.Tensor] = None, *,
              matmul=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``x [B, N, C_in]`` (and
    ``tp [L, B, H]`` for the denoiser) → ``[B, N, C_out]``, at ``w``'s tier
    (:func:`tier_of`).  ``matmul`` computes the stack's channel products
    (default: the tier's, ``ops/tf32.py:tier_matmul``;
    ``ops/tf32.py:matmul_3xtf32`` gives the parity kernel's tensor-core
    products); the input and output ChebConvs are f32, as in the kernel, on
    the tier's weights and inputs (bf16: rounded, and the input ChebConv's
    output rounded)."""
    tier, basis = tier_of(w), w["basis"]
    x, tp = round_inputs(tier, x, tp)
    h = round_inputs(tier, _cheb(x, w["win"], w["bin"], basis))[0]
    h = _layers_plain(w, h, tp, matmul or tier_matmul(tier), tier)
    return _cheb(h, w["wout"], w["bout"], basis)


def backbone_plain(w: Weights, z: torch.Tensor, tp: torch.Tensor, *,
                   matmul=None) -> torch.Tensor:
    """The bare layer stack in plain PyTorch: ``z [B, N, H]``, ``tp [L, B, H]``
    → ``[B, N, H]`` (:func:`net_plain` without its two ChebConvs)."""
    tier = tier_of(w)
    z, tp = round_inputs(tier, z, tp)
    return _layers_plain(w, z, tp, matmul or tier_matmul(tier), tier)


def _layers_plain(w: Weights, h: torch.Tensor, tp: Optional[torch.Tensor],
                  mm=torch.matmul, tier: str = PARITY_TIER) -> torch.Tensor:
    """The stack at ``tier``: under bf16 the activations rounded where the
    kernel rounds them (``csrc/net_kernel.cuh``: QKV, each score's products,
    the probabilities, the residual stream after each sublayer)."""
    hid, heads = w["hid_dim"], w["num_heads"]
    bsz, n = h.shape[:2]
    basis = w["basis"]
    bf16 = tier == "bf16"

    def act(z):   # the TPU kernel's .astype(act)
        return round_bf16(z) if bf16 else z

    for l in range(w["num_layers"]):
        y = _layer_norm(h, w["ln1s"][l], w["ln1b"][l])
        qkv = act(mm(y, w["wqkv"][l]) + w["bqkv"][l])
        q, k, v = (z.reshape(bsz, n, heads, -1).transpose(1, 2) for z in qkv.split(hid, dim=-1))
        if bf16:   # each product q_d k_d rounded, as the segment product of bf16 operands
            s = round_bf16(q.unsqueeze(-2) * k.unsqueeze(-3)).sum(dim=-1)
        else:
            s = q @ k.transpose(-1, -2)                          # q holds 1/√d_k
        probs = act(torch.softmax(s, dim=-1))
        att = (probs @ v).transpose(1, 2).reshape(bsz, n, hid)
        h = act(h + (mm(att, w["wao"][l]) + w["bao"][l]))

        lap = w["lap"][l]
        y = _layer_norm(h, w["ln2s"][l], w["ln2b"][l])
        y = F.relu(mm(lap @ y, w["wfc1"][l]) + w["bfc1"][l])
        h = act(h + (mm(lap @ y, w["wfc2"][l]) + w["bfc2"][l]))

        u = F.relu(_cheb(h, w["wg1"][l], w["bg1"][l], basis, mm))
        if tp is not None:
            u = u + tp[l][:, None, :]
        h = act(h + F.relu(_cheb(u, w["wg2"][l], w["bg2"][l], basis, mm)))
    return h


def denoiser_plain(w: Weights, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return net_plain(w, x, timestep_projections(w, t))


def lifter_plain(w: Weights, x: torch.Tensor) -> torch.Tensor:
    return net_plain(w, x, None)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return bind(_build.load("net_kernel"))


@functools.lru_cache(maxsize=None)
def _tier_library() -> ctypes.CDLL:
    """The one-pass tiers' build (``csrc/net_kernel_tiers.cu``), at first use."""
    return bind_tiers(_build.load("net_kernel_tiers"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/net_kernel.cu``) with its entries typed."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.net_forward.argtypes = [i32] * 9 + [ptr] * (3 + len(_KERNEL_WEIGHTS)) + [i32, ptr]
    lib.net_forward.restype = i32
    lib.net_backbone.argtypes = [i32] * 6 + [ptr] * (3 + len(_BACKBONE_WEIGHTS)) + [i32, ptr]
    lib.net_backbone.restype = i32
    lib.net_error_string.argtypes = [i32]
    lib.net_error_string.restype = ctypes.c_char_p
    return lib


def bind_tiers(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/net_kernel_tiers.cu``) with its entries typed:
    ``bind``'s, after a leading tier code."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.net_forward_tier.argtypes = [i32] * 10 + [ptr] * (3 + len(_KERNEL_WEIGHTS)) + [i32, ptr]
    lib.net_forward_tier.restype = i32
    lib.net_backbone_tier.argtypes = [i32] * 7 + [ptr] * (3 + len(_BACKBONE_WEIGHTS)) + [i32, ptr]
    lib.net_backbone_tier.restype = i32
    lib.net_tier_error_string.argtypes = [i32]
    lib.net_tier_error_string.restype = ctypes.c_char_p
    return lib


def _expected_shapes(w: Weights) -> Dict[str, tuple]:
    L, H, n, k1 = w["num_layers"], w["hid_dim"], w["n_pts"], KERNEL_CHEB_TERMS
    shapes = dict(
        win=(w["c_in"], k1 * H), bin=(H,), ln1s=(L, H), ln1b=(L, H), ln2s=(L, H), ln2b=(L, H),
        wqkv=(L, H, 3 * H), bqkv=(L, 3 * H), wao=(L, H, H), bao=(L, H), lap=(L, n, n),
        wfc1=(L, H, 2 * H), bfc1=(L, 2 * H), wfc2=(L, 2 * H, H), bfc2=(L, H),
        wg1=(L, H, k1 * H), bg1=(L, H), wg2=(L, H, k1 * H), bg2=(L, H),
        wout=(H, k1 * w["c_out"]), bout=(w["c_out"],),
        cheb_ptr=(n + 1,), cheb_idx=(w["cheb_nnz"],), cheb_val=(w["cheb_nnz"],),
    )
    shapes.update({f"{k}_tf32": (L, 2) + shapes[k][1:] for k in SPLIT_KEYS})
    shapes.update({f"{k}_1p": shapes[k] for k in SPLIT_KEYS})
    return shapes


def _check_tensor(name: str, t: torch.Tensor, shape: tuple, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_launch(w: Weights, x: torch.Tensor, tp: Optional[torch.Tensor], c_in: int,
                  names) -> None:
    """The checks shared by both entries of the kernel."""
    cfg = (w["hid_dim"], w["num_heads"], w["n_pts"])
    if cfg != (KERNEL_HID, KERNEL_HEADS, KERNEL_PTS):
        raise ValueError(f"the kernel is built for hid/heads/joints "
                         f"{(KERNEL_HID, KERNEL_HEADS, KERNEL_PTS)}, got {cfg}")
    if w["basis"].shape[0] != KERNEL_CHEB_TERMS:
        raise ValueError(f"the kernel takes a Chebyshev basis of {KERNEL_CHEB_TERMS} terms")
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {x.device}")
    bsz, L, H, n = x.shape[0], w["num_layers"], w["hid_dim"], w["n_pts"]
    dev = x.device
    _check_tensor("x", x, (bsz, n, c_in), torch.float32, dev)
    if tp is not None:
        _check_tensor("tp", tp, (L, bsz, H), torch.float32, dev)
    shapes = _expected_shapes(w)
    missing = [name for name in names if name not in w]
    if missing:
        raise ValueError(f"the kernel takes the TF32 parts (at a reduced tier its rounded weights, "
                         f"tier_weights) {missing} of prepare_weights(..., differentiable=False); "
                         f"these weights have none")
    for name in names:
        dtype = torch.int32 if name in ("cheb_ptr", "cheb_idx") else torch.float32
        _check_tensor(name, w[name], shapes[name], dtype, dev)


def _raise_on(code: int, what: str, tier: str = PARITY_TIER):
    if code != 0:
        text = (_library().net_error_string(code) if tier == PARITY_TIER
                else _tier_library().net_tier_error_string(code))
        raise RuntimeError(f"{what} kernel (tier {tier}): {text.decode()} (cudaError {code})")


def _launch(w: Weights, x: torch.Tensor, tp: Optional[torch.Tensor]) -> torch.Tensor:
    """One launch of the CUDA kernel; every input is checked first."""
    if (w["c_in"], w["c_out"]) != KERNEL_IO[w["has_temb"]]:
        raise ValueError(f"the kernel takes (c_in, c_out) {KERNEL_IO[w['has_temb']]} "
                         f"for has_temb={w['has_temb']}, got {(w['c_in'], w['c_out'])}")
    if w["has_temb"] and tp is None:
        raise ValueError("the denoiser's kernel takes the timestep projections tp")
    tier = tier_of(w)
    names = kernel_names(_KERNEL_WEIGHTS, tier)
    x, tp = round_inputs(tier, x, tp if w["has_temb"] else None)
    _check_launch(w, x, tp, w["c_in"], names)
    bsz, dev = x.shape[0], x.device
    out = torch.empty((bsz, w["n_pts"], w["c_out"]), dtype=torch.float32, device=dev)
    if bsz == 0:
        return out
    args = (dev.index, int(w["has_temb"]), w["c_in"], w["c_out"], w["hid_dim"], w["num_heads"],
            w["n_pts"], bsz, w["num_layers"],
            x.data_ptr(), tp.data_ptr() if tp is not None else None, out.data_ptr(),
            *[w[k].data_ptr() for k in names], w["cheb_nnz"],
            torch.cuda.current_stream(dev).cuda_stream)
    if tier == PARITY_TIER:
        code = _library().net_forward(*args)
    else:
        code = _tier_library().net_forward_tier(TIER_CODES[tier], *args)
    _raise_on(code, "net_forward", tier)
    return out


def _launch_backbone(w: Weights, z: torch.Tensor, tp: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel's bare-stack build; every input is checked first."""
    if tp is None:
        raise ValueError("the bare stack takes the timestep projections tp")
    tier = tier_of(w)
    names = kernel_names(_BACKBONE_WEIGHTS, tier)
    z, tp = round_inputs(tier, z, tp)
    _check_launch(w, z, tp, w["hid_dim"], names)
    bsz, dev = z.shape[0], z.device
    out = torch.empty_like(z)
    if bsz == 0:
        return out
    args = (dev.index, w["hid_dim"], w["num_heads"], w["n_pts"], bsz, w["num_layers"],
            z.data_ptr(), tp.data_ptr(), out.data_ptr(),
            *[w[k].data_ptr() for k in names], w["cheb_nnz"],
            torch.cuda.current_stream(dev).cuda_stream)
    if tier == PARITY_TIER:
        code = _library().net_backbone(*args)
    else:
        code = _tier_library().net_backbone_tier(TIER_CODES[tier], *args)
    _raise_on(code, "net_backbone", tier)
    return out


def count_launch(wrapper, tier: str):
    """One launch of ``wrapper``'s kernel at ``tier``: ``wrapper.launches``
    counts the parity build's, ``wrapper.tier_launches[tier]`` the others'."""
    if tier == PARITY_TIER:
        wrapper.launches += 1
    else:
        wrapper.tier_launches[tier] += 1


def reset_counts(*wrappers):
    for fn in wrappers:
        fn.launches = 0
        fn.tier_launches = {t: 0 for t in TIER_CODES}


def fused_denoiser(w: Weights, x: torch.Tensor, t: torch.Tensor, *,
                   tier: Optional[str] = None) -> torch.Tensor:
    """GCNDiff eval forward ``ε̂(x [B, 17, 5], t [B]) → [B, 17, 5]``: one kernel
    launch for CUDA tensors, the plain version for CPU tensors; at ``w``'s
    tier, or at ``tier`` (:func:`at_tier`)."""
    if not w["has_temb"]:
        raise ValueError("fused_denoiser takes GCNDiff weights (with timestep projections)")
    w = at_tier(w, tier)
    if x.device.type == "cpu":
        return denoiser_plain(w, x, t)
    out = _launch(w, x, timestep_projections(w, t))
    count_launch(fused_denoiser, tier_of(w))
    return out


def fused_lifter(w: Weights, x: torch.Tensor, *, tier: Optional[str] = None) -> torch.Tensor:
    """GCNPose eval forward ``[B, 17, 2] → [B, 17, 3]``: one kernel launch for
    CUDA tensors, the plain version for CPU tensors; the tier as
    :func:`fused_denoiser`'s."""
    if w["has_temb"]:
        raise ValueError("fused_lifter takes GCNPose weights (no timestep projections)")
    w = at_tier(w, tier)
    if x.device.type == "cpu":
        return lifter_plain(w, x)
    out = _launch(w, x, None)
    count_launch(fused_lifter, tier_of(w))
    return out


def fused_backbone(w: Weights, z: torch.Tensor, tp: torch.Tensor, *,
                   tier: Optional[str] = None) -> torch.Tensor:
    """The bare layer stack ``z [B, 17, 96], tp [L, B, 96] → [B, 17, 96]``
    (the implicit model's fixed-point body; GCNDiff or IGCN weights): one
    kernel launch for CUDA tensors, the plain version for CPU tensors; the
    tier as :func:`fused_denoiser`'s."""
    if not w["has_temb"]:
        raise ValueError("fused_backbone takes weights with timestep projections")
    w = at_tier(w, tier)
    if z.device.type == "cpu":
        return backbone_plain(w, z, tp)
    out = _launch_backbone(w, z, tp)
    count_launch(fused_backbone, tier_of(w))
    return out


reset_counts(fused_denoiser, fused_lifter, fused_backbone)
