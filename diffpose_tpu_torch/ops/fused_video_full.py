"""The video denoiser's layer kernels: one TemporalBlock (kernel row 10) and one
whole spatio-temporal layer (row 9), hand-written in CUDA.

Replaces the TPU kernels ``diffpose_tpu/ops/pallas_video_full.py:329
_temporal_only_kernel`` (built by ``make_pallas_temporal_layer_fn:346``)
and ``:148 _st_kernel`` (built by ``make_pallas_video_full_fn:183``).  The
CUDA source is ``csrc/video_kernel.cuh`` (device code; the spatial phase
reuses ``csrc/net_kernel.cuh``'s layer, every channel product
``csrc/tc_gemm.cuh``) and ``csrc/video_kernel.cu`` (launch).

* :func:`fused_temporal_layer` (row 10): ``ht [N, F, 96] → [N, F, 96]``,
  N = windows × joints.  Bound: operations.  A frame vector costs 8·96²
  multiply-adds of channel products (QKV, out-projection, feed-forward) and
  2·F·96 of attention products; at 16 windows of 81 frames (22,032
  vectors) 3.25 GFLOP of channel products and 0.69 of attention, about
  0.024 ms at the 495 TFLOP/s TF32 tensor-core peak, three passes, against
  17 MB of activations in and out (0.005 ms at 3.35 TB/s).
* :func:`fused_st_layer` (row 9): ``h [B, F, 17, 96] → [B, F, 17, 96]``, the
  spatial block of every frame (row 3's layer over tiles of 4 frames) and
  then the temporal block of every (window, joint).  Bound: operations,
  row 3's layer at B·F frames plus row 10.

Design (both kernels; ``csrc/video_kernel.cuh`` has the details).  Every
LayerNorm, product, bias, ReLU and residual of the TemporalBlock acts on one
frame vector; only the attention needs a (window, joint) row.  So the block
runs as three phases over work items that fill the card, one cooperative
launch of as many CTAs as can be co-resident (an error, and nothing runs,
where none can), a grid-wide barrier between phases: T1, LN1 and
Q|K|V over tiles of 68 frame vectors into a global scratch (in row 9 on the
spatial phase's tile while it is still in shared memory); T2, the attention,
one warp a task of 16 queries of one (row, head), K and V streamed through
the warp's shared memory by ``cp.async``, both products on ``mma.sync`` at
3xTF32, an online softmax over chunks of :data:`KERNEL_KEYS` keys; T3, the
out-projection, LN2 and the feed-forward over tiles of 68 vectors.  Every
channel product runs through ``tc_gemm`` on weights split into TF32 parts
once here (:func:`prepare_video_weights`).  The earlier design (one CTA a
row, CUDA-core products, 36-frame tiles) left most SMs idle at the
published shapes and recomputed work.

Outside the kernels, as in the JAX wrappers: the weight prep (one
``prepare_weights`` over every spatial block, sliced per layer by
:func:`layer_weights`; :func:`temporal_weight_stacks` with 1/√d_k folded
into q), the timestep MLP and per-layer projections repeated over the
frames (:func:`spatial_projections`), the input ChebConv with the
positional embedding and the output ChebConv (:func:`make_video_full_fn`).

On CPU tensors the wrappers run the plain versions (:func:`temporal_layer_plain`,
:func:`st_layer_plain`); on CUDA tensors they launch the kernel or raise.
Given ``matmul=ops/tf32.py:matmul_3xtf32``, the plain versions compute the
kernels' arithmetic: the products at 3xTF32, the attention in the kernels'
order (:func:`window_attention`).  ``fused_temporal_layer.launches`` and
``fused_st_layer.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from types import SimpleNamespace
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from diffpose_tpu_torch.models.layers import chunked_attention
from diffpose_tpu_torch.ops import _build
from diffpose_tpu_torch.ops.fused_denoiser import (
    _BACKBONE_WEIGHTS,
    KERNEL_HEADS,
    KERNEL_HID,
    SPLIT_KEYS,
    _check_launch,
    _check_tensor,
    _cheb,
    _layer_norm,
    backbone_plain,
    prepare_weights,
    resolve_device,
    timestep_projections,
)
from diffpose_tpu_torch.ops.tf32 import split_tf32
from diffpose_tpu_torch.parallel.context import gather_frames

Weights = Dict[str, Any]

# Temporal weight stacks (pallas_video_full.py:_T_ORDER).
T_KEYS = ("tln1s", "tln1b", "tln2s", "tln2b", "twqkv", "tbqkv", "twao", "tbao",
          "tff1", "tbff1", "tff2", "tbff2")
# The channel products' stacks [L, K, N], which the kernels take split into
# their TF32 parts, [L, 2, K, N] under "<name>_tf32" (prepare_video_weights).
T_SPLIT_KEYS = ("twqkv", "twao", "tff1", "tff2")
# What the kernels take, in the order of their arguments.
_T_KERNEL = tuple(f"{k}_tf32" if k in T_SPLIT_KEYS else k for k in T_KEYS)
# Keys a chunk of the kernels' attention (csrc/video_kernel.cuh: KEYS).
KERNEL_KEYS = 32


# prepare_weights' per-layer stacks (leading dimension L), and its tensors
# that only the network's ends read: the I/O ChebConvs and the timestep MLP.
_LAYER_STACKS = ("ln1s", "ln1b", "ln2s", "ln2b", "wqkv", "bqkv", "wao", "bao", "lap", "wfc1",
                 "bfc1", "wfc2", "bfc2", "wg1", "bg1", "wg2", "bg2", "wtp", "btp")
_SPLIT_STACKS = tuple(f"{k}_tf32" for k in SPLIT_KEYS)     # eval weights only
_ENDS = ("win", "bin", "wout", "bout", "t0k", "t0b", "t1k", "t1b")


class SpatialBlocks:
    """What ``prepare_weights`` reads of a GCNDiff, for the spatial blocks of a
    ``SpatioTemporalDiff``: every layer's GraAttenLayer and ResChebGCDiff, the
    I/O ChebConvs and the timestep MLP.  The Chebyshev basis is copied to the
    host once, here, so that preparing the weights never waits on the device."""

    def __init__(self, model):
        layers = range(model.num_layers)
        self.atten_layers = [model.layer(i)[0] for i in layers]
        self.gconv_layers = [model.layer(i)[1] for i in layers]
        self.num_layers, self.hid_dim, self.num_heads = len(layers), model.hid_dim, model.num_heads
        cin = model.gconv_input
        self.gconv_input = SimpleNamespace(weight=cin.weight, bias=cin.bias,
                                           basis=cin.basis.detach().cpu())
        self.gconv_output = model.gconv_output
        self.temb = SimpleNamespace(dense=[model.temb_dense_0, model.temb_dense_1])


def layer_weights(sw: Weights) -> List[Weights]:
    """Each layer of ``prepare_weights(SpatialBlocks(model))`` (every spatial
    block at once: ``[L, ...]`` stacks, the I/O ChebConvs, the timestep MLP)
    as a one-layer bare stack, row 3's and the train pair's weight set: its
    slice of every stack, the graph constants and the configuration, none of
    the network's ends."""
    stacks = _LAYER_STACKS + tuple(k for k in _SPLIT_STACKS if k in sw)
    shared = {k: v for k, v in sw.items() if k not in stacks + _ENDS}

    def one(i):
        w = {k: sw[k][i:i + 1] for k in stacks}
        w["lap"] = w["lap"].clone()       # a 17×17 slice is not 16-byte aligned
        return {**w, **shared, "num_layers": 1}

    return [one(i) for i in range(sw["num_layers"])]


def temporal_weight_stacks(model, device="cuda", *, differentiable: bool = False) -> Weights:
    """The temporal blocks' weights stacked over layers (``[L, ...]``, dense
    weights ``[in, out]``), QKV side by side with 1/√d_k folded into q's
    weight and bias (``pallas_video_full.py:78-111``)."""
    device = resolve_device(device)
    blocks = [model.layer(i)[2] for i in range(model.num_layers)]
    hid, heads = model.hid_dim, model.num_heads

    def f32(t):
        if differentiable:
            return t.to(device=device, dtype=torch.float32)
        return t.detach().to(device=device, dtype=torch.float32, copy=True)

    def stack(fn):
        return torch.stack([f32(fn(b)) for b in blocks]).contiguous()

    with torch.enable_grad() if differentiable else torch.no_grad():
        a = lambda b: b.attn  # noqa: E731
        tw = dict(
            tln1s=stack(lambda b: b.norm1.a_2), tln1b=stack(lambda b: b.norm1.b_2),
            tln2s=stack(lambda b: b.norm2.a_2), tln2b=stack(lambda b: b.norm2.b_2),
            twqkv=stack(lambda b: torch.cat([a(b).q.weight.t(), a(b).k.weight.t(),
                                             a(b).v.weight.t()], dim=1)),
            tbqkv=stack(lambda b: torch.cat([a(b).q.bias, a(b).k.bias, a(b).v.bias])),
            twao=stack(lambda b: a(b).out.weight.t()), tbao=stack(lambda b: a(b).out.bias),
            tff1=stack(lambda b: b.ff1.weight.t()), tbff1=stack(lambda b: b.ff1.bias),
            tff2=stack(lambda b: b.ff2.weight.t()), tbff2=stack(lambda b: b.ff2.bias),
        )
        fold = torch.ones(3 * hid, device=device)
        fold[:hid] = 1.0 / math.sqrt(hid // heads)
        tw["twqkv"] = (tw["twqkv"] * fold).contiguous()
        tw["tbqkv"] = (tw["tbqkv"] * fold).contiguous()
    tw.update(num_layers=model.num_layers, num_heads=heads, hid_dim=hid)
    return tw


@torch.no_grad()
def prepare_video_weights(model, device="cuda") -> Weights:
    """A snapshot of a ``SpatioTemporalDiff``'s weights for the fused eval
    forwards: ``spatial`` (``prepare_weights`` of :class:`SpatialBlocks`), ``layers``
    (:func:`layer_weights`), ``temporal`` (:func:`temporal_weight_stacks`,
    with each stack of ``T_SPLIT_KEYS`` also split into its TF32 parts,
    ``[L, 2, K, N]``, once an evaluation, for the kernels), ``pos``
    (``[F, H]``)."""
    device = resolve_device(device)
    sw = prepare_weights(SpatialBlocks(model), device)
    tw = temporal_weight_stacks(model, device)
    tw.update({f"{k}_tf32": torch.stack(split_tf32(tw[k]), dim=1).contiguous()
               for k in T_SPLIT_KEYS})
    return dict(spatial=sw, layers=layer_weights(sw), temporal=tw,
                pos=model.pos_embed.detach().to(device=device, dtype=torch.float32, copy=True))


def spatial_projections(sw: Weights, t: torch.Tensor, frames: int) -> List[torch.Tensor]:
    """The timestep MLP once, then each layer's projection of ``swish(temb)``
    repeated over the window's frames: ``[1, B·F, H]`` per layer."""
    return list(timestep_projections(sw, t).repeat_interleave(frames, dim=1).split(1))


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     matmul=torch.matmul) -> torch.Tensor:
    """``softmax(q kᵀ) v`` over ``[..., F, d_k]`` (q carries the scale) in the
    kernels' order (``csrc/video_kernel.cuh``, T2): the keys in chunks of
    :data:`KERNEL_KEYS`; a chunk's scores, its row max carried from the
    chunks before (an online softmax: the running sum and output rescaled
    by ``exp(m_old − m_new)``), ``exp(s − m)`` times its values with the
    keys padded by zeros to whole tiles of 8 (the padded keys masked out of
    the max and the sum); the output divided by the row sum at the end.
    Both products through ``matmul``."""
    f = k.shape[-2]
    m = l = o = None
    for c0 in range(0, f, KERNEL_KEYS):
        kc, vc = k[..., c0:c0 + KERNEL_KEYS, :], v[..., c0:c0 + KERNEL_KEYS, :]
        pad = -kc.shape[-2] % 8
        s = matmul(q, kc.transpose(-1, -2))
        mn = s.amax(dim=-1, keepdim=True)
        if m is not None:
            mn = torch.maximum(m, mn)
        p = torch.exp(s - mn)
        pv = matmul(F.pad(p, (0, pad)), F.pad(vc, (0, 0, 0, pad)))
        if m is None:
            l, o = p.sum(dim=-1, keepdim=True), pv
        else:
            a = torch.exp(m - mn)
            l, o = l * a + p.sum(dim=-1, keepdim=True), o * a + pv
        m = mn
    return o / l


def temporal_layer_plain(tw: Weights, ht: torch.Tensor, layer: int, *,
                         attention_chunk: int = 0, matmul=None, context=None) -> torch.Tensor:
    """One eval-mode TemporalBlock on ``ht [N, F, H]`` from the stacks
    (q carries 1/√d_k), the function of row 10.  ``matmul=None``: f32, the
    module's arithmetic; ``attention_chunk > 0``: at or above that many
    (gathered) key frames the attention goes through :func:`chunked_attention`,
    as the module's does.  ``matmul`` given (``ops/tf32.py:matmul_3xtf32`` for the
    kernels' tensor cores): the four channel products through it and the
    attention as :func:`window_attention` computes it with it.  ``context``
    (a ``MeshAxis``): ``ht`` holds this rank's frames of each window, and the
    keys and values of the whole window are gathered over the axis
    (``parallel/context.py:gather_frames``)."""
    l, heads = layer, tw["num_heads"]
    n, f, hid = ht.shape
    mm = torch.matmul if matmul is None else matmul

    def split(z):
        return z.reshape(n, z.shape[1], heads, -1).transpose(1, 2)

    y = _layer_norm(ht, tw["tln1s"][l], tw["tln1b"][l])
    qkv = mm(y, tw["twqkv"][l]) + tw["tbqkv"][l]
    kv = gather_frames(qkv[..., hid:], context)    # keys and values side by side: one gather
    q, k, v = split(qkv[..., :hid]), *(split(z) for z in kv.split(hid, dim=-1))
    if matmul is not None:
        att = window_attention(q, k, v, matmul)
    elif attention_chunk > 0 and k.shape[2] >= attention_chunk:
        att = chunked_attention(q, k, v, chunk_size=attention_chunk, scale=1.0)
    else:
        att = torch.softmax(q @ k.transpose(-1, -2), dim=-1) @ v
    x = ht + (mm(att.transpose(1, 2).reshape(n, f, hid), tw["twao"][l]) + tw["tbao"][l])
    y = F.relu(mm(_layer_norm(x, tw["tln2s"][l], tw["tln2b"][l]), tw["tff1"][l]) + tw["tbff1"][l])
    return x + (mm(y, tw["tff2"][l]) + tw["tbff2"][l])


def to_rows(h: torch.Tensor) -> torch.Tensor:
    """``[B, F, J, H]`` → the temporal blocks' ``[B·J, F, H]`` rows."""
    b, f, j, hid = h.shape
    return h.transpose(1, 2).reshape(b * j, f, hid)


def from_rows(ht: torch.Tensor, b: int) -> torch.Tensor:
    """The inverse of :func:`to_rows`."""
    n, f, hid = ht.shape
    return ht.reshape(b, n // b, f, hid).transpose(1, 2)


def st_layer_plain(lw: List[Weights], tw: Weights, h: torch.Tensor, tp: torch.Tensor,
                   layer: int, *, matmul=None) -> torch.Tensor:
    """One video layer, the function of row 9: ``backbone_plain`` with layer
    ``layer``'s one-layer spatial weights (of :func:`layer_weights`) on the
    ``B·F`` frames, then :func:`temporal_layer_plain` on the ``B·J`` rows;
    ``matmul`` as there (the spatial channel products through it too)."""
    b, f, j, hid = h.shape
    hs = backbone_plain(lw[layer], h.reshape(b * f, j, hid), tp,
                        matmul=torch.matmul if matmul is None else matmul).reshape(b, f, j, hid)
    return from_rows(temporal_layer_plain(tw, to_rows(hs), layer, matmul=matmul), b)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return bind(_build.load("video_kernel"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the entries of a build of ``csrc/video_kernel.cu``."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.temporal_forward.argtypes = [i32] * 3 + [ptr] * (4 + len(_T_KERNEL)) + [ptr]
    lib.temporal_forward.restype = i32
    n_spatial = len(_BACKBONE_WEIGHTS)           # 17 stacks and the 3 term-list arrays
    lib.st_layer_forward.argtypes = ([i32] * 3 + [ptr] * (6 + n_spatial) + [i32]
                                     + [ptr] * len(_T_KERNEL) + [ptr])
    lib.st_layer_forward.restype = i32
    lib.video_occupancy.argtypes = [i32, i32] + [ctypes.POINTER(i32)] * 4
    lib.video_occupancy.restype = i32
    lib.video_error_string.argtypes = [i32]
    lib.video_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what} kernel: {_library().video_error_string(code).decode()} "
                           f"(cudaError {code})")


def _temporal_ptrs(tw: Weights, layer: int, dev: torch.device) -> list:
    """Layer ``layer``'s slice of every stack the kernels take (the products'
    TF32 parts), checked, as pointers."""
    L, H = tw["num_layers"], tw["hid_dim"]
    if (H, tw["num_heads"]) != (KERNEL_HID, KERNEL_HEADS):
        raise ValueError(f"the kernels are built for hid/heads {(KERNEL_HID, KERNEL_HEADS)}, "
                         f"got {(H, tw['num_heads'])}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} of a {L}-layer stack")
    missing = [k for k in _T_KERNEL if k not in tw]
    if missing:
        raise ValueError(f"the kernels take the TF32 parts of prepare_video_weights; missing "
                         f"{missing}")
    shapes = dict(tln1s=(L, H), tln1b=(L, H), tln2s=(L, H), tln2b=(L, H),
                  twqkv_tf32=(L, 2, H, 3 * H), tbqkv=(L, 3 * H), twao_tf32=(L, 2, H, H),
                  tbao=(L, H), tff1_tf32=(L, 2, H, 2 * H), tbff1=(L, 2 * H),
                  tff2_tf32=(L, 2, 2 * H, H), tbff2=(L, H))
    for k in _T_KERNEL:
        _check_tensor(k, tw[k], shapes[k], torch.float32, dev)
    return [tw[k][layer].data_ptr() for k in _T_KERNEL]   # every layer slice is 16-byte aligned


def _check_rows(name: str, x: torch.Tensor, shape: tuple):
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {x.device}")
    _check_tensor(name, x, shape, torch.float32, x.device)


def _scratch(vectors: int, dev: torch.device):
    """Q|K|V ``[V, 288]`` and the attention output ``[V, 96]`` of V frame vectors."""
    return (torch.empty((vectors, 3 * KERNEL_HID), dtype=torch.float32, device=dev),
            torch.empty((vectors, KERNEL_HID), dtype=torch.float32, device=dev))


def _launch_temporal(tw: Weights, ht: torch.Tensor, layer: int) -> torch.Tensor:
    """One cooperative launch of row 10; every input is checked first."""
    n, f, H = ht.shape
    _check_rows("ht", ht, (n, f, KERNEL_HID))
    dev = ht.device
    wptrs = _temporal_ptrs(tw, layer, dev)
    out = torch.empty_like(ht)
    if n == 0 or f == 0:
        return out
    qkv, att = _scratch(n * f, dev)
    code = _library().temporal_forward(dev.index, n, f, ht.data_ptr(), out.data_ptr(),
                                       qkv.data_ptr(), att.data_ptr(), *wptrs,
                                       torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(code, "temporal_forward")
    return out


def _launch_st(lw: List[Weights], tw: Weights, h: torch.Tensor, tp: torch.Tensor,
               layer: int) -> torch.Tensor:
    """One cooperative launch of row 9; every input is checked first."""
    b, f, j, H = h.shape
    _check_rows("h", h, (b, f, j, KERNEL_HID))
    dev = h.device
    w = lw[layer]
    if w["num_layers"] != 1:
        raise ValueError("row 9 takes the one-layer spatial weights of layer_weights()")
    _check_launch(w, h.reshape(b * f, j, H), tp, H, _BACKBONE_WEIGHTS)
    wptrs = _temporal_ptrs(tw, layer, dev)
    out = torch.empty_like(h)
    if b == 0 or f == 0:
        return out
    spatial = torch.empty_like(h)
    qkv, att = _scratch(b * f * j, dev)
    code = _library().st_layer_forward(
        dev.index, b, f, h.data_ptr(), tp.data_ptr(), spatial.data_ptr(), out.data_ptr(),
        qkv.data_ptr(), att.data_ptr(), *[w[k].data_ptr() for k in _BACKBONE_WEIGHTS],
        w["cheb_nnz"], *wptrs, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(code, "st_layer_forward")
    return out


def kernel_occupancy(device: torch.device, kernel: str) -> Dict[str, int]:
    """Co-resident CTAs per SM, dynamic shared memory, registers a thread and
    threads a CTA of row 10 (``kernel="temporal"``) or row 9 (``"st"``)."""
    which = {"temporal": 0, "st": 1}[kernel]
    per_sm, smem, regs, threads = (ctypes.c_int() for _ in range(4))
    _raise_on(_library().video_occupancy(device.index or 0, which, ctypes.byref(per_sm),
                                         ctypes.byref(smem), ctypes.byref(regs),
                                         ctypes.byref(threads)),
              "video_occupancy")
    return {"ctas_per_sm": per_sm.value, "smem_bytes": smem.value, "regs": regs.value,
            "threads": threads.value}


def fused_temporal_layer(tw: Weights, ht: torch.Tensor, layer: int) -> torch.Tensor:
    """TemporalBlock ``layer`` on ``ht [N, F, 96]``: one launch of row 10 for
    CUDA tensors, :func:`temporal_layer_plain` for CPU tensors."""
    if ht.device.type == "cpu":
        return temporal_layer_plain(tw, ht, layer)
    out = _launch_temporal(tw, ht, layer)
    fused_temporal_layer.launches += 1
    return out


def fused_st_layer(lw: List[Weights], tw: Weights, h: torch.Tensor, tp: torch.Tensor,
                   layer: int) -> torch.Tensor:
    """Video layer ``layer`` on ``h [B, F, 17, 96]`` with ``tp [1, B·F, 96]``:
    one cooperative launch of row 9 for CUDA tensors, :func:`st_layer_plain`
    for CPU tensors."""
    if h.device.type == "cpu":
        return st_layer_plain(lw, tw, h, tp, layer)
    out = _launch_st(lw, tw, h, tp, layer)
    fused_st_layer.launches += 1
    return out


fused_temporal_layer.launches = 0
fused_st_layer.launches = 0


def embed(vw: Weights, x: torch.Tensor, frames: slice = slice(None)) -> torch.Tensor:
    """Input ChebConv per frame plus the positional embedding's rows
    ``frames`` (this rank's block of the window under context parallelism):
    ``[B, F, J, H]``."""
    b, f, j, c = x.shape
    sw = vw["spatial"]
    h = _cheb(x.reshape(b * f, j, c), sw["win"], sw["bin"], sw["basis"]).reshape(b, f, j, -1)
    return (h + vw["pos"][frames][None, :, None, :]).contiguous()


def project_out(vw: Weights, h: torch.Tensor) -> torch.Tensor:
    """Output ChebConv per frame: ``[B, F, J, C_out]``."""
    b, f, j, hid = h.shape
    sw = vw["spatial"]
    return _cheb(h.reshape(b * f, j, hid), sw["wout"], sw["bout"], sw["basis"]).reshape(b, f, j, -1)


def whole_windows(model, what: str):
    """Raise unless ``model``'s frames are unsharded: ``what`` owns whole
    windows (``diffpose_tpu/train/video_runner.py:354-377``)."""
    if model.context.size > 1:
        raise ValueError(f"{what} owns whole windows; it does not compose with context "
                         f"parallelism over {model.context.size} ranks (use the fused eval "
                         "forward, row 3 a spatial block, under a context axis)")


def make_video_full_fn(model):
    """Build ``fn(vw, x [B, F, J, 5], t [B]) → ε̂``: the eval forward of a
    ``SpatioTemporalDiff`` with every layer one launch of row 9 (the JAX
    default ``layers_per_call=1``); ``vw`` is :func:`prepare_video_weights`'
    snapshot.  Counterpart of ``make_pallas_video_full_fn``.  Whole windows
    only: under a context axis of more than one rank it raises."""
    frames, num_layers = model.frames, model.num_layers

    def fn(vw: Weights, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        whole_windows(model, "the fused_full eval forward (row 9)")
        if x.shape[1] != frames:
            raise ValueError(f"the model takes {frames}-frame windows, got {x.shape[1]}")
        tps = spatial_projections(vw["spatial"], t, frames)
        h = embed(vw, x)
        for l in range(num_layers):
            h = fused_st_layer(vw["layers"], vw["temporal"], h, tps[l], l)
        return project_out(vw, h)

    return fn
