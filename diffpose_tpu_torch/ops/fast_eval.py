"""The "BigW" inference form of the GCNDiff denoiser and the GCNPose lifter.

Counterpart of ``diffpose_tpu/ops/fast_eval.py`` (``precompute_fast_params``,
``make_fast_denoiser``, ``make_fast_lifter``), built from the port's
``GCNDiff`` / ``GCNPose`` modules.  The forward is restructured into a few
large matrix products:

* **fused Chebyshev convolution**: for basis ``T_k [N, N]`` and weights
  ``W_k [C, D]``, ``y[b, n, d] = Σ_k Σ_m Σ_c T_k[n, m] x[b, m, c] W_k[c, d]``
  is ``reshape(x, [B, N·C]) @ BigW`` with ``BigW[(m, c), (n, d)] =
  Σ_k T_k[n, m] W_k[c, d]``, ``[N·C, N·D]`` (1632² at hid 96), folded once;
* the Q, K and V projections as one ``[C, 3C]`` product (1/√d_k folded into
  q's weight and bias, as ``fused_denoiser.prepare_weights`` folds it);
* each layer's learned-adjacency Laplacian normalised once.

``dtype`` ``torch.float32`` or ``torch.bfloat16``: every folded constant and
every operation in that type (the attention scores accumulated in f32, as
the JAX function's ``preferred_element_type``); the output is always f32.
It has no kernel of its own: its products are plain large matrix products,
which the JAX package leaves to XLA, so here they are ``torch.matmul``.  On
the TPU it lost to the whole-network kernel (4.45 against 3.06 ms, the JAX
module's text); ``chip_smoke.py`` phase 35 times it beside row 1.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from diffpose_tpu_torch.models.layers import timestep_embedding
from diffpose_tpu_torch.ops.fused_denoiser import prepare_weights, resolve_device

FastParams = Dict[str, Any]


def _big_cheb(basis: torch.Tensor, wcat: torch.Tensor, bias: torch.Tensor, dtype) -> dict:
    """``basis [K, N, N]`` and a ChebConv's side-by-side weights ``[C, K·D]``
    → ``{"w": BigW [N·C, N·D], "b": the bias tiled over the N joints}``."""
    k, n, _ = basis.shape
    c = wcat.shape[0]
    w = wcat.reshape(c, k, -1).permute(1, 0, 2)                     # [K, C, D]
    big = torch.einsum("knm,kcd->mcnd", basis, w).reshape(n * c, -1)
    return {"w": big.to(dtype).contiguous(), "b": bias.repeat(n).to(dtype)}


@torch.no_grad()
def precompute_fast_params(model, dtype=torch.float32, device="cuda") -> FastParams:
    """Fold a GCNDiff's or GCNPose's weights into the inference constants on
    ``device``: each ChebConv's BigW and tiled bias, the fused QKV, the
    normalised Laplacians, the LayerNorms, and the timestep MLP (denoiser)."""
    w = prepare_weights(model, device)
    basis, n, num_layers = w["basis"], w["n_pts"], w["num_layers"]

    def cast(t):
        return t.to(dtype)

    fp: FastParams = dict(
        n_pts=n, hid_dim=w["hid_dim"], num_heads=w["num_heads"], has_temb=w["has_temb"],
        dtype=dtype, device=torch.device(device),
        gconv_input=_big_cheb(basis, w["win"], w["bin"], dtype),
        gconv_output=_big_cheb(basis, w["wout"], w["bout"], dtype),
        layers=[],
    )
    if w["has_temb"]:
        fp.update({k: cast(w[k]) for k in ("t0k", "t0b", "t1k", "t1b")})
    for i in range(num_layers):
        layer = {k: cast(w[k][i]) for k in ("ln1s", "ln1b", "ln2s", "ln2b", "wqkv", "bqkv",
                                             "wao", "bao", "lap", "wfc1", "bfc1", "wfc2",
                                             "bfc2")}
        layer["gconv1"] = _big_cheb(basis, w["wg1"][i], w["bg1"][i], dtype)
        layer["gconv2"] = _big_cheb(basis, w["wg2"][i], w["bg2"][i], dtype)
        if w["has_temb"]:
            layer["wtp"], layer["btp"] = cast(w["wtp"][i]), cast(w["btp"][i])
        fp["layers"].append(layer)
    return fp


def _layer_norm(x, scale, shift):
    c = x - x.mean(dim=-1, keepdim=True)
    std = torch.sqrt((c * c).sum(dim=-1, keepdim=True) / (x.shape[-1] - 1))
    return scale * c / (std + 1e-6) + shift


def _backbone(fp: FastParams, x: torch.Tensor, temb) -> torch.Tensor:
    n, hid, heads = fp["n_pts"], fp["hid_dim"], fp["num_heads"]
    b = x.shape[0]
    h = x.reshape(b, -1) @ fp["gconv_input"]["w"] + fp["gconv_input"]["b"]   # [B, N·H]
    for layer in fp["layers"]:
        h3 = h.reshape(b, n, hid)
        # attention sublayer (pre-LN residual); q carries 1/√d_k
        y = _layer_norm(h3, layer["ln1s"], layer["ln1b"])
        qkv = (y @ layer["wqkv"] + layer["bqkv"]).reshape(b, n, 3, heads, -1)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        att = (probs @ v).transpose(1, 2).reshape(b, n, hid)
        h3 = h3 + (att @ layer["wao"] + layer["bao"])
        # GraphNet sublayer
        y = layer["lap"] @ _layer_norm(h3, layer["ln2s"], layer["ln2b"])
        y = layer["lap"] @ F.relu(y @ layer["wfc1"] + layer["bfc1"])
        h3 = h3 + (y @ layer["wfc2"] + layer["bfc2"])
        # residual Chebyshev block (timestep injection for the denoiser)
        hf = h3.reshape(b, -1)
        out = F.relu(hf @ layer["gconv1"]["w"] + layer["gconv1"]["b"])
        if temb is not None:
            tproj = F.silu(temb) @ layer["wtp"] + layer["btp"]            # [B, H]
            out = out + tproj.repeat(1, n)
        h = hf + F.relu(out @ layer["gconv2"]["w"] + layer["gconv2"]["b"])
    out = h @ fp["gconv_output"]["w"] + fp["gconv_output"]["b"]
    return out.reshape(b, n, -1).to(torch.float32)


def make_fast_denoiser(model, *, dtype=torch.float32, device="cuda"):
    """Build ``fn(x [B, N, C_in], t [B]) → ε̂`` with every inference fusion
    applied: ``GCNDiff``'s eval forward from the weights it has now."""
    device = resolve_device(device)
    fp = precompute_fast_params(model, dtype, device)
    if not fp["has_temb"]:
        raise ValueError("make_fast_denoiser takes a GCNDiff (with timestep projections)")

    @torch.no_grad()
    def fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x, device=device).to(dtype)
        temb = timestep_embedding(torch.as_tensor(t, device=device), fp["hid_dim"]).to(dtype)
        temb = F.silu(temb @ fp["t0k"] + fp["t0b"]) @ fp["t1k"] + fp["t1b"]
        return _backbone(fp, x, temb)

    return fn


def make_fast_lifter(model, *, dtype=torch.float32, device="cuda"):
    """The fast 2D→3D lifter: ``fn(x_2d) → xyz``, ``GCNPose``'s eval forward."""
    device = resolve_device(device)
    fp = precompute_fast_params(model, dtype, device)
    if fp["has_temb"]:
        raise ValueError("make_fast_lifter takes a GCNPose (no timestep projections)")

    @torch.no_grad()
    def fn(x: torch.Tensor) -> torch.Tensor:
        return _backbone(fp, torch.as_tensor(x, device=device).to(dtype), None)

    return fn
