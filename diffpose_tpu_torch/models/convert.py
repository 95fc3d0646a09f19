"""Weights in and out: the JAX package's parameter trees and reference ``.pth`` files.

The port's :class:`~diffpose_tpu_torch.models.GCNDiff` and
:class:`~diffpose_tpu_torch.models.GCNPose` use the reference ``state_dict``
names, so reference checkpoints load into them unchanged.  This module

* turns a Flax parameter tree of those models (a nested dict of numpy
  arrays) into such a ``state_dict`` (:func:`state_dict_from_flax`), and
* turns tensors named like that ``state_dict`` back into the Flax tree
  (:func:`flax_from_state_dict`), so that gradients and updated parameters
  can be compared leaf by leaf,
* does both for the implicit model's variables, parameters and BatchNorm
  statistics (:func:`state_dict_from_flax_igcn`,
  :func:`flax_igcn_from_state_dict`), for the video model's parameters
  (:func:`state_dict_from_flax_video`, :func:`flax_video_from_state_dict`)
  and for the standalone GraFormer's (:func:`state_dict_from_flax_graformer`,
  :func:`flax_graformer_from_state_dict`), and the first for ``ChebNet`` and
  ``PositionwiseFeedForward``,
* reads and writes the reference 5-element checkpoint list
  ``[model, optim, epoch, step, ema]`` (``runners/diffpose_frame.py:248-255``),
  whose names carry ``DataParallel``'s ``module.`` prefix.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

ATTN_NAMES = ("q", "k", "v", "out")


def _get(tree: Mapping, path: tuple) -> np.ndarray:
    node = tree
    for p in path:
        node = node[p]
    return np.asarray(node)


def _put_cheb(sd: dict, params: Mapping, src: tuple, dst: str):
    sd[f"{dst}.weight"] = _get(params, src + ("w",))[:, None]
    sd[f"{dst}.bias"] = _get(params, src + ("b",)).reshape(1, 1, -1)


def _put_linear(sd: dict, params: Mapping, src: tuple, dst: str):
    sd[f"{dst}.weight"] = _get(params, src + ("kernel",)).T
    sd[f"{dst}.bias"] = _get(params, src + ("bias",))


def _put_norm(sd: dict, params: Mapping, src: tuple, dst: str):
    sd[f"{dst}.a_2"] = _get(params, src + ("scale",))
    sd[f"{dst}.b_2"] = _get(params, src + ("bias",))


def _put_atten(sd: dict, params: Mapping, src: str, dst: str):
    """A Flax GraAttenLayer ``src`` → the reference names under ``dst``."""
    for j, name in enumerate(ATTN_NAMES):
        _put_linear(sd, params, (src, "attn", name), f"{dst}.self_attn.linears.{j}")
    for j, norm in enumerate(("norm1", "norm2")):
        _put_norm(sd, params, (src, norm), f"{dst}.sublayer.{j}.norm")
    sd[f"{dst}.feed_forward.A_hat"] = _get(params, (src, "gnet", "a_hat"))
    for conv, fc in (("gconv1", "fc1"), ("gconv2", "fc2")):
        _put_linear(sd, params, (src, "gnet", fc), f"{dst}.feed_forward.{conv}.fc")


def _put_chebnet(sd: dict, params: Mapping, src: tuple, prefix: str):
    """A Flax ChebNet (two GraphConvBlocks) at ``src`` → ``{prefix}gconv{1,2}.gconv``."""
    for conv in ("gconv1", "gconv2"):
        _put_cheb(sd, params, src + (conv, "gconv"), f"{prefix}{conv}.gconv")


def _put_ffn(sd: dict, params: Mapping, src: tuple, prefix: str):
    """A Flax PositionwiseFeedForward at ``src`` (``w1``, ``w2``) → ``{prefix}w_{1,2}``."""
    for fc in ("1", "2"):
        _put_linear(sd, params, src + (f"w{fc}",), f"{prefix}w_{fc}")


def _put_res(sd: dict, params: Mapping, src: str, dst: str, with_temb: bool):
    """A Flax ResChebGCDiff (or, without ``temb_proj``, ResChebGC) ``src``."""
    _put_chebnet(sd, params, (src,), f"{dst}.")
    if with_temb:
        _put_linear(sd, params, (src, "temb_proj"), f"{dst}.temb_proj")


def _tensors(sd: dict) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.ascontiguousarray(v, np.float32)) for k, v in sd.items()}


def state_dict_from_flax(
    params: Mapping, *, with_temb: bool, num_layers: int, hid_dim: int
) -> Dict[str, torch.Tensor]:
    """A Flax GCNDiff (``with_temb=True``) or GCNPose parameter tree → the
    reference ``state_dict`` (no ``module.`` prefix).

    Flax dense kernels are ``[in, out]`` and torch's ``[out, in]``;
    Chebyshev weights gain the reference's singleton axis
    (``[K+1, in, out] → [K+1, 1, in, out]``).  GCNPose declares but never
    uses ``temb.dense.{0,1}``; they are filled with zeros.
    """
    sd: Dict[str, np.ndarray] = {}
    emd_dim = 4 * hid_dim
    _put_cheb(sd, params, ("gconv_input",), "gconv_input")
    _put_cheb(sd, params, ("gconv_output",), "gconv_output")
    if with_temb:
        _put_linear(sd, params, ("temb_dense_0",), "temb.dense.0")
        _put_linear(sd, params, ("temb_dense_1",), "temb.dense.1")
    else:
        sd["temb.dense.0.weight"] = np.zeros((emd_dim, hid_dim), np.float32)
        sd["temb.dense.0.bias"] = np.zeros((emd_dim,), np.float32)
        sd["temb.dense.1.weight"] = np.zeros((emd_dim, emd_dim), np.float32)
        sd["temb.dense.1.bias"] = np.zeros((emd_dim,), np.float32)
    for i in range(num_layers):
        _put_atten(sd, params, f"atten_{i}", f"atten_layers.{i}")
        _put_res(sd, params, f"res_{i}", f"gconv_layers.{i}", with_temb)
    return _tensors(sd)


def _reader(state: Mapping[str, torch.Tensor]):
    def arr(name):
        return np.asarray(torch.as_tensor(state[name]).detach().cpu().numpy())

    def cheb(name):
        return {"w": arr(f"{name}.weight")[:, 0], "b": arr(f"{name}.bias").reshape(-1)}

    def linear(name):
        return {"kernel": arr(f"{name}.weight").T, "bias": arr(f"{name}.bias")}

    def norm(name):
        return {"scale": arr(f"{name}.a_2"), "bias": arr(f"{name}.b_2")}

    def atten(name):
        return {
            "attn": {n: linear(f"{name}.self_attn.linears.{j}") for j, n in enumerate(ATTN_NAMES)},
            **{nm: norm(f"{name}.sublayer.{j}.norm") for j, nm in enumerate(("norm1", "norm2"))},
            "gnet": {"a_hat": arr(f"{name}.feed_forward.A_hat"),
                     "fc1": linear(f"{name}.feed_forward.gconv1.fc"),
                     "fc2": linear(f"{name}.feed_forward.gconv2.fc")},
        }

    def res(name, with_temb):
        out = {conv: {"gconv": cheb(f"{name}.{conv}.gconv")} for conv in ("gconv1", "gconv2")}
        if with_temb:
            out["temb_proj"] = linear(f"{name}.temb_proj")
        return out

    return arr, cheb, linear, norm, atten, res


def flax_from_state_dict(
    state: Mapping[str, torch.Tensor], *, with_temb: bool, num_layers: int
) -> Dict[str, dict]:
    """The inverse of :func:`state_dict_from_flax`: tensors named like the
    reference ``state_dict`` (parameters, their gradients, ...) → the Flax
    tree of numpy arrays.  Dense weights go back to ``[in, out]``, Chebyshev
    weights lose the singleton axis, their biases become ``[out]``.  The
    ``temb.dense`` entries of a GCNPose are dropped, as Flax has none."""
    _, cheb, linear, _, atten, res = _reader(state)
    tree: Dict[str, dict] = {"gconv_input": cheb("gconv_input"),
                             "gconv_output": cheb("gconv_output")}
    if with_temb:
        tree["temb_dense_0"] = linear("temb.dense.0")
        tree["temb_dense_1"] = linear("temb.dense.1")
    for i in range(num_layers):
        tree[f"atten_{i}"] = atten(f"atten_layers.{i}")
        tree[f"res_{i}"] = res(f"gconv_layers.{i}", with_temb)
    return tree


def state_dict_from_flax_chebnet(params: Mapping) -> Dict[str, torch.Tensor]:
    """A Flax ``ChebNet`` parameter tree → the port's ``ChebNet`` ``state_dict``
    (``gconv{1,2}.gconv.{weight,bias}``)."""
    sd: Dict[str, np.ndarray] = {}
    _put_chebnet(sd, params, (), "")
    return _tensors(sd)


def state_dict_from_flax_ffn(params: Mapping) -> Dict[str, torch.Tensor]:
    """A Flax ``PositionwiseFeedForward`` parameter tree (``w1``, ``w2``) → the
    reference names ``w_1``, ``w_2`` (``models/GraFormer.py:143-155``)."""
    sd: Dict[str, np.ndarray] = {}
    _put_ffn(sd, params, (), "")
    return _tensors(sd)


def state_dict_from_flax_graformer(params: Mapping, *, num_layers: int) -> Dict[str, torch.Tensor]:
    """A Flax standalone ``GraFormer`` parameter tree → the reference
    ``GraFormer`` ``state_dict`` (``models/GraFormer.py:204-237``): the
    I/O ChebConvs, ``atten_layers.{i}`` and ``gconv_layers.{i}`` (ResChebGC,
    no timestep projection); the model has no ``temb``."""
    sd: Dict[str, np.ndarray] = {}
    _put_cheb(sd, params, ("gconv_input",), "gconv_input")
    _put_cheb(sd, params, ("gconv_output",), "gconv_output")
    for i in range(num_layers):
        _put_atten(sd, params, f"atten_{i}", f"atten_layers.{i}")
        _put_res(sd, params, f"res_{i}", f"gconv_layers.{i}", with_temb=False)
    return _tensors(sd)


def flax_graformer_from_state_dict(state: Mapping[str, torch.Tensor], *,
                                   num_layers: int) -> Dict[str, dict]:
    """The inverse of :func:`state_dict_from_flax_graformer`, for parameters or
    their gradients named like the ``state_dict``."""
    _, cheb, _, _, atten, res = _reader(state)
    tree: Dict[str, dict] = {"gconv_input": cheb("gconv_input"),
                             "gconv_output": cheb("gconv_output")}
    for i in range(num_layers):
        tree[f"atten_{i}"] = atten(f"atten_layers.{i}")
        tree[f"res_{i}"] = res(f"gconv_layers.{i}", False)
    return tree


def _video_layers(names) -> int:
    return len({k.split(".")[0] for k in names if k.startswith("spatial_atten_")})


def state_dict_from_flax_video(params: Mapping) -> Dict[str, torch.Tensor]:
    """A Flax ``SpatioTemporalDiff`` parameter tree → the port's
    ``SpatioTemporalDiff`` ``state_dict``.

    The family has no reference checkpoint format, so the names are the
    Flax tree's: ``temb_dense_{0,1}``, ``pos_embed``, and per layer
    ``temporal_{i}.{attn.{q,k,v,out},norm1,norm2,ff1,ff2}``; the spatial
    blocks ``spatial_atten_{i}`` / ``spatial_res_{i}`` and the I/O ChebConvs
    take the frame model's reference names under those prefixes."""
    sd: Dict[str, np.ndarray] = {"pos_embed": _get(params, ("pos_embed",))}
    _put_cheb(sd, params, ("gconv_input",), "gconv_input")
    _put_cheb(sd, params, ("gconv_output",), "gconv_output")
    for d in ("temb_dense_0", "temb_dense_1"):
        _put_linear(sd, params, (d,), d)
    for i in range(_video_layers(params)):
        _put_atten(sd, params, f"spatial_atten_{i}", f"spatial_atten_{i}")
        _put_res(sd, params, f"spatial_res_{i}", f"spatial_res_{i}", True)
        tb = f"temporal_{i}"
        for name in ATTN_NAMES:
            _put_linear(sd, params, (tb, "attn", name), f"{tb}.attn.{name}")
        for name in ("norm1", "norm2"):
            _put_norm(sd, params, (tb, name), f"{tb}.{name}")
        for name in ("ff1", "ff2"):
            _put_linear(sd, params, (tb, name), f"{tb}.{name}")
    return _tensors(sd)


def flax_video_from_state_dict(state: Mapping[str, torch.Tensor]) -> Dict[str, dict]:
    """The inverse of :func:`state_dict_from_flax_video`, for parameters,
    their gradients or an EMA shadow named like the ``state_dict``."""
    arr, cheb, linear, norm, atten, res = _reader(state)
    tree: Dict[str, dict] = {"pos_embed": arr("pos_embed"), "gconv_input": cheb("gconv_input"),
                             "gconv_output": cheb("gconv_output"),
                             "temb_dense_0": linear("temb_dense_0"),
                             "temb_dense_1": linear("temb_dense_1")}
    for i in range(_video_layers(state)):
        tb = f"temporal_{i}"
        tree[f"spatial_atten_{i}"] = atten(f"spatial_atten_{i}")
        tree[f"spatial_res_{i}"] = res(f"spatial_res_{i}", True)
        tree[tb] = {"attn": {n: linear(f"{tb}.attn.{n}") for n in ATTN_NAMES},
                    "norm1": norm(f"{tb}.norm1"), "norm2": norm(f"{tb}.norm2"),
                    "ff1": linear(f"{tb}.ff1"), "ff2": linear(f"{tb}.ff2")}
    return tree


def state_dict_from_flax_igcn(variables: Mapping, *, num_layers: int,
                              hid_dim: int) -> Dict[str, torch.Tensor]:
    """Flax IGCN variables ``{"params", "batch_stats"}`` → the reference IGCN
    ``state_dict`` (no ``module.`` prefix): the GCNDiff names plus
    ``batch_norm.{weight, bias}`` from ``bn_scale`` / ``bn_bias`` and
    ``batch_norm.{running_mean, running_var}`` from the batch statistics
    (reference ``models/igcn.py:95``; ``diffpose_tpu/models/convert.py:204-221``)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = state_dict_from_flax(params, with_temb=True, num_layers=num_layers, hid_dim=hid_dim)
    for name, src in (("weight", params["bn_scale"]), ("bias", params["bn_bias"]),
                      ("running_mean", stats["bn_mean"]), ("running_var", stats["bn_var"])):
        sd[f"batch_norm.{name}"] = torch.as_tensor(np.ascontiguousarray(src, np.float32))
    sd["batch_norm.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return sd


def flax_igcn_from_state_dict(state: Mapping[str, torch.Tensor], *,
                              num_layers: int) -> Dict[str, dict]:
    """The inverse of :func:`state_dict_from_flax_igcn` (a ``module.`` prefix
    is stripped): ``{"params", "batch_stats"}`` of numpy arrays.  Works on
    any tensors named like the ``state_dict``, gradients included (then
    without the running buffers, which have none)."""
    sd = _strip_prefix(state)
    params = flax_from_state_dict(sd, with_temb=True, num_layers=num_layers)

    def arr(name):
        return np.asarray(torch.as_tensor(sd[name]).detach().cpu().numpy())

    params["bn_scale"], params["bn_bias"] = arr("batch_norm.weight"), arr("batch_norm.bias")
    stats = ({"bn_mean": arr("batch_norm.running_mean"), "bn_var": arr("batch_norm.running_var")}
             if "batch_norm.running_mean" in sd else None)
    return {"params": params, "batch_stats": stats}


def _strip_prefix(state: Optional[Mapping]) -> Optional[Dict[str, torch.Tensor]]:
    if state is None:
        return None
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state.items()}


def save_torch_states(
    path: str, model_state: Mapping[str, torch.Tensor], *,
    optimizer_state=None, epoch: int = 0, step: int = 0, ema_state=None,
):
    """Write the reference checkpoint list ``[model, optim, epoch, step, ema]``.

    Names get the ``module.`` prefix, since the reference loads into
    ``DataParallel``-wrapped modules (``runners/diffpose_frame.py:126-132``).
    """
    def prefixed(state):
        if state is None:
            return None
        return {"module." + k: torch.as_tensor(v).detach().cpu() for k, v in state.items()}

    torch.save([prefixed(model_state), optimizer_state, epoch, step, prefixed(ema_state)], path)


def load_torch_states(path: str):
    """Read a reference ``ckpt.pth`` list.

    Returns ``(model_state, optim_state, epoch, step, ema_state_or_None)``
    with the ``module.`` prefix stripped from the state names, ready for
    ``load_state_dict(strict=True)``.
    """
    states = torch.load(path, map_location="cpu", weights_only=False)
    model_state = _strip_prefix(states[0])
    optim_state = states[1] if len(states) > 1 else None
    epoch = states[2] if len(states) > 2 else 0
    step = states[3] if len(states) > 3 else 0
    ema_state = _strip_prefix(states[4]) if len(states) > 4 else None
    return model_state, optim_state, epoch, step, ema_state
