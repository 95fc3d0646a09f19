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
  :func:`flax_igcn_from_state_dict`), and
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

    def put_cheb(src: tuple, dst: str):
        sd[f"{dst}.weight"] = _get(params, src + ("w",))[:, None]
        sd[f"{dst}.bias"] = _get(params, src + ("b",)).reshape(1, 1, -1)

    def put_linear(src: tuple, dst: str):
        sd[f"{dst}.weight"] = _get(params, src + ("kernel",)).T
        sd[f"{dst}.bias"] = _get(params, src + ("bias",))

    put_cheb(("gconv_input",), "gconv_input")
    put_cheb(("gconv_output",), "gconv_output")
    if with_temb:
        put_linear(("temb_dense_0",), "temb.dense.0")
        put_linear(("temb_dense_1",), "temb.dense.1")
    else:
        sd["temb.dense.0.weight"] = np.zeros((emd_dim, hid_dim), np.float32)
        sd["temb.dense.0.bias"] = np.zeros((emd_dim,), np.float32)
        sd["temb.dense.1.weight"] = np.zeros((emd_dim, emd_dim), np.float32)
        sd["temb.dense.1.bias"] = np.zeros((emd_dim,), np.float32)

    for i in range(num_layers):
        a = f"atten_layers.{i}"
        for j, name in enumerate(ATTN_NAMES):
            put_linear((f"atten_{i}", "attn", name), f"{a}.self_attn.linears.{j}")
        for j, norm in enumerate(("norm1", "norm2")):
            sd[f"{a}.sublayer.{j}.norm.a_2"] = _get(params, (f"atten_{i}", norm, "scale"))
            sd[f"{a}.sublayer.{j}.norm.b_2"] = _get(params, (f"atten_{i}", norm, "bias"))
        sd[f"{a}.feed_forward.A_hat"] = _get(params, (f"atten_{i}", "gnet", "a_hat"))
        for conv, fc in (("gconv1", "fc1"), ("gconv2", "fc2")):
            put_linear((f"atten_{i}", "gnet", fc), f"{a}.feed_forward.{conv}.fc")

        g = f"gconv_layers.{i}"
        for conv in ("gconv1", "gconv2"):
            put_cheb((f"res_{i}", conv, "gconv"), f"{g}.{conv}.gconv")
        if with_temb:
            put_linear((f"res_{i}", "temb_proj"), f"{g}.temb_proj")

    return {k: torch.as_tensor(np.ascontiguousarray(v, np.float32)) for k, v in sd.items()}


def flax_from_state_dict(
    state: Mapping[str, torch.Tensor], *, with_temb: bool, num_layers: int
) -> Dict[str, dict]:
    """The inverse of :func:`state_dict_from_flax`: tensors named like the
    reference ``state_dict`` (parameters, their gradients, ...) → the Flax
    tree of numpy arrays.  Dense weights go back to ``[in, out]``, Chebyshev
    weights lose the singleton axis, their biases become ``[out]``.  The
    ``temb.dense`` entries of a GCNPose are dropped, as Flax has none."""
    def arr(name):
        return np.asarray(torch.as_tensor(state[name]).detach().cpu().numpy())

    def cheb(name):
        return {"w": arr(f"{name}.weight")[:, 0], "b": arr(f"{name}.bias").reshape(-1)}

    def linear(name):
        return {"kernel": arr(f"{name}.weight").T, "bias": arr(f"{name}.bias")}

    tree: Dict[str, dict] = {"gconv_input": cheb("gconv_input"),
                             "gconv_output": cheb("gconv_output")}
    if with_temb:
        tree["temb_dense_0"] = linear("temb.dense.0")
        tree["temb_dense_1"] = linear("temb.dense.1")
    for i in range(num_layers):
        a = f"atten_layers.{i}"
        tree[f"atten_{i}"] = {
            "attn": {name: linear(f"{a}.self_attn.linears.{j}")
                     for j, name in enumerate(ATTN_NAMES)},
            **{norm: {"scale": arr(f"{a}.sublayer.{j}.norm.a_2"),
                      "bias": arr(f"{a}.sublayer.{j}.norm.b_2")}
               for j, norm in enumerate(("norm1", "norm2"))},
            "gnet": {"a_hat": arr(f"{a}.feed_forward.A_hat"),
                     "fc1": linear(f"{a}.feed_forward.gconv1.fc"),
                     "fc2": linear(f"{a}.feed_forward.gconv2.fc")},
        }
        g = f"gconv_layers.{i}"
        res = {conv: {"gconv": cheb(f"{g}.{conv}.gconv")} for conv in ("gconv1", "gconv2")}
        if with_temb:
            res["temb_proj"] = linear(f"{g}.temb_proj")
        tree[f"res_{i}"] = res
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
