"""The video denoiser's eval forward with each spatial block on the bare-stack
kernel (kernel row 3) and the temporal blocks as torch operations or as
row 10.

Counterpart of ``diffpose_tpu/ops/pallas_video.py:make_pallas_video_denoiser_fn``:
each spatial block (GraAttenLayer + ResChebGCDiff per frame) is the frame
model's layer at batch ``B·F``, so it runs as one launch of
``fused_backbone`` with that layer's one-layer weight set on
``[B·F, 17, 96]`` and ``tp [1, B·F, 96]`` (the window's timestep
projection repeated over its frames).  The timestep MLP, the input ChebConv
with the positional embedding and the output ChebConv stay torch operations,
as the JAX package leaves them to XLA.  ``temporal_impl="torch"``: the
temporal blocks are torch operations in f32 (``_temporal_block``,
``pallas_video.py:53``, also plain products in the JAX package);
``"kernel"``: each is one launch of row 10 (``fused_temporal_layer``).

At a reduced kernel tier (``tier="bf16"`` or ``"default"``, the JAX
wrapper's ``precision``) rows 3 and 10 run that tier's kernels and the
temporal blocks in torch operations stay f32, as the JAX wrapper leaves
them to XLA (``video_tier_weights``' ``temporal_f32``).

Under context parallelism (the model bound to a mesh,
``SpatioTemporalDiff.bind_mesh``) ``temporal_impl="torch"`` composes: row 3
runs on this rank's ``B·F_local`` frames with ``tp [1, B·F_local, 96]``, the
input takes this block's positional rows and each temporal block gathers the
keys and values of the whole window (``parallel/context.py``).  Row 10 owns
whole windows and raises there.
"""

from __future__ import annotations

import torch

from diffpose_tpu_torch.ops.fused_denoiser import fused_backbone
from diffpose_tpu_torch.ops.fused_video_full import (
    Weights,
    check_tier,
    embed,
    from_rows,
    fused_temporal_layer,
    project_out,
    spatial_projections,
    temporal_layer_plain,
    to_rows,
    video_tier_weights,
    whole_windows,
)

TEMPORAL_IMPLS = ("torch", "kernel")


def make_video_denoiser_fn(model, *, temporal_impl: str = "torch", tier: str = "bf16x3"):
    """Build ``fn(vw, x [B, F, J, 5], t [B]) → ε̂``, the eval forward of a
    ``SpatioTemporalDiff`` over ``prepare_video_weights``' snapshot ``vw``:
    ``num_layers`` row-3 launches, and with ``temporal_impl="kernel"`` as many
    row-10 launches, at kernel tier ``tier`` (``video_tier_weights``: made
    once by the caller, or here at every call).  ``x`` holds this rank's
    frames of each window where the model is bound to a context axis (the
    module's docstring)."""
    if temporal_impl not in TEMPORAL_IMPLS:
        raise ValueError(f"temporal_impl must be one of {TEMPORAL_IMPLS}, got {temporal_impl!r}")
    check_tier(tier)
    num_layers, chunk = model.num_layers, model.attention_chunk

    def fn(vw: Weights, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        if temporal_impl == "kernel":
            whole_windows(model, "the fused_st eval forward (row 10)")
        b, f, j, _ = x.shape
        block, context = model.frame_block(f), model.context
        vw = video_tier_weights(vw, tier)
        tw = vw["temporal"] if temporal_impl == "kernel" else vw.get("temporal_f32", vw["temporal"])
        tps = spatial_projections(vw["spatial"], t, f)
        h = embed(vw, x, block)
        for l in range(num_layers):
            hs = fused_backbone(vw["layers"][l], h.reshape(b * f, j, -1), tps[l]).reshape(h.shape)
            if temporal_impl == "kernel":
                ht = fused_temporal_layer(tw, to_rows(hs).contiguous(), l)
            else:
                ht = temporal_layer_plain(tw, to_rows(hs), l, attention_chunk=chunk,
                                          context=context)
            h = from_rows(ht, b).contiguous()
        return project_out(vw, h)

    return fn
