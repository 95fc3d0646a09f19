"""The standalone GraFormer's eval forward with every ChebConv on kernel row 4.

Counterpart of using ``diffpose_tpu/ops/pallas_cheb.py:fused_cheb_conv``
where ``diffpose_tpu/models/graformer.py:GraFormer`` has a
``ChebGraphConv``: the input and output ChebConvs and the two of each
residual block, ``2 + 2·num_layers`` launches of :func:`fused_cheb_conv` a
call (10 at the default 4 layers).  The attention layers stay the model's
torch modules, as the JAX package leaves them to XLA: no TPU kernel exists
for them.  Eval only: row 4 has no backward kernel in the JAX package, so
training is the module under autograd.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from diffpose_tpu_torch.models.graformer import GraFormer
from diffpose_tpu_torch.ops.fused_cheb import fused_cheb_conv, graph_constants

__all__ = ["make_graformer_fn"]


def make_graformer_fn(model: GraFormer) -> Callable:
    """Build ``fn(x [B, N, 2], mask=None) → [B, N, 3]``, the equivalent of
    ``model.eval()(x, mask)``, reading the model's current weights at each
    call.  The inputs' device decides what runs: the kernel on the card, its
    plain version on the CPU.  Raises if the model is in training mode."""
    basis = model.gconv_input.basis.detach().cpu().numpy()   # read to the host once
    consts = {}                                               # its term list, per device

    @torch.no_grad()
    def fn(x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if model.training:
            raise ValueError("make_graformer_fn is the eval forward: call model.eval() first")
        g = consts.get(x.device)
        if g is None:
            g = consts[x.device] = graph_constants(basis, x.device)

        def cheb(conv, h):
            return fused_cheb_conv(h, conv.weight[:, 0], conv.bias.reshape(-1), g)

        out = cheb(model.gconv_input, x.contiguous())
        for atten, res in zip(model.atten_layers, model.gconv_layers):
            out = atten(out, mask).contiguous()
            # GraphConvBlock in eval: relu(gconv(x)), with or without its dropout
            out = out + F.relu(cheb(res.gconv2.gconv, F.relu(cheb(res.gconv1.gconv, out))))
        return cheb(model.gconv_output, out)

    return fn
