"""Optimizer assembly: Adam + global-norm clip + staircase LR decay.

Reference semantics: Adam(β=(0.9, 0.999), eps=1e-8, no weight decay, no
amsgrad) (``common/utils.py:39-50``); global gradient-norm clip at 1.0
(``runners/diffpose_frame.py:230``); LR ``lr·γ^⌊epoch/decay⌋``
(``common/utils.py:26-30``).  Counterpart of ``diffpose_tpu/train/optim.py``,
which chains ``optax.clip_by_global_norm`` with an optax optimizer; the
arithmetic here is optax's, where torch's own differs:

* the clip scales by ``clip / max(norm, clip)`` (optax), not by
  ``clip / (norm + 1e-6)`` (``torch.nn.utils.clip_grad_norm_``);
* RMSProp is ``optax.rmsprop``'s default: decay 0.9, eps 1e-8 **inside**
  the root, ``g / sqrt(ν + eps)``, no momentum.  ``torch.optim.RMSprop``
  defaults to alpha 0.99 and puts eps outside the root and cannot be set to
  this, so the rule is written out in :class:`RMSPropEpsInRoot`;
* Adam and SGD(momentum 0.9) are ``torch.optim``'s, whose rules equal
  optax's (bias-corrected moments, eps added to the corrected root;
  ``buf = 0.9·buf + g``).
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch


def staircase_lr(lr: float, gamma: float, decay_epochs: int,
                 steps_per_epoch: int) -> Callable[[int], float]:
    """Per-step schedule of the reference's epoch staircase."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return lr * gamma ** (epoch // decay_epochs)

    return schedule


class RMSPropEpsInRoot(torch.optim.Optimizer):
    """``ν = decay·ν + (1−decay)·g²;  p −= lr·g / sqrt(ν + eps)``."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad, value=1.0 - group["decay"])
                p.addcdiv_(p.grad, torch.sqrt(nu + group["eps"]), value=-group["lr"])


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """``sqrt(Σ ‖g‖²)`` over all gradients, a scalar tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))


class ClippedOptimizer:
    """A ``torch.optim`` optimizer behind a global-norm clip and a per-step
    learning-rate schedule.  ``count`` is the number of updates made, the
    schedule's argument; it is part of ``state_dict``."""

    def __init__(self, inner: torch.optim.Optimizer, schedule: Callable[[int], float],
                 grad_clip: float):
        self.inner, self.schedule, self.grad_clip = inner, schedule, float(grad_clip)
        self.count = 0

    @property
    def params(self):
        return [p for g in self.inner.param_groups for p in g["params"]]

    def zero_grad(self):
        self.inner.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip the gradients in place, set this step's rate, update.
        Returns the global norm of the gradients before the clip."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = global_norm(grads)
        torch._foreach_mul_(grads, self.grad_clip / torch.clamp(norm, min=self.grad_clip))
        lr = self.schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.count += 1
        return norm

    def state_dict(self):
        return {"inner": self.inner.state_dict(), "count": self.count}

    def load_state_dict(self, state):
        self.inner.load_state_dict(state["inner"])
        self.count = int(state["count"])


def make_optimizer(
    params,
    *,
    optimizer: str = "Adam",
    lr: float = 2e-5,
    lr_gamma: float = 0.9,
    decay_epochs: int = 60,
    steps_per_epoch: int = 1,
    grad_clip: float = 1.0,
    eps: float = 1e-8,
) -> ClippedOptimizer:
    """The optimizer of ``params`` (an iterable of parameters) by the
    config's name: ``Adam``, ``RMSProp`` or ``SGD``."""
    params = list(params)
    schedule = staircase_lr(lr, lr_gamma, decay_epochs, steps_per_epoch)
    if optimizer == "Adam":
        # one kernel for all parameters on the card; the default elsewhere
        fused = all(p.is_cuda for p in params) or None
        inner = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=eps, fused=fused)
    elif optimizer == "RMSProp":
        inner = RMSPropEpsInRoot(params, lr=lr, decay=0.9, eps=1e-8)
    elif optimizer == "SGD":
        inner = torch.optim.SGD(params, lr=lr, momentum=0.9)
    else:
        raise NotImplementedError(f"Optimizer {optimizer} not understood.")
    return ClippedOptimizer(inner, schedule, grad_clip)
