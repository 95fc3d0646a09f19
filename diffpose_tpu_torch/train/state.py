"""Train state: model, optimizer, EMA shadow, counters.

Counterpart of ``diffpose_tpu/train/state.py``.  There the state is an
immutable tree that every step replaces; here it holds the live
``nn.Module`` and optimizer, which a step updates in place, and the step
returns the same object with its counters advanced.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
from torch import nn


@dataclass
class TrainState:
    model: nn.Module
    optimizer: Any                                   # train.optim.ClippedOptimizer
    ema_params: Optional[Dict[str, torch.Tensor]]    # named like model.named_parameters()
    step: int = 0
    epoch: int = 0
    model_state: Any = None   # mutable collections (IGCN batch statistics), unused by the frame family

    @classmethod
    def create(cls, model, optimizer, ema_params=None, model_state=None) -> "TrainState":
        return cls(model=model, optimizer=optimizer, ema_params=ema_params,
                   model_state=model_state)
