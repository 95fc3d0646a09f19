"""Checkpoint of a train state: the reference 5-element ``.pth`` list
``[model, optimizer, epoch, step, ema]`` that
:func:`~diffpose_tpu_torch.models.convert.save_torch_states` writes.  The
JAX package checkpoints with orbax (``diffpose_tpu/train/checkpoint.py``);
this is the port's counterpart over plain ``torch.save``."""

from __future__ import annotations

from diffpose_tpu_torch.models.convert import load_torch_states, save_torch_states
from diffpose_tpu_torch.train.state import TrainState


def save_train_state(path: str, state: TrainState):
    save_torch_states(path, state.model.state_dict(),
                      optimizer_state=state.optimizer.state_dict(),
                      epoch=int(state.epoch), step=int(state.step), ema_state=state.ema_params)


def load_train_state(path: str, state: TrainState) -> TrainState:
    """Restore ``state`` in place (model, optimizer, counters, EMA shadow)
    from :func:`save_train_state`'s file and return it."""
    model_state, optim_state, epoch, step, ema_state = load_torch_states(path)
    state.model.load_state_dict(model_state, strict=True)
    if optim_state is not None:
        state.optimizer.load_state_dict(optim_state)
    state.epoch, state.step = int(epoch), int(step)
    if ema_state is not None:
        device = next(state.model.parameters()).device
        state.ema_params = {k: v.to(device) for k, v in ema_state.items()}
    return state
