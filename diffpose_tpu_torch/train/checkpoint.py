"""Checkpoint of a train state: the reference 5-element ``.pth`` list
``[model, optimizer, epoch, step, ema]`` that
:func:`~diffpose_tpu_torch.models.convert.save_torch_states` writes.  The
JAX package checkpoints with orbax (``diffpose_tpu/train/checkpoint.py``);
this is the port's counterpart over plain ``torch.save``:
:class:`Checkpointer` keeps a directory of step-numbered such files with
full resume (model, optimizer moments, EMA, step and epoch), where the
reference restores the model weights only (``runners/diffpose_frame.py:130-132``)."""

from __future__ import annotations

import os
import re
from typing import List, Optional

from torch import nn

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


_CKPT = re.compile(r"^ckpt_(\d+)\.pth$")


class Checkpointer:
    """Step-numbered checkpoints under ``directory``: ``ckpt_<step>.pth`` is
    :func:`save_train_state`'s file (loadable as a reference ``ckpt.pth``),
    ``ckpt_<step>.pose.pth`` the lifter's weights in the same format when
    ``pose_params`` is given.  The newest ``max_to_keep`` steps stay."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3):
        self._dir = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def path(self, step: int, pose: bool = False) -> str:
        return os.path.join(self._dir, f"ckpt_{int(step):08d}{'.pose' if pose else ''}.pth")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_CKPT.match, os.listdir(self._dir)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, *, pose_params=None, wait: bool = False):
        """``pose_params``: the lifter module or its ``state_dict``.  The
        write is finished when this returns (``wait`` is accepted for the
        JAX package's signature)."""
        if pose_params is not None:
            if isinstance(pose_params, nn.Module):
                pose_params = pose_params.state_dict()
            tmp = self.path(step, pose=True) + ".tmp"
            save_torch_states(tmp, pose_params)
            os.replace(tmp, self.path(step, pose=True))
        tmp = self.path(step) + ".tmp"
        save_train_state(tmp, state)
        os.replace(tmp, self.path(step))     # the step exists once its last file does
        if self._max_to_keep is not None:
            for old in self.all_steps()[:-self._max_to_keep]:
                for path in (self.path(old), self.path(old, pose=True)):
                    if os.path.exists(path):
                        os.remove(path)

    def restore(self, template_state: TrainState, *, step: Optional[int] = None,
                template_pose_params: Optional[nn.Module] = None):
        """Restore into ``template_state`` (in place) and, where the step has
        them, the lifter's weights into the module ``template_pose_params``.

        Returns ``(state, pose_params_or_None)``; raises if no checkpoint.
        """
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {self._dir}")
        state = load_train_state(self.path(step), template_state)
        pose = None
        if template_pose_params is not None and os.path.exists(self.path(step, pose=True)):
            template_pose_params.load_state_dict(
                load_torch_states(self.path(step, pose=True))[0], strict=True)
            pose = template_pose_params
        return state, pose

    def close(self):
        pass
