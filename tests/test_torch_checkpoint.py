"""Port Checkpointer: step-numbered torch.save files with full resume."""

import copy
import os

import pytest
import torch

from diffpose_tpu_torch.data.synthetic import make_synthetic_dataset
from diffpose_tpu_torch.diffusion import get_beta_schedule
from diffpose_tpu_torch.graph import H36M_EDGES, cheb_basis_from_edges
from diffpose_tpu_torch.models import GCNDiff, GCNPose
from diffpose_tpu_torch.models.convert import load_torch_states
from diffpose_tpu_torch.models.ema import ema_register
from diffpose_tpu_torch.train.checkpoint import Checkpointer
from diffpose_tpu_torch.train.optim import make_optimizer
from diffpose_tpu_torch.train.state import TrainState
from diffpose_tpu_torch.train.steps import make_train_step

# Small tensors on a host that runs several test workers: one thread each is
# faster than contended thread pools.
torch.set_num_threads(1)

CFG = dict(hid_dim=32, num_layers=2, num_heads=4)
BASIS = cheb_basis_from_edges(17, H36M_EDGES)
BETAS = get_beta_schedule("linear", beta_start=1e-4, beta_end=1e-3, num_diffusion_timesteps=51)
DATA = make_synthetic_dataset(num_frames=16, seed=0)
BATCH = {"poses_3d": DATA.poses_3d, "poses_2d_gmm": DATA.poses_2d_gmm}


def fresh(seed):
    torch.manual_seed(seed)
    model = GCNDiff(BASIS, **CFG)
    opt = make_optimizer(model.parameters(), lr=1e-3, steps_per_epoch=2, decay_epochs=1)
    state = TrainState.create(model, opt, ema_register(model))
    return state, make_train_step(model, opt, BETAS, impl="plain", device="cpu")


def test_save_restore_gives_the_identical_next_step(tmp_path):
    state, step = fresh(0)
    gen = torch.Generator().manual_seed(1)
    for _ in range(3):
        state, _ = step(state, BATCH, gen)
    state.epoch = 1
    pose = GCNPose(BASIS, **CFG)
    ckpt = Checkpointer(str(tmp_path))
    assert ckpt.latest_step() is None
    ckpt.save(state.step, state, pose_params=pose)
    assert ckpt.latest_step() == 3 and os.path.exists(ckpt.path(3, pose=True))
    draws = step.draw(BATCH, gen)
    state, want = step.apply(state, draws)

    other, other_step = fresh(7)                      # other weights, empty moments
    other_pose = GCNPose(BASIS, **CFG)
    restored, got_pose = Checkpointer(str(tmp_path)).restore(other, template_pose_params=other_pose)
    assert restored is other and (restored.step, restored.epoch) == (3, 1)
    assert restored.optimizer.count == 3
    assert got_pose is other_pose
    assert all(torch.equal(a, b) for a, b in zip(pose.state_dict().values(),
                                                 other_pose.state_dict().values()))
    restored, got = other_step.apply(restored, draws)
    assert float(got["loss"]) == float(want["loss"])
    assert float(got["grad_norm"]) == float(want["grad_norm"])
    for a, b in zip(state.model.parameters(), restored.model.parameters()):
        assert torch.equal(a, b)
    assert all(torch.equal(state.ema_params[k], restored.ema_params[k]) for k in state.ema_params)


def test_max_to_keep_and_step_selection(tmp_path):
    state, _ = fresh(0)
    ckpt = Checkpointer(str(tmp_path), max_to_keep=3)
    snapshots = {}
    for s in (2, 4, 6, 8, 10):
        with torch.no_grad():
            next(state.model.parameters()).add_(1.0)
        state.step = s
        snapshots[s] = copy.deepcopy(next(state.model.parameters()).detach())
        ckpt.save(s, state, pose_params=GCNPose(BASIS, **CFG).state_dict())
    assert ckpt.all_steps() == [6, 8, 10] and ckpt.latest_step() == 10
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"ckpt_{s:08d}{suffix}.pth" for s in (6, 8, 10) for suffix in ("", ".pose"))
    other, _ = fresh(3)
    restored, pose = ckpt.restore(other, step=8)
    assert pose is None and restored.step == 8
    assert torch.equal(next(restored.model.parameters()), snapshots[8])
    unlimited = Checkpointer(str(tmp_path / "all"), max_to_keep=None)
    for s in range(5):
        unlimited.save(s, state)
    assert unlimited.all_steps() == list(range(5))


def test_checkpoint_file_is_a_reference_pth_and_empty_dir_raises(tmp_path):
    state, _ = fresh(0)
    ckpt = Checkpointer(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ckpt.restore(state)
    state.step = 5
    ckpt.save(5, state)
    model_state, optim_state, epoch, step, ema = load_torch_states(ckpt.path(5))
    fresh_model = GCNDiff(BASIS, **CFG)
    fresh_model.load_state_dict(model_state, strict=True)
    assert (epoch, step) == (0, 5) and set(ema) == set(dict(fresh_model.named_parameters()))
    assert optim_state["count"] == 0
    raw = torch.load(ckpt.path(5), map_location="cpu", weights_only=False)
    assert len(raw) == 5 and all(k.startswith("module.") for k in raw[0])
