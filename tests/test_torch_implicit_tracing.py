"""The implicit family's spans (``utils/profiling.py``) on the CPU: one eval
batch of ``make_implicit_eval_step`` under ``torch.profiler`` records
``step.eval`` once and the solver's ``solver.f`` / ``solver.mix`` /
``solver.test`` once an evaluation of the map (before the loop and after
each body that moved ``z``), a body and a host read (one a body);
``ImplicitRunner``'s evaluate records its ``runner.prepare`` and
``runner.readback``; nothing is recorded without a session."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from diffpose_tpu_torch import config as tconfig
from diffpose_tpu_torch.data.synthetic import make_synthetic_dataset
from diffpose_tpu_torch.graph import H36M_EDGES, cheb_basis_from_edges
from diffpose_tpu_torch.models import GCNPose, IGCN
from diffpose_tpu_torch.models.solvers import solve_damped
from diffpose_tpu_torch.train.implicit_runner import ImplicitRunner
from diffpose_tpu_torch.train.implicit_steps import make_implicit_eval_step
from diffpose_tpu_torch.train.state import TrainState
from diffpose_tpu_torch.utils import SPANS, span

torch.set_num_threads(1)

BASIS = cheb_basis_from_edges(17, H36M_EDGES, 2).astype(np.float32)
SOLVER_SPANS = ("solver.f", "solver.mix", "solver.test")
MAX, MIN = 6, 3


def names(prof):
    return [e.name() for e in prof.profiler.kineto_results.events()]


def spans_of(prof):
    return [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.name() in {s[0] for s in SPANS}]


def eval_setup(impl, tol):
    torch.manual_seed(0)
    model = IGCN(BASIS, hid_dim=32, num_layers=2, num_heads=4, max_iterations=MAX,
                 min_iterations=MIN, tolerance=tol).eval()
    pose = GCNPose(BASIS, hid_dim=32, num_layers=2, num_heads=4).eval()
    step = make_implicit_eval_step(model, pose, t_infer=12, test_times=2, impl=impl, device="cpu")
    data = make_synthetic_dataset(num_frames=8, seed=1)
    batch = {"poses_3d": data.poses_3d, "poses_2d_gmm": data.poses_2d_gmm,
             "seeds": np.arange(8, dtype=np.int32)}
    state = TrainState.create(model, None, None)
    return step, state, pose, batch


def test_solver_spans_are_listed():
    layers = {name: layer for name, layer, _ in SPANS}
    assert all(layers.get(n) == "solver" for n in SOLVER_SPANS)


# tol 0.1: the solve stops at min_iterations (its stalls read 0); tol 0: it runs every body.
# At m=5 bodies 0 and 5 move z and the others stall, so f runs 2 and 3 times.
@pytest.mark.parametrize("impl", ["fused", "module"])
@pytest.mark.parametrize("tol", [0.1, 0.0])
def test_one_eval_batch_records_the_solver(impl, tol):
    step, state, pose, batch = eval_setup(impl, tol)
    prepared = step.prepare(state, pose)
    step(state, pose, batch, prepared=prepared)                 # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        *_, iterations = step(state, pose, batch, prepared=prepared)
    got = names(prof)
    assert iterations == (MIN if tol else MAX)
    assert got.count("step.eval") == 1
    assert got.count("solver.f") == 1 + len(range(0, iterations, 5)) == (2 if tol else 3)
    assert got.count("solver.mix") == iterations
    assert got.count("solver.test") == iterations
    for n in ("step.inputs", "step.gmm", "metrics.errors"):
        assert got.count(n) == 1
    recs = spans_of(prof)
    (outer,) = [(s, e) for n, s, e in recs if n == "step.eval"]
    assert all(outer[0] <= s and e <= outer[1] for n, s, e in recs if n in SOLVER_SPANS)


@pytest.mark.parametrize("tol,maps", [(0.1, 2), (0.0, 3)])
def test_solver_maps_reader_counts_the_maps_a_batch(tol, maps):
    """``portbench/metrics/solver_maps.implicit.py`` on two profiled eval
    batches: the whole ``solver.f`` spans over the ``step.eval`` spans."""
    from portbench.harness import core

    step, state, pose, batch = eval_setup("fused", tol)
    prepared = step.prepare(state, pose)
    step(state, pose, batch, prepared=prepared)                 # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            step(state, pose, batch, prepared=prepared)
    reader = core.load_file(core.BENCH_DIR / "metrics" / "solver_maps.implicit.py",
                            "t_solver_maps")
    slice_ = SimpleNamespace(host_ops=spans_of(prof), device_events=[])
    assert reader.read(SimpleNamespace(slice=slice_)) == maps
    assert reader.read(SimpleNamespace(slice=None)) is None


def test_damped_solve_records_the_solver():
    a = torch.eye(12, dtype=torch.float64) * 0.5

    def f(z):
        return z @ a + 1.0, None

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, aux, _ = solve_damped(f, torch.zeros(3, 12, dtype=torch.float64), 0.0,
                                 max_iterations=5, min_iterations=2)
    got = names(prof)
    assert aux["iterations"] == 5
    assert got.count("solver.f") == 5 and got.count("solver.mix") == 5
    assert got.count("solver.test") == 5 - 2 + 1


def test_nothing_recorded_without_a_session():
    step, state, pose, batch = eval_setup("fused", 0.1)
    assert span("solver.f") is span("solver.test")           # the shared no-op
    out = step(state, pose, batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(2) + 1
    assert not set(names(prof)) & {s[0] for s in SPANS}
    with profile(activities=[ProfilerActivity.CPU]):
        on = step(state, pose, batch)
    assert all(torch.equal(a, b) for a, b in zip(out[:3], on[:3])) and out[3] == on[3]


def test_runner_records_prepare_and_readback():
    cfg = tconfig.Config(
        model=tconfig.ModelConfig(hid_dim=32, num_layer=2, n_head=4),
        implicit=tconfig.ImplicitConfig(max_iterations=MAX, min_iterations=MIN),
        training=tconfig.TrainingConfig(batch_size=16, n_epochs=1),
        testing=tconfig.TestingConfig(test_times=2, test_num_diffusion_timesteps=12),
        optim=tconfig.OptimConfig(lr=1e-3))
    runner = ImplicitRunner(cfg, seed=3, device="cpu", denoiser_impl="fused")
    runner.create_diffusion_model()
    runner.create_pose_model()
    runner.set_data(None, make_synthetic_dataset(num_frames=40, seed=1))
    runner.evaluate(is_train=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runner.evaluate(is_train=True)
    got = names(prof)
    batches = len(runner.fp_iterations)
    assert batches == 3
    assert got.count("runner.prepare") == 1
    assert got.count("runner.readback") == batches == got.count("step.eval")
    assert got.count("solver.mix") == sum(runner.fp_iterations)
