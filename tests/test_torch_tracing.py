"""The port's spans (``diffpose_tpu_torch/utils/profiling.py``) on the CPU:
the shared no-op without a profiler, and one ``evaluate`` of a tiny fused
eval runner of each family (the frame family's and the implicit one's, which
share the eval loop and the step's shell) under ``torch.profiler``: every
listed span but the other family's sampler's recorded and nested as the eval
path nests, on the clock of the operators it holds, and the outputs
bit-equal with and without the profiler."""

import collections
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from diffpose_tpu_torch import config as tconfig
from diffpose_tpu_torch.data.gmm import sample_gmm_batch_per_sample
from diffpose_tpu_torch.data.synthetic import make_synthetic_dataset
from diffpose_tpu_torch.diffusion import make_skip_sequence
from diffpose_tpu_torch.train.implicit_runner import ImplicitRunner
from diffpose_tpu_torch.train.trainer import DiffposeRunner
from diffpose_tpu_torch.utils import SPANS, span

torch.set_num_threads(1)

NAMES = {s[0] for s in SPANS}
SOLVER = {s[0] for s in SPANS if s[1] == "solver"}   # the implicit family's sampler's
DENOISER = {s[0] for s in SPANS if s[1] == "denoiser"}   # the video family's MixSTE's
# the spans only one family's sampler opens
OWN = {"frame": {"diffusion.step"}, "implicit": SOLVER}
# the prefixes of the benchmark's profiled slice that are not operators
NOT_OPERATORS = ("cuda", "Activity Buffer", "Runtime Triggered", "Lazy Function",
                 "ProfilerStep", "Memcpy", "Memset")
DOTTED = re.compile(r"^[a-z]+\.[a-z]+$")


def tiny_runner(family="frame"):
    cfg = tconfig.Config(
        model=tconfig.ModelConfig(hid_dim=32, num_layer=2, n_head=4),
        training=tconfig.TrainingConfig(batch_size=16, n_epochs=1),
        testing=tconfig.TestingConfig(test_times=2, test_timesteps=2,
                                      test_num_diffusion_timesteps=12),
        optim=tconfig.OptimConfig(lr=1e-3))
    if family == "frame":
        runner = DiffposeRunner(cfg, seed=3, device="cpu", denoiser_impl="fused")
    else:
        cfg.implicit = tconfig.ImplicitConfig(max_iterations=6, min_iterations=3)
        runner = ImplicitRunner(cfg, seed=3, device="cpu", denoiser_impl="fused")
    runner.create_diffusion_model()
    runner.create_pose_model()
    runner.set_data(None, make_synthetic_dataset(num_frames=48, seed=1))
    return runner


def records(prof):
    return [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()]


@pytest.fixture(scope="module", params=sorted(OWN))
def traced(request):
    """One warm ``evaluate`` of the family's tiny runner, then one under the
    profiler: ``(runner, its records, the errors without and with the
    profiler)``; ``runner.family`` names the family."""
    runner = tiny_runner(request.param)
    runner.family = request.param
    plain = runner.evaluate(is_train=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        under = runner.evaluate(is_train=True)
    return runner, records(prof), plain, under


def test_span_is_one_shared_no_op_without_a_profiler():
    assert span("a") is span("b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        inside = span("inside.on")
        with inside:
            torch.ones(2) + 1
    assert inside is not span("a")
    with span("after.off"):
        torch.ones(2) + 1
    names = [n for n, _, _ in records(prof)]
    assert "inside.on" in names and "after.off" not in names
    # the listed names: unique, plain dotted words, none the slice drops as a non-operator
    assert len(NAMES) == len(SPANS)
    assert all(DOTTED.match(n) and not n.startswith(NOT_OPERATORS) for n in NAMES)
    assert {layer for _, layer, _ in SPANS} == {"loader", "runner", "step", "metrics", "solver",
                                                "denoiser"}


def test_every_span_recorded_and_nested(traced):
    runner, recs, _, _ = traced
    others = set().union(DENOISER, *(v for k, v in OWN.items() if k != runner.family))
    spans = [r for r in recs if r[0] in NAMES]
    count = collections.Counter(n for n, _, _ in spans)
    assert set(count) == NAMES - others
    assert {n for n, _, _ in recs if DOTTED.match(n)} <= NAMES   # no program span unlisted
    batches = len(runner._make_loader(runner.test_data, shuffle=False, keyed=False))
    assert count["runner.prepare"] == 1
    assert all(count[n] == batches
               for n in NAMES - SOLVER - DENOISER - {"runner.prepare", "diffusion.step"})

    def by(name):
        return [(s, e) for n, s, e in spans if n == name]

    def inside(name, outer):
        return all(any(os <= s and e <= oe for os, oe in by(outer)) for s, e in by(name))

    assert inside("step.eval", "runner.batch") and inside("metrics.errors", "step.eval")
    assert inside("runner.sync", "runner.batch") and inside("metrics.accumulate", "runner.batch")
    assert all(inside(n, "step.eval") for n in OWN[runner.family])
    assert inside("step.gmm", "step.eval")
    # the loader's span is closed before its yield: outside every runner.batch
    assert all(e <= bs or be <= s for s, e in by("loader.batch") for bs, be in by("runner.batch"))


def test_one_diffusion_step_span_per_ddim_step(traced):
    """The sampler's own spans in each step: one ``diffusion.step`` a DDIM
    step (frame), one ``solver.mix`` a body of the batch's solve (implicit)."""
    runner, recs, _, _ = traced
    t = runner.config.testing
    seq = make_skip_sequence(runner.skip_type, t.test_timesteps, t.test_num_diffusion_timesteps)
    steps = [(s, e) for n, s, e in recs if n == "step.eval"]
    name, want = (("diffusion.step", [len(seq)] * len(steps)) if runner.family == "frame" else
                  ("solver.mix", runner.fp_iterations))
    assert len(want) == len(steps)
    for (s, e), w in zip(steps, want):
        assert sum(n == name and s <= a and b <= e for n, a, b in recs) == w


def test_gmm_operators_inside_the_gmm_span(traced):
    """The shared clock: every operator the GMM draw issues (as a profile of
    the draw alone names them) starts and ends inside ``step.gmm``."""
    runner, recs, _, _ = traced
    batch = next(runner._make_loader(runner.test_data, shuffle=False, keyed=False).epoch(0))
    args = [torch.as_tensor(batch[k]) for k in ("seeds", "poses_2d_gmm", "poses_3d")]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sample_gmm_batch_per_sample(0, *args)
    alone = collections.Counter(n for n, _, _ in records(prof) if n.startswith("aten::"))
    assert alone
    for s, e in [(s, e) for n, s, e in recs if n == "step.gmm"]:
        ops = [(n, a, b) for n, a, b in recs if n.startswith("aten::") and s <= a < e]
        assert collections.Counter(n for n, _, _ in ops) == alone
        assert all(b <= e for _, _, b in ops)


def test_outputs_bit_equal_under_the_profiler(traced):
    runner, _, plain, under = traced
    assert plain == under
    eval_fn = next(iter(runner._eval_cache.values()))
    prepared = eval_fn.prepare(runner.state, runner.pose_params)
    batch = next(runner._make_loader(runner.test_data, shuffle=False, keyed=False).epoch(0))
    off = eval_fn(runner.state, runner.pose_params, batch, runner.generator, prepared=prepared)
    with profile(activities=[ProfilerActivity.CPU]):
        on = eval_fn(runner.state, runner.pose_params, batch, runner.generator, prepared=prepared)
    assert len(off) == len(on) == (3 if runner.family == "frame" else 4)
    assert all(torch.equal(a, b) for a, b in zip(off[:3], on[:3]))   # p1, p2 and the poses
    assert off[3:] == on[3:]                                           # the solve's iterations
