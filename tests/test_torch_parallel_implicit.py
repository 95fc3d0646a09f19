"""The implicit (IGCN) family's sharded steps over a real two-process gloo
world on the CPU: the train step against the mean of per-shard steps (each
rank's BatchNorm normalises with its own batch statistics, and the buffers
it writes are averaged), the warm-started sweep, the fixed-count eval
against the single-process eval and the JAX package's
make_sharded_implicit_eval_step on the 8-device CPU mesh, and
main_implicit / compare with --data_parallel and --hypothesis_parallel 2.

One world of 2 ranks runs once for the module (parallel/worker.py: the
"implicit" and "cli_implicit" tasks); every test reads its ranks' results."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffpose_tpu.parallel import make_mesh as j_make_mesh
from diffpose_tpu.parallel import shard_batch as j_shard_batch
from diffpose_tpu.parallel.sharding import make_sharded_implicit_eval_step as j_make_eval_step
from diffpose_tpu.train.state import TrainState as JTrainState
from diffpose_tpu_torch.data.synthetic import make_synthetic_dataset
from diffpose_tpu_torch.parallel import worker
from test_torch_igcn import CFG, igcn_pair
from test_torch_models import flax_pair
from test_torch_parallel import TOL, eval_batch, grads_close
from test_torch_train_step import E2E_EPS

torch.set_num_threads(1)

WORLD, B, STEPS, SWEEP, ITERS = 2, 16, 2, 2, 4
SOLVER = dict(solver="damped", max_iterations=ITERS, min_iterations=ITERS)
IMPLS = ("fused", "module")
BN = ("running_mean", "running_var")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_implicit")
    jm, variables, tm = igcn_pair(2, **SOLVER)
    jp, pp, tp = flax_pair(CFG, 3, with_temb=False)
    data = make_synthetic_dataset(num_frames=64, seed=0)
    spec = dict(device="cpu", backend="gloo", threads=1, cfg=CFG, igcn=tm.state_dict(),
                igcn_solver=dict(SOLVER, tolerance=0.05), pose=tp.state_dict(), batch=B,
                steps=STEPS, lr=1e-3, eps=E2E_EPS, seed=11,
                data={"poses_3d": data.poses_3d, "poses_2d_gmm": data.poses_2d_gmm},
                implicit_impls=IMPLS, sweep=SWEEP,
                sweep_idx=np.random.default_rng(1).integers(0, 64, (SWEEP, B)),
                eval=dict(batch=eval_batch(), test_times=[1, 2], iterations=ITERS,
                          impl="fused"),
                exp=str(tmp / "exp"))
    torch.save(spec, tmp / "spec.pth")
    worker.spawn(WORLD, ["--spec", str(tmp / "spec.pth"), "--out", str(tmp), "--task",
                         "implicit", "--task", "cli_implicit"], tmp / "logs",
                 env={"OMP_NUM_THREADS": "1"}, timeout=300)
    ranks = worker.load_ranks(tmp, WORLD)
    return dict(ranks=ranks, ref=worker.implicit_reference(spec, ranks, "cpu"),
                jax=(jm, variables, jp, pp), exp=tmp / "exp")


@pytest.mark.parametrize("impl", IMPLS)
def test_sharded_implicit_step_is_the_mean_of_the_shards_steps(run, impl):
    ranks, ref = run["ranks"], run["ref"]
    tag = f"implicit/{impl}"
    for s in range(STEPS):
        for res in ranks:
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(res[f"{tag}/step{s}/{k}"], ref[f"{tag}/step{s}/{k}"],
                                           rtol=1e-5, err_msg=f"{tag} step {s} {k}")
            grads_close(res, ref, f"{tag}/step{s}/grad/")
    for k in (k for k in ref if k.startswith(f"{tag}/params/")):
        assert np.array_equal(ranks[0][k], ranks[1][k]), k
        np.testing.assert_allclose(ranks[0][k], ref[k], atol=1e-5, err_msg=k)


@pytest.mark.parametrize("impl", IMPLS)
def test_batchnorm_buffers_equal_on_both_ranks_and_the_reduced_value(run, impl):
    ranks, ref = run["ranks"], run["ref"]
    for s in range(STEPS):
        for k in BN:
            key = f"implicit/{impl}/step{s}/{k}"
            assert np.array_equal(ranks[0][key], ranks[1][key]), key
            np.testing.assert_allclose(ranks[0][key], ref[key], atol=1e-6, err_msg=key)
    # the buffers moved: each shard's batch statistics differ, their mean is kept
    assert float(np.abs(ranks[0][f"implicit/{impl}/step0/running_var"] - 1).max()) > 1e-3


def test_solver_telemetry_is_reduced(run):
    for impl in IMPLS:
        for s in range(STEPS):
            it = [float(r[f"implicit/{impl}/step{s}/fp_iterations"]) for r in run["ranks"]]
            res = [float(r[f"implicit/{impl}/step{s}/fp_residual"]) for r in run["ranks"]]
            assert it == [ITERS, ITERS] and res[0] == res[1] and np.isfinite(res[0])


def test_warm_started_sweep_equals_single_sharded_steps(run):
    for res in run["ranks"]:
        assert res["implicit/sweep/sweep/fixed_point"].shape == (B // WORLD, 17, CFG["hid_dim"])
        for k in (k for k in res if k.startswith("implicit/sweep/sweep/")):
            assert np.array_equal(res[k], res[k.replace("/sweep/sweep/", "/sweep/steps/")]), k
    k = "implicit/sweep/sweep/fixed_point"
    assert not np.array_equal(run["ranks"][0][k], run["ranks"][1][k])   # each rank's own slice


@pytest.mark.parametrize("tt", [1, 2])
def test_sharded_implicit_eval_matches_single_process(run, tt):
    ranks, ref = run["ranks"], run["ref"]
    tag = f"implicit/eval/tt{tt}"
    for key, atol in (("p1", 1e-6), ("p2", 1e-5), ("pred", 1e-6)):
        np.testing.assert_allclose(worker.gathered(ranks, f"{tag}/{key}"), ref[f"{tag}/{key}"],
                                   atol=atol, err_msg=key)
    assert [r[f"{tag}/iters"].tolist() for r in ranks] == [[ITERS], [ITERS]]


def test_sharded_implicit_eval_matches_jax_sharded_eval(run):
    """make_sharded_implicit_eval_step on the 8-device CPU mesh, damped at a
    fixed count, the same converted weights."""
    jm, variables, jp, pp = run["jax"]
    mesh = j_make_mesh()
    step = j_make_eval_step(jm, jp, mesh, t_infer=12, test_times=2)
    batch = j_shard_batch(mesh, {k: jnp.asarray(v) for k, v in eval_batch().items()})
    state = JTrainState.create(variables["params"], opt_state=(),
                               model_state=variables["batch_stats"])
    want = step(state, pp, batch, jax.random.PRNGKey(0))
    for key, w in zip(("p1", "p2", "pred"), want[:3]):
        np.testing.assert_allclose(worker.gathered(run["ranks"], f"implicit/eval/tt2/{key}"),
                                   np.asarray(w), atol=TOL, err_msg=key)
    assert np.asarray(want[3]).tolist() == [ITERS] * 8


def test_cli_implicit_and_compare_over_two_ranks(run):
    ranks, exp = run["ranks"], run["exp"]
    for name in ("train", "hyp_eval", "compare"):
        assert [int(r[f"cli_implicit/{name}/rc"]) for r in ranks] == [0, 0], name
    assert [int(r["cli_implicit/train/saves"]) for r in ranks] == [1, 0]
    log = (exp / "ip" / "stdout.txt").read_text()
    assert "mean fp iterations" in log and len((exp / "ip" / "log.tsv").read_text().splitlines()) == 2
    cmp = (exp / "cmp" / "stdout.txt").read_text()
    assert "[diffusion] MPJPE" in cmp and "[implicit] MPJPE" in cmp
    assert "Final | MPJPE:" in (exp / "ih" / "stdout.txt").read_text()
