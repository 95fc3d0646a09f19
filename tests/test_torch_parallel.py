"""The port's parallel layer (diffpose_tpu_torch/parallel) over a real
two-process gloo world on the CPU: the mesh, the sharded frame train step
and sweep against the single-process step on the concatenated draws, the
sharded and hypothesis-parallel evals against the single-process eval and
against the JAX package's make_sharded_eval_step on the 8-device CPU mesh,
and the command line with --data_parallel / --hypothesis_parallel 2.

One world of 2 ranks runs once for the module (parallel/worker.py: the
"frame" and "cli_frame" tasks); every test reads its ranks' results."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffpose_tpu.parallel import make_mesh as j_make_mesh
from diffpose_tpu.parallel import make_sharded_eval_step as j_make_sharded_eval_step
from diffpose_tpu.parallel import shard_batch as j_shard_batch
from diffpose_tpu.train.state import TrainState as JTrainState
from diffpose_tpu_torch.data.synthetic import make_synthetic_dataset
from diffpose_tpu_torch.parallel import worker
from diffpose_tpu_torch.parallel.mesh import MeshAxis
from diffpose_tpu_torch.parallel.sharding import Shard, fold_in
from diffpose_tpu_torch.train.steps import make_draw
from test_torch_models import CONFIGS, flax_pair
from test_torch_train_step import E2E_EPS

torch.set_num_threads(1)

CFG = CONFIGS[0]                                   # hid 32, 2 layers, 4 heads
WORLD, B, STEPS, SWEEP, EVAL_B = 2, 16, 2, 2, 16
TRAIN = [("fused", "masks"), ("plain", "masks"), ("fused", "prng")]
TOL = 2e-4                                         # the eval pipeline's (tests/test_pallas_pipeline.py)
GRAD_ABS, GRAD_REL = 1e-5, 1e-3                    # tests/test_pallas_train.py:64-71


def eval_batch():
    """Frames whose GMM puts its whole weight on one kernel, so the two
    packages' different generators pick the same (test_torch_eval_step.py)."""
    data = make_synthetic_dataset(num_frames=EVAL_B, seed=3)
    gmm = data.poses_2d_gmm.copy()
    gmm[..., 0] = 0.0
    gmm[..., 2, 0] = 1.0
    return {"poses_3d": data.poses_3d, "poses_2d_gmm": gmm,
            "seeds": np.arange(EVAL_B, dtype=np.int32) * 7919 - 5}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    jd, pd, td = flax_pair(CFG, 0, with_temb=True)
    jp, pp, tp = flax_pair(CFG, 1, with_temb=False)
    data = make_synthetic_dataset(num_frames=64, seed=0)
    spec = dict(device="cpu", backend="gloo", threads=1, cfg=CFG, diff=td.state_dict(),
                pose=tp.state_dict(), batch=B, steps=STEPS, lr=1e-3, eps=E2E_EPS, seed=7,
                data={"poses_3d": data.poses_3d, "poses_2d_gmm": data.poses_2d_gmm},
                train_impls=TRAIN, sweep=SWEEP,
                sweep_idx=np.random.default_rng(0).integers(0, 64, (SWEEP, B)),
                eval=dict(batch=eval_batch(), test_times=[1, 2], hyp_test_times=[2],
                          impl="fused"),
                exp=str(tmp / "exp"))
    torch.save(spec, tmp / "spec.pth")
    worker.spawn(WORLD, ["--spec", str(tmp / "spec.pth"), "--out", str(tmp), "--task", "frame",
                         "--task", "cli_frame"], tmp / "logs", env={"OMP_NUM_THREADS": "1"},
                 timeout=300)
    ranks = worker.load_ranks(tmp, WORLD)
    return dict(spec=spec, ranks=ranks, ref=worker.frame_reference(spec, ranks, "cpu"),
                jax=(jd, pd, jp, pp), exp=tmp / "exp")


def grads_close(got: dict, want: dict, prefix: str):
    for k in (k for k in want if k.startswith(prefix)):
        d = float(np.abs(got[k] - want[k]).max())
        assert d < GRAD_ABS or d / (float(np.abs(want[k]).max()) + 1e-8) < GRAD_REL, (k, d)


def test_make_mesh_coordinates_and_refusal(run):
    for r, res in enumerate(run["ranks"]):
        assert res["mesh/data"].tolist() == [r, WORLD]
        # (data, hypothesis) coordinates and sizes of the (1, 2) grid
        assert res["mesh/grid"].tolist() == [0, r, 1, 2]
        assert str(res["mesh/refused"]) == f"mesh ({WORLD + 1},) != {WORLD} ranks"
    assert Shard(1, 4).rows(16) == slice(4, 8)
    with pytest.raises(AssertionError, match="equal shards"):
        Shard(0, 3).rows(16)


@pytest.mark.parametrize("impl,dropout", TRAIN, ids=lambda v: str(v))
def test_sharded_train_step_matches_single_process_on_the_concatenated_draws(run, impl, dropout):
    ranks, ref = run["ranks"], run["ref"]
    tag = f"frame/{impl}-{dropout}"
    for s in range(STEPS):
        for res in ranks:
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(res[f"{tag}/step{s}/{k}"], ref[f"{tag}/step{s}/{k}"],
                                           rtol=1e-5, err_msg=f"{tag} step {s} {k}")
            grads_close(res, ref, f"{tag}/step{s}/grad/")
    params = [k for k in ref if k.startswith(f"{tag}/params/")]
    for k in params:
        # replicated: both ranks hold the same parameters, bit for bit
        assert np.array_equal(ranks[0][k], ranks[1][k]), k
        np.testing.assert_allclose(ranks[0][k], ref[k], atol=1e-5, err_msg=k)


def test_sharded_sweep_matches_single_process(run):
    ranks, ref = run["ranks"], run["ref"]
    tag = f"frame/sweep-{TRAIN[0][0]}-{TRAIN[0][1]}"
    for res in ranks:
        np.testing.assert_allclose(res[f"{tag}/loss"],
                                   [ref[f"{tag}/step{s}/loss"] for s in range(SWEEP)], rtol=1e-5)
    for k in (k for k in ref if k.startswith(f"{tag}/params/")):
        assert np.array_equal(ranks[0][k], ranks[1][k]), k
        np.testing.assert_allclose(ranks[0][k], ref[k], atol=1e-5, err_msg=k)


def test_draws_are_keyed_by_the_data_coordinate(run):
    """Rank r's draws are the step's draw from the generator folded with r:
    the same here from the same seed; the two ranks' noise differs."""
    spec, ranks = run["spec"], run["ranks"]
    tag = "frame/fused-prng/step0"
    for r, res in enumerate(ranks):
        draw = make_draw(worker.BETAS, torch.device("cpu"), **{k: CFG[k] for k in CFG},
                         dropout="prng", masks_dtype=torch.uint8, axis=MeshAxis("data", None, r, 2))
        rows = slice(r * B // 2, (r + 1) * B // 2)
        batch = {k: v[rows] for k, v in worker._global_batch(spec, 0).items()}
        d = draw(batch, torch.Generator().manual_seed(spec["seed"]))
        for key, v in (("e", d.e), ("t", d.t), ("seed", d.seed)):
            assert np.array_equal(v.numpy(), res[f"{tag}/{key}"]), key
    assert ranks[0][f"{tag}/seed"] != ranks[1][f"{tag}/seed"]
    g = torch.Generator().manual_seed(1)
    a = fold_in(g, 0).initial_seed()
    assert fold_in(torch.Generator().manual_seed(1), 0).initial_seed() == a
    assert fold_in(torch.Generator().manual_seed(1), 1).initial_seed() != a
    assert fold_in(g, 0).initial_seed() != a            # the generator moved on


@pytest.mark.parametrize("name,tt", [("data", 1), ("data", 2), ("grid", 2)],
                         ids=["data-tt1", "data-tt2", "hypothesis-tt2"])
def test_sharded_eval_matches_single_process(run, name, tt):
    ranks, ref = run["ranks"], run["ref"]
    tag = f"frame/eval-{name}/tt{tt}"
    # the grid is (1, 2): each rank holds every frame, the mean over both
    parts = [[0, 1]] if name == "data" else [[0], [1]]
    for sel in parts:
        for key, atol in (("p1", 1e-6), ("p2", 1e-5), ("pred", 1e-6)):
            np.testing.assert_allclose(worker.gathered(ranks, f"{tag}/{key}", sel),
                                       ref[f"{tag}/{key}"], atol=atol, err_msg=f"{tag} {key}")


@pytest.mark.parametrize("hyp", [False, True], ids=["data", "hypothesis"])
def test_sharded_eval_matches_jax_sharded_eval(run, hyp):
    """The JAX package's make_sharded_eval_step on the 8-device CPU mesh
    ((8,) data, or (4, 2) data x hypothesis), the same converted weights."""
    jd, pd, jp, pp = run["jax"]
    mesh = j_make_mesh((4, 2), ("data", "hypothesis")) if hyp else j_make_mesh()
    step = j_make_sharded_eval_step(jd, jp, worker.BETAS, worker.SEQ, mesh, test_times=2,
                                    mask=jnp.ones((1, 1, 17)),
                                    hyp_axis="hypothesis" if hyp else None)
    batch = j_shard_batch(mesh, {k: jnp.asarray(v) for k, v in eval_batch().items()})
    want = step(JTrainState.create(pd, opt_state=(), ema_params=None), pp, batch,
                jax.random.PRNGKey(0))
    tag = f"frame/eval-{'grid' if hyp else 'data'}/tt2"
    for key, w in zip(("p1", "p2", "pred"), want):
        got = worker.gathered(run["ranks"], f"{tag}/{key}", [0] if hyp else None)
        np.testing.assert_allclose(got, np.asarray(w), atol=TOL, err_msg=key)


def test_cli_data_and_hypothesis_parallel_over_two_ranks(run):
    """main_frame --train --data_parallel, --resume, and an eval-only run with
    --hypothesis_parallel 2: every rank returns 0, rank 0 alone writes."""
    ranks, exp = run["ranks"], run["exp"]
    for name in ("train", "resume", "hyp_eval"):
        assert [int(r[f"cli_frame/{name}/rc"]) for r in ranks] == [0, 0], name
    for name in ("train", "resume"):
        assert [int(r[f"cli_frame/{name}/saves"]) for r in ranks] == [1, 0], name
    log = (exp / "dp" / "stdout.txt").read_text()
    assert "resumed from step 2 (epoch 1)" in log and log.count("| Epoch 00") == 2
    assert len((exp / "dp" / "log.tsv").read_text().splitlines()) == 3
    assert {p.name for p in (exp / "dp").glob("ckpt_*")} == {
        "ckpt_00000002.pth", "ckpt_00000002.pose.pth", "ckpt_00000004.pth",
        "ckpt_00000004.pose.pth"}
    assert "Final | MPJPE:" in (exp / "hp" / "stdout.txt").read_text()
