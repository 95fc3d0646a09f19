"""The video family's data and context parallelism (diffpose_tpu_torch/parallel:
sharding.py's video steps, context.py's key/value gather) over a real
four-process gloo world on the CPU, on a (4,) data mesh, a (4,) context mesh
and a (2, 2) data x context grid: the context forward against the JAX
package's make_cp_video_forward, the sharded evals against its
make_sharded_video_eval_step and against the single-process eval, the
sharded train steps against the single-process step on the ranks' draws
joined along the windows and the frames, the draws' streams, gather_frames
through gradcheck, the refusals of the whole-window paths, and main_video
--data_parallel --context_parallel 2.

One world of 4 ranks runs once for the module (parallel/worker.py: the
"video" and "cli_video" tasks); every test reads its ranks' results."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffpose_tpu.parallel import make_mesh as j_make_mesh
from diffpose_tpu.parallel.context import make_cp_video_forward as j_make_cp_video_forward
from diffpose_tpu.parallel.sharding import make_sharded_video_eval_step as j_make_eval_step
from diffpose_tpu.train.state import TrainState as JTrainState
from diffpose_tpu_torch.data.video import synthetic_video_dataset
from diffpose_tpu_torch.parallel import worker
from diffpose_tpu_torch.parallel.context import gather_frames
from diffpose_tpu_torch.parallel.mesh import MeshAxis
from diffpose_tpu_torch.train import optim
from diffpose_tpu_torch.train.video_steps import make_video_train_step
from test_torch_models import CONFIGS
from test_torch_parallel import GRAD_ABS, GRAD_REL, TOL
from test_torch_train_step import E2E_EPS
from test_torch_video_models import video_pair
from test_torch_video_train import one_component_windows

torch.set_num_threads(1)

WORLD, FRAMES, WINDOWS, STEPS = 4, 8, 4, 2
CFG = dict(CONFIGS[0], frames=FRAMES)                  # hid 32, 2 layers, 4 heads
MESHES = [
    dict(name="data", sizes=(4,), names=("data",),
         train=[("fused", "masks"), ("fused", "prng"), ("module", "masks")],
         eval=["fused", "fused_st", "fused_full", "module"]),
    dict(name="context", sizes=(4,), names=("context",), train=[("module", "masks")],
         eval=["fused", "module"]),
    dict(name="grid", sizes=(2, 2), names=("data", "context"),
         train=[("module", "masks"), ("fused", "masks")], eval=["fused", "module", "fused_full"]),
]
CONTEXT_FORWARD_TOL = 5e-5      # tests/test_video.py holds the JAX context forward to 2e-5


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_video")
    jm, params, tm = video_pair(21, **CFG)
    data = synthetic_video_dataset(STEPS * WINDOWS, FRAMES, seed=0)
    rng = np.random.default_rng(0)
    spec = dict(device="cpu", backend="gloo", threads=1, lr=1e-3, eps=E2E_EPS, seed=7,
                exp=str(tmp / "exp"),
                video=dict(cfg=CFG, state=tm.state_dict(), batch=WINDOWS, steps=STEPS,
                           data={"poses_3d": data.poses_3d, "poses_2d_gmm": data.poses_2d_gmm},
                           meshes=MESHES,
                           eval=dict(batch=one_component_windows(FRAMES, WINDOWS), test_times=1),
                           forward=dict(x=rng.normal(size=(2, FRAMES, 17, 5)).astype(np.float32),
                                        t=np.asarray([3.0, 11.0], np.float32)),
                           gradcheck=True,
                           cli=dict(frames=FRAMES, windows=8, batch=4,
                                    flags=["--data_parallel", "--context_parallel", "2"])))
    torch.save(spec, tmp / "spec.pth")
    worker.spawn(WORLD, ["--spec", str(tmp / "spec.pth"), "--out", str(tmp), "--task", "video",
                         "--task", "cli_video"], tmp / "logs", env={"OMP_NUM_THREADS": "1"},
                 timeout=300)
    ranks = worker.load_ranks(tmp, WORLD)
    return dict(spec=spec, ranks=ranks, ref=worker.video_reference(spec, ranks, "cpu"),
                jax=(jm, params), exp=tmp / "exp")


def mesh_spec(name):
    return next(m for m in MESHES if m["name"] == name)


def joined(run, name, impl, key):
    part, d, c = worker.video_part(run["ranks"], mesh_spec(name), impl, train=False)
    return worker.join_blocks([r[f"video/{name}/eval/{impl}/{key}"] for r in part], d, c)


def test_context_forward_matches_jax_context_forward(run):
    """Each rank's frame block through make_cp_video_forward, joined, against
    the JAX package's make_cp_video_forward on the 8-device CPU mesh (one
    frame a device), on the (4,) context mesh and the grid's context pairs."""
    jm, params = run["jax"]
    fw = run["spec"]["video"]["forward"]
    fn = j_make_cp_video_forward(jm.clone(cp_axis="context"), j_make_mesh((8,), ("context",)))
    want = np.asarray(fn(params, jnp.asarray(fw["x"]), jnp.asarray(fw["t"])))
    for name, blocks in (("context", run["ranks"]), ("grid", run["ranks"][:2])):
        got = np.concatenate([r[f"video/{name}/forward"] for r in blocks], axis=1)
        np.testing.assert_allclose(got, want, atol=CONTEXT_FORWARD_TOL, err_msg=name)


@pytest.mark.parametrize("name", ["data", "context", "grid"])
def test_sharded_eval_matches_jax_sharded_eval(run, name):
    """The fused eval (row 3's plain version, keys and values gathered) over
    each mesh against the JAX package's make_sharded_video_eval_step on the
    same layout of the 8-device CPU mesh, the same converted weights."""
    jm, params = run["jax"]
    m = mesh_spec(name)
    mesh = j_make_mesh(m["sizes"], m["names"], devices=jax.devices()[:WORLD])
    cp = "context" if "context" in m["names"] else None
    step = j_make_eval_step(jm.clone(cp_axis=cp), worker.BETAS, worker.SEQ, mesh,
                            frames_total=FRAMES, data_axis="data" if "data" in m["names"] else None,
                            cp_axis=cp, mask=jnp.ones((1, 1, 17)))
    batch = {k: jnp.asarray(v) for k, v in run["spec"]["video"]["eval"]["batch"].items()}
    want = step(JTrainState.create(params, opt_state=(), ema_params=None), batch,
                jax.random.PRNGKey(0))
    for key, w in zip(("p1", "p2", "pred"), want):
        np.testing.assert_allclose(joined(run, name, "fused", key), np.asarray(w), atol=TOL,
                                   err_msg=key)


def test_sharded_evals_match_the_single_process_eval(run):
    """Every eval forward on every mesh, the ranks' [B_local, F_local] blocks
    joined, against the single-process eval of the whole batch, and where
    only the windows are split, bit for bit against that eval of each rank's
    windows alone."""
    for m in MESHES:
        for impl in m["eval"]:
            for key, atol in (("p1", 1e-6), ("p2", 1e-5), ("pred", 1e-6)):
                tag = f"video/{m['name']}/eval/{impl}/{key}"
                got = joined(run, m["name"], impl, key)
                np.testing.assert_allclose(got, run["ref"][tag], atol=atol, err_msg=tag)
                if m["name"] == "data" or impl in ("fused_st", "fused_full"):
                    assert np.array_equal(got, run["ref"][f"{tag}_shards"]), tag


@pytest.mark.parametrize("name", ["data", "context", "grid"])
def test_sharded_train_steps_match_the_single_process_step_on_the_joined_draws(run, name):
    """Loss within 1e-6 relative, every gradient entry within 1e-5 or 1e-3
    relative (summed over context, averaged over data: a missing sum over
    the ranks would leave the K/V projections' gradients 1/size too small),
    and the ranks' parameters equal, bit for bit."""
    ranks, ref = run["ranks"], run["ref"]
    for impl, dropout in mesh_spec(name)["train"]:
        tag = f"video/{name}/train/{impl}-{dropout}"
        part, _, _ = worker.video_part(ranks, mesh_spec(name), impl, train=True)
        for s in range(STEPS):
            for res in part:
                np.testing.assert_allclose(res[f"{tag}/step{s}/loss"], ref[f"{tag}/step{s}/loss"],
                                           rtol=1e-6, err_msg=f"{tag} step {s}")
                for k in (k for k in ref if k.startswith(f"{tag}/step{s}/grad/")):
                    d = float(np.abs(res[k] - ref[k]).max())
                    assert d < GRAD_ABS or d / (float(np.abs(ref[k]).max()) + 1e-8) < GRAD_REL, (k, d)
        for k in (k for k in ref if k.startswith(f"{tag}/params/")):
            assert all(np.array_equal(r[k], ranks[0][k]) for r in ranks), k
            np.testing.assert_allclose(ranks[0][k], ref[k], atol=1e-5, err_msg=k)


def test_draws_fold_the_data_coordinate_then_the_context_coordinate(run):
    """On the grid: every frame shard of a window has its timestep, the
    per-frame noise and the module's dropout seed differ from shard to shard;
    rank (d, c)'s draws are the step's draw with those coordinates, and at a
    context size of 1 the draws are the data-only step's bit for bit."""
    ranks, spec = run["ranks"], run["spec"]
    tag = "video/grid/train/module-masks/step0"
    assert [r["video/grid/coords"].tolist() for r in ranks] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    for d in (0, 1):
        a, b = ranks[2 * d], ranks[2 * d + 1]
        assert np.array_equal(a[f"{tag}/t"], b[f"{tag}/t"])
        assert not np.array_equal(a[f"{tag}/e"], b[f"{tag}/e"])
    assert len({int(r[f"{tag}/drop_seed"]) for r in ranks}) == WORLD
    tm = worker._video_model(spec, "cpu", "context")
    opt = optim.make_optimizer(tm.parameters(), lr=1e-3)
    batch = worker._video_batch(spec["video"], 0)
    for r, res in enumerate(ranks):
        d, c = divmod(r, 2)
        step = make_video_train_step(tm, opt, worker.BETAS, impl="module", device="cpu",
                                     data_axis=MeshAxis("data", None, d, 2),
                                     cp_axis=MeshAxis("context", None, c, 2))
        local = {k: v[2 * d:2 * d + 2, 4 * c:4 * c + 4] for k, v in batch.items()}
        draws = step.draw(local, torch.Generator().manual_seed(spec["seed"]))
        for key in ("x_t", "t", "e"):
            assert np.array_equal(getattr(draws, key).numpy(), res[f"{tag}/{key}"]), key
        assert draws.drop_seed == int(res[f"{tag}/drop_seed"])
    data = MeshAxis("data", None, 1, 2)
    local = {k: v[2:] for k, v in batch.items()}
    one, none = (make_video_train_step(tm, opt, worker.BETAS, impl="module", device="cpu",
                                       data_axis=data, cp_axis=cp).draw(
                     local, torch.Generator().manual_seed(3))
                 for cp in (MeshAxis("context", None, 0, 1), None))
    assert all(np.array_equal(getattr(one, k).numpy(), getattr(none, k).numpy())
               for k in ("x_t", "t", "e")) and one.drop_seed == none.drop_seed


def test_gather_frames_gradcheck_in_float64(run):
    """gather_frames through torch.autograd.gradcheck in float64 from one
    rank's view (its input and output count, the others send zeros), on the
    (4,) context mesh and the grid's context pairs; without a group it is the
    identity."""
    for name in ("context", "grid"):
        assert all(bool(r[f"video/{name}/gradcheck"]) for r in run["ranks"]), name
    x = torch.randn(2, 3, 4)
    assert gather_frames(x, None) is x and gather_frames(x, MeshAxis("context", None, 0, 1)) is x


def test_whole_window_paths_refuse_a_context_axis(run):
    for name in ("context", "grid"):
        for r in run["ranks"]:
            msgs = [str(m) for m in r[f"video/{name}/refused"]]
            assert len(msgs) == 3, msgs
            assert "only impl='module' trains" in msgs[0]
            assert all("owns whole windows" in m for m in msgs[1:]), msgs


def test_cli_data_and_context_parallel_in_the_world(run):
    """main_video --train --data_parallel --context_parallel 2 (a (2, 2) grid)
    and an eval-only run of its checkpoint: every rank returns 0, rank 0 alone
    writes the checkpoint."""
    ranks, exp = run["ranks"], run["exp"]
    for name in ("train", "eval"):
        assert [int(r[f"cli_video/{name}/rc"]) for r in ranks] == [0] * WORLD, name
    assert [int(r["cli_video/train/saves"]) for r in ranks] == [1, 0, 0, 0]
    assert {p.name for p in (exp / "vp").glob("ckpt_*")} == {"ckpt_00000002.pth"}
    assert "| Epoch 0000 |" in (exp / "vp" / "stdout.txt").read_text()
    assert "Final | MPJPE:" in (exp / "ve" / "stdout.txt").read_text()
