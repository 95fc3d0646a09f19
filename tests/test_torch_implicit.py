"""Port implicit steps, runner and CLI vs the JAX package
(diffpose_tpu/train/implicit_steps.py, train/implicit_runner.py,
cli/main_implicit.py, cli/compare.py), on the CPU."""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from diffpose_tpu.models.ema import ema_update as j_ema_update
from diffpose_tpu.ops import train_ref as jref
from diffpose_tpu.ops.pallas_igcn_train import make_pallas_igcn_train_fn
from diffpose_tpu.train import optim as joptim
from diffpose_tpu.train.implicit_steps import make_implicit_eval_step as j_make_eval_step
from diffpose_tpu.train.state import TrainState as JTrainState
from diffpose_tpu_torch.cli import compare, main_implicit
from diffpose_tpu_torch.data.synthetic import make_synthetic_dataset
from diffpose_tpu_torch.diffusion import get_beta_schedule
from diffpose_tpu_torch.models import convert
from diffpose_tpu_torch.models.ema import ema_register
from diffpose_tpu_torch.ops import fused_denoiser as fd
from diffpose_tpu_torch.train import optim
from diffpose_tpu_torch.train.implicit_steps import (
    make_implicit_eval_step,
    make_implicit_train_step,
    make_implicit_train_sweep_step,
    progressive_tolerance,
)
from diffpose_tpu_torch.train.state import TrainState
from test_torch_eval_step import one_component_batch
from test_torch_igcn import CFG, igcn_pair
from test_torch_models import BASIS, flax_pair
from test_torch_train_step import E2E_EPS

torch.set_num_threads(1)

BETAS = get_beta_schedule("linear", beta_start=1e-4, beta_end=1e-3, num_diffusion_timesteps=51)
DATA = make_synthetic_dataset(num_frames=32, seed=0)
B = 8
L, HID = CFG["num_layers"], CFG["hid_dim"]
IPOSE = "configs/human36m_ipose.yml"


def batch_of(i):
    sl = slice(i * B, (i + 1) * B)
    return {"poses_3d": DATA.poses_3d[sl], "poses_2d_gmm": DATA.poses_2d_gmm[sl]}


def port_state(tm, impl, dropout="masks", **kw):
    model = copy.deepcopy(tm).train()
    opt = optim.make_optimizer(model.parameters(), lr=1e-3, eps=E2E_EPS)
    state = TrainState.create(model, opt, ema_register(model))
    return state, make_implicit_train_step(model, opt, BETAS, impl=impl, dropout=dropout,
                                           device="cpu", **kw)


def jax_masks_of(m):
    """The port's batch-major masks in the JAX package's joint-major layout."""
    return jref.DropoutMasks(
        probs=jnp.asarray(m.probs.permute(0, 3, 4, 1, 2).float().numpy()),
        **{k: jnp.asarray(getattr(m, k).permute(0, 2, 1, 3).float().numpy())
           for k in ("attn_out", "gnet_out", "cheb1", "cheb2")})


def test_progressive_tolerance_matches_the_jax_step():
    sched = (0.1, 0.05, 7)
    for step in (0, 1, 3, 7, 100):
        frac = jnp.clip(jnp.asarray(step, jnp.int32).astype(jnp.float32) / max(sched[2], 1), 0.0, 1.0)
        want = float(sched[0] + (sched[1] - sched[0]) * frac)
        assert progressive_tolerance(step, sched) == want


@pytest.mark.parametrize("impl", ["module", "fused"])
def test_one_implicit_step_matches_jax(impl):
    """One step, the draws handed to both: the JAX train fn over its oracle
    stack, optax's Adam and the EMA, against the port's step."""
    jm, variables, tm = igcn_pair(0, solver="damped", max_iterations=3, min_iterations=2)
    state, step = port_state(tm, impl, tol_schedule=(0.1, 0.05, 10))
    d = step.draw(batch_of(0), torch.Generator().manual_seed(0))
    state, metrics = step.apply(state, d)

    basis = jnp.asarray(BASIS, jnp.float32)
    jfn = make_pallas_igcn_train_fn(jm, stack_override=lambda w, h0, tp, m: jref.layers_forward(
        w, h0, tp, m, basis=basis, **CFG))
    jopt = joptim.make_optimizer(lr=1e-3, eps=E2E_EPS)
    x_t, t, e = (jnp.asarray(v.numpy()) for v in (d.x_t, d.t.float(), d.e))

    def loss_fn(p):
        out, aux, bs = jfn(p, variables["batch_stats"], x_t, t, jax_masks_of(d.masks),
                           tolerance_override=jnp.float32(0.1))
        return jnp.mean(jnp.sum((e - out) ** 2, axis=(1, 2))), (aux, bs)

    (loss, (aux, bs)), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
    updates, _ = jopt.update(grads, jopt.init(variables["params"]), variables["params"])
    params = optax.apply_updates(variables["params"], updates)
    ema = j_ema_update(variables["params"], params, 0.999)

    np.testing.assert_allclose(float(metrics["loss"]), float(loss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(optax.global_norm(grads)),
                               rtol=1e-4)
    assert float(metrics["fp_iterations"]) == int(aux["iterations"])
    np.testing.assert_allclose(float(metrics["fp_residual"]), float(aux["residual"]), rtol=1e-4)
    assert float(metrics["fp_tolerance"]) == pytest.approx(0.1)
    got = convert.flax_igcn_from_state_dict(state.model.state_dict(), num_layers=L)
    for k in ("bn_mean", "bn_var"):
        np.testing.assert_allclose(got["batch_stats"][k], np.asarray(bs[k]), atol=1e-5)
    for tree_got, tree_want in ((got["params"], params),
                                (convert.flax_igcn_from_state_dict(
                                    {**state.ema_params, **{f"batch_norm.{b}": v for b, v in
                                                            state.model.batch_norm.named_buffers()}},
                                    num_layers=L)["params"], ema)):
        for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(tree_want),
                                     jax.tree_util.tree_leaves_with_path(tree_got)):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-6,
                                       err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("dropout", ["masks", "prng"])
def test_fused_step_equals_module_step_and_the_sweep_equals_single_steps(dropout):
    """Same draws, same step (fused against module); a warm-started sweep of 3
    against 3 single steps that carry the fixed point, at weight 0.5 first and
    the momentum 0.9 after."""
    _, _, tm = igcn_pair(1, solver="anderson", max_iterations=3, min_iterations=2)
    (sf, stepf), (sm, stepm) = (port_state(tm, impl, dropout, use_warm_start=True)
                                for impl in ("fused", "module"))
    # one stream each: the module's draws also hold the seed's masks, as floats
    genf, genm = (torch.Generator().manual_seed(1) for _ in range(2))
    z0 = torch.zeros(B, 17, HID)
    carry = {"fused": (z0, 0.5), "module": (z0, 0.5)}
    for i in range(2):
        sf, mf = stepf(sf, batch_of(i), genf, *carry["fused"])
        sm, mm = stepm(sm, batch_of(i), genm, *carry["module"])
        np.testing.assert_allclose(float(mf["loss"]), float(mm["loss"]), rtol=1e-5)
        carry = {"fused": (mf["fixed_point"], 0.9), "module": (mm["fixed_point"], 0.9)}
    torch.testing.assert_close(sf.model.batch_norm.running_var, sm.model.batch_norm.running_var)
    for a, b in zip(sf.model.parameters(), sm.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-6)

    (sa, stepa), (sb, stepb) = (port_state(tm, "fused", dropout, use_warm_start=True)
                                for _ in range(2))
    sweep = make_implicit_train_sweep_step(sa.model, sa.optimizer, BETAS, sweep=3, base_step=stepa,
                                           use_warm_start=True, warm_start_momentum=0.9)
    data = {k: torch.as_tensor(getattr(DATA, k)) for k in ("poses_3d", "poses_2d_gmm")}
    idx = torch.arange(3 * B).reshape(3, B)
    sa, out = sweep(sa, data, idx, torch.Generator().manual_seed(2), z0, 0.5)
    gen, zc, wc, losses = torch.Generator().manual_seed(2), z0, 0.5, []
    for ids in idx:
        sb, m = stepb(sb, {k: v[ids] for k, v in data.items()}, gen, zc, wc)
        zc, wc = m["fixed_point"], 0.9
        losses.append(m["loss"])
    assert torch.equal(out["loss"], torch.stack(losses)) and out["fp_iterations"].shape == (3,)
    assert torch.equal(out["fixed_point"], zc) and sa.step == sb.step == 3


@pytest.mark.parametrize("test_times", [1, 2])
def test_eval_step_matches_jax(test_times):
    jm, variables, tm = igcn_pair(2)
    jp, pp, tp = flax_pair(CFG, 3, with_temb=False)
    batch = one_component_batch()
    j_step = jax.jit(j_make_eval_step(jm, jp, t_infer=12, test_times=test_times))
    jstate = JTrainState.create(variables["params"], opt_state=(),
                                model_state=variables["batch_stats"])
    want = j_step(jstate, pp, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    state = TrainState.create(tm, None)
    fd.fused_lifter.launches = fd.fused_backbone.launches = 0
    for impl in ("module", "fused"):
        step = make_implicit_eval_step(tm, tp, t_infer=12, test_times=test_times, impl=impl,
                                       device="cpu")
        got = step(state, tp, batch, prepared=step.prepare(state, tp))
        for g, w, name in zip(got[:3], want[:3], ("p1", "p2", "pred_xyz")):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, err_msg=f"{impl} {name}")
        assert got[3] == int(want[3])
    assert (fd.fused_lifter.launches, fd.fused_backbone.launches) == (0, 0)


def _cli(tmp_path, *extra):
    return ["--config", IPOSE, "--exp", str(tmp_path), "--ni", "--synthetic_frames", "32",
            "--batch_size", "16", "--device", "cpu", "--implicit_iters", "3",
            "--min_iterations", "2", *extra]


def test_cli_implicit_train_resume_and_eval_only_on_cpu(tmp_path):
    train = _cli(tmp_path, "--doc", "run", "--train", "--use_implicit", "--train_impl", "fused",
                 "--dropout_impl", "prng", "--denoiser_impl", "fused", "--use_warm_start",
                 "--process_chunk_size", "64")
    assert main_implicit.main(train + ["--n_epochs", "1"]) == 0
    run = tmp_path / "run"
    log = (run / "stdout.txt").read_text()
    assert "--process_chunk_size has no effect" in log and "mean fp iterations" in log
    assert main_implicit.main(train + ["--n_epochs", "2", "--resume"]) == 0
    log = (run / "stdout.txt").read_text()
    assert "resumed from step 2 (epoch 1)" in log and log.count("| Epoch 00") == 2
    assert len((run / "log.tsv").read_text().splitlines()) == 3
    state = convert.load_torch_states(str(run / "ckpt_00000004.pth"))[0]
    assert "batch_norm.running_var" in state and float((state["batch_norm.running_var"] - 1)
                                                       .abs().max()) > 0
    assert main_implicit.main(_cli(tmp_path, "--doc", "ev", "--use_implicit", "--track_metrics",
                                   "--denoiser_impl", "fused",
                                   "--model_diff_path", str(run / "ckpt_00000004.pth"),
                                   "--model_pose_path", str(run / "ckpt_00000004.pose.pth"))) == 0
    ev = (tmp_path / "ev" / "stdout.txt").read_text()
    assert "Final | MPJPE:" in ev and "fixed-point iterations: mean" in ev
    last = [line for line in log.splitlines() if "P-MPJPE" in line and "Best" not in line][-1]
    alone = [line for line in ev.splitlines() if "P-MPJPE" in line and "Final" not in line][-1]
    assert last.split(" - MPJPE")[1] == alone.split(" - MPJPE")[1]


def test_cli_without_use_implicit_runs_the_frame_family_and_compare_runs_both(tmp_path):
    assert main_implicit.main(_cli(tmp_path, "--doc", "frame", "--detect_anomaly")) == 0
    log = (tmp_path / "frame" / "stdout.txt").read_text()
    assert "using 2 diffusion steps" in log and "fp iterations" not in log
    assert "anomaly detection on" in log and not torch.is_anomaly_enabled()
    assert compare.main(["--config", IPOSE, "--exp", str(tmp_path), "--doc", "cmp", "--ni",
                         "--synthetic_frames", "16", "--batch_size", "16", "--device", "cpu",
                         "--denoiser_impl", "fused"]) == 0
    cmp = (tmp_path / "cmp" / "stdout.txt").read_text()
    assert "[diffusion] MPJPE" in cmp and "[implicit] MPJPE" in cmp and "comparison: {" in cmp


@pytest.mark.parametrize("flag", [["--data_parallel"], ["--hypothesis_parallel", "2"]],
                         ids=["data_parallel", "hypothesis_parallel"])
def test_mesh_flags_raise(tmp_path, flag):
    """The mesh flags in a world of one rank (no launcher): --data_parallel
    trains the implicit model over a 1-rank data mesh; --hypothesis_parallel
    2 raises, as the world does not divide by 2.  Either way the process
    group is left."""
    args = _cli(tmp_path, "--doc", "t", "--use_implicit", *flag)
    if flag == ["--data_parallel"]:
        assert main_implicit.main(args + ["--train", "--n_epochs", "1"]) == 0
        log = (tmp_path / "t" / "stdout.txt").read_text()
        assert "mean fp iterations" in log and (tmp_path / "t" / "ckpt_00000002.pth").exists()
    else:
        with pytest.raises(ValueError, match="1 ranks not divisible by hypothesis_parallel=2"):
            main_implicit.main(args)
    assert not torch.distributed.is_initialized()
