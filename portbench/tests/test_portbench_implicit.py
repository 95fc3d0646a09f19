"""The implicit cell's harness pieces on the CPU: its row-3 counts against
``chip_smoke.py``'s; a tiny run of ``implicit-eval-h5`` (the published
widths, few rows) that is correct, traced, with the solver's metrics; and
faults planted in the program's solve that the check must catch."""

import numpy as np
import pytest
import torch

from portbench.harness import counts, counts_implicit
from portbench.tests.tiny import tiny_run

CELL = "implicit-eval-h5"


@pytest.mark.parametrize("batch", [1, 7, 2560])
def test_row3_counts_equal_chip_smoke(batch):
    import chip_smoke
    from diffpose_tpu_torch.models.igcn import IGCN
    from diffpose_tpu_torch.ops.fused_denoiser import prepare_weights

    torch.manual_seed(0)
    w = prepare_weights(IGCN(counts.cheb_basis().astype(np.float32), hid_dim=16, num_layers=2,
                             num_heads=4), device="cpu")
    net = counts.net(16, 2, 4, 5, 5, True)
    assert counts_implicit.backbone_flops(net, batch) == chip_smoke.backbone_flops(w, batch)
    assert counts_implicit.backbone_bytes(net, batch) == chip_smoke.backbone_bytes(w, batch)


def test_mixing_and_batch_counts_by_hand():
    """A stack and a plain step for each body that moves ``z``: bodies 0, m,
    2m, …"""
    assert [counts_implicit.moving_bodies(k, 5) for k in (1, 5, 6, 10, 11, 20)] == [1, 1, 2, 2, 3, 4]
    den, lift = counts.net(16, 2, 4, 5, 5, True), counts.net(16, 2, 4, 2, 3, False)
    flops = [counts_implicit.eval_batch_flops(den, lift, 3, 2, k, 5) for k in (5, 6, 10)]
    assert flops[0] < flops[1] == flops[2]
    assert flops[1] - flops[0] == counts_implicit.backbone_flops(den, 6) + 3 * 6 * 17 * 16


@pytest.mark.parametrize("m,bodies", [(5, 10), (5, 13), (3, 9)])
def test_moving_bodies_are_the_references(m, bodies):
    """The reference's solve moves ``z`` on exactly the bodies the counts
    count (a stalled body's residual is 0)."""
    from portbench.reference import implicit as ref_implicit

    rng = np.random.default_rng(m + bodies)
    a, b = (torch.as_tensor(rng.normal(size=(8, 12)) * s) for s in (0.9, 1.0))
    _, run, residuals = ref_implicit.anderson(lambda z: torch.tanh(a * z + b),
                                              torch.as_tensor(rng.normal(size=(8, 12))), m=m,
                                              beta=1.0, lam=0.1, max_iterations=bodies,
                                              min_iterations=bodies, tol=0.0)
    assert run == bodies
    assert [k for k, r in enumerate(residuals) if r != 0.0] == list(range(0, bodies, m))
    assert sum(r != 0.0 for r in residuals) == counts_implicit.moving_bodies(bodies, m)


def test_traced_tiny_run_is_correct_and_reports_the_solver():
    res = tiny_run(CELL, trace=True)
    m = res["metrics"]
    assert res["correct"] is True and res["failed"] == 0
    assert m["solver_iters.implicit"]["value"] == 10.0
    assert m["solver_mix_host_ms.implicit"]["value"] > 0
    assert m["solver_test_wait_ms.implicit"]["value"] >= 0
    assert 0 < m["mfu.implicit"]["value"] < 100
    assert res["checks"]["iters_gap"]["value"] == 0.0


def _plant(monkeypatch, fault):
    import diffpose_tpu_torch.models.igcn as igcn

    real = igcn.solve_anderson
    if fault == "start_returned":             # the solve returns its start
        def planted(f, z, tol, **kw):
            _, aux, stats = real(f, z, tol, **kw)
            return z, aux, stats
    elif fault == "one_body_fewer":           # the solve stops a body early
        def planted(f, z, tol, **kw):
            return real(f, z, tol, **{**kw, "min_iterations": kw["min_iterations"] - 1})
    else:                                     # half the hypotheses' rows left at their start
        def planted(f, z, tol, **kw):
            out, aux, stats = real(f, z, tol, **kw)
            h = z.shape[0] // 2
            return torch.cat([out[:h], z[h:]]), aux, stats
    monkeypatch.setattr(igcn, "solve_anderson", planted)


@pytest.mark.parametrize("fault", ["start_returned", "one_body_fewer", "half_unsolved"])
def test_solver_fault_is_caught(monkeypatch, fault):
    _plant(monkeypatch, fault)
    assert tiny_run(CELL)["correct"] is False


@pytest.mark.card
def test_control_fails_on_card(card):
    """The program at one TF32 pass (``--kernel_precision default``) fails the
    check that the parity grade passes, on the card at a size a test holds."""
    assert tiny_run(CELL, device="cuda")["correct"] is True
    assert tiny_run(CELL, device="cuda", control="default")["correct"] is False
