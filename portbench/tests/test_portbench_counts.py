"""The frozen operation and byte counts: equal to hand counts at a small
shape, and to ``chip_smoke.py``'s counts (its product terms once, without the
pass factor its bounds charge) on the program's own prepared weights."""

import pytest
import torch

from portbench.harness import counts as c


def test_hand_counts_small():
    # hid 4, 1 layer, 2 heads, a 3-point path graph (nnz of its Chebyshev stack by hand)
    w = c.Net(hid=4, layers=1, heads=2, n=3, nnz=7, c_in=2, c_out=1, has_temb=False)
    gemm = 4 * 12 + 16 + 4 * 8 + 2 * 16 + 2 * 4 * 12          # qkv, out, fc1, fc2, two chebs
    prod, rest = c.stack_flops(w, batch=2)
    assert prod == 2 * 2 * 1 * 3 * gemm
    assert rest == 2 * 2 * 1 * (3 * (2 * 3 * 4 + 2 * 3 * 4) + 2 * 7 * 4)
    io = 3 * (2 * 3 * 4 + 4 * 3 * 1) + 7 * (4 + 1)
    assert c.net_flops(w, 2) == (prod, rest + 2 * 2 * io)
    weights = 4 * 4 + 3 * 16 + 12 + 16 + 4 + 9 + 32 + 8 + 32 + 4 + 2 * (48 + 4)
    assert c.stack_weights(w) == weights
    assert c.net_bytes(w, 2) == 4 * (weights + 2 * 12 + 4 + 4 * 3 + 1) + 4 * 4 + 8 * 7 + 4 * 2 * 3 * 3
    assert c.least_seconds(495, 0) == pytest.approx(1e-12)
    assert c.least_seconds(0, 3.35e12) == pytest.approx(1.0)


def test_skeleton_nnz():
    assert c.cheb_nnz(c.cheb_basis()) == 153


@pytest.fixture(scope="module")
def prepared():
    import chip_smoke
    from diffpose_tpu_torch.graph import H36M_EDGES, cheb_basis_from_edges
    from diffpose_tpu_torch.models import GCNDiff, GCNPose
    from diffpose_tpu_torch.ops.fused_denoiser import prepare_weights

    basis = cheb_basis_from_edges(17, H36M_EDGES, 2)
    torch.manual_seed(0)
    den = prepare_weights(GCNDiff(basis, hid_dim=16, num_layers=2, num_heads=4), device="cpu")
    lift = prepare_weights(GCNPose(basis, hid_dim=16, num_layers=2, num_heads=4), device="cpu")
    return chip_smoke, den, lift


@pytest.mark.parametrize("batch", [1, 7])
def test_equal_chip_smoke(prepared, batch):
    cs, den, lift = prepared
    d = c.net(16, 2, 4, 5, 5, True)
    p = c.net(16, 2, 4, 2, 3, False)
    assert c.stack_flops(d, batch) == cs.stack_flops(den, batch)
    assert c.net_flops(d, batch) == cs.net_flops_split(den, batch)
    assert c.net_flops(p, batch) == cs.net_flops_split(lift, batch)
    assert c.net_bytes(d, batch) == cs.net_bytes(den, batch)
    assert c.net_bytes(p, batch) == cs.net_bytes(lift, batch)


def test_once_is_chip_smoke_over_its_passes(prepared):
    """``chip_smoke.tf32_bounds`` charges the products three TF32 passes; the
    benchmark's least time charges the work once at the same peak."""
    cs, den, _ = prepared
    prod, _ = cs.stack_flops(den, 64)
    ms, _, _ = cs.tf32_bounds((prod, 0), 0)
    assert ms / 3 == pytest.approx(1e3 * c.least_seconds(prod, 0), rel=1e-12)
    assert cs.PEAK_TF32 == c.PEAK_TF32 and cs.PEAK_BYTES == c.PEAK_BYTES
