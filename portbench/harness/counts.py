"""Operations and bytes of the port's kernels and models, from shapes alone.

Frozen copies of ``chip_smoke.py``'s counts of rows 1-2 (``stack_flops``,
``net_flops_split``, ``weight_bytes``, ``net_bytes``), rewritten to take the configuration's sizes instead of the program's
prepared weights, so that no later change to the program moves them.

The work is what the function needs, counted once: a multiply-add is two
operations, whatever precision or number of passes implements it.  So a
kernel's least time is ``max(ops / PEAK_TF32, bytes / PEAK_BYTES)``: every
operation at the dense TF32 tensor-core peak, the fastest rate at which the
card computes float32-grade products, and each input read once and each
output written once.  No pass factor: a 3xTF32 or a bf16x3 kernel does three
times the tensor-core work of this count, which is its own cost, not the
function's.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from portbench.harness.data import H36M_EDGES

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit.
PEAK_TF32 = 495e12       # FLOP/s, TF32 tensor cores
PEAK_BYTES = 3.35e12     # B/s, HBM3


class Net(NamedTuple):
    """One GraFormer-style network as the kernels see it."""

    hid: int
    layers: int
    heads: int
    n: int               # graph points
    nnz: int             # nonzero terms of the Chebyshev stack [K+1, n, n]
    c_in: int
    c_out: int
    has_temb: bool


def cheb_basis(n: int = 17, edges=H36M_EDGES, order: int = 2) -> np.ndarray:
    """``[T_0(L), ..., T_order(L)]`` of the normalised Laplacian of the
    skeleton with self-loops, rows of the adjacency divided by their sums
    (the reference's ``adj_mx_from_edges``, ``ChebConv.get_laplacian``)."""
    e = np.asarray(edges, np.int64)
    adj = np.zeros((n, n))
    adj[e[:, 0], e[:, 1]] = 1.0
    adj = np.maximum(adj, adj.T) + np.eye(n)
    adj = adj / adj.sum(axis=1, keepdims=True)
    deg = adj.sum(axis=-1)
    lap = np.eye(n) - deg[:, None] ** -0.5 * adj * deg[None, :] ** -0.5
    terms = [np.eye(n), lap]
    for _ in range(2, order + 1):
        terms.append(2.0 * lap @ terms[-1] - terms[-2])
    return np.stack(terms[:order + 1])


def cheb_nnz(basis: np.ndarray) -> int:
    return int((np.abs(basis) > 1e-12).sum())


def net(hid: int, layers: int, heads: int, c_in: int, c_out: int, has_temb: bool,
        n: int = 17) -> Net:
    return Net(hid, layers, heads, n, cheb_nnz(cheb_basis(n)), c_in, c_out, has_temb)


def stack_flops(w: Net, batch: int) -> Tuple[int, int]:
    """(channel products, the rest) of the L-layer stack: QKV, out-projection,
    fc1, fc2 and the two residual ChebConvs' products; the attention, the
    learned-adjacency mixes and the Chebyshev mixes."""
    H, L, n, nnz = w.hid, w.layers, w.n, w.nnz
    gemm = H * 3 * H + H * H + H * 2 * H + 2 * H * H + 2 * (H * 3 * H)
    attention = 2 * n * H
    lap_mix = 2 * n * H
    return 2 * batch * L * n * gemm, 2 * batch * L * (n * (attention + lap_mix) + 2 * nnz * H)


def net_flops(w: Net, batch: int) -> Tuple[int, int]:
    """``stack_flops`` plus the input and output ChebConvs."""
    H, n, nnz = w.hid, w.n, w.nnz
    prod, rest = stack_flops(w, batch)
    io = n * (w.c_in * 3 * H + H * 3 * w.c_out) + nnz * (H + w.c_out)
    return prod, rest + 2 * batch * io


def stack_weights(w: Net, layers: int = None) -> int:
    """Elements of the stack's weights: LayerNorms, QKV, out-projection, the
    learned Laplacian, fc1, fc2 and the two ChebConvs (three weights each)."""
    H, n = w.hid, w.n
    per_layer = (4 * H + 3 * H * H + 3 * H + H * H + H + n * n + 2 * H * H + 2 * H
                 + 2 * H * H + H + 2 * (3 * H * H + H))
    return (w.layers if layers is None else layers) * per_layer


def term_list_bytes(w: Net) -> int:
    """The sparse Chebyshev terms the kernels read: pointers, indices, values."""
    return 4 * (w.n + 1) + 8 * w.nnz


def net_bytes(w: Net, batch: int) -> int:
    """Rows 1-2: the weights once, the input read and the output written once."""
    io_weights = w.c_in * 3 * w.hid + w.hid + w.hid * 3 * w.c_out + w.c_out
    act = batch * w.n * (w.c_in + w.c_out)
    if w.has_temb:
        act += w.layers * batch * w.hid
    return 4 * (stack_weights(w) + io_weights) + term_list_bytes(w) + 4 * act


def least_seconds(ops: int, nbytes: int) -> float:
    """The least time of ``ops`` operations moving ``nbytes`` bytes."""
    return max(ops / PEAK_TF32, nbytes / PEAK_BYTES)


def timestep_mlp_flops(hid: int, layers: int) -> int:
    """One sample's timestep MLP (hid -> 4 hid -> 4 hid) and each layer's
    projection of it (4 hid -> hid)."""
    emd = 4 * hid
    return 2 * (hid * emd + emd * emd) + 2 * layers * emd * hid


def frame_model_flops(denoiser: Net, lifter: Net, ddim_steps: int, test_times: int) -> int:
    """Model operations of one evaluated frame: the lifter once, the denoiser
    (with its timestep MLP) at each DDIM step for each hypothesis."""
    den = sum(net_flops(denoiser, 1)) + timestep_mlp_flops(denoiser.hid, denoiser.layers)
    return sum(net_flops(lifter, 1)) + ddim_steps * test_times * den
