"""Port graph constants and functions vs diffpose_tpu.graph: exact equality."""

import numpy as np
import pytest
import torch

from diffpose_tpu import graph as jg
from diffpose_tpu_torch import graph as tg

GRAPHS = [("H36M_EDGES", 17), ("BODY_EDGES", 16), ("GAN_EDGES", 21)]


@pytest.mark.parametrize("name,n", GRAPHS)
def test_graph_functions_exact(name, n):
    edges = getattr(tg, name)
    assert edges == getattr(jg, name)
    for dtype in (np.float32, np.float64):
        want, got = jg.adjacency_from_edges(n, edges, dtype), tg.adjacency_from_edges(n, edges, dtype)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    adj = jg.adjacency_from_edges(n, edges, np.float64)
    lap = jg.normalized_laplacian(adj)
    assert np.array_equal(tg.normalized_laplacian(adj), lap)
    assert np.array_equal(tg.combinatorial_laplacian(adj), jg.combinatorial_laplacian(adj))
    for order in (0, 1, 2, 3):
        assert np.array_equal(tg.chebyshev_basis(lap, order), jg.chebyshev_basis(lap, order))
        want = jg.cheb_basis_from_edges(n, edges, order)
        got = tg.cheb_basis_from_edges(n, edges, order)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_learned_adjacency_laplacian(rng):
    a_hat = np.eye(17) + rng.uniform(0, 0.2, size=(3, 17, 17))
    want = jg.learned_adjacency_laplacian(a_hat)
    assert np.array_equal(tg.learned_adjacency_laplacian(a_hat), want)
    # column sums: a matrix whose columns differ in sum is not symmetric in d
    a = np.eye(4) + np.triu(np.ones((4, 4)))
    got = tg.learned_adjacency_laplacian(a)
    d = (a.sum(axis=0) + 1e-5) ** -0.5
    np.testing.assert_allclose(got, d[:, None] * a * d[None, :], rtol=1e-15)
    # the same function on torch tensors, as the fused weight prep calls it
    t = tg.learned_adjacency_laplacian(torch.as_tensor(a_hat, dtype=torch.float32))
    np.testing.assert_allclose(
        t.numpy(), jg.learned_adjacency_laplacian(a_hat.astype(np.float32)), rtol=1e-6)
