"""Skeleton-graph primitives: adjacency, Laplacian, Chebyshev basis.

The graph is static, so everything derivable from it is computed once on
the host in float64 numpy; the ``[K+1, N, N]`` Chebyshev stack is the only
thing the device sees.  Counterpart of ``diffpose_tpu/graph.py``, kept as
an independent copy so this package needs nothing of the JAX one.
"""

from __future__ import annotations

import numpy as np

# 17-joint Human3.6M skeleton edge list used by both frame models
# (reference: runners/diffpose_frame.py:120-124).
H36M_EDGES: tuple[tuple[int, int], ...] = (
    (0, 1), (1, 2), (2, 3),
    (0, 4), (4, 5), (5, 6),
    (0, 7), (7, 8), (8, 9), (9, 10),
    (8, 11), (11, 12), (12, 13),
    (8, 14), (14, 15), (15, 16),
)

# 16-edge body graph of the standalone ChebConv module
# (reference: models/ChebConv.py:8-12).
BODY_EDGES: tuple[tuple[int, int], ...] = (
    (0, 1), (1, 2), (2, 3),
    (0, 4), (4, 5), (5, 6),
    (0, 7), (7, 8), (8, 9),
    (8, 10), (10, 11), (11, 12),
    (8, 13), (13, 14), (14, 15),
)

# 21-point hand/gan graph of the standalone GraFormer smoke test
# (reference: models/GraFormer.py:47-51).
GAN_EDGES: tuple[tuple[int, int], ...] = (
    (0, 1), (1, 2), (2, 3), (3, 4),
    (0, 5), (5, 6), (6, 7), (7, 8),
    (0, 9), (9, 10), (10, 11), (11, 12),
    (0, 13), (13, 14), (14, 15), (15, 16),
    (0, 17), (17, 18), (18, 19), (19, 20),
)


def adjacency_from_edges(num_joints: int, edges, dtype=np.float32) -> np.ndarray:
    """Symmetric 0/1 adjacency with self-loops, each row divided by its sum.

    Matches ``adj_mx_from_edges`` + ``normalize`` of the reference
    (``models/ChebConv.py:17-48``).  Rows that sum to zero stay zero.
    """
    edges = np.asarray(edges, dtype=np.int64)
    adj = np.zeros((num_joints, num_joints), dtype=np.float64)
    adj[edges[:, 0], edges[:, 1]] = 1.0
    adj = np.maximum(adj, adj.T)
    adj = adj + np.eye(num_joints)
    rowsum = adj.sum(axis=1, keepdims=True)
    inv = np.where(rowsum > 0, 1.0 / np.where(rowsum > 0, rowsum, 1.0), 0.0)
    return (adj * inv).astype(dtype)


def normalized_laplacian(adj: np.ndarray) -> np.ndarray:
    """``L = I − D^{-1/2} A D^{-1/2}`` with ``D = diag(rowsum(A))``
    (reference ``ChebConv.get_laplacian(graph, normalize=True)``)."""
    adj = np.asarray(adj, dtype=np.float64)
    deg = adj.sum(axis=-1)
    with np.errstate(divide="ignore"):
        dinv = np.where(deg > 0, deg ** -0.5, 0.0)
    return np.eye(adj.shape[0]) - dinv[:, None] * adj * dinv[None, :]


def combinatorial_laplacian(adj: np.ndarray) -> np.ndarray:
    """``L = D − A`` (reference ``models/ChebConv.py:127-129``, normalize=False)."""
    adj = np.asarray(adj, dtype=np.float64)
    return np.diag(adj.sum(axis=-1)) - adj


def chebyshev_basis(laplacian: np.ndarray, order: int = 2) -> np.ndarray:
    """Stacked Chebyshev polynomials ``[T_0(L), …, T_order(L)]``, shape
    ``[order+1, N, N]``: ``T_0 = I``, ``T_1 = L``,
    ``T_k = 2 L T_{k-1} − T_{k-2}``."""
    lap = np.asarray(laplacian, dtype=np.float64)
    n = lap.shape[0]
    terms = [np.eye(n)]
    if order >= 1:
        terms.append(lap)
    for _ in range(2, order + 1):
        terms.append(2.0 * lap @ terms[-1] - terms[-2])
    return np.stack(terms, axis=0)


def cheb_basis_from_edges(
    num_joints: int, edges, order: int = 2, dtype=np.float32
) -> np.ndarray:
    """Edge list → normalized adjacency → Laplacian → Chebyshev stack."""
    adj = adjacency_from_edges(num_joints, edges, dtype=np.float64)
    lap = normalized_laplacian(adj)
    return chebyshev_basis(lap, order).astype(dtype)


def learned_adjacency_laplacian(a_hat, eps: float = 1e-5):
    """``D^{-1/2} Â D^{-1/2}`` with ``D = colsum(Â) + eps``.

    Matches ``LAM_Gconv.laplacian_batch`` (reference
    ``models/GraFormer.py:174-178``), which sums over the row axis, i.e.
    takes column sums.  Works on numpy arrays and torch tensors alike.
    """
    d = (a_hat.sum(axis=-2) + eps) ** -0.5
    return d[..., :, None] * a_hat * d[..., None, :]
