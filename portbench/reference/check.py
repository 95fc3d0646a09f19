"""The numbers that decide ``correct``: gaps between the program's outputs and
the reference's, each held to its limit."""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch


def max_rel(got: np.ndarray, want: np.ndarray) -> float:
    """Largest absolute difference over the largest magnitude of ``want``."""
    return float(np.max(np.abs(got - want)) / max(float(np.max(np.abs(want))), 1e-30))


def max_abs_mm(got: np.ndarray, want: np.ndarray) -> float:
    """Largest absolute difference of two arrays in metres, in millimetres."""
    return float(np.max(np.abs(got - want)) * 1000.0)


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              keep: Iterable[str]) -> Dict[str, float]:
    """Per leaf of ``keep``: ``| |got_k| - |want_k| |`` over the larger of
    ``|want_k|`` and the median leaf's ``|want|`` (Frobenius norms)."""
    keep = list(keep)
    g, w = _norms({k: got[k] for k in keep}), _norms({k: want[k] for k in keep})
    median = float(np.median([w[k] for k in keep]))
    return {k: abs(g[k] - w[k]) / max(w[k], median, 1e-30) for k in keep}


def worst_leaf(got, want, keep) -> float:
    """The largest of :func:`leaf_gaps`."""
    return max(leaf_gaps(got, want, keep).values())


def median_leaf(got, want, keep) -> float:
    """The median of :func:`leaf_gaps`: steady where single leaves read the
    rounding of their storage."""
    return float(np.median(list(leaf_gaps(got, want, keep).values())))


def moving_leaves(ref_grads: Dict[str, torch.Tensor]) -> list:
    """Leaves whose reference gradient is not nought to rounding: a norm of
    at least a thousandth of the median leaf's (a key's bias under the
    softmax, whose gradient is zero in exact arithmetic, moves under Adam by
    round-off alone)."""
    n = _norms(ref_grads)
    median = float(np.median(list(n.values())))
    return [k for k, v in n.items() if v >= 1e-3 * median]


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a missing or non-finite number fails)."""
    return all(k in numbers and bool(np.isfinite(numbers[k])) and numbers[k] <= limits[k]
               for k in limits)
