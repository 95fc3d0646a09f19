"""Pose-error metrics and per-action accounting.

Protocol #1 (MPJPE) and Protocol #2 (Procrustes-aligned MPJPE) with the
same math as the reference (``common/loss.py:7-64``), the Procrustes
alignment batched on the tensors' device (the reference drops to per-batch
numpy on the CPU, a device→host sync every eval batch,
``runners/diffpose_frame.py:387``).  Counterpart of ``diffpose_tpu/metrics.py``.

The per-action accumulation replicates ``common/utils.py:96-271``
including its averaging conventions (per-action average of per-frame
errors, then unweighted mean over the 15 actions).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from diffpose_tpu_torch.ops.fused_metrics import fused_p_mpjpe
from diffpose_tpu_torch.utils.profiling import span

Tensor = torch.Tensor

H36M_ACTIONS: Tuple[str, ...] = (
    "Directions", "Discussion", "Eating", "Greeting", "Phoning", "Photo",
    "Posing", "Purchases", "Sitting", "SittingDown", "Smoking", "Waiting",
    "WalkDog", "Walking", "WalkTogether",
)


# ---------------------------------------------------------------------------
# Device-side metrics
# ---------------------------------------------------------------------------


def _norm(x: Tensor) -> Tensor:
    return torch.linalg.vector_norm(x, dim=-1)


def mpjpe(predicted: Tensor, target: Tensor) -> Tensor:
    """Protocol #1: mean Euclidean distance over joints and batch."""
    assert predicted.shape == target.shape
    return _norm(predicted - target).mean()


def mpjpe_per_sample(predicted: Tensor, target: Tensor) -> Tensor:
    """Per-sample mean joint error, shape [B]."""
    return _norm(predicted - target).mean(dim=-1)


def weighted_mpjpe(predicted: Tensor, target: Tensor, w: Tensor) -> Tensor:
    """Per-joint weighted MPJPE (reference ``common/loss.py:16-22``)."""
    return (w * _norm(predicted - target)).mean()


def _det3(a, rows, cols):
    """3×3 minor determinant of a batched 4×4 matrix ``a``."""
    (i0, i1, i2), (j0, j1, j2) = rows, cols
    return (
        a[..., i0, j0] * (a[..., i1, j1] * a[..., i2, j2]
                          - a[..., i1, j2] * a[..., i2, j1])
        - a[..., i0, j1] * (a[..., i1, j0] * a[..., i2, j2]
                            - a[..., i1, j2] * a[..., i2, j0])
        + a[..., i0, j2] * (a[..., i1, j0] * a[..., i2, j1]
                            - a[..., i1, j1] * a[..., i2, j0])
    )


def _adjugate4(a: Tensor) -> Tensor:
    """Adjugate of a batched symmetric 4×4 matrix (closed-form cofactors):
    ``out[..., j, i] = C_ij``."""
    idx = [(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)]
    cols = []
    for j in range(4):
        col = [((-1.0) ** (i + j)) * _det3(a, idx[i], idx[j]) for i in range(4)]
        cols.append(torch.stack(col, dim=-1))
    return torch.stack(cols, dim=-2)


def _quat_rotation_and_trace(b_mat: Tensor, newton_iters: int = 20, polish_iters: int = 4):
    """Optimal PROPER rotation for Wahba's problem via the quaternion
    (Davenport/QUEST) method, branch-free.

    ``b_mat`` [..., 3, 3] is the correlation matrix ``B = Σᵢ bᵢ aᵢᵀ``;
    returns ``(r, λ_max)`` with ``r ∈ SO(3)`` in ROW convention
    (``a_row @ r ≈ b_row``) and ``λ_max`` the attained maximum, which equals
    the reflection-fixed singular-value sum σ₁+σ₂±σ₃ of the SVD solution.

    Algorithm (all batched):
    1. λ_max = largest root of K's characteristic quartic (K is traceless ⇒
       λ⁴ − (p₂/2)λ² − (p₃/3)λ + (p₂²/8 − p₄/4), pₖ = tr(Kᵏ)), by Newton
       from the upper bound √3‖B‖_F: monotone, quadratic convergence.
    2. eigenvector by one exact-shift inverse-iteration step:
       q ∝ adj(K − (λ_max+δ)I) v₀ (δ ~ 1e-6‖B‖_F keeps the matrix invertible
       when λ_max is a double root).
    3. a few shifted power-iteration polish steps (shift 0.6‖B‖_F > σ₃ keeps
       λ_max dominant for det(B) < 0).

    Accuracy: the SVD path's to ~1e-7 in λ and ~1e-4 mm in P-MPJPE on
    realistic pose data; on near-ties of λ_max (planar near-collinear clouds)
    the rotation may be any member of the near-optimal family: use
    ``method="svd"`` where that matters.
    """
    m = b_mat
    b11, b12, b13 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    b21, b22, b23 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    b31, b32, b33 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    def row(*xs):
        return torch.stack(xs, dim=-1)

    k = torch.stack([
        row(b11 + b22 + b33, b23 - b32, b31 - b13, b12 - b21),
        row(b23 - b32, b11 - b22 - b33, b12 + b21, b31 + b13),
        row(b31 - b13, b12 + b21, -b11 + b22 - b33, b23 + b32),
        row(b12 - b21, b31 + b13, b23 + b32, -b11 - b22 + b33),
    ], dim=-2)
    fro = torch.sqrt((m * m).sum(dim=(-2, -1))) + 1e-30

    k2 = k @ k
    k3 = k2 @ k

    def tr(a):
        return a.diagonal(dim1=-2, dim2=-1).sum(dim=-1)

    p2, p3, p4 = tr(k2), tr(k3), tr(k2 @ k2)
    c2 = -p2 / 2.0
    c1 = -p3 / 3.0
    c0 = p2 * p2 / 8.0 - p4 / 4.0

    lam = (3.0 ** 0.5) * fro  # ≥ λ_max, the monotone side
    for _ in range(newton_iters):
        lam2 = lam * lam
        f = lam2 * lam2 + c2 * lam2 + c1 * lam + c0
        df = 4.0 * lam2 * lam + 2.0 * c2 * lam + c1
        lam = lam - f / df.clamp_min(1e-30)

    eye = torch.eye(4, dtype=k.dtype, device=k.device)
    delta = (1e-6 * fro)[..., None, None]
    adj = _adjugate4(k - (lam[..., None, None] + delta) * eye)
    v0 = torch.tensor([1.0, 0.31, 0.17, 0.093], dtype=k.dtype, device=k.device)
    q = adj @ v0
    # tiny-norm rescue (v0 ⊥ eigenvector): a second probe
    n1 = (q * q).sum(dim=-1, keepdim=True)
    q2 = adj @ torch.tensor([0.11, -0.93, 0.41, 0.27], dtype=k.dtype, device=k.device)
    q = torch.where(n1 > 1e-12 * (adj * adj).sum(dim=(-2, -1))[..., None], q, q2)
    q = q / (_norm(q)[..., None] + 1e-30)
    ks = k + (0.6 * fro)[..., None, None] * eye
    for _ in range(polish_iters):
        q = (ks @ q[..., None])[..., 0]
        q = q / (_norm(q)[..., None] + 1e-30)
    lam = (q * (k @ q[..., None])[..., 0]).sum(dim=-1)

    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack([
        row(1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        row(2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        row(2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    ], dim=-2)
    return r, lam


def procrustes_align(predicted: Tensor, target: Tensor, method: str = "quat") -> Tensor:
    """Optimal rigid alignment (scale+rotation+translation) of ``predicted``
    onto ``target``; batched on the tensors' device.

    Follows the reference solution (``common/loss.py:25-61``): normalize
    both point sets, ``H = X₀ᵀY₀``, then the optimal PROPER rotation and
    its trace.  ``method="svd"`` is the literal reference algorithm
    (SVD + reflection fix via det sign); ``method="quat"`` (default)
    computes the identical solution through the quaternion method
    (:func:`_quat_rotation_and_trace`), elementwise math and 4×4 products
    only.  2-D inputs take the SVD path (the quaternion method is 3-D).
    """
    assert predicted.shape == target.shape and predicted.shape[-1] in (2, 3)
    mu_x = target.mean(dim=-2, keepdim=True)
    mu_y = predicted.mean(dim=-2, keepdim=True)
    x0 = target - mu_x
    y0 = predicted - mu_y
    norm_x = torch.sqrt((x0 ** 2).sum(dim=(-2, -1), keepdim=True))
    norm_y = torch.sqrt((y0 ** 2).sum(dim=(-2, -1), keepdim=True))
    x0 = x0 / norm_x
    y0 = y0 / norm_y

    h = x0.transpose(-2, -1) @ y0
    if method == "quat" and predicted.shape[-1] == 3:
        # h = Σᵢ x0ᵢ y0ᵢᵀ = B for a→b with a = y0 rows (predicted),
        # b = x0 rows (target); the returned r is already row-convention
        r, lam = _quat_rotation_and_trace(h)
        tr = lam[..., None, None]
    else:
        u, s, vt = torch.linalg.svd(h)
        v = vt.transpose(-2, -1)
        r = v @ u.transpose(-2, -1)

        sign = torch.sign(torch.linalg.det(r))[..., None]
        v = torch.cat([v[..., :, :-1], v[..., :, -1:] * sign[..., None]], dim=-1)
        s = torch.cat([s[..., :-1], s[..., -1:] * sign], dim=-1)
        r = v @ u.transpose(-2, -1)
        tr = s.sum(dim=-1)[..., None, None]

    a = tr * norm_x / norm_y
    t = mu_x - a * (mu_y @ r)
    return a * (predicted @ r) + t


def p_mpjpe_plain(predicted: Tensor, target: Tensor, method: str = "quat") -> Tensor:
    """Protocol #2 per-sample error, shape [B], by PyTorch operators: with
    ``method="quat"`` on 3-D poses, the plain version of the CUDA kernel
    (``ops/fused_metrics.py``)."""
    aligned = procrustes_align(predicted, target, method=method)
    return _norm(aligned - target).mean(dim=-1)


def p_mpjpe_per_sample(predicted: Tensor, target: Tensor, method: str = "quat") -> Tensor:
    """Protocol #2 per-sample error, shape [B].  3-D poses by the quaternion
    method go through :func:`~diffpose_tpu_torch.ops.fused_metrics.fused_p_mpjpe`
    (one kernel launch for CUDA tensors, :func:`p_mpjpe_plain` for CPU
    tensors); ``method="svd"`` and 2-D poses run :func:`p_mpjpe_plain`."""
    if method == "quat" and predicted.shape[-1] == 3:
        return fused_p_mpjpe(predicted, target)
    return p_mpjpe_plain(predicted, target, method=method)


def p_mpjpe(predicted: Tensor, target: Tensor, method: str = "quat") -> Tensor:
    """Protocol #2 scalar (mean over batch and joints)."""
    return p_mpjpe_per_sample(predicted, target, method=method).mean()


def n_mpjpe(predicted: Tensor, target: Tensor) -> Tensor:
    """Scale-normalized MPJPE (reference ``common/loss.py:67-77``)."""
    norm_pred = (predicted ** 2).sum(dim=-1, keepdim=True).mean(dim=-2, keepdim=True)
    norm_tgt = (target * predicted).sum(dim=-1, keepdim=True).mean(dim=-2, keepdim=True)
    scale = norm_tgt / norm_pred
    return mpjpe(scale * predicted, target)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def mean_velocity_error(predicted, target) -> float:
    """First-derivative (velocity) error over the frame axis (host numpy)."""
    vp = np.diff(_host(predicted), axis=0)
    vt = np.diff(_host(target), axis=0)
    return float(np.mean(np.linalg.norm(vp - vt, axis=-1)))


def root_center(x: Tensor) -> Tensor:
    """Subtract the root joint (index 0), done before both protocols."""
    return x - x[..., :1, :]


# ---------------------------------------------------------------------------
# Host-side accumulation (per-action tables)
# ---------------------------------------------------------------------------


class AccumLoss:
    """Running sum/count accumulator (reference ``common/utils.py:212-223``)."""

    def __init__(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val
        self.count += n
        self.avg = self.sum / self.count if self.count else 0.0


class AverageMeter:
    """Weighted running average (reference ``common/utils.py:9-24``)."""

    def __init__(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count if self.count else 0.0


def define_error_list(actions: Sequence[str]) -> Dict[str, Dict[str, AccumLoss]]:
    return {a: {"p1": AccumLoss(), "p2": AccumLoss()} for a in actions}


def _action_name(action: str) -> str:
    idx = action.find(" ")
    return action[:idx] if idx != -1 else action


def accumulate_action_errors(
    error_sum: Dict[str, Dict[str, AccumLoss]],
    p1_per_sample: np.ndarray,
    p2_per_sample: np.ndarray,
    actions: List[str],
    *,
    num_joints: int = 17,
    reference_compat: bool = True,
) -> Dict[str, Dict[str, AccumLoss]]:
    """Fold per-sample P1/P2 errors into the per-action accumulators.

    Replicates ``mpjpe_by_action_p1/p2`` (``common/utils.py:103-152``)
    including the quirk that, for mixed-action batches, the reference
    credits every sample's P2 with the *batch-wide* mean
    (``utils.py:150``).  Pass ``reference_compat=False`` for the corrected
    per-sample attribution.
    """
    p1 = _host(p1_per_sample).astype(np.float64)
    p2 = _host(p2_per_sample).astype(np.float64)
    n = len(actions)
    assert p1.shape[0] == n and p2.shape[0] == n

    if len(set(actions)) == 1:
        name = _action_name(actions[0])
        error_sum[name]["p1"].update(float(p1.mean()) * n * num_joints, n * num_joints)
        error_sum[name]["p2"].update(float(p2.mean()) * n, n)
    else:
        batch_p2_mean = float(p2.mean())
        for i in range(n):
            name = _action_name(actions[i])
            error_sum[name]["p1"].update(float(p1[i]) * num_joints, num_joints)
            if reference_compat:
                error_sum[name]["p2"].update(batch_p2_mean, 1)
            else:
                error_sum[name]["p2"].update(float(p2[i]), 1)
    return error_sum


def summarize_action_errors(
    error_sum: Dict[str, Dict[str, AccumLoss]], print_table: bool = False
) -> Tuple[float, float]:
    """Per-action table + unweighted across-action averages, in millimetres.

    Output format matches ``print_error_action``
    (``common/utils.py:247-271``) byte-for-byte when ``print_table``.
    """
    mean_all = {"p1": AccumLoss(), "p2": AccumLoss()}
    if print_table:
        print("{0:=^12} {1:=^10} {2:=^8}".format("Action", "p#1 mm", "p#2 mm"))
    for action, value in error_sum.items():
        p1 = value["p1"].avg * 1000.0
        p2 = value["p2"].avg * 1000.0
        mean_all["p1"].update(p1, 1)
        mean_all["p2"].update(p2, 1)
        if print_table:
            print("{0:<12} ".format(action), end="")
            print("{0:>6.2f} {1:>10.2f}".format(p1, p2))
    if print_table:
        print(
            "{0:<12} {1:>6.2f} {2:>10.2f}".format(
                "Average", mean_all["p1"].avg, mean_all["p2"].avg
            )
        )
    return mean_all["p1"].avg, mean_all["p2"].avg


class ActionErrorAccumulator:
    """Shared eval-loop accumulation: valid-masking, per-action error sums
    and running P1/P2 meters (mm): the loop every runner repeats around
    :func:`accumulate_action_errors` (frame, implicit and video eval all
    fold batches the same way; the video family adds a frame axis).
    """

    def __init__(self, actions: Sequence[str], *, num_joints: int = 17,
                 reference_compat: bool = True):
        self.actions = list(actions)
        self.error_sum = define_error_list(self.actions)
        self.p1_meter = AverageMeter()
        self.p2_meter = AverageMeter()
        self.num_joints = num_joints
        self.reference_compat = reference_compat
        self.frames = 0

    def add(self, batch: dict, p1_b, p2_b, *, frames_per_item: int = 1):
        """Fold one batch's per-sample (or per-sample-per-frame, when
        ``frames_per_item > 1``) errors; padded rows are dropped via the
        batch's ``valid`` mask, every frame inherits its window's action."""
        with span("metrics.accumulate"):
            valid = _host(batch["valid"]).astype(bool)
            ids = _host(batch["action_ids"])[valid]
            p1_v = _host(p1_b)[valid].reshape(-1)
            p2_v = _host(p2_b)[valid].reshape(-1)
            if frames_per_item > 1:
                ids = np.repeat(ids, frames_per_item)
            names = [self.actions[i] for i in ids]
            self.frames += len(p1_v)
            if names:
                accumulate_action_errors(
                    self.error_sum, p1_v, p2_v, names,
                    num_joints=self.num_joints,
                    reference_compat=self.reference_compat,
                )
                self.p1_meter.update(float(p1_v.mean()) * 1000.0, len(names))
                self.p2_meter.update(float(p2_v.mean()) * 1000.0, len(names))

    def summarize(self, print_table: bool = False) -> Tuple[float, float]:
        return summarize_action_errors(self.error_sum, print_table=print_table)
