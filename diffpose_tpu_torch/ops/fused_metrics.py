"""Per-sample P-MPJPE (Protocol #2) of 3-D poses as one hand-written CUDA kernel.

Replaces no TPU kernel: the JAX metric (``diffpose_tpu/metrics.py:
procrustes_align``, ``_quat_rotation_and_trace``) is plain ``jnp``, fused by
XLA on the TPU.  Run eagerly on the H100, the same chain of PyTorch operators
(``metrics.py:procrustes_align(method="quat")``) takes some 600 launches of
tiny kernels a call, and their enqueue outlasts the eval step's network
kernels.  The CUDA source is ``csrc/procrustes_kernel.cu``.

Bound on the H100: bytes, ``2·N·J·3·4`` in and ``4·N`` out, 0.42 MB at
N=1,024 and J=17 (0.13 µs at 3.35 TB/s); about 2 kFLOP a sample, far under
the FP32 peak.  The kernel is latency-bound; what it saves is the host's
enqueue of the launches, not device bandwidth.

Design: one warp a sample, lanes over joints, the sums by warp shuffles, and
the 4x4 quaternion solve with the plain version's float32 steps and
constants, computed redundantly by every lane in registers (the source's
note).  Only the order of the sums differs from the plain version.

:func:`fused_p_mpjpe` launches the kernel for CUDA tensors and raises on
what it does not take (:func:`check_inputs`); for CPU tensors it runs the
plain version, ``metrics.py:p_mpjpe_plain``.  ``fused_p_mpjpe.launches``
counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from diffpose_tpu_torch.ops import _build


def check_inputs(pred: torch.Tensor, target: torch.Tensor):
    """Raise ``ValueError`` on what the kernel does not take: shapes other than
    one ``[..., J, 3]`` for both, J < 1, a dtype other than float32, two
    devices, or inputs that ask for a gradient (the kernel has no backward)."""
    if pred.shape != target.shape:
        raise ValueError(f"pred and target differ in shape: {tuple(pred.shape)}, "
                         f"{tuple(target.shape)}")
    if pred.dim() < 2 or pred.shape[-1] != 3 or pred.shape[-2] < 1:
        raise ValueError(f"the kernel takes 3-D poses [..., J, 3] with J >= 1, got "
                         f"{tuple(pred.shape)}")
    if pred.dtype != torch.float32 or target.dtype != torch.float32:
        raise ValueError(f"the kernel takes float32, got {pred.dtype}, {target.dtype}")
    if pred.device != target.device:
        raise ValueError(f"pred is on {pred.device}, target on {target.device}")
    if torch.is_grad_enabled() and (pred.requires_grad or target.requires_grad):
        raise ValueError("the kernel has no backward: call it under torch.no_grad()")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("procrustes_kernel")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.p_mpjpe_forward.argtypes = [i32] * 3 + [ptr] * 4
    lib.p_mpjpe_forward.restype = i32
    lib.p_mpjpe_error_string.argtypes = [i32]
    lib.p_mpjpe_error_string.restype = ctypes.c_char_p
    return lib


def _launch(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """One launch of the CUDA kernel; the inputs are checked first."""
    check_inputs(pred, target)
    joints, dev = pred.shape[-2], pred.device
    p = pred.contiguous().view(-1, joints, 3)
    t = target.contiguous().view(-1, joints, 3)
    out = torch.empty(p.shape[0], dtype=torch.float32, device=dev)
    if p.shape[0]:
        lib = _library()
        code = lib.p_mpjpe_forward(dev.index, p.shape[0], joints, p.data_ptr(), t.data_ptr(),
                                   out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if code != 0:
            raise RuntimeError(f"p_mpjpe_forward kernel: "
                               f"{lib.p_mpjpe_error_string(code).decode()} (cudaError {code})")
    return out.view(pred.shape[:-2])


def fused_p_mpjpe(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-sample P-MPJPE of ``pred``, ``target`` ``[..., J, 3]`` → ``[...]``
    (quaternion Procrustes, ``metrics.py:procrustes_align(method="quat")``):
    one kernel launch for CUDA tensors, the plain version for CPU tensors."""
    if pred.device.type == "cpu":
        from diffpose_tpu_torch.metrics import p_mpjpe_plain   # metrics.py imports this module

        return p_mpjpe_plain(pred, target)
    if pred.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {pred.device}")
    out = _launch(pred, target)
    fused_p_mpjpe.launches += 1
    return out


fused_p_mpjpe.launches = 0
