"""One body of the stopped Anderson solve as four hand-written CUDA kernels.

Replaces no TPU kernel: the JAX solver's mixing (``diffpose_tpu/models/
solvers.py:solve_anderson``, its body) is plain ``jnp``, fused by XLA on the
TPU.  Run eagerly on the H100, the same body in PyTorch
(``models/solvers.py:anderson_body_plain``, the plain version) is some 80
launches a body: history pushes, differences, a float64 copy of them, a
float64 GEMM with a 5-wide output over millions of values, GEMVs and norms.
The CUDA source is ``csrc/anderson_kernel.cu``.

Bound on the H100: bytes.  At the implicit eval's d = 2,560 × 17 × 96 values
and m = 5, a body reads ``z``, ``f(z)``, the histories' rows and writes two
rows and ``z_new``: about 0.35 GB, 0.1 ms at 3.35 TB/s.

Design: (a) the push into ring slot ``it mod m`` and the float64 Gram system's
per-block partial sums in one pass; (b) one block sums the partials in a fixed
order and solves the m×m system; (c) the mixing (or the plain step) in a
second pass with the partial sums of the two norms; (d) the stall and the
relative update, every block summing the norms alike, ``z`` copied into
``z_new`` on a stall.  No atomics, so two runs are bit-equal; nothing
synchronises with the host.  Only the order of the sums differs from the
plain version.

:func:`fused_anderson_body` launches the chain for CUDA tensors and raises on
what it does not take (:func:`check_inputs`); for CPU tensors it runs the
plain version.  ``fused_anderson_body.launches`` counts the bodies that went
through the kernels (four launches each).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from diffpose_tpu_torch.ops import _build

MAX_M = 8   # csrc/anderson_kernel.cu: anderson::MAX_M


def check_inputs(z, fz, X, F, it):
    """Raise ``ValueError`` on what the kernels do not take: ``z`` and ``fz``
    of different shapes or empty, histories other than ``[m, z.numel()]``
    with 1 <= m <= 8, a dtype other than float32 or float64 or two dtypes,
    two devices, histories not contiguous (the kernels write them in place),
    ``it`` not a Python int >= 0, or inputs that ask for a gradient (the
    kernels have no backward)."""
    if not isinstance(it, int) or it < 0:
        raise ValueError(f"the kernels take the stopped mode's count, an int >= 0, got {it!r}")
    if z.shape != fz.shape or z.numel() < 1:
        raise ValueError(f"z and f(z) differ in shape or are empty: {tuple(z.shape)}, "
                         f"{tuple(fz.shape)}")
    m = X.shape[0] if X.dim() == 2 else 0
    if X.shape != F.shape or X.dim() != 2 or X.shape[1] != z.numel() or not 1 <= m <= MAX_M:
        raise ValueError(f"the histories must be [m, {z.numel()}] with 1 <= m <= {MAX_M}, got "
                         f"{tuple(X.shape)}, {tuple(F.shape)}")
    tensors = (z, fz, X, F)
    if z.dtype not in (torch.float32, torch.float64) or any(t.dtype != z.dtype for t in tensors):
        raise ValueError(f"the kernels take float32 or float64, one dtype, got "
                         f"{[t.dtype for t in tensors]}")
    if any(t.device != z.device for t in tensors):
        raise ValueError(f"the inputs lie on {[str(t.device) for t in tensors]}")
    if not (X.is_contiguous() and F.is_contiguous()):
        raise ValueError("the kernels write the histories in place: they must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError("the kernels have no backward: the differentiable mode runs the plain body")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("anderson_kernel")
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.anderson_scratch_doubles.argtypes = [i32, ctypes.POINTER(ctypes.c_longlong)]
    lib.anderson_scratch_doubles.restype = i32
    lib.anderson_body.argtypes = ([i32, i32, ctypes.c_longlong, i32, i32, f64, f64, f64]
                                  + [ptr] * 9)
    lib.anderson_body.restype = i32
    lib.anderson_error_string.argtypes = [i32]
    lib.anderson_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what}: {_library().anderson_error_string(code).decode()} "
                           f"(cudaError {code})")


@functools.lru_cache(maxsize=None)
def _scratch_doubles(index: int) -> int:
    n = ctypes.c_longlong()
    _raise_on(_library().anderson_scratch_doubles(index, ctypes.byref(n)), "anderson_scratch_doubles")
    return n.value


def _launch(z, fz, X, F, it: int, beta: float, lam: float):
    """One body's four launches; the inputs are checked first."""
    from diffpose_tpu_torch.models import solvers   # solvers.py imports this module

    check_inputs(z, fz, X, F, it)
    z, fz = z.contiguous(), fz.contiguous()
    dev = z.device
    lib = _library()
    z_new = torch.empty_like(z)
    err = torch.empty((), dtype=z.dtype, device=dev)
    flags = torch.empty(2, dtype=torch.int32, device=dev)
    scratch = torch.empty(_scratch_doubles(dev.index), dtype=torch.float64, device=dev)
    code = lib.anderson_body(
        dev.index, int(z.dtype == torch.float64), z.numel(), X.shape[0], it, float(beta),
        float(lam), float(solvers.STALL_TOL), z.data_ptr(), fz.data_ptr(), X.data_ptr(),
        F.data_ptr(), z_new.data_ptr(), err.data_ptr(), flags.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(code, "anderson_body kernels")
    return z_new, err, X, F, (flags[0], flags[1])


def fused_anderson_body(z, fz, X, F, it: int, beta: float, lam: float):
    """One body of the stopped Anderson solve (``models/solvers.py:
    anderson_body_plain``'s function and returns; ``X``, ``F`` updated in
    place): four kernel launches for CUDA tensors, the plain version for CPU
    tensors."""
    if z.device.type == "cpu":
        from diffpose_tpu_torch.models.solvers import anderson_body_plain

        return anderson_body_plain(z, fz, X, F, it, beta, lam)
    if z.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {z.device}")
    out = _launch(z, fz, X, F, it, beta, lam)
    fused_anderson_body.launches += 1
    return out


fused_anderson_body.launches = 0
