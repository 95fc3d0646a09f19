"""One Chebyshev graph convolution as a hand-written CUDA kernel (kernel row 4).

Replaces the TPU kernel ``diffpose_tpu/ops/pallas_cheb.py:48 _cheb_kernel``
(its wrapper ``fused_cheb_conv:69``): ``y = Σ_k T_k·X·W_k + b`` for
``x [B, N, C]``, ``w [K+1, C, D]``, ``b [D]`` and the Chebyshev stack
``basis [K+1, N, N]``.  The CUDA source is ``csrc/cheb_kernel.cuh`` (device
code) and ``csrc/cheb_kernel.cu`` (launch).

Bound on the H100: at GraFormer's 128 → 128 width, 21 joints, K+1 = 3 and
B=1024 the channel product is 2.11 GFLOP against 22 MB of input and output,
0.0316 ms at the 67 TFLOP/s FP32 peak: operations.  Its 2 → 128 and 128 → 3
convolutions are bound by their bytes (about 0.0033 ms each).

Design: a CTA of 256 threads takes a few whole samples (the joint mix needs
every joint of a sample), mixes their joints into ``Z = [T_0·X | T_1·X | …]``
in shared memory over the sparse term list of the basis, then multiplies
``Z`` by ``w`` viewed as ``[(K+1)·C, D]`` with f32 FMAs, the weights read
through L2.  The JAX kernel multiplies first and mixes after; the order of
the sums differs, the function does not.  The term list is
``ops/fused_denoiser.py:sparse_terms`` of the basis, ``T_0 = I`` folded in as
terms.  Any batch: the last tile is ragged.  Widths that are not a multiple
of 4 (GraFormer's 2 → 128 and 128 → 3) take a scalar path.

:func:`fused_cheb_conv` launches the kernel for CUDA tensors and raises on
what it does not take; for CPU tensors it runs :func:`cheb_conv_plain`.
``fused_cheb_conv.launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from diffpose_tpu_torch.ops import _build
from diffpose_tpu_torch.ops.fused_denoiser import _check_tensor, _graph_constants

# What the kernel takes (csrc/cheb_kernel.cuh).
KERNEL_MAX_PTS, KERNEL_MAX_ORDERS = 32, 8


def cheb_conv_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    basis: torch.Tensor) -> torch.Tensor:
    """``ChebGraphConv.forward`` on bare tensors: the graph mix, the channel
    product, the bias."""
    xk = torch.einsum("knm,bmc->bnkc", basis.to(x.dtype), x)
    return torch.einsum("bnkc,kcd->bnd", xk, w) + b


def graph_constants(basis, device) -> dict:
    """The basis on ``device`` and its term list (``cheb_ptr``, ``cheb_idx``,
    ``cheb_val``), cached per basis; ``basis`` is a host array or a tensor,
    which is read to the host."""
    if isinstance(basis, torch.Tensor):
        basis = basis.detach().cpu().numpy()
    basis = np.ascontiguousarray(basis, np.float32)
    return _graph_constants(basis.tobytes(), basis.shape, torch.device(device))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("cheb_kernel")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cheb_forward.argtypes = [i32] * 6 + [ptr] * 8
    lib.cheb_forward.restype = i32
    lib.cheb_tile.argtypes = [i32] * 3
    lib.cheb_tile.restype = i32
    lib.cheb_error_string.argtypes = [i32]
    lib.cheb_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, g: dict) -> torch.Tensor:
    """One launch of the CUDA kernel over the graph constants ``g``; every
    input is checked first."""
    k1, n = g["basis"].shape[:2]
    if n > KERNEL_MAX_PTS or k1 > KERNEL_MAX_ORDERS:
        raise ValueError(f"the kernel takes at most {KERNEL_MAX_PTS} joints and "
                         f"{KERNEL_MAX_ORDERS} orders, got {n} and {k1}")
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {x.device}")
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"x must be [B, N, C] and w [K+1, C, D], got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    bsz, c, d = x.shape[0], x.shape[2], w.shape[2]
    dev = x.device
    _check_tensor("x", x, (bsz, n, c), torch.float32, dev)
    _check_tensor("w", w, (k1, c, d), torch.float32, dev)
    _check_tensor("b", b, (d,), torch.float32, dev)
    for name in ("cheb_ptr", "cheb_idx"):
        _check_tensor(name, g[name], tuple(g[name].shape), torch.int32, dev)
    _check_tensor("cheb_val", g["cheb_val"], tuple(g["cheb_val"].shape), torch.float32, dev)
    out = torch.empty((bsz, n, d), dtype=torch.float32, device=dev)
    if bsz == 0:
        return out
    lib = _library()
    code = lib.cheb_forward(dev.index, bsz, n, c, d, k1, x.data_ptr(), w.data_ptr(),
                            b.data_ptr(), out.data_ptr(), g["cheb_ptr"].data_ptr(),
                            g["cheb_idx"].data_ptr(), g["cheb_val"].data_ptr(),
                            torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError(f"cheb_forward kernel: {lib.cheb_error_string(code).decode()} "
                           f"(cudaError {code})")
    return out


def fused_cheb_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, basis) -> torch.Tensor:
    """ChebConv ``x [B, N, C] → [B, N, D]`` with ``w [K+1, C, D]``, ``b [D]``
    and the Chebyshev stack ``basis [K+1, N, N]`` (a host array, or a tensor
    read to the host) or the dict that :func:`graph_constants` made of it for
    ``x``'s device: one kernel launch for CUDA tensors, the plain version for
    CPU tensors."""
    g = basis if isinstance(basis, dict) else graph_constants(basis, x.device)
    if x.device.type == "cpu":
        return cheb_conv_plain(x, w, b, g["basis"])
    out = _launch(x, w, b, g)
    fused_cheb_conv.launches += 1
    return out


fused_cheb_conv.launches = 0
