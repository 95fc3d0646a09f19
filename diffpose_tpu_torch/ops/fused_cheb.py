"""One Chebyshev graph convolution as hand-written CUDA kernels (kernel row 4).

Replaces the TPU kernel ``diffpose_tpu/ops/pallas_cheb.py:48 _cheb_kernel``
(its wrapper ``fused_cheb_conv:69``): ``y = Σ_k T_k·X·W_k + b`` for
``x [B, N, C]``, ``w [K+1, C, D]``, ``b [D]`` and the Chebyshev stack
``basis [K+1, N, N]``.  The CUDA source is ``csrc/cheb_kernel.cuh`` (device
code) and ``csrc/cheb_kernel.cu`` (launch: ``cheb_plan`` picks the kernel).

Bound on the H100: at GraFormer's 128 → 128 width, 21 joints, K+1 = 3 and
B=1024 the channel product is 2.11 GFLOP against 22 MB of input and output:
operations, 0.0128 ms at the 495 TFLOP/s TF32 tensor-core peak for its
three passes (0.0316 ms for all of it at the 67 TFLOP/s FP32 peak).  Its
2 → 128 and 128 → 3 convolutions are bound by their bytes (about 0.0033 ms
each).

Design: every kernel mixes joints over the sparse term list of the basis
(``ops/fused_denoiser.py:sparse_terms``, ``T_0 = I`` folded in as terms);
any batch, the last tile ragged.

* ``cheb_kernel_wide`` (C and D multiples of 8): the mix first, then the
  channel product over ``Z = [T_0·X | T_1·X | …]`` on the tensor cores at
  3xTF32 (``ops/tf32.py:matmul_3xtf32``'s arithmetic, a fresh partial sum
  each k-step of 8), slab by slab of :data:`KERNEL_KS` channels of one order,
  channel chunk outer and order inner (:func:`kernel_k_order`), each slab's
  mix overlapping the product of the one before; weights stream from L2
  through a ``cp.async`` ring.  A CTA of 12 warps takes up to 168 rows of
  whole samples: 1024 samples of 21 joints fill the 132 SMs in one wave.
* ``cheb_kernel_mix`` (D ≥ 8 otherwise: 2 → 128, 5 → 96): the mix into
  shared memory, then each thread writes adjacent outputs of a row in f32.
* ``cheb_kernel_proj`` (D < 8: 128 → 3, 96 → 5): the product first, each
  row's K+1 · D projections a quad's reduction over C with shuffles, then the
  mix; f32.

The JAX kernel multiplies first and mixes after; the order of the sums
differs, the function does not.  ``cheb_conv_plain(..., matmul=matmul_3xtf32)``
is the wide kernel's arithmetic on the CPU.

:func:`fused_cheb_conv` launches a kernel for CUDA tensors and raises on
what none takes; for CPU tensors it runs :func:`cheb_conv_plain`.
``fused_cheb_conv.launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from diffpose_tpu_torch.ops import _build
from diffpose_tpu_torch.ops.fused_denoiser import _check_tensor, _graph_constants

# What the kernels take, and the wide kernel's slab of channels (csrc/cheb_kernel.cuh).
KERNEL_MAX_PTS, KERNEL_MAX_ORDERS, KERNEL_KS = 32, 8, 32
# cheb_plan's kernels, by its plan[0].
KERNELS = ("wide", "mix", "proj")


def kernel_k_order(k1: int, c: int) -> torch.Tensor:
    """The wide kernel's order of the reduction over ``Z``'s ``K1·C`` columns
    (column ``k·C + c``): chunks of :data:`KERNEL_KS` channels, and within a
    chunk order by order."""
    return torch.tensor([k * c + ch for c0 in range(0, c, KERNEL_KS) for k in range(k1)
                         for ch in range(c0, min(c0 + KERNEL_KS, c))])


def cheb_conv_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    basis: torch.Tensor, matmul=None) -> torch.Tensor:
    """``ChebGraphConv.forward`` on bare tensors: the graph mix, the channel
    product, the bias.  ``matmul`` given (``ops/tf32.py:matmul_3xtf32`` for
    the wide kernel's tensor cores; C a multiple of 8): the channel product
    through it over ``Z = [T_0·X | T_1·X | …]``, reduced in the wide kernel's
    order (:func:`kernel_k_order`)."""
    xk = torch.einsum("knm,bmc->bnkc", basis.to(x.dtype), x)
    if matmul is None:
        return torch.einsum("bnkc,kcd->bnd", xk, w) + b
    k1, c, d = w.shape
    order = kernel_k_order(k1, c)
    return matmul(xk.flatten(-2)[..., order], w.reshape(k1 * c, d)[order]) + b


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
    lib.cheb_plan.argtypes = [i32] * 6 + [ptr]
    lib.cheb_plan.restype = i32
    lib.cheb_error_string.argtypes = [i32]
    lib.cheb_error_string.restype = ctypes.c_char_p
    return lib


def kernel_plan(device: torch.device, batch: int, n_pts: int, c_in: int, d_out: int,
                orders: int) -> dict:
    """The launch the kernel makes for these widths on a CUDA ``device``:
    the kernel (:data:`KERNELS`), samples a CTA, CTAs, column chunks, dynamic
    shared memory bytes and threads a CTA."""
    plan = (ctypes.c_int * 6)()
    lib = _library()
    code = lib.cheb_plan(device.index or 0, batch, n_pts, c_in, d_out, orders, plan)
    if code != 0:
        raise ValueError(f"no ChebConv kernel takes B={batch}, N={n_pts}, {c_in} -> {d_out}, "
                         f"{orders} orders: {lib.cheb_error_string(code).decode()}")
    return dict(zip(("kernel", "tb", "ctas", "chunks", "smem", "threads"),
                    (KERNELS[plan[0]], *plan[1:])))


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
