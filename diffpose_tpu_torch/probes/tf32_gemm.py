"""The tensor cores' TF32 products against their plain model (``ops/tf32.py``).

``csrc/probe_tf32_gemm.cu`` computes ``C = A @ W`` on ``mma.sync.m16n8k8``
TF32 with the operand layout of ``csrc/train_kernel.cuh:tc_gemm`` in three
modes: ``"1xtf32"`` (the whole K into one accumulator that starts at ``C0``:
the tensor cores' own accumulation), ``"kstep"`` (3xTF32 as ``tc_gemm``
computes it: a fresh partial sum each k-step of 8, added in f32) and
``"whole_k"`` (3xTF32 fed the whole K, the design ``tc_gemm`` replaced).
:func:`run` holds each mode bit for bit against the plain model on the
card.  Nothing on a main path calls this.  Run on the card:
``python -m diffpose_tpu_torch.probes.tf32_gemm``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from diffpose_tpu_torch.ops import _build
from diffpose_tpu_torch.ops.fused_denoiser import _check_tensor, resolve_device
from diffpose_tpu_torch.ops.tf32 import matmul_3xtf32, mma_chain, round_tf32

# (name, mode, M, K, N, operands): "tf32" operands are TF32 values with
# exponents in ±6 (C0 f32 in ±14, a twentieth 0); "cancel" gives C0 near
# minus the exact product; "normal" and "weights" are the train kernels'
# scales (activations ~N(0, 1), weights ~N(0, 1/17²)); "wide" f32 in ±2^8.
CASES = (("one mma", "1xtf32", 1024, 8, 64, "tf32"),
         ("one mma, cancelling C0", "1xtf32", 1024, 8, 64, "cancel"),
         ("a chain over K=64", "1xtf32", 1024, 64, 64, "normal"),
         ("3xTF32 k-step partials, K=288", "kstep", 136, 288, 96, "weights"),
         ("3xTF32 whole K, K=288", "whole_k", 136, 288, 96, "weights"),
         ("3xTF32 k-step partials, wide", "kstep", 136, 96, 96, "wide"),
         ("3xTF32 whole K, wide", "whole_k", 136, 96, 96, "wide"))

MODES = {"1xtf32": 0, "kstep": 1, "whole_k": 2}


def gemm_plain(a: torch.Tensor, w: torch.Tensor, c0: Optional[torch.Tensor] = None,
               mode: str = "kstep") -> torch.Tensor:
    """The plain model of :func:`gemm` (``ops/tf32.py``)."""
    if mode == "1xtf32":
        return mma_chain(c0, round_tf32(a), round_tf32(w))
    return matmul_3xtf32(a, w, accumulate=mode)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("probe_tf32_gemm")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.probe_tf32_gemm.argtypes = [i32] * 5 + [ptr] * 5
    lib.probe_tf32_gemm.restype = i32
    lib.probe_tf32_gemm_error_string.argtypes = [i32]
    lib.probe_tf32_gemm_error_string.restype = ctypes.c_char_p
    return lib


def gemm(a: torch.Tensor, w: torch.Tensor, c0: Optional[torch.Tensor] = None,
         mode: str = "kstep") -> torch.Tensor:
    """``(c0 +) a [M, K] @ w [K, N]`` (M % 8, N % 16, K % 8 all 0; ``c0``
    only in mode ``"1xtf32"``, zeros if absent): one launch of the probe
    kernel for CUDA tensors, :func:`gemm_plain` for CPU tensors."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")
    m, k = a.shape
    n = w.shape[1]
    if c0 is None:
        c0 = torch.zeros(m, n, dtype=a.dtype, device=a.device)
    if a.device.type == "cpu":
        return gemm_plain(a, w, c0, mode)
    if m % 8 or n % 16 or k % 8:
        raise ValueError(f"the kernel takes M % 8, N % 16 and K % 8 of 0, got {m}, {n}, {k}")
    _check_tensor("a", a, (m, k), torch.float32, a.device)
    _check_tensor("w", w, (k, n), torch.float32, a.device)
    _check_tensor("c0", c0, (m, n), torch.float32, a.device)
    out = torch.empty(m, n, dtype=torch.float32, device=a.device)
    lib = _library()
    code = lib.probe_tf32_gemm(a.device.index, MODES[mode], m, n, k, a.data_ptr(), w.data_ptr(),
                               c0.data_ptr(), out.data_ptr(),
                               torch.cuda.current_stream(a.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"probe_tf32_gemm kernel: "
                           f"{lib.probe_tf32_gemm_error_string(code).decode()} (cudaError {code})")
    gemm.launches += 1
    return out


gemm.launches = 0


def _operands(kind: str, m: int, k: int, n: int, g: torch.Generator, dev):
    def signed(shape, lo, hi, mant):
        e = torch.randint(lo, hi + 1, shape, generator=g, device=dev).float()
        sign = torch.where(torch.rand(shape, generator=g, device=dev) < 0.5, -1.0, 1.0)
        return sign * mant(shape) * torch.exp2(e)

    def tf32_mant(shape):
        return 1 + torch.randint(0, 1024, shape, generator=g, device=dev).float() / 1024

    def f32_mant(shape):
        return 1 + torch.rand(shape, generator=g, device=dev)

    if kind in ("tf32", "cancel"):
        a, w = signed((m, k), -6, 6, tf32_mant), signed((k, n), -6, 6, tf32_mant)
        if kind == "tf32":
            c0 = signed((m, n), -14, 14, f32_mant)
            c0[torch.rand((m, n), generator=g, device=dev) < 0.05] = 0
        else:
            jitter = 1 + 1e-3 * torch.randn(m, n, generator=g, device=dev, dtype=torch.float64)
            c0 = (-(a.double() @ w.double()) * jitter).float()
        return a, w, c0
    if kind == "normal":
        a = round_tf32(torch.randn(m, k, generator=g, device=dev))
        w = round_tf32(torch.randn(k, n, generator=g, device=dev))
        return a, w, torch.randn(m, n, generator=g, device=dev)
    if kind == "weights":
        return (torch.randn(m, k, generator=g, device=dev),
                torch.randn(k, n, generator=g, device=dev) / 17, None)
    return signed((m, k), -8, 8, f32_mant), signed((k, n), -8, 8, f32_mant), None


def run() -> Dict[str, dict]:
    """For each of :data:`CASES` on the card (seed 0): the elements whose
    bits differ between the kernel and :func:`gemm_plain`, of how many, and
    the largest |Δ|."""
    dev = resolve_device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    with torch.no_grad():
        for name, mode, m, k, n, kind in CASES:
            a, w, c0 = (None if t is None else t.contiguous() for t in _operands(kind, m, k, n, g, dev))
            got, want = gemm(a, w, c0, mode), gemm_plain(a, w, c0, mode)
            out[name] = {"differing": int((got.view(torch.int32) != want.view(torch.int32)).sum()),
                         "of": got.numel(), "max_abs_diff": float((got - want).abs().max())}
    return out


def main() -> int:
    for name, rec in run().items():
        print(f"{name}: {rec['differing']} of {rec['of']} elements differ from the plain model "
              f"(max |Δ| {rec['max_abs_diff']:.3e})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
