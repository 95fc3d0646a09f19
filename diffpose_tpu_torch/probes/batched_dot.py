"""Batched attention on TF32 tensor cores: what error at the video shapes?
(kernel row 12)

Counterpart of ``scripts/probe_batched_dot.py:22 kernel``: per row t,
``o[t] = softmax(q[t]·k[t]ᵀ)·v[t]`` for ``q, k, v [T, F, dk]``, no 1/√dk
scale.  The JAX probe asked whether Mosaic lowers a batched
``dot_general``; this one asks whether the products can run on Hopper's
tensor cores at the f32 parity grade (5e-5).  ``csrc/probe_attention.cu``
runs both products as ``mma.sync.m16n8k8`` TF32 in two modes, ``"1xtf32"``
(operands rounded to TF32) and ``"3xtf32"`` (small·big + big·small +
big·big of the TF32 splits into a fresh partial each k-step of 8, f32
accumulation); the softmax is f32.  The plain twin is the three torch
operations in f32 with TF32 off; :func:`attention_model` is the kernel's
own order and arithmetic (ops/tf32.py) on the CPU.

Design (Hopper): a persistent grid that fills every SM, one warp a task of
16 queries of a row, the next row's q, k and v staged by ``cp.async`` while
this one computes, K and V split into TF32 parts once a row, the
probabilities handed from the accumulators to ``P·V`` in registers.

Shapes: the JAX probe's ``T=136, F=81, dk=24`` and kernel row 10's
``T = 16 windows · 17 joints · 4 heads = 1088``.  Nothing on a main path
calls this.  Run on the card: ``python -m diffpose_tpu_torch.probes.batched_dot``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch
import torch.nn.functional as F

from diffpose_tpu_torch.ops import _build
from diffpose_tpu_torch.ops.fused_denoiser import _check_tensor, resolve_device
from diffpose_tpu_torch.ops.tf32 import matmul_1xtf32, matmul_3xtf32
from diffpose_tpu_torch.probes import device_clock, device_ms, time_ms

MODES = {"1xtf32": 1, "3xtf32": 3}
SHAPES = ((136, 81, 24), (16 * 17 * 4, 81, 24))
KERNEL_DK, KERNEL_MAX_F = 24, 96


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``softmax(q·kᵀ)·v`` per row in f32, with TF32 off."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.softmax(q @ k.transpose(-1, -2), dim=-1) @ v
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def attention_model(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mode: str = "3xtf32") -> torch.Tensor:
    """``softmax(q·kᵀ)·v`` as the kernel computes it: both products in
    ``mode``'s tensor-core arithmetic (``ops/tf32.py``: ``matmul_3xtf32``, or
    ``matmul_1xtf32``), ``exp(s − row max)`` unnormalised, ``P·V`` over the
    keys padded with zeros to whole tiles of 8, divided by the row sum at
    the end."""
    mm = {"1xtf32": matmul_1xtf32, "3xtf32": matmul_3xtf32}[mode]
    s = mm(q, k.transpose(-1, -2))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    pad = -k.shape[-2] % 8
    return mm(F.pad(p, (0, pad)), F.pad(v, (0, 0, 0, pad))) / p.sum(dim=-1, keepdim=True)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("probe_attention")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.probe_attention.argtypes = [i32] * 5 + [ptr] * 5
    lib.probe_attention.restype = i32
    lib.probe_attention_grid.argtypes = [i32] * 4 + [ptr]
    lib.probe_attention_grid.restype = i32
    lib.probe_attention_error_string.argtypes = [i32]
    lib.probe_attention_error_string.restype = ctypes.c_char_p
    return lib


def kernel_grid(device: torch.device, rows: int, frames: int, mode: str = "3xtf32") -> dict:
    """The kernel's launch for ``rows × frames`` on a CUDA ``device``: CTAs
    an SM (occupancy) and CTAs of the persistent grid."""
    out = (ctypes.c_int * 2)()
    lib = _library()
    code = lib.probe_attention_grid(device.index or 0, MODES[mode], rows, frames, out)
    if code != 0:
        raise RuntimeError(f"probe_attention_grid: "
                           f"{lib.probe_attention_error_string(code).decode()} (cudaError {code})")
    return {"ctas_an_sm": out[0], "ctas": out[1]}


def batched_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mode: str = "3xtf32") -> torch.Tensor:
    """``softmax(q·kᵀ)·v`` for ``q, k, v [T, F, 24]`` (F ≤ 96): one launch of
    the tensor-core kernel for CUDA tensors, :func:`attention_plain` for CPU
    tensors."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {tuple(MODES)}, got {mode!r}")
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    rows, frames, dk = q.shape
    if dk != KERNEL_DK or frames > KERNEL_MAX_F:
        raise ValueError(f"the kernel takes dk {KERNEL_DK} and F <= {KERNEL_MAX_F}, "
                         f"got {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_tensor(name, t, (rows, frames, dk), torch.float32, q.device)
    out = torch.empty_like(q)
    lib = _library()
    code = lib.probe_attention(q.device.index, MODES[mode], rows, frames, dk, q.data_ptr(),
                               k.data_ptr(), v.data_ptr(), out.data_ptr(),
                               torch.cuda.current_stream(q.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"probe_attention kernel: "
                           f"{lib.probe_attention_error_string(code).decode()} (cudaError {code})")
    batched_attention.launches += 1
    return out


batched_attention.launches = 0


def run() -> Dict[tuple, dict]:
    """For each of :data:`SHAPES` on the card: each mode's max |Δ| against the
    plain twin, ms (wrapper calls, CUDA events) and device ms (the kernel
    alone, ``torch.profiler``), the launch's grid, the plain twin's ms and
    ``scaled_dot_product_attention``'s (``scale=1.0``, the library
    yardstick); inputs standard normal, seed 0."""
    dev = resolve_device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    with torch.no_grad():
        for shape in SHAPES:
            q, k, v = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
            want = attention_plain(q, k, v)
            rec = {"plain_ms": time_ms(lambda: attention_plain(q, k, v)),
                   "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                                                scale=1.0))}
            for mode in MODES:
                got = batched_attention(q, k, v, mode)
                torch.cuda.synchronize()
                rec[mode] = {"max_abs_err": float((got - want).abs().max()),
                             "ms": time_ms(lambda: batched_attention(q, k, v, mode)),
                             "device_ms": device_ms(lambda: batched_attention(q, k, v, mode),
                                                    "attention_kernel"),
                             "device_clock": device_clock(),
                             **kernel_grid(dev, shape[0], shape[1], mode)}
            out[shape] = rec
    return out


def main() -> int:
    for shape, rec in run().items():
        modes = "  ".join(f"{m} max|Δ| {rec[m]['max_abs_err']:.2e} {rec[m]['ms']:.4f} ms "
                          f"(device {rec[m]['device_ms']:.4f})" for m in MODES)
        print(f"T, F, dk = {shape}: {modes}  plain {rec['plain_ms']:.4f} ms  "
              f"SDPA {rec['library_ms']:.4f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
