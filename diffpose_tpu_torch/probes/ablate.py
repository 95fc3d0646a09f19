"""Cost split of the whole-network kernel (kernel row 11): where do its ms go?

Counterpart of ``scripts/probe_ablate.py:79 _kernel``: the GCNDiff eval
forward of kernel row 1 (``csrc/net_kernel.cuh``, hid 96, 5 layers, 4 heads,
17 joints) built with parts left out at compile time (``csrc/probe_kernel.cu``,
the ``SKIP`` template argument), each variant timed at B=1024 beside the
full build:

  full        the production kernel, built in the probe's own library
  no_attn     the attention sublayer left out
  attn_only   only the attention sublayers (GraphNet and the residual
              Chebyshev blocks left out)
  no_lap      GraphNet's two learned-Laplacian mixes left out
  no_chebmix  every ChebConv is its order-0 channel product plus the bias
  no_ln       both LayerNorms are the identity

The variants compute other functions: the times split the cost, nothing
more.  :func:`net_plain_ablated` is each variant's plain PyTorch twin, over
the plain network forward's helpers (``ops/fused_denoiser.py``).

Run on the card: ``python -m diffpose_tpu_torch.probes.ablate``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Iterable, Optional

import torch
import torch.nn.functional as F

from diffpose_tpu_torch.graph import H36M_EDGES, cheb_basis_from_edges
from diffpose_tpu_torch.models import GCNDiff
from diffpose_tpu_torch.ops import _build
from diffpose_tpu_torch.ops.fused_denoiser import (
    _KERNEL_WEIGHTS,
    Weights,
    _cheb,
    _check_launch,
    _layer_norm,
    prepare_weights,
    resolve_device,
    timestep_projections,
)
from diffpose_tpu_torch.probes import time_ms

# The parts a variant leaves out, and their bits in csrc/net_kernel.cuh's Skip.
PART_BITS = {"attn": 1, "gnetcheb": 2, "lap": 4, "chebmix": 8, "ln": 16}
VARIANTS = {
    "full": (),
    "no_attn": ("attn",),
    "attn_only": ("gnetcheb",),
    "no_lap": ("lap",),
    "no_chebmix": ("chebmix",),
    "no_ln": ("ln",),
}
# The TPU probe's other variants, which have no meaning for a single-pass f32
# CUDA-core kernel: nothing is measured for them.
NOT_APPLICABLE = {
    "onepass": "single-pass bf16 MXU products; the kernel's 3xTF32 products are its f32 grade, and "
               "a single pass is a reduced tier (ROADMAP item 14), held by |dP1|, not timed here",
    "full_b32": "a VMEM batch tile of 32; the CUDA family's tile (TB = 4) is a constant of "
                "every kernel built from net_kernel.cuh",
    "grp4": "segment-GEMM query grouping; the kernel computes scores directly, no segment GEMMs",
    "grp8_b64": "segment-GEMM query grouping at a VMEM tile of 64: neither exists here",
    "grp17_b32": "segment-GEMM query grouping at a VMEM tile of 32: neither exists here",
    "grp17_b64": "segment-GEMM query grouping at a VMEM tile of 64: neither exists here",
}
BATCH = 1024


def skip_bits(skip: Iterable[str]) -> int:
    skip = tuple(skip)
    unknown = set(skip) - set(PART_BITS)
    if unknown:
        raise ValueError(f"unknown parts {sorted(unknown)}; known: {sorted(PART_BITS)}")
    return sum(PART_BITS[p] for p in set(skip))


def net_plain_ablated(w: Weights, x: torch.Tensor, tp: Optional[torch.Tensor],
                      skip: Iterable[str] = ()) -> torch.Tensor:
    """The plain network forward (``fused_denoiser.net_plain``) with the parts
    in ``skip`` left out as the probe kernel leaves them: ``x [B, N, C_in]``
    (and ``tp [L, B, H]``) → ``[B, N, C_out]``."""
    skip = frozenset(skip)
    skip_bits(skip)
    basis = w["basis"]
    k1 = basis.shape[0]
    hid, heads = w["hid_dim"], w["num_heads"]

    def cheb(z, wcat, bias):
        if "chebmix" in skip:   # the order-0 product W_0 alone
            return z @ wcat[:, :wcat.shape[1] // k1] + bias
        return _cheb(z, wcat, bias, basis)

    def norm(z, scale, shift):
        return z if "ln" in skip else _layer_norm(z, scale, shift)

    h = cheb(x, w["win"], w["bin"])
    bsz, n = h.shape[:2]
    for l in range(w["num_layers"]):
        if "attn" not in skip:
            y = norm(h, w["ln1s"][l], w["ln1b"][l])
            qkv = y @ w["wqkv"][l] + w["bqkv"][l]
            q, k, v = (z.reshape(bsz, n, heads, -1).transpose(1, 2)
                       for z in qkv.split(hid, dim=-1))
            probs = torch.softmax(q @ k.transpose(-1, -2), dim=-1)  # q holds 1/√d_k
            att = (probs @ v).transpose(1, 2).reshape(bsz, n, hid)
            h = h + (att @ w["wao"][l] + w["bao"][l])
        if "gnetcheb" in skip:
            continue
        lap = w["lap"][l]
        y = norm(h, w["ln2s"][l], w["ln2b"][l])
        if "lap" not in skip:
            y = lap @ y
        y = F.relu(y @ w["wfc1"][l] + w["bfc1"][l])
        if "lap" not in skip:
            y = lap @ y
        h = h + (y @ w["wfc2"][l] + w["bfc2"][l])

        u = F.relu(cheb(h, w["wg1"][l], w["bg1"][l]))
        if tp is not None:
            u = u + tp[l][:, None, :]
        h = h + F.relu(cheb(u, w["wg2"][l], w["bg2"][l]))
    return cheb(h, w["wout"], w["bout"])


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("probe_kernel")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.probe_forward.argtypes = [i32] * 4 + [ptr] * (3 + len(_KERNEL_WEIGHTS)) + [i32, ptr]
    lib.probe_forward.restype = i32
    lib.probe_smem_bytes.argtypes = []
    lib.probe_smem_bytes.restype = i32
    lib.probe_error_string.argtypes = [i32]
    lib.probe_error_string.restype = ctypes.c_char_p
    return lib


def probe_forward(w: Weights, x: torch.Tensor, tp: torch.Tensor,
                  skip: Iterable[str] = ()) -> torch.Tensor:
    """GCNDiff forward ``x [B, 17, 5], tp [L, B, 96] → [B, 17, 5]`` with the
    parts in ``skip`` left out: one launch of the probe kernel for CUDA
    tensors, :func:`net_plain_ablated` for CPU tensors."""
    bits = skip_bits(skip)
    if not w["has_temb"] or (w["c_in"], w["c_out"]) != (5, 5):
        raise ValueError("the probe is built for GCNDiff weights: timestep projections, 5 → 5")
    if x.device.type == "cpu":
        return net_plain_ablated(w, x, tp, skip)
    _check_launch(w, x, tp, w["c_in"], _KERNEL_WEIGHTS)
    bsz, dev = x.shape[0], x.device
    out = torch.empty((bsz, w["n_pts"], w["c_out"]), dtype=torch.float32, device=dev)
    lib = _library()
    code = lib.probe_forward(
        dev.index, bits, bsz, w["num_layers"], x.data_ptr(), tp.data_ptr(), out.data_ptr(),
        *[w[k].data_ptr() for k in _KERNEL_WEIGHTS], w["cheb_nnz"],
        torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError(f"probe_forward kernel: {lib.probe_error_string(code).decode()} "
                           f"(cudaError {code})")
    probe_forward.launches += 1
    return out


probe_forward.launches = 0


def seeded_inputs(batch: int, device) -> tuple:
    """A GCNDiff's weights from seed 0 and an input batch with timestep
    projections."""
    torch.manual_seed(0)
    model = GCNDiff(cheb_basis_from_edges(17, H36M_EDGES)).eval()
    w = prepare_weights(model, device)
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((batch, 17, 5), generator=g, device=device)
    t = torch.randint(0, 51, (batch,), generator=g, device=device).to(torch.float32)
    return w, x, timestep_projections(w, t)


def run(batch: int = BATCH, inputs: Optional[tuple] = None) -> Dict[str, float]:
    """ms a launch of each variant on the card (CUDA events), ``full`` first
    and last (their mean is reported).  ``inputs``: ``(w, x, tp)``, else
    :func:`seeded_inputs` at ``batch``."""
    w, x, tp = inputs or seeded_inputs(batch, resolve_device("cuda"))
    with torch.no_grad():
        first = time_ms(lambda: probe_forward(w, x, tp))
        ms = {name: time_ms(lambda: probe_forward(w, x, tp, parts))
              for name, parts in VARIANTS.items() if name != "full"}
        ms["full"] = (first + time_ms(lambda: probe_forward(w, x, tp))) / 2
    return ms


def main() -> int:
    ms = run()
    for name in VARIANTS:
        share = 1.0 - ms[name] / ms["full"]
        print(f"{name:12s} {ms[name]:8.4f} ms  ({100 * share:5.1f}% of full left out)")
    for name, why in NOT_APPLICABLE.items():
        print(f"{name:12s} not applicable: {why}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
