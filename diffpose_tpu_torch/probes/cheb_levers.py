"""Where kernel rows 4 and 12's time goes, lever by lever.

Builds variants of ``csrc/cheb_kernel.cu`` (row 4, one ChebConv) and
``csrc/probe_attention.cu`` (row 12, batched attention) from patched copies
of ``csrc/`` (into ``build/cheb_levers/<variant>/``), and times each kernel
alone (device time, ``torch.profiler``) beside the committed build, variant
after variant, ``rounds`` times over: row 4's wide path at GraFormer's
128 → 128 (21 joints B=1024, 17 joints B=1000), row 12 at T = 1088 and 136
(F = 81, 3xTF32).  Variants of row 4:

  shipped       the committed source
  mix_after     each slab's mix after the product of the slab before, not
                ahead of it
  four_mixers   only row group 2's 4 warps mix, and they hold 5 of the 21
                n tiles (the other 8 warps 8 each): the mix beside the
                product in other warps
  no_mix        timing only: the mix left out (Z holds zeros)
  no_mma        timing only: the three mma passes left out
  no_split_w    timing only: the weights' TF32 split left out

and of row 12:

  shipped       the committed source
  expf          accurate ``expf`` in place of ``exp2f`` of one FMA
  one_cta       ``__launch_bounds__(192, 1)``: registers freed, one CTA an
                SM by registers no longer, by shared memory still two
  no_exp        timing only: the exponentials left out
  no_qk         timing only: the score product left out
  no_pv         timing only: the P·V product left out

``--against DIR``: also ``DIR`` (another tree's ``csrc/``, say an earlier
design unpacked with ``git archive`` under ``build/``) built unpatched as
``against``, timed at both rows' shapes and row 4's narrow shapes.
Variants that compute the same function are held to 5e-5 of the plain
versions.  Run on the card: ``python -m diffpose_tpu_torch.probes.cheb_levers``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from diffpose_tpu_torch.graph import GAN_EDGES, H36M_EDGES, cheb_basis_from_edges
from diffpose_tpu_torch.ops import _build
from diffpose_tpu_torch.ops import fused_cheb as fc
from diffpose_tpu_torch.ops.fused_denoiser import resolve_device
from diffpose_tpu_torch.probes import batched_dot as bd
from diffpose_tpu_torch.probes import device_ms

OUT = _build.BUILD_DIR / "cheb_levers"
TOL = 5e-5
CHEB, ATTN = "cheb_kernel", "probe_attention"


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"cheb_levers: the source no longer holds {old!r}")
    return text.replace(old, new)


def _edit(name: str, *pairs) -> Callable[[Path], None]:
    def apply(d: Path):
        text = (d / name).read_text()
        for old, new in pairs:
            text = _sub(text, old, new)
        (d / name).write_text(text)
    return apply


_MIX = ("    if (j + 1 < slabs)\n      mix_slab(a, slab_of(a, j + 1), ring + (j % STAGES) * STAGE_FLOATS"
        " + W_FLOATS, seg, rows,\n               zbuf + ((j + 1) & 1) * ZBUF_FLOATS, tid);\n")
_PRODUCT = ("    product(acc, zbuf + (j & 1) * ZBUF_FLOATS, ring + (j % STAGES) * STAGE_FLOATS,\n"
            "            slab_of(a, j).kw, p0, mts, q, nts, g, t);\n")
_EXP = "exp2f(fmaf(s[j][i], LOG2E, nm[i >> 1]))"
_FOUR_MIXERS = (
    ("constexpr int NPW = 7;", "constexpr int NPW = 8;"),
    ("constexpr int WIDE_ROWS = 3 * NPW * 8;", "constexpr int WIDE_ROWS = 168;"),
    ("const int* seg, int rows, float* zb, int tid) {\n  const int groups = s.kw / 8;\n"
     "  for (int it = tid; it < rows * groups; it += WIDE_THREADS) {",
     "const int* seg, int rows, float* zb, int tid, int nt = WIDE_THREADS) {\n"
     "  const int groups = s.kw / 8;\n  for (int it = tid; it < rows * groups; it += nt) {"),
    ("const int o = (8 * (q + 3 * i) + g) * LDZ + kk + t;", "const int o = (8 * (8 * q + i) + g) * LDZ + kk + t;"),
    ("const int nts = max(0, ((rows + 7) / 8 - q + 2) / 3);", "const int nts = min(NPW, max(0, (rows + 7) / 8 - 8 * q));"),
    (_MIX, _MIX.replace("if (j + 1 < slabs)", "if (j + 1 < slabs && q == 2)").replace(
        "ZBUF_FLOATS, tid);", "ZBUF_FLOATS, tid - 256, 128);")),
    ("const int r = 8 * (q + 3 * i) + 2 * t + e;", "const int r = 8 * (8 * q + i) + 2 * t + e;"),
)

# name: (library, patch or None, computes the same function)
VARIANTS: Dict[str, tuple] = {
    "cheb.shipped": (CHEB, None, True),
    "cheb.mix_after": (CHEB, _edit("cheb_kernel.cuh", (_MIX + _PRODUCT, _PRODUCT + _MIX)), True),
    "cheb.four_mixers": (CHEB, _edit("cheb_kernel.cuh", *_FOUR_MIXERS), True),
    "cheb.no_mix": (CHEB, _edit("cheb_kernel.cuh", (_MIX, "")), False),
    "cheb.no_mma": (CHEB, _edit("cheb_kernel.cuh", ("if (i < nts) tf32::mma(part[i],",
                                                    "if (false) tf32::mma(part[i],")), False),
    "cheb.no_split_w": (CHEB, _edit("cheb_kernel.cuh", ("    if (c >= dcols) continue;\n    float* p = big",
                                                        "    continue;\n    float* p = big")), False),
    "attn.shipped": (ATTN, None, True),
    "attn.expf": (ATTN, _edit("probe_attention.cu", (_EXP, "expf(fmaf(s[j][i], LOG2E, nm[i >> 1]) / LOG2E)")),
                  True),
    "attn.one_cta": (ATTN, _edit("probe_attention.cu", ("__launch_bounds__(32 * MAX_WARPS, 2)",
                                                        "__launch_bounds__(32 * MAX_WARPS, 1)")), True),
    "attn.no_exp": (ATTN, _edit("probe_attention.cu", (_EXP, "fmaf(s[j][i], LOG2E, nm[i >> 1])")),
                    False),
    "attn.no_qk": (ATTN, _edit("probe_attention.cu", (
        "    if (j >= ktiles) continue;\n#pragma unroll\n    for (int kk = 0; kk < DK / 8; ++kk) {",
        "    continue;\n#pragma unroll\n    for (int kk = 0; kk < DK / 8; ++kk) {")), False),
    "attn.no_pv": (ATTN, _edit("probe_attention.cu", ("    if (j >= ktiles) continue;\n    uint32_t pb[4]",
                                                      "    continue;\n    uint32_t pb[4]")), False),
}


def build(name: str, src: Path = _build.CSRC) -> Path:
    """``src`` patched for ``name`` and compiled into ``OUT/<name>/``."""
    lib_name, patch, _ = VARIANTS.get(name, (name.split(".")[0], None, True))
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src, d)
    if patch is not None:
        patch(d)
    lib = d / f"{lib_name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(d / f"{lib_name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}: {proc.stderr[-2000:]}")
    (d / "build.log").write_text(proc.stdout + proc.stderr)
    return lib


def _bind(path: Path, lib_name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path.resolve()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if lib_name == CHEB:
        lib.cheb_forward.argtypes = [i32] * 6 + [ptr] * 8
        lib.cheb_forward.restype = i32
        lib.cheb_error_string.argtypes = [i32]
        lib.cheb_error_string.restype = ctypes.c_char_p
    else:
        lib.probe_attention.argtypes = [i32] * 5 + [ptr] * 5
        lib.probe_attention.restype = i32
        lib.probe_attention_error_string.argtypes = [i32]
        lib.probe_attention_error_string.restype = ctypes.c_char_p
    return lib


@contextlib.contextmanager
def using(lib: ctypes.CDLL, lib_name: str):
    """The wrapper's launches go to ``lib`` inside the block."""
    module = fc if lib_name == CHEB else bd
    saved = module._library
    module._library = lambda: lib
    try:
        yield
    finally:
        module._library = saved


def cases(device, narrow: bool) -> Dict[str, tuple]:
    """Each shape's (library, launch, expected output), inputs from seed 0."""
    g = torch.Generator(device=device).manual_seed(0)
    out = {}
    shapes = [(21, 1024, 128, 128), (17, 1000, 128, 128)]
    if narrow:
        shapes += [(21, 1024, 2, 128), (21, 1024, 128, 3), (17, 1296, 5, 96), (17, 1296, 96, 5)]
    for n, bsz, c, d in shapes:
        gc = fc.graph_constants(cheb_basis_from_edges(n, GAN_EDGES if n == 21 else H36M_EDGES),
                                device)
        x = torch.randn((bsz, n, c), generator=g, device=device)
        w = torch.randn((3, c, d), generator=g, device=device) / (3 * c) ** 0.5
        b = torch.randn((d,), generator=g, device=device)
        out[f"row4 {c}->{d} N={n} B={bsz}"] = (
            CHEB, lambda x=x, w=w, b=b, gc=gc: fc._launch(x, w, b, gc),
            fc.cheb_conv_plain(x, w, b, gc["basis"]))
    for shape in reversed(bd.SHAPES):
        q, k, v = (torch.randn(shape, generator=g, device=device) for _ in range(3))
        out[f"row12 T={shape[0]} 3xTF32"] = (
            ATTN, lambda q=q, k=k, v=v: bd.batched_attention(q, k, v, "3xtf32"),
            bd.attention_plain(q, k, v))
    return out


def _times(name: str, lib_name: str, shape: str, libs: dict) -> bool:
    """Whether variant ``name`` is timed at ``shape``: its own row's wide
    shapes; row 4's narrow shapes only the committed build and ``against``."""
    if lib_name not in libs:
        return False
    return "128->128" in shape or shape.startswith("row12") or name in ("cheb.shipped", "against")


def run(rounds: int = 2, against: Optional[Path] = None) -> Dict[str, dict]:
    """Device ms of each variant at each of its shapes (variant after variant,
    ``rounds`` times over, every time kept), its max |kernel − plain| and
    its ptxas registers."""
    device = resolve_device("cuda")
    names = list(VARIANTS) + (["against"] if against is not None else [])
    srcs = {n: Path(against) if n == "against" else _build.CSRC for n in names}

    def make(n):
        if n == "against":
            return {lib_name: build(f"{lib_name}.against", srcs[n]) for lib_name in (CHEB, ATTN)}
        return {VARIANTS[n][0]: build(n)}
    with ThreadPoolExecutor(len(names)) as pool:
        paths = dict(zip(names, pool.map(make, names)))
    libs = {n: {k: _bind(p, k) for k, p in v.items()} for n, v in paths.items()}
    shapes = cases(device, narrow=against is not None)
    res = {n: {"ms": {}, "err": {}} for n in names}
    with torch.no_grad():
        for _ in range(rounds):
            for n in names:
                for shape, (lib_name, launch, want) in shapes.items():
                    if not _times(n, lib_name, shape, libs[n]):
                        continue
                    with using(libs[n][lib_name], lib_name):
                        got = launch()
                        torch.cuda.synchronize()
                        res[n]["err"][shape] = float((got - want).abs().max())
                        kernel = "cheb_kernel" if lib_name == CHEB else "attention_kernel"
                        res[n]["ms"].setdefault(shape, []).append(device_ms(launch, kernel))
    for n, r in res.items():
        if (n == "against" or VARIANTS[n][2]) and max(r["err"].values()) > TOL:
            raise RuntimeError(f"cheb_levers: {n} differs from the plain version: {r['err']}")
        logs = [OUT / f"{k}.against" / "build.log" for k in (CHEB, ATTN)] if n == "against" \
            else [OUT / n / "build.log"]
        r["ptxas"] = [line.split("Used", 1)[1].strip() for log in logs
                      for line in log.read_text().splitlines() if "Used" in line]
    return res


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--against", type=Path, default=None,
                        help="another tree's csrc/ to time beside the committed build")
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    res = run(args.rounds, args.against)
    for n, r in res.items():
        for shape, ms in r["ms"].items():
            print(f"{n:16s} {shape:28s} device ms {' '.join(f'{t:.4f}' for t in ms)}  "
                  f"(max|kernel-plain| {r['err'][shape]:.1e})")
        print(f"{n:16s} ptxas: {'; '.join(r['ptxas'])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
