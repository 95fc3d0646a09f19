"""Where the eval network kernel's time goes (kernel rows 1-3), lever by lever.

Builds variants of ``csrc/net_kernel.cu`` from patched copies of ``csrc/``
(into ``build/net_levers/<variant>/``), each undoing one lever of the
committed design or leaving a part out, and times them beside the committed
build at the main-path shapes: the bare stack (row 3) at B=512 and 1024, the
denoiser (row 1) at B=1024.  Variants:

  shipped          the committed source
  nine_warps       288 threads (9 warps) as the train kernels, not 384
  in_cta_split     each CTA splits the weights into TF32 parts (the big
                   parts staged, split_slab), as the train kernels do; its
                   small parts are 0, so its error is not held
  ks32_s3          32-row weight slabs in a 3-stage ring (the train
                   forward's), not 48 rows in 2 stages
  recip_div        one reciprocal a row in the LayerNorms and the softmax in
                   place of a division an element (dropped: no measurable gain)
  no_mma           timing only: the three mma passes replaced by one FMA (what
                   the products cost besides the tensor cores)
  no_small_loads   timing only: the weights' small parts not loaded (the big
                   parts' fragments reused): half the ring's fragment loads
  no_a_split       timing only: the activations' fragments not split (their
                   bits passed as both parts)
  no_partials      timing only: the passes accumulate into the k-step sum
                   itself, no fresh partial a k-step

and ``stamps``: the committed source with ``clock64()`` read by thread 0 of
block 0 after every barrier, one bare-stack launch at B=512, the cycles
summed by the stage that ends at each barrier.  Variants that compute the
same function are held to 5e-5 of the plain version.

Run on the card: ``python -m diffpose_tpu_torch.probes.net_levers``.
"""

from __future__ import annotations

import contextlib
import ctypes
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from diffpose_tpu_torch.graph import H36M_EDGES, cheb_basis_from_edges
from diffpose_tpu_torch.models import GCNDiff
from diffpose_tpu_torch.ops import _build
from diffpose_tpu_torch.ops import fused_denoiser as fd
from diffpose_tpu_torch.probes import time_ms

OUT = _build.BUILD_DIR / "net_levers"
TOL = 5e-5
STAMPS = 8192
_STAMP_DEFS = f"""
__device__ unsigned long long g_stamp[2 * {STAMPS}];
__device__ int g_cnt;
#define STAMP(id) do {{ if (blockIdx.x == 0 && threadIdx.x == 0) {{ const int k_ = g_cnt; \\
  if (k_ < {STAMPS}) {{ g_stamp[2 * k_] = clock64(); g_stamp[2 * k_ + 1] = (id); \\
                       g_cnt = k_ + 1; }} }} }} while (0)
"""
_STAMP_API = """
extern "C" int net_stamps(unsigned long long* out, int* n) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));
  return err != cudaSuccess ? err : cudaMemcpyFromSymbol(n, g_cnt, sizeof(int));
}
extern "C" int net_stamps_reset() {
  const int z = 0;
  return cudaMemcpyToSymbol(g_cnt, &z, sizeof(int));
}
"""
SLAB, TAIL = 1000, 2000     # stamp ids inside tc_gemm: + LDW, + N


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"net_levers: the source no longer holds {old!r}")
    return text.replace(old, new)


def _edit(d: Path, name: str, fn: Callable[[str], str]):
    (d / name).write_text(fn((d / name).read_text()))


def _nine_warps(d: Path):
    _edit(d, "net_kernel.cuh", lambda s: _sub(s, "constexpr int NET_THREADS = 384;",
                                              "constexpr int NET_THREADS = THREADS;"))


def _in_cta_split(d: Path):
    _edit(d, "net_kernel.cuh", lambda s: _sub(s, ", true, NT, TIER>(", ", false, NT, TIER>("))


def _ks32_s3(d: Path):
    _edit(d, "net_kernel.cuh", lambda s: _sub(s, "NET_KS = 48, NET_STAGES = 2;",
                                              "NET_KS = 32, NET_STAGES = 3;"))


def _recip_div(d: Path):
    def net(s):
        s = _sub(s, "round_bf16(s[m] / sum) : s[m] / sum;",
                 "round_bf16(s[m] * (1.f / sum)) : s[m] * (1.f / sum);")
        return s

    def gemm(s):
        return _sub(s, "const float o = sc[j] * v[q][j] / den + sh[j];",
                    "const float o = sc[j] * v[q][j] * (1.f / den) + sh[j];")
    _edit(d, "net_kernel.cuh", net)
    _edit(d, "tc_gemm.cuh", gemm)


def _no_mma(d: Path):
    def f(s):
        for a, b in (("ab", "bs"), ("as", "bb"), ("ab", "bb")):
            s = _sub(s, f"if (nt < nts) tf32::mma(part[nt], {a}, {b}[nt]);",
                     f"if (nt < nts) part[nt][0] += "
                     f"__uint_as_float({a}[0]) * __uint_as_float({b}[nt][0]);")
        return s
    _edit(d, "tc_gemm.cuh", f)


def _stamps(d: Path):
    def gemm(s):
        s = _sub(s, "namespace netk {", _STAMP_DEFS + "namespace netk {")
        s = _sub(s, "    __syncthreads();                   // slab j split everywhere",
                 f"    __syncthreads(); STAMP({SLAB} + LDW);  // slab j split everywhere")
        end = "        epi(acc, (j / NSK) * CW + m_warp, rb, g, t, nts);\n    }\n  }\n"
        return _sub(s, end, end + f"  STAMP({TAIL} + N);\n")

    def net(s):   # a stamp after every barrier of the kernel, its line as id
        out = []
        for i, line in enumerate(s.split("\n"), start=1):
            out.append(line)
            if line.strip() == "__syncthreads();":
                out.append(line.replace("__syncthreads();", f"STAMP({i});"))
        return "\n".join(out)
    _edit(d, "tc_gemm.cuh", gemm)
    _edit(d, "net_kernel.cuh", net)
    _edit(d, "net_kernel.cu", lambda s: s + _STAMP_API)


def _no_small_loads(d: Path):
    _edit(d, "tc_gemm.cuh", lambda s: _sub(s, "          as[i] = __float_as_uint(ws[o[i]]);",
                                           "          as[i] = ab[i];"))


def _no_a_split(d: Path):
    def f(s):
        for e, i in (("a0[8 * nt * LDA + kk]", 0), ("a0[8 * nt * LDA + kk + 4]", 1)):
            s = _sub(s, f"tf32::split({e}, bb[nt][{i}], bs[nt][{i}]);",
                     f"bb[nt][{i}] = bs[nt][{i}] = __float_as_uint({e});")
        return s
    _edit(d, "tc_gemm.cuh", f)


def _no_partials(d: Path):
    def f(s):
        s = _sub(s, "        float part[3][4] = {};", "        float (&part)[3][4] = acc[mt];")
        return _sub(s, "          for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[nt][i];",
                    "          for (int i = 0; i < 4; ++i) {}")
    _edit(d, "tc_gemm.cuh", f)


VARIANTS: Dict[str, Optional[Callable[[Path], None]]] = {
    "shipped": None,
    "nine_warps": _nine_warps,
    "in_cta_split": _in_cta_split,
    "ks32_s3": _ks32_s3,
    "recip_div": _recip_div,
    "no_mma": _no_mma,
    "no_small_loads": _no_small_loads,
    "no_a_split": _no_a_split,
    "no_partials": _no_partials,
    "stamps": _stamps,
}
HELD = ("shipped", "nine_warps", "ks32_s3", "recip_div")   # the same function: held to TOL


def build(name: str) -> Path:
    """``csrc/`` patched for ``name``, compiled as ``net_kernel.cu``."""
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    if VARIANTS[name] is not None:
        VARIANTS[name](d)
    lib = d / "net_kernel.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(d / "net_kernel.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}: {proc.stderr[-2000:]}")
    (d / "build.log").write_text(proc.stdout + proc.stderr)
    return lib


@contextlib.contextmanager
def using(lib: ctypes.CDLL):
    """``fused_denoiser``'s launches go to ``lib`` inside the block."""
    saved = fd._library
    fd._library = lambda: lib
    try:
        yield
    finally:
        fd._library = saved


def seeded(device) -> tuple:
    """A GCNDiff (seed 0, every term live) and its inputs at the shapes."""
    gen = torch.Generator().manual_seed(0)
    model = GCNDiff(cheb_basis_from_edges(17, H36M_EDGES))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("A_hat"):
                p.add_(0.1 * torch.rand(p.shape, generator=gen))
            elif name.endswith(("bias", "a_2", "b_2")):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    w = fd.prepare_weights(model.to(device).eval(), device)
    g = torch.Generator(device=device).manual_seed(0)
    cases = {}
    for bsz in (512, 1024):
        z = torch.randn((bsz, 17, 96), generator=g, device=device)
        tp = fd.timestep_projections(w, torch.full((bsz,), 12.0, device=device))
        cases[f"row3_B{bsz}"] = (fd._launch_backbone, (w, z, tp), fd.backbone_plain(w, z, tp))
    x = torch.randn((1024, 17, 5), generator=g, device=device)
    tp = fd.timestep_projections(w, torch.full((1024,), 12.0, device=device))
    cases["row1_B1024"] = (fd._launch, (w, x, tp), fd.net_plain(w, x, tp))
    return cases


def stamp_split(lib: ctypes.CDLL, launch, args) -> Dict[str, int]:
    """Cycles of block 0 by the stage that ends at each stamp, one launch."""
    with using(lib), torch.no_grad():
        for _ in range(3):
            launch(*args)
        torch.cuda.synchronize()
        lib.net_stamps_reset()
        launch(*args)
        torch.cuda.synchronize()
    buf, n = (ctypes.c_ulonglong * (2 * STAMPS))(), ctypes.c_int()
    lib.net_stamps(buf, ctypes.byref(n))
    src = (_build.CSRC / "net_kernel.cuh").read_text().split("\n")
    split: Dict[str, int] = {}
    for i in range(1, n.value):
        sid, cyc = buf[2 * i + 1], buf[2 * i] - buf[2 * i - 2]
        if sid >= TAIL:
            what = f"product N={sid - TAIL}: last slab and epilogue"
        elif sid >= SLAB:
            what = f"product (W rows {sid - SLAB} floats): a slab"
        else:   # the statement before the barrier at line sid
            what = next(l.strip() for l in reversed(src[:sid - 1]) if l.strip() and
                        not l.strip().startswith(("//", "}", "__syncthreads")))[:70]
            what = f"line {sid}: {what}"
        split[what] = split.get(what, 0) + cyc
    split["total"] = buf[2 * n.value - 2] - buf[0]
    return split


def run(rounds: int = 2) -> Dict[str, dict]:
    """ms of each variant at each shape (turn by turn, ``rounds`` times, the
    mean), its max |kernel − plain|, and block 0's stamp split."""
    device = fd.resolve_device("cuda")
    names = list(VARIANTS)
    with ThreadPoolExecutor(len(names)) as pool:
        libs = {n: fd.bind(ctypes.CDLL(str(p.resolve())))
                for n, p in zip(names, pool.map(build, names))}
    for n in ("stamps",):
        libs[n].net_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    cases = seeded(device)
    res: Dict[str, dict] = {n: {"ms": {}, "err": {}} for n in names if n != "stamps"}
    with torch.no_grad():
        for _ in range(rounds):
            for n in res:
                with using(libs[n]):
                    for shape, (launch, args, want) in cases.items():
                        got = launch(*args)
                        torch.cuda.synchronize()
                        res[n]["err"][shape] = float((got - want).abs().max())
                        res[n]["ms"].setdefault(shape, []).append(time_ms(lambda: launch(*args)))
    for n, r in res.items():
        r["ms"] = {k: sum(v) / len(v) for k, v in r["ms"].items()}
        if n in HELD and max(r["err"].values()) > TOL:
            raise RuntimeError(f"net_levers: {n} differs from the plain version: {r['err']}")
    launch, args, _ = cases["row3_B512"]
    res["stamps"] = stamp_split(libs["stamps"], launch, args)
    for n in names:
        for line in (OUT / n / "build.log").read_text().splitlines():
            if "net_forward_kernel" in line or ("Used" in line and "registers" in line):
                res.setdefault("ptxas", {}).setdefault(n, []).append(line.strip())
    return res


def main() -> int:
    res = run()
    for n, r in res.items():
        if n in ("stamps", "ptxas"):
            continue
        print(f"{n:13s} " + "  ".join(f"{k} {v:.4f} ms (err {r['err'][k]:.1e})"
                                      for k, v in r["ms"].items()))
    split = dict(res["stamps"])
    total = split.pop("total")
    print(f"block 0, one bare-stack launch at B=512: {total} cycles")
    for what, cyc in sorted(split.items(), key=lambda kv: -kv[1]):
        print(f"  {cyc:9d} cycles {100 * cyc / total:5.1f}%  {what}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
