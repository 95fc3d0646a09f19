"""Build the CUDA sources in ``diffpose_tpu_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/<name>-<hash>.so`` at the root of
the checkout, compiled by ``nvcc`` for ``sm_90a`` (Hopper).  The hash
covers every file under ``csrc/`` and the flags, so an edited source is
rebuilt and an unchanged one is reused.  Nothing here runs when the
package is imported: the first call of a kernel builds it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    candidates = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if os.environ.get("CUDA_HOME"):
        candidates.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a host with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def build_log(name: str) -> str:
    """What nvcc and ptxas reported (registers, shared memory, spills)."""
    return library_path(name).with_suffix(".log").read_text()


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of these sources exists."""
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def build_all() -> Dict[str, Path]:
    """Build every ``csrc/*.cu``, one nvcc process per source, all at once."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)))
