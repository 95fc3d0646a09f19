"""Where kernel rows 9 and 10 spend their time, phase by phase.

Builds ``csrc/video_kernel.cu`` with ``VIDK_STAMPS`` defined (into
``build/video_stamps/``): thread 0 of block 0 then sums ``clock64()``
cycles by phase (``csrc/video_kernel.cuh``): S, row 9's spatial layer of a
tile; T1, LN1 and Q|K|V; T2, the attention; T3, the out-projection, LN2 and
the feed-forward; and the two waits at the grid-wide barriers, which hold
what block 0 waits for the other CTAs.  One warm launch is read at a
time.  ``chip_smoke.py`` phase 17 runs it; on the card only.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import subprocess
from typing import Callable, Dict

import torch

from diffpose_tpu_torch.ops import _build
from diffpose_tpu_torch.ops import fused_video_full as fv

OUT = _build.BUILD_DIR / "video_stamps"
PHASES = ("S", "T1", "wait 1", "T2", "wait 2", "T3")   # vidk_cycles[0..5]


def build() -> str:
    """The stamped build of these sources (reused while they are unchanged)."""
    lib = OUT / f"video_kernel-{_build._digest()}.so"
    if not lib.exists():
        OUT.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(".tmp")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DVIDK_STAMPS", "-o", str(tmp),
               str(_build.CSRC / "video_kernel.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        tmp.replace(lib)
    return str(lib)


@functools.lru_cache(maxsize=None)
def _stamped() -> ctypes.CDLL:
    lib = fv.bind(ctypes.CDLL(build()))
    lib.video_cycles.argtypes = [ctypes.c_void_p]
    lib.video_cycles_reset.argtypes = []
    return lib


@contextlib.contextmanager
def _using_stamped():
    saved = fv._library
    fv._library = _stamped
    try:
        yield _stamped()
    finally:
        fv._library = saved


def cycles(launch: Callable[[], torch.Tensor]) -> Dict[str, int]:
    """Block 0's cycles by phase in one warm call of ``launch`` (a call of
    ``fv._launch_temporal`` or ``fv._launch_st``), with their total."""
    with _using_stamped() as lib:
        launch()
        torch.cuda.synchronize()
        if lib.video_cycles_reset() != 0:
            raise RuntimeError("video_cycles_reset failed")
        launch()
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * 8)()
        if lib.video_cycles(ctypes.addressof(buf)) != 0:
            raise RuntimeError("video_cycles failed")
    split = dict(zip(PHASES, (int(v) for v in buf)))
    split["total"] = sum(split.values())
    return split
