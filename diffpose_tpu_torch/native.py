"""ctypes binding for the native host-pipeline library.

Loads ``native/libdiffpose_native.so`` (building it with ``make`` on first
use if a toolchain is available) and exposes:

* :func:`gather_rows` — multithreaded batch row-gather used by the loader,
* :func:`gmm_select` — CPU per-joint categorical GMM kernel draw.

Every entry point has a pure-numpy fallback, so the framework works
without a compiler; the native path is an optimization, selected
automatically when the library loads.

Counterpart of ``diffpose_tpu/native.py`` (this package keeps its own copy).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libdiffpose_native.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _make(force: bool) -> bool:
    try:
        subprocess.run(
            ["make", "-s"] + (["-B"] if force else []), cwd=_NATIVE_DIR,
            check=True, capture_output=True, timeout=120,
        )
        return True
    except Exception:
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.gather_rows.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_int64,
    ]
    lib.gather_rows_multi.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int64, ctypes.c_int64,
    ]
    lib.gmm_select.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.native_num_threads.restype = ctypes.c_int
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH) and not _make(force=False):
        return None
    try:
        _lib = _bind(ctypes.CDLL(_LIB_PATH))
    except (OSError, AttributeError):
        # A stale build artifact may predate a newly added symbol
        # (AttributeError from ctypes): rebuild once and retry.
        _lib = None
        if _make(force=True):
            try:
                _lib = _bind(ctypes.CDLL(_LIB_PATH))
            except (OSError, AttributeError):
                _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``dst[i] = src[idx[i]]`` over the leading axis (native or numpy)."""
    lib = _load()
    idx = np.ascontiguousarray(idx, np.int64)
    if lib is None:
        return np.ascontiguousarray(src[idx])
    src = np.ascontiguousarray(src)
    out = np.empty((idx.shape[0],) + src.shape[1:], src.dtype)
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:], dtype=np.int64))
    lib.gather_rows(
        src.ctypes.data_as(ctypes.c_char_p),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.ctypes.data_as(ctypes.c_char_p),
        ctypes.c_int64(idx.shape[0]),
        ctypes.c_int64(row_bytes),
    )
    return out


def gather_rows_multi(srcs, idx: np.ndarray):
    """Gather the same rows from several arrays in ONE parallel region:
    ``outs[a][i] = srcs[a][idx[i]]`` (the loader's whole batch assembly —
    one call instead of one per array).  Numpy fallback when the native
    library is unavailable."""
    lib = _load()
    idx = np.ascontiguousarray(idx, np.int64)
    if lib is None:
        return [np.ascontiguousarray(s[idx]) for s in srcs]
    srcs = [np.ascontiguousarray(s) for s in srcs]
    outs = [np.empty((idx.shape[0],) + s.shape[1:], s.dtype) for s in srcs]
    n = len(srcs)
    row_bytes = (ctypes.c_int64 * n)(
        *[s.dtype.itemsize * int(np.prod(s.shape[1:], dtype=np.int64)) for s in srcs]
    )
    src_ptrs = (ctypes.c_void_p * n)(*[s.ctypes.data for s in srcs])
    dst_ptrs = (ctypes.c_void_p * n)(*[o.ctypes.data for o in outs])
    lib.gather_rows_multi(
        src_ptrs, row_bytes,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dst_ptrs, ctypes.c_int64(idx.shape[0]), ctypes.c_int64(n),
    )
    return outs


def gmm_select(gmm: np.ndarray, uniform: np.ndarray):
    """Select one kernel per joint by weight; returns (mean_uv, var_uv).

    ``gmm``: [N, J, K, 5] float32; ``uniform``: [N, J] U[0,1).
    Matches the reference's per-joint ``np.random.choice`` semantics
    (``common/generators.py:36-38``) given the same uniform draws.
    """
    gmm = np.ascontiguousarray(gmm, np.float32)
    uniform = np.ascontiguousarray(uniform, np.float32)
    n, j, k, c = gmm.shape
    assert c == 5 and uniform.shape == (n, j)
    lib = _load()
    if lib is None:
        w = gmm[..., 0]
        cdf = np.cumsum(w, axis=-1)
        pick = np.sum(uniform[..., None] >= cdf, axis=-1)
        pick = np.minimum(pick, k - 1)
        sel = np.take_along_axis(gmm, pick[..., None, None], axis=2)[:, :, 0]
        return sel[..., 1:3].copy(), sel[..., 3:5].copy()
    out_uv = np.empty((n, j, 2), np.float32)
    out_var = np.empty((n, j, 2), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.gmm_select(
        gmm.ctypes.data_as(fp), uniform.ctypes.data_as(fp),
        out_uv.ctypes.data_as(fp), out_var.ctypes.data_as(fp),
        ctypes.c_int64(n), ctypes.c_int64(j), ctypes.c_int64(k),
    )
    return out_uv, out_var
