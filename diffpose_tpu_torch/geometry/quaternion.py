"""Quaternion rotation helpers (host-side numpy).

Capability parity with the reference ``common/quaternion.py:6-31``; used by
the one-time dataset preparation (world→camera transform), so these run on
the host in numpy — there is nothing hot here.

Counterpart of ``diffpose_tpu/geometry/quaternion.py`` (this package keeps its own copy).
"""

from __future__ import annotations

import numpy as np


def qrot(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vectors ``v`` (…, 3) by unit quaternions ``q`` (…, 4) [w,x,y,z].

    Uses the standard 15-multiply form ``v + 2 (w (q⃗×v) + q⃗×(q⃗×v))``.
    Broadcasts over leading dimensions.
    """
    q = np.asarray(q)
    v = np.asarray(v)
    assert q.shape[-1] == 4 and v.shape[-1] == 3
    qvec = q[..., 1:]
    uv = np.cross(qvec, v)
    uuv = np.cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def qinverse(q: np.ndarray) -> np.ndarray:
    """Conjugate of a (unit) quaternion: negate the vector part."""
    q = np.asarray(q)
    return np.concatenate([q[..., :1], -q[..., 1:]], axis=-1)
