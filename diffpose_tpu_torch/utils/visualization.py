"""Pose visualization: 2D keypoints + 3D reconstructions → mp4/avi/gif.

The port's own copy of ``diffpose_tpu/utils/visualization.py`` (framework-free;
the port imports nothing of the JAX package).  Capability parity with the reference ``common/visualization.py:58-183``
(``render_animation``, ``read_video``): an input panel with the 2D
keypoints over video (or black background) next to one 3D subplot per
named pose sequence.  Writers: ffmpeg (mp4), pillow (gif), and a
DEPENDENCY-FREE MJPEG-AVI path (``.avi``) built from Pillow JPEG frames
and hand-packed RIFF chunks — so video export works (and is tested) on
hosts without ffmpeg, like this build environment.  ``read_video``
prefers the ffmpeg rawvideo pipe and transparently falls back to the
pure-Python MJPEG-AVI parser when ffmpeg is absent.
Host-side, optional dependency on matplotlib — not on any hot path.
"""

from __future__ import annotations

import io
import struct
import subprocess as sp
from typing import Dict, Iterable, Optional, Tuple

import numpy as np


def downsample_tensor(x: np.ndarray, factor: int) -> np.ndarray:
    length = x.shape[0] // factor * factor
    return np.mean(x[:length].reshape(-1, factor, *x.shape[1:]), axis=1)


def read_video(filename: str, fps: Optional[float] = None, skip: int = 0):
    """Yield RGB frames from a video.

    ffmpeg rawvideo pipe when available (any container/codec, matching
    the reference ``common/visualization.py:16-28``); without ffmpeg,
    MJPEG-AVI files (as written by :func:`write_mjpeg_avi` /
    ``render_animation(output="*.avi")``) decode through the pure-Python
    parser.
    """
    try:
        w, h = _get_resolution(filename)
    except (FileNotFoundError, sp.CalledProcessError):
        yield from _read_mjpeg_avi(filename, skip=skip)
        return
    cmd = ["ffmpeg", "-i", filename, "-f", "image2pipe", "-pix_fmt", "rgb24",
           "-vsync", "0", "-vcodec", "rawvideo", "-"]
    pipe = sp.Popen(cmd, stdout=sp.PIPE, stderr=sp.DEVNULL, bufsize=-1)
    i = 0
    while True:
        data = pipe.stdout.read(w * h * 3)
        if not data:
            break
        i += 1
        if i > skip:
            yield np.frombuffer(data, dtype="uint8").reshape(h, w, 3)
    pipe.stdout.close()


def _get_resolution(filename: str) -> Tuple[int, int]:
    cmd = ["ffprobe", "-v", "error", "-select_streams", "v:0",
           "-show_entries", "stream=width,height", "-of", "csv=p=0", filename]
    out = sp.check_output(cmd, stderr=sp.DEVNULL).decode().strip().split(",")
    return int(out[0]), int(out[1])


# ---------------------------------------------------------------------------
# Pure-Python MJPEG-AVI container (no ffmpeg required)
# ---------------------------------------------------------------------------


def write_mjpeg_avi(path: str, frames: Iterable[np.ndarray], fps: int,
                    quality: int = 85) -> int:
    """Write RGB uint8 frames [H, W, 3] as an MJPEG AVI; returns the
    frame count.  Standard RIFF layout (hdrl/movi/idx1) with per-frame
    Pillow JPEGs — playable by ffmpeg/VLC/browsers and readable back by
    :func:`read_video` on ffmpeg-less hosts."""
    from PIL import Image

    jpegs = []
    size = None
    for fr in frames:
        fr = np.ascontiguousarray(fr)
        assert fr.dtype == np.uint8 and fr.ndim == 3 and fr.shape[2] == 3, fr.shape
        if size is None:
            size = (fr.shape[1], fr.shape[0])
        assert (fr.shape[1], fr.shape[0]) == size, "frame size must be constant"
        buf = io.BytesIO()
        Image.fromarray(fr).save(buf, format="JPEG", quality=quality)
        jpegs.append(buf.getvalue())
    assert jpegs, "no frames"
    w, h = size
    n = len(jpegs)
    max_size = max(len(j) for j in jpegs)

    avih = struct.pack(
        "<14I", int(1e6 / max(fps, 1)), max_size * fps, 0, 0x10,  # HASINDEX
        n, 0, 1, max_size, w, h, 0, 0, 0, 0)
    strh = struct.pack(
        "<4s4sIHHIIIIIIIi4H", b"vids", b"MJPG", 0, 0, 0, 0, 1, int(fps),
        0, n, max_size, 0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG",
                       w * h * 3, 0, 0, 0, 0)

    def chunk(ckid: bytes, data: bytes) -> bytes:
        return ckid + struct.pack("<I", len(data)) + data \
            + (b"\x00" if len(data) % 2 else b"")

    def lst(kind: bytes, data: bytes) -> bytes:
        return b"LIST" + struct.pack("<I", len(data) + 4) + kind + data

    strl = lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf))
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + strl)

    movi_parts = []
    idx_parts = []
    offset = 4  # after the 'movi' fourcc
    for j in jpegs:
        movi_parts.append(chunk(b"00dc", j))
        idx_parts.append(b"00dc" + struct.pack("<III", 0x10, offset, len(j)))
        offset += len(movi_parts[-1])
    movi = lst(b"movi", b"".join(movi_parts))
    idx1 = chunk(b"idx1", b"".join(idx_parts))

    riff_body = b"AVI " + hdrl + movi + idx1
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff_body)) + riff_body)
    return n


def _read_mjpeg_avi(filename: str, skip: int = 0):
    """Yield RGB frames from an MJPEG AVI (pure Python + Pillow)."""
    from PIL import Image

    with open(filename, "rb") as f:
        data = f.read()
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI ", "not an AVI file"

    def walk(pos: int, end: int):
        while pos + 8 <= end:
            ckid = data[pos:pos + 4]
            (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
            body = pos + 8
            if ckid == b"LIST":
                kind = data[body:body + 4]
                if kind in (b"movi", b"rec "):
                    yield from walk(body + 4, body + size)
                elif kind == b"hdrl":
                    pass
            elif ckid in (b"00dc", b"00db"):
                yield data[body:body + size]
            pos = body + size + (size % 2)

    i = 0
    for jpeg in walk(12, len(data)):
        i += 1
        if i > skip:
            yield np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB"))


def render_animation(
    keypoints: np.ndarray,
    poses: Dict[str, np.ndarray],
    skeleton,
    fps: int,
    bitrate: int,
    azim: float,
    output: str,
    viewport: Tuple[int, int],
    limit: int = -1,
    downsample: int = 1,
    size: int = 6,
    input_video_path: Optional[str] = None,
    input_video_skip: int = 0,
):
    """Animate 2D inputs + 3D pose panels and save to mp4/avi/gif.

    ``.mp4`` needs ffmpeg; ``.avi`` (MJPEG) and ``.gif`` (pillow) are
    dependency-free.

    ``keypoints``: [F, J, 2] screen coords; ``poses``: {title: [F, J, 3]};
    ``skeleton``: a :class:`diffpose_tpu_torch.skeleton.Skeleton`.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, writers

    if limit < 1:
        limit = keypoints.shape[0]
    limit = min(limit, keypoints.shape[0], *[p.shape[0] for p in poses.values()])
    if downsample > 1:
        keypoints = downsample_tensor(keypoints, downsample)
        poses = {k: downsample_tensor(v, downsample) for k, v in poses.items()}
        limit = limit // downsample
        fps = max(fps // downsample, 1)

    if input_video_path is None:
        frames = np.zeros((limit, viewport[1], viewport[0]), dtype="uint8")
    else:
        frames = list(read_video(input_video_path, skip=input_video_skip))[:limit]

    parents = skeleton.parents()
    left = set(skeleton.joints_left() or [])

    fig = plt.figure(figsize=(size * (1 + len(poses)), size))
    ax_in = fig.add_subplot(1, 1 + len(poses), 1)
    ax_in.set_axis_off()
    ax_in.set_title("Input")

    radius = 1.7
    axes_3d = []
    for index, title in enumerate(poses):
        ax = fig.add_subplot(1, 1 + len(poses), index + 2, projection="3d")
        ax.view_init(elev=15.0, azim=azim)
        ax.set_xlim3d([-radius / 2, radius / 2])
        ax.set_zlim3d([0, radius])
        ax.set_ylim3d([-radius / 2, radius / 2])
        ax.set_xticklabels([])
        ax.set_yticklabels([])
        ax.set_zticklabels([])
        ax.set_title(title)
        axes_3d.append(ax)
    pose_list = list(poses.values())

    image = ax_in.imshow(frames[0], aspect="equal")
    points = ax_in.scatter(*keypoints[0].T, s=10, color="red", edgecolors="white", zorder=10)
    lines_3d = [[] for _ in pose_list]

    def update(i):
        image.set_data(frames[i] if i < len(frames) else frames[-1])
        points.set_offsets(keypoints[i])
        for p_idx, (ax, pos) in enumerate(zip(axes_3d, pose_list)):
            for artist in lines_3d[p_idx]:
                artist.remove()
            lines_3d[p_idx] = []
            for j, parent in enumerate(parents):
                if parent < 0:
                    continue
                col = "black" if j in left else "red"
                (ln,) = ax.plot(
                    [pos[i, j, 0], pos[i, parent, 0]],
                    [pos[i, j, 1], pos[i, parent, 1]],
                    [pos[i, j, 2], pos[i, parent, 2]],
                    zdir="z", c=col,
                )
                lines_3d[p_idx].append(ln)
        return []

    if output.endswith(".avi"):
        # dependency-free video export: render each frame with Agg and
        # pack the JPEGs into an MJPEG AVI (works without ffmpeg)
        def frame_iter():
            for i in range(limit):
                update(i)
                fig.canvas.draw()
                rgba = np.asarray(fig.canvas.buffer_rgba())
                yield np.ascontiguousarray(rgba[..., :3])

        write_mjpeg_avi(output, frame_iter(), fps=fps)
        plt.close(fig)
        return

    anim = FuncAnimation(fig, update, frames=limit, interval=1000.0 / fps, blit=False)
    if output.endswith(".mp4"):
        writer = writers["ffmpeg"](fps=fps, bitrate=bitrate)
        anim.save(output, writer=writer)
    elif output.endswith(".gif"):
        anim.save(output, dpi=80, writer="pillow")
    else:
        raise ValueError(f"Unsupported output format ({output})")
    plt.close(fig)
