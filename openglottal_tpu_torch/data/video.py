"""Video decode and colour conversion.

Counterpart of ``openglottal_tpu/data/video.py``.  ``bgr_to_gray_u8`` is the
reference's formula, cv2's fixed-point BT.601 coefficients, bit for bit.
(It is the reference's formula that is matched, not cv2 itself: cv2 5.0.0's
``cvtColor`` differs from it by 1 on 0.26 % of colours.)

``load_frames_bgr`` / ``iter_frames_bgr`` decode a video as the JAX
package's do, as (T, H, W, 3) uint8 BGR frames, but without cv2, which the
port does not import: the port reads AVI files itself, in numpy.  It walks
the RIFF tree (``RIFF AVI `` and any ``RIFF AVIX`` that follow it, nested
``LIST`` chunks such as ``movi`` and ``rec ``, ``JUNK`` and index chunks
skipped, each chunk's data padded to an even length) and takes the frames
of the first video stream (``##db`` / ``##dc`` chunks) in file order, so an
absent or broken ``idx1`` does not matter.  Formats decoded:

  * uncompressed 8-bit gray (fourcc ``Y800``, ``GREY``, ``Y8  ``): rows top
    down, returned as three equal BGR channels, as cv2 returns them;
  * ``BI_RGB`` (compression 0, or the fourcc ``DIB ``), 24-bit BGR or 8-bit
    palettised: rows bottom up for a positive height, top down for a
    negative one, each row padded to a multiple of 4 bytes.

Any other codec (MJPG, I420, ...) raises ``ValueError`` naming its fourcc:
compressed decode is not ported.  A missing or empty file gives no frames,
as cv2 gives none.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

GRAY_FOURCCS = (b"Y800", b"GREY", b"Y8  ")
RGB_FOURCCS = (b"\x00\x00\x00\x00", b"DIB ")


def bgr_to_gray_u8(frames_bgr):
    """(..., 3) uint8 BGR -> (...) uint8 gray:
    (R*4899 + G*9617 + B*1868 + (1 << 13)) >> 14, on the array's device (a
    tensor) or on the host (a numpy array)."""
    if isinstance(frames_bgr, torch.Tensor):
        x = frames_bgr.to(torch.int32)
        out_dtype = torch.uint8
    else:
        x = np.asarray(frames_bgr).astype(np.int32)
        out_dtype = np.uint8
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    gray = (r * 4899 + g * 9617 + b * 1868 + (1 << 13)) >> 14
    return gray.to(out_dtype) if isinstance(gray, torch.Tensor) else \
        gray.astype(out_dtype)


# ── the AVI reader ──────────────────────────────────────────────────────────

def _chunks(f, start: int, end: int):
    """(id, size, data offset) of the RIFF chunks in [start, end) of ``f``;
    a chunk that runs past ``end`` is cut there (a truncated file)."""
    pos = start
    while pos + 8 <= end:
        f.seek(pos)
        head = f.read(8)
        if len(head) < 8:
            return
        size = struct.unpack("<I", head[4:])[0]
        size = min(size, end - pos - 8)
        yield head[:4], size, pos + 8
        pos += 8 + size + (size & 1)


class _Format:
    """The first video stream's frame layout, from its ``strf``
    (BITMAPINFOHEADER and palette)."""

    def __init__(self, strf: bytes):
        if len(strf) < 40:
            raise ValueError("AVI: the video stream's format is too short")
        (_, w, h, _, bits, comp) = struct.unpack("<IiiHH4s", strf[:20])
        clr_used = struct.unpack("<I", strf[32:36])[0]
        self.w, self.h = w, abs(h)
        self.palette = None
        if comp in GRAY_FOURCCS and bits == 8:
            self.kind, self.stride, self.bottom_up = "gray", w, False
        elif comp in RGB_FOURCCS and bits in (24, 8):
            self.kind = "bgr" if bits == 24 else "pal"
            self.stride = (w * bits // 8 + 3) // 4 * 4
            self.bottom_up = h > 0
            if bits == 8:
                n = clr_used or 256
                pal = np.frombuffer(strf[40:40 + 4 * n], np.uint8)
                pal = pal[:len(pal) // 4 * 4].reshape(-1, 4)[:, :3]
                self.palette = np.zeros((256, 3), np.uint8)
                self.palette[:len(pal)] = pal
        else:
            name = comp.decode("latin-1") if comp != b"\0\0\0\0" else "BI_RGB"
            raise ValueError(
                f"AVI: codec {name!r} ({bits}-bit) is not decoded; this "
                f"reader decodes uncompressed Y800 / GREY / Y8 gray and "
                f"BI_RGB 24-bit or 8-bit palettised frames")
        if self.w <= 0 or self.h <= 0:
            raise ValueError(f"AVI: bad frame size {w}x{h}")

    def decode(self, data: bytes) -> np.ndarray:
        """One frame chunk -> (H, W, 3) uint8 BGR."""
        need = self.stride * self.h
        if len(data) < need:
            raise ValueError(f"AVI: a frame chunk holds {len(data)} bytes, "
                             f"a {self.w}x{self.h} frame needs {need}")
        rows = np.frombuffer(data, np.uint8, need).reshape(self.h,
                                                           self.stride)
        if self.bottom_up:
            rows = rows[::-1]
        if self.kind == "gray":
            px = rows[:, :self.w]
            return np.repeat(px[..., None], 3, axis=-1)
        if self.kind == "bgr":
            return np.ascontiguousarray(
                rows[:, :3 * self.w].reshape(self.h, self.w, 3))
        return self.palette[rows[:, :self.w]]


def _frames(path):
    """Decoded frames of an AVI file, one (H, W, 3) uint8 BGR array at a
    time, in file order."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return
    if size == 0:
        return
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"AVI ":
            raise ValueError(f"{path}: not a RIFF AVI file (other "
                             f"containers are not decoded)")
        state = {"streams": 0, "video": None, "fmt": None}
        for data in _walk(f, 0, size, state):
            yield state["fmt"].decode(data)


def _walk(f, start: int, end: int, state: dict):
    """The video stream's frame chunks (bytes) of the chunks in [start,
    end), descending into ``RIFF`` / ``LIST`` chunks; ``strl`` lists set the
    stream's number and format in ``state`` as they come."""
    for cid, size, off in _chunks(f, start, end):
        if cid in (b"RIFF", b"LIST"):
            f.seek(off)
            kind = f.read(4)
            if kind == b"strl":
                _stream_list(f, off + 4, off + size, state)
            else:
                yield from _walk(f, off + 4, off + size, state)
        elif (state["video"] is not None and cid[2:] in (b"db", b"dc")
              and cid[:2] == state["video"]):
            if size == 0:
                continue        # an empty chunk: a dropped frame, no data
            f.seek(off)
            yield f.read(size)


def _stream_list(f, start: int, end: int, state: dict) -> None:
    """One ``strl``: the first stream whose ``strh`` says ``vids`` is the
    video stream; its number gives the frame chunks' ids (``00dc`` ...)."""
    number = state["streams"]
    state["streams"] += 1
    vids = False
    for cid, size, off in _chunks(f, start, end):
        f.seek(off)
        if cid == b"strh":
            vids = f.read(4) == b"vids"
        elif cid == b"strf" and vids and state["video"] is None:
            state["fmt"] = _Format(f.read(size))
            state["video"] = b"%02d" % number


def load_frames_bgr(path) -> np.ndarray:
    """Decode all frames of an AVI file as one (T, H, W, 3) uint8 BGR
    array; (0, 0, 0, 3) for a missing or empty file."""
    frames = list(_frames(path))
    if not frames:
        return np.zeros((0, 0, 0, 3), np.uint8)
    return np.stack(frames)


def iter_frames_bgr(path, chunk: int = 512):
    """Decode an AVI file as a stream of (n <= chunk, H, W, 3) uint8 BGR
    arrays, ``chunk`` frames each and the rest last: bounded host memory for
    the streaming pipelines (``GlottalPipelines.stream_areas``)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    frames = []
    for fr in _frames(path):
        frames.append(fr)
        if len(frames) == chunk:
            yield np.stack(frames)
            frames = []
    if frames:
        yield np.stack(frames)
