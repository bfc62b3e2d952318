"""Video decode and colour conversion.

Counterpart of ``openglottal_tpu/data/video.py``.  ``bgr_to_gray_u8`` is the
reference's formula, cv2's fixed-point BT.601 coefficients, bit for bit.
(It is the reference's formula that is matched, not cv2 itself: cv2 5.0.0's
``cvtColor`` differs from it by 1 on 0.26 % of colours.)

The JAX package decodes with cv2; the port reads AVI files itself, in numpy,
and decodes MJPG on the card.  It walks the RIFF tree (``RIFF AVI `` and
any ``RIFF AVIX`` that follow it, nested ``LIST`` chunks such as ``movi``
and ``rec ``, ``JUNK`` and index chunks skipped, each chunk's data padded
to an even length) and takes the frames of the first video stream (``##db``
/ ``##dc`` chunks) in file order, so an absent or broken ``idx1`` does not
matter.  Formats decoded:

  * uncompressed 8-bit gray (fourcc ``Y800``, ``GREY``, ``Y8  ``): rows top
    down, returned as three equal BGR channels, as cv2 returns them;
  * ``BI_RGB`` (compression 0, or the fourcc ``DIB ``), 24-bit BGR or 8-bit
    palettised: rows bottom up for a positive height, top down for a
    negative one, each row padded to a multiple of 4 bytes;
  * MJPG (fourcc ``MJPG``, ``mjpg`` or ``AVI1``): baseline JPEG frames
    (``data/jpeg.py``: 8-bit, gray or 4:4:4 / 4:2:2 / 4:2:0, restart
    intervals, the Annex K Huffman tables where a frame has none), parsed on
    the host and decoded on the card by ``ops/jpeg_cuda`` (two kernels),
    equal to cv2's frames (FFmpeg's IDCT and swscale's conversion) bit for
    bit; 4:2:0 / 4:2:2 frames of odd height, which swscale scales through
    bicubic chroma filters not ported here, are refused (ROADMAP.md, C).
    Only the compressed bytes cross to the card.

Any other codec (I420, H.264, ...) raises ``ValueError`` naming its fourcc,
as does a container other than RIFF AVI (``.mp4``).  A missing or empty
file gives no frames, as cv2 gives none.

Host frames (the JAX package's contract): ``load_frames_bgr`` /
``iter_frames_bgr`` return (T, H, W, 3) uint8 BGR numpy arrays; MJPG frames
are decoded on ``device`` and copied back once.  Device frames:
``read_frames`` / ``iter_frames`` return uint8 tensors on ``device``, (T,
H, W) for gray sources (a one-component MJPG, and uncompressed frames whose
channels are equal, as the pipelines' own check finds them) and (T, H, W,
3) BGR otherwise: uncompressed frames are uploaded once, an MJPG chunk
crosses as its packed compressed bytes (from pinned memory, on a side
stream) and is decoded there.  ``device=None`` is the CUDA device (raises
without one); ``"cpu"`` runs the kernels' plain versions.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

GRAY_FOURCCS = (b"Y800", b"GREY", b"Y8  ")
RGB_FOURCCS = (b"\x00\x00\x00\x00", b"DIB ")
MJPG_FOURCCS = (b"MJPG", b"mjpg", b"AVI1")


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


def is_monochrome(frames_np) -> bool:
    """Host-side check whether a (T, H, W, 3) uint8 video has equal channels
    (checked on first/middle/last frames)."""
    if not isinstance(frames_np, np.ndarray) or frames_np.ndim != 4:
        return False
    t = frames_np.shape[0]
    if t == 0:
        return False
    f = frames_np[[0, t // 2, t - 1]]
    return bool((f[..., 0] == f[..., 1]).all()
                and (f[..., 1] == f[..., 2]).all())


def _resolve(device) -> torch.device:
    """``None`` -> the CUDA device (raises without one)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "MJPG frames are decoded on a CUDA device and none is "
                "available; pass device='cpu' to decode on the CPU on "
                "purpose")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


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
        if comp in MJPG_FOURCCS:
            self.kind, self.stride, self.bottom_up = "mjpg", 0, False
        elif comp in GRAY_FOURCCS and bits == 8:
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
                f"reader decodes uncompressed Y800 / GREY / Y8 gray, BI_RGB "
                f"24-bit or 8-bit palettised and MJPG (baseline JPEG) "
                f"frames")
        if self.w <= 0 or self.h <= 0:
            raise ValueError(f"AVI: bad frame size {w}x{h}")

    def decode(self, data: bytes) -> np.ndarray:
        """One uncompressed frame chunk -> (H, W, 3) uint8 BGR."""
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


def _raw(path):
    """(format, frame chunk bytes) of the video stream's frames, in file
    order; nothing for a missing or empty file."""
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
            yield state["fmt"], data


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


def _pieces(path, chunk: int):
    """The video in pieces of ``chunk`` frames (the rest last): ("host",
    (n, H, W, 3) uint8 BGR array) for uncompressed frames, ("mjpg", list of
    parsed frames, number of the first) for MJPG; the tables carry across
    pieces as FFmpeg carries them."""
    from openglottal_tpu_torch.data import jpeg

    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    buf, first, n, state = [], 0, 0, None
    kind = None
    for fmt, data in _raw(path):
        kind = fmt.kind
        if kind == "mjpg":
            state = state or jpeg.JpegState()
            frame = jpeg.parse_frame(data, state, n)
            if 4 * frame.geo.h < 3 * fmt.h:
                # FFmpeg's test for a frame of two interlaced fields
                raise ValueError(
                    f"JPEG frame {n}: {frame.geo.h} rows in a {fmt.h}-row "
                    f"stream: interlaced MJPG fields are not decoded")
            buf.append(frame)
        else:
            buf.append(fmt.decode(data))
        n += 1
        if len(buf) == chunk:
            yield _piece(kind, buf, first)
            buf, first = [], n
    if buf:
        yield _piece(kind, buf, first)


def _piece(kind, buf, first):
    if kind == "mjpg":
        return "mjpg", buf, first
    return "host", np.stack(buf), first


class _Decoder:
    """MJPG chunks decoded on one device: on a CUDA device the packed arrays
    go through a pinned uploader (``data/prefetch.PinnedUploader``) and are
    decoded on its side stream, which the caller's stream then waits for
    (the error check syncs the side stream only); on the CPU the plain
    versions."""

    def __init__(self, device: torch.device):
        from openglottal_tpu_torch.data.prefetch import PinnedUploader
        from openglottal_tpu_torch.ops import jpeg_cuda

        self.jc = jpeg_cuda
        self.device = device
        self.up = PinnedUploader(device, 2) if device.type == "cuda" else None

    def __call__(self, frames, first: int) -> torch.Tensor:
        from openglottal_tpu_torch.data import jpeg

        p = jpeg.pack(frames, first)
        if self.up is None:
            return self.jc.decode(p, self.device, first)
        with torch.cuda.device(self.device), torch.cuda.stream(self.up.stream):
            out = self.jc.decode(p, self.device, first, self.up)
        cur = torch.cuda.current_stream(self.device)
        cur.wait_stream(self.up.stream)
        out.record_stream(cur)
        return out


def _upload(frames: np.ndarray, device: torch.device) -> torch.Tensor:
    """Uncompressed host frames on ``device``: one channel where the
    channels are equal (``is_monochrome``), through pinned memory."""
    if is_monochrome(frames):
        frames = frames[..., 0]
    x = torch.from_numpy(np.ascontiguousarray(frames))
    if device.type == "cuda":
        return x.pin_memory().to(device, non_blocking=True)
    return x


def iter_frames(path, chunk: int = 512, device=None):
    """The video as a stream of uint8 tensors on ``device``, ``chunk``
    frames each and the rest last: (n, H, W) for gray sources, else (n, H,
    W, 3) BGR (see the module docstring).  An MJPG chunk's device memory is
    its packed bytes, its coefficients (128 bytes an 8x8 block) and its
    frames."""
    dec, dev = None, None
    for kind, body, first in _pieces(path, chunk):
        if dev is None:
            dev = _resolve(device)
        if kind == "mjpg":
            dec = dec or _Decoder(dev)
            yield dec(body, first)
        else:
            yield _upload(body, dev)


def _device_frames(pieces, dev: torch.device) -> torch.Tensor:
    """The pieces of a whole video (``_pieces``) as one tensor on ``dev``;
    MJPG pieces decoded one by one into the output."""
    if pieces[0][0] == "host":
        return _upload(np.concatenate([b for _, b, _ in pieces]), dev)
    dec = _Decoder(dev)
    out, t = None, sum(len(b) for _, b, _ in pieces)
    for _, body, first in pieces:
        x = dec(body, first)
        if out is None:
            out = torch.empty((t,) + tuple(x.shape[1:]), dtype=torch.uint8,
                              device=dev)
        out[first:first + len(body)] = x
    return out


def read_frames(path, device=None) -> torch.Tensor:
    """All frames of an AVI file as one uint8 tensor on ``device`` ((T, H,
    W) for gray sources, else (T, H, W, 3) BGR); (0, 0, 0, 3) for a missing
    or empty file.  MJPG is decoded in chunks of 512 frames into the one
    output, so the coefficients never take more than a chunk's memory."""
    dev = _resolve(device)
    pieces = list(_pieces(path, 512))
    if not pieces:
        return torch.zeros((0, 0, 0, 3), dtype=torch.uint8, device=dev)
    return _device_frames(pieces, dev)


def _to_host_bgr(x: torch.Tensor) -> np.ndarray:
    a = x.cpu().numpy()
    return np.repeat(a[..., None], 3, axis=-1) if a.ndim == 3 else a


def load_frames_bgr(path, device=None) -> np.ndarray:
    """Decode all frames of an AVI file as one (T, H, W, 3) uint8 BGR
    array; (0, 0, 0, 3) for a missing or empty file.  MJPG frames are
    decoded on ``device`` (None: the CUDA device) and copied back once."""
    pieces = list(_pieces(path, 512))
    if not pieces:
        return np.zeros((0, 0, 0, 3), np.uint8)
    if pieces[0][0] == "host":
        return np.concatenate([b for _, b, _ in pieces])
    return _to_host_bgr(_device_frames(pieces, _resolve(device)))


def iter_frames_bgr(path, chunk: int = 512, device=None):
    """Decode an AVI file as a stream of (n <= chunk, H, W, 3) uint8 BGR
    arrays, ``chunk`` frames each and the rest last: bounded host memory for
    the streaming pipelines (``GlottalPipelines.stream_areas``).  MJPG
    chunks are decoded on ``device`` (None: the CUDA device)."""
    dec = None
    for kind, body, first in _pieces(path, chunk):
        if kind == "host":
            yield body
            continue
        dec = dec or _Decoder(_resolve(device))
        yield _to_host_bgr(dec(body, first))
