"""PNG files without cv2 or PIL: a reader that gives ``cv2.imread``'s arrays
and a small writer, from the standard library's ``zlib`` and numpy.

The reader takes non-interlaced PNGs of 8-bit gray, gray + alpha, RGB, RGBA
and palette colour (and 1-, 2- and 4-bit gray and palette), undoes the five
row filters, and returns what cv2 5.0.0 returns, bit for bit:

  * :func:`imread_gray` (``cv2.IMREAD_GRAYSCALE``): colour is converted
    inside cv2's PNG decoder (libpng's ``png_set_rgb_to_gray`` with 0.299 /
    0.587 as 15-bit weights), as ``(9797·R + 19234·G + 3737·B) >> 15``,
    truncated; found by comparing bits, it is neither ``cvtColor``'s rounding
    nor the port's ``bgr_to_gray_u8``.  Alpha is dropped; low-bit gray is
    scaled to 8 bits (v·255 / (2^d − 1)).
  * :func:`imread_bgr` (``cv2.IMREAD_COLOR``): (H, W, 3) BGR; gray is
    replicated, alpha dropped, palette entries looked up.

16-bit and interlaced files are refused with ``ValueError``; a missing file
gives ``None``, as cv2 gives it.  Gamma and colour-space chunks are ignored
(cv2 ignores them too when it reads 8-bit data).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_GRAY_WEIGHTS = (9797, 19234, 3737)      # R, G, B over 2^15


def _chunks(data: bytes, path):
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: no IEND chunk")


def _paeth_row(cur: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _average_row(cur: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prior[i]) >> 1)) & 0xFF


def unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The filtered scanlines (a filter byte, then ``stride`` bytes, per
    row) -> (h, stride) uint8, filters 0-4 undone."""
    if len(raw) < h * (stride + 1):
        raise ValueError("PNG image data is short")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h,
                                                                  stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, cur = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            rec = cur
        elif ftype == 1:      # sub: a running sum per byte of the pixel
            pad = (-stride) % bpp
            v = np.concatenate([cur, np.zeros(pad, np.uint8)]).reshape(-1,
                                                                       bpp)
            rec = (np.cumsum(v.astype(np.int64), 0) & 0xFF).astype(
                np.uint8).reshape(-1)[:stride]
        elif ftype == 2:
            rec = cur + prior
        elif ftype in (3, 4):
            buf = bytearray(cur.tobytes())
            (_average_row if ftype == 3 else _paeth_row)(buf, prior.tobytes(),
                                                         bpp)
            rec = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
        out[y] = rec
        prior = out[y]
    return out


def _unpack_bits(rows: np.ndarray, w: int, depth: int) -> np.ndarray:
    """(h, stride) rows of ``depth``-bit samples -> (h, w) uint8 samples."""
    if depth == 8:
        return rows[:, :w]
    bits = np.unpackbits(rows, axis=1)
    bits = bits[:, :w * depth].reshape(rows.shape[0], w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1).astype(np.uint8)


def decode_png(data: bytes, path="<bytes>"):
    """PNG bytes -> (samples (H, W, C) uint8, colour type, palette (N, 3) or
    None, bit depth), C the file's channels (palette indices for colour
    type 3), low-bit samples unpacked but not scaled."""
    ihdr = None
    palette = None
    idat = []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {ctype}")
    if depth == 16:
        raise ValueError(f"{path}: 16-bit PNGs are not read")
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not read")
    if comp or filt:
        raise ValueError(f"{path}: unknown compression or filter method")
    if depth != 8 and not (ctype in (0, 3) and depth in (1, 2, 4)):
        raise ValueError(f"{path}: bit depth {depth} with colour type "
                         f"{ctype} is not a PNG this reader takes")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette image without PLTE")
    ch = _CHANNELS[ctype]
    stride = (w * ch * depth + 7) // 8
    rows = unfilter(zlib.decompress(b"".join(idat)), h, stride,
                    max(1, ch * depth // 8))
    return (_unpack_bits(rows, w * ch, depth).reshape(h, w, ch), ctype,
            palette, depth)


def _read(path):
    p = Path(path)
    if not p.is_file():
        return None
    return decode_png(p.read_bytes(), path)


def _rgb(samples, ctype, palette, depth):
    """(H, W, 3) RGB and whether the file is colour."""
    if ctype == 3:
        idx = samples[..., 0].astype(np.int64)
        if idx.max(initial=0) >= len(palette):
            raise ValueError("palette index out of range")
        return palette[idx], True
    if ctype in (2, 6):
        return samples[..., :3], True
    g = samples[..., 0]
    if depth < 8:
        g = (g.astype(np.int64) * 255 // ((1 << depth) - 1)).astype(np.uint8)
    return np.repeat(g[..., None], 3, -1), False


def imread_gray(path):
    """``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` -> (H, W) uint8, or None
    for a missing file."""
    got = _read(path)
    if got is None:
        return None
    rgb, colour = _rgb(*got)
    if not colour:
        return np.ascontiguousarray(rgb[..., 0])
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    wr, wg, wb = _GRAY_WEIGHTS
    return ((wr * r + wg * g + wb * b) >> 15).astype(np.uint8)


def imread_bgr(path):
    """``cv2.imread(path, cv2.IMREAD_COLOR)`` -> (H, W, 3) uint8 BGR, or
    None for a missing file."""
    got = _read(path)
    if got is None:
        return None
    rgb, _ = _rgb(*got)
    return np.ascontiguousarray(rgb[..., ::-1])


# ── writer ──────────────────────────────────────────────────────────────────

def _filter_rows(img: np.ndarray, bpp: int, filters) -> bytes:
    """Filter each row of (H, stride) uint8 with the type given for it."""
    h, stride = img.shape
    out = bytearray()
    prior = np.zeros(stride, np.int64)
    for y in range(h):
        cur = img[y].astype(np.int64)
        a = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        f = int(filters[y % len(filters)])
        if f == 0:
            v = cur
        elif f == 1:
            v = cur - a
        elif f == 2:
            v = cur - prior
        elif f == 3:
            v = cur - ((a + prior) >> 1)
        else:
            p = a + prior - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prior), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, prior, c))
            v = cur - pred
        out.append(f)
        out += (v & 0xFF).astype(np.uint8).tobytes()
        prior = cur
    return bytes(out)


def encode_png(img: np.ndarray, palette=None, filters=(0,),
               level: int = 6) -> bytes:
    """(H, W) gray, (H, W, 2) gray + alpha, (H, W, 3) RGB or (H, W, 4) RGBA
    uint8 -> PNG bytes (8-bit, not interlaced).  With ``palette`` ((N, 3)
    uint8), ``img`` (H, W) holds palette indices (colour type 3).
    ``filters``: the row filter types, cycled over the rows."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    ctype = 3 if palette is not None else {1: 0, 2: 4, 3: 2, 4: 6}[ch]

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    raw = _filter_rows(img.reshape(h, w * ch), ch, filters)
    out = _SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0,
                                            0, 0))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return (out + chunk(b"IDAT", zlib.compress(raw, level))
            + chunk(b"IEND", b""))


def write_png(path, img: np.ndarray, **kw) -> None:
    """Write :func:`encode_png`'s bytes to ``path``."""
    Path(path).write_bytes(encode_png(img, **kw))
