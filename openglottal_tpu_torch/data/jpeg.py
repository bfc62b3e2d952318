"""Baseline JPEG frames of an MJPG AVI: the host side of the card's decoder
and the plain versions of its two kernels (``ops/jpeg_cuda``).

The JAX package reads MJPG through ``cv2.VideoCapture``
(``openglottal_tpu/data/video.py:32-74``): FFmpeg's MJPEG decoder, then
swscale's conversion to BGR24.  The port decodes on the card and returns
those frames bit for bit (the arithmetic below is FFmpeg's, see
:func:`idct_bgr_plain`).

Host side, per frame: the markers are parsed (SOI; APPn and COM skipped;
DQT 8- and 16-bit; DHT; SOF0 / SOF1 with 8-bit samples; DRI; SOS; RSTn;
EOI), the entropy-coded data is unstuffed (``FF 00`` -> ``FF``, fill bytes
dropped) and cut at its restart markers into segments, each decodable on
its own.  Tables carry from frame to frame as FFmpeg's decoder carries
them, starting from the Annex K.3 Huffman tables (the "AVI1" convention: a
frame without a DHT takes them).  Refused with ``ValueError`` naming the
marker: progressive (SOF2), lossless (SOF3), hierarchical (SOF5-7, SOF13-15,
DHP), arithmetic coding (SOF9-11, DAC), JPEG-LS (SOF55), samples of other
than 8 bits, frames of more than one scan, and component layouts other than
one component (gray) or three with luma sampled 1x1, 2x1 or 2x2 against
chroma 1x1 (4:4:4, 4:2:2, 4:2:0).

:func:`pack` lays a chunk of frames (one geometry) out as what crosses to
the card, and the only thing that crosses: the segments' bytes (each at a
4-byte boundary, 8 zero bytes after the last), a row per segment, the
chunk's distinct Huffman tables and each frame's table slots and
quantisation tables.  The plain versions :func:`entropy_decode_plain` and
:func:`idct_bgr_plain` take the same packed inputs and return what the
kernels return, in Python integers and numpy int32 / uint8 on the CPU.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

# natural (row-major) index of zigzag position k
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int32)

# ── Annex K.3: the standard Huffman tables (bits per length 1..16, values)

_K_DC_BITS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)
_K_DC_C_BITS = (0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0)
_K_DC_VALS = bytes(range(12))
_K_AC_Y_BITS = (0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D)
_K_AC_Y_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")
_K_AC_C_BITS = (0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77)
_K_AC_C_VALS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")

ANNEX_K = {(0, 0): (_K_DC_BITS, _K_DC_VALS), (0, 1): (_K_DC_C_BITS,
                                                     _K_DC_VALS),
           (1, 0): (_K_AC_Y_BITS, _K_AC_Y_VALS),
           (1, 1): (_K_AC_C_BITS, _K_AC_C_VALS)}

_SOF_NAMES = {
    0xC2: "SOF2 (progressive)", 0xC3: "SOF3 (lossless)",
    0xC5: "SOF5 (hierarchical)", 0xC6: "SOF6 (hierarchical progressive)",
    0xC7: "SOF7 (hierarchical lossless)",
    0xC9: "SOF9 (arithmetic coding)",
    0xCA: "SOF10 (arithmetic coding, progressive)",
    0xCB: "SOF11 (arithmetic coding, lossless)",
    0xCD: "SOF13 (hierarchical, arithmetic coding)",
    0xCE: "SOF14 (hierarchical progressive, arithmetic coding)",
    0xCF: "SOF15 (hierarchical lossless, arithmetic coding)",
    0xDE: "DHP (hierarchical)", 0xCC: "DAC (arithmetic coding)",
    0xF7: "SOF55 (JPEG-LS)", 0xDC: "DNL (height after the scan)"}

# a Huffman table as the kernel reads it, int32 words: the 9-bit fast table
# (512 uint16 entries (length << 8) | symbol, 0 where the code is longer),
# maxcode[0..16] (-1: no code of that length), delta[0..16] (index of the
# length's first value minus its first code), the 256 values as bytes, the
# 16 counts as bytes; padded to a multiple of 4 words
FAST_BITS = 9
T_FAST, T_MAXCODE, T_DELTA, T_VALS, T_BITS = 0, 256, 273, 290, 354
TABLE_WORDS = 360

SAMPLINGS = {(1, 1): "4:4:4", (2, 1): "4:2:2", (2, 2): "4:2:0"}


def _fail(frame, msg):
    where = "JPEG" if frame is None else f"JPEG frame {frame}"
    raise ValueError(f"{where}: {msg}")


def _prefix_table(bits, vals) -> np.ndarray:
    """(65536,) int32 over every 16-bit prefix: (length << 8) | symbol of
    the code it starts with, -1 where none does.  Canonical codes taken in
    order tile the prefixes from 0 up, each 2**(16 - length) of them."""
    lengths = np.repeat(np.arange(1, 17), np.asarray(bits, np.int64))
    sym = np.frombuffer(bytes(vals)[:len(lengths)], np.uint8)
    out = np.full(1 << 16, -1, np.int32)
    span = np.repeat((lengths << 8) | sym, 1 << (16 - lengths))
    out[:len(span)] = span
    return out


def table_words(bits, vals, frame=None) -> np.ndarray:
    """One DHT table (16 counts, values) -> its (TABLE_WORDS,) int32 row;
    a count list that overflows its code space raises."""
    bits = [int(b) for b in bits]
    vals = bytes(vals)
    if len(bits) != 16 or sum(bits) > 256 or sum(bits) > len(vals):
        _fail(frame, "bad DHT table")
    maxcode = np.full(17, -1, np.int64)
    delta = np.zeros(17, np.int64)
    code = k = 0
    for n in range(1, 17):
        c = bits[n - 1]
        if code + c > (1 << n):
            _fail(frame, "bad DHT table (its codes overflow)")
        if c:
            maxcode[n] = code + c - 1
            delta[n] = k - code
        k += c
        code = (code + c) << 1
    # the codes of up to FAST_BITS bits come first and tile the 9-bit
    # prefixes from 0 up; the rest of the fast table stays 0
    n_short = sum(bits[:FAST_BITS])
    lengths = np.repeat(np.arange(1, FAST_BITS + 1), bits[:FAST_BITS])
    sym = np.frombuffer(vals[:n_short], np.uint8).astype(np.int64)
    span = np.repeat((lengths << 8) | sym, 1 << (FAST_BITS - lengths))
    fast = np.zeros(1 << FAST_BITS, np.uint16)
    fast[:len(span)] = span
    row = np.zeros(TABLE_WORDS, np.int32)
    row[T_FAST:T_MAXCODE] = fast.view(np.int32)
    row[T_MAXCODE:T_DELTA] = maxcode
    row[T_DELTA:T_VALS] = delta
    v = np.zeros(256, np.uint8)
    v[:len(vals[:256])] = np.frombuffer(vals[:256], np.uint8)
    row[T_VALS:T_BITS] = v.view(np.int32)
    row[T_BITS:T_BITS + 4] = np.array(bits, np.uint8).view(np.int32)
    row.flags.writeable = False
    return row


@dataclass
class Geometry:
    """The frame layout shared by a chunk: size, components and their block
    grids in the coefficient buffer (component c's blocks from blk0[c],
    bh[c] rows of bw[c] blocks, row-major), MCUs."""
    h: int
    w: int
    ncomp: int
    hs: tuple           # per component horizontal sampling in the MCU
    vs: tuple           # per component vertical sampling in the MCU
    mcux: int
    mcuy: int
    bw: tuple
    bh: tuple
    blk0: tuple
    nblk: int           # blocks a frame

    @property
    def sampling(self) -> str:
        return "gray" if self.ncomp == 1 else SAMPLINGS[(self.hs[0],
                                                          self.vs[0])]

    @property
    def mcus(self) -> int:
        return self.mcux * self.mcuy

    def key(self):
        return (self.h, self.w, self.ncomp, self.hs, self.vs)


def _geometry(h, w, comps, frame) -> Geometry:
    if h <= 0 or w <= 0:
        _fail(frame, f"bad frame size {w}x{h} (a DNL height is not read)")
    if len(comps) == 1:
        bw, bh = (w + 7) // 8, (h + 7) // 8
        return Geometry(h, w, 1, (1,), (1,), bw, bh, (bw,), (bh,), (0,),
                        bw * bh)
    if len(comps) != 3:
        _fail(frame, f"{len(comps)} components are not decoded (1 or 3)")
    hv = [(c[1], c[2]) for c in comps]
    if hv[1] != (1, 1) or hv[2] != (1, 1) or hv[0] not in SAMPLINGS:
        _fail(frame, f"sampling {hv} is not decoded (luma 1x1, 2x1 or 2x2 "
                     f"against chroma 1x1)")
    if hv[0] != (1, 1) and h % 2:
        # cv2 converts these through swscale's scaler, whose bicubic chroma
        # filters are not ported (ROADMAP.md, C)
        _fail(frame, f"{SAMPLINGS[hv[0]]} of odd height ({h} rows) is not "
                     f"decoded: only 4:4:4 or one component may have an odd "
                     f"height")
    hs, vs = (hv[0][0], 1, 1), (hv[0][1], 1, 1)
    mcux = -(-w // (8 * hs[0]))
    mcuy = -(-h // (8 * vs[0]))
    bw = tuple(mcux * x for x in hs)
    bh = tuple(mcuy * y for y in vs)
    blk0, n = [], 0
    for c in range(3):
        blk0.append(n)
        n += bw[c] * bh[c]
    return Geometry(h, w, 3, hs, vs, mcux, mcuy, bw, bh, tuple(blk0), n)


@dataclass
class Frame:
    """One parsed frame: its geometry, per component (in scan order) the
    quantisation table (64 values, zigzag order) and the (DC, AC) Huffman
    tables as (counts, values, row), and its entropy-coded segments as
    (unstuffed bytes, first MCU, MCU count)."""
    geo: Geometry
    quant: list
    huff: list
    segments: list


class JpegState:
    """What FFmpeg's decoder carries from frame to frame of a video: the
    Huffman tables as (counts, values, row), the Annex K ones until a DHT
    replaces them, and the quantisation tables; and the rows already built
    for the video, by table (frames often repeat their tables)."""

    def __init__(self):
        self.rows = {}
        self.quant = {}
        self.huff = {k: self.table(*bv) for k, bv in ANNEX_K.items()}

    def table(self, bits, vals, frame=None) -> tuple:
        key = (bytes(bits), bytes(vals))
        if key not in self.rows:
            self.rows[key] = table_words(bits, vals, frame)
        return (*key, self.rows[key])


def _segments(data: bytes, start: int):
    """The entropy-coded data from ``start``: unstuffed segments (cut at
    RSTn) and the offset of the marker that ends the scan (len(data) when
    none does).  ``FF 00`` -> ``FF``; an ``FF`` before another ``FF`` is a
    fill byte."""
    body = np.frombuffer(data, np.uint8)[start:]
    n = len(body)
    ffs = np.flatnonzero(body[:-1] == 0xFF) if n > 1 else np.zeros(0, int)
    nxt = body[ffs + 1]
    rst = (nxt >= 0xD0) & (nxt <= 0xD7)
    marker = ~rst & (nxt != 0x00) & (nxt != 0xFF)
    end = int(ffs[marker][0]) if marker.any() else (
        n - 1 if n and body[-1] == 0xFF else n)
    keep = ffs < end
    drop = np.concatenate([ffs[keep & (nxt == 0x00)] + 1,
                           ffs[keep & (nxt == 0xFF)]])
    cuts = ffs[keep & rst]
    mask = np.ones(end, bool)
    mask[drop] = False
    firsts = np.concatenate([[0], cuts + 2])
    lasts = np.concatenate([cuts, [end]])
    segs = [body[a:b][mask[a:b]].tobytes() for a, b in zip(firsts, lasts)]
    return segs, start + end


def parse_frame(data: bytes, state: JpegState | None = None,
                frame=None) -> Frame:
    """One JPEG frame's bytes -> :class:`Frame`; ``state`` carries the
    tables from the frame before (a fresh one when None)."""
    state = JpegState() if state is None else state
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        _fail(frame, "no SOI marker (not a JPEG frame)")
    pos, sof, restart, scan, adobe_rgb = 2, None, 0, None, False
    n = len(data)
    while pos < n:
        if data[pos] != 0xFF:
            pos += 1                    # garbage between markers
            continue
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        m = data[pos]
        pos += 1
        if m == 0xD9:
            break
        if m in (0x01, 0xD8) or 0xD0 <= m <= 0xD7:
            continue
        if pos + 2 > n:
            _fail(frame, "truncated marker")
        ln = struct.unpack(">H", data[pos:pos + 2])[0]
        seg = data[pos + 2:pos + ln]
        if ln < 2 or len(seg) < ln - 2:
            _fail(frame, f"truncated marker segment FF{m:02X}")
        pos += ln
        if m in _SOF_NAMES:
            _fail(frame, f"{_SOF_NAMES[m]} is not decoded: the decoder "
                         f"reads baseline and extended sequential (SOF0 / "
                         f"SOF1) Huffman-coded 8-bit frames")
        if m in (0xC0, 0xC1):
            if scan is not None or sof is not None:
                _fail(frame, "a second SOF is not decoded")
            if seg[0] != 8:
                _fail(frame, f"SOF{m - 0xC0}: {seg[0]}-bit samples are "
                             f"not decoded (8-bit only)")
            h, w, nc = struct.unpack(">HHB", seg[1:6])
            if len(seg) < 6 + 3 * nc:
                _fail(frame, "truncated SOF")
            comps = [(seg[6 + 3 * i], seg[7 + 3 * i] >> 4,
                      seg[7 + 3 * i] & 15, seg[8 + 3 * i])
                     for i in range(nc)]
            if nc == 3 and bytes(c[0] for c in comps) == b"RGB":
                _fail(frame, "RGB-coded components are not decoded")
            sof = (h, w, comps)
        elif m == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                bits = tuple(seg[i + 1:i + 17])
                k = sum(bits)
                if tc > 1 or th > 3 or len(bits) < 16 or i + 17 + k > len(
                        seg):
                    _fail(frame, "bad DHT segment")
                vals = bytes(seg[i + 17:i + 17 + k])
                state.huff[(tc, th)] = state.table(bits, vals, frame)
                i += 17 + k
        elif m == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                size = 128 if pq else 64
                if pq > 1 or tq > 3 or i + 1 + size > len(seg):
                    _fail(frame, "bad DQT segment")
                q = np.frombuffer(seg[i + 1:i + 1 + size],
                                  ">u2" if pq else np.uint8)
                state.quant[tq] = q.astype(np.int32)
                i += 1 + size
        elif m == 0xDD:
            if len(seg) < 2:
                _fail(frame, "bad DRI segment")
            restart = struct.unpack(">H", seg[:2])[0]
        elif m == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe_rgb = seg[11] == 0    # transform 0: components not YCbCr
        elif m == 0xDA:
            if sof is None:
                _fail(frame, "SOS before SOF")
            if scan is not None:
                _fail(frame, "frames of more than one scan are not decoded")
            ns = seg[0]
            sel = [(seg[1 + 2 * i], seg[2 + 2 * i] >> 4, seg[2 + 2 * i] & 15)
                   for i in range(ns)]
            ss, se, a = seg[1 + 2 * ns:4 + 2 * ns]
            if (ss, se, a) != (0, 63, 0):
                _fail(frame, f"scan Ss={ss} Se={se} Ah/Al={a:#x} is not "
                             f"sequential")
            h, w, comps = sof
            if len(comps) == 3 and adobe_rgb:
                _fail(frame, "Adobe RGB-coded components are not decoded")
            ids = [c[0] for c in comps]
            if sorted(s[0] for s in sel) != sorted(ids) or len(sel) != len(
                    ids):
                _fail(frame, "a scan of only some components is not decoded")
            order = [ids.index(s[0]) for s in sel]
            if order != list(range(len(ids))):
                _fail(frame, "scan components out of frame order")
            geo = _geometry(h, w, comps, frame)
            quant, huff = [], []
            for (cid, hh, vv, tq), (_, td, ta) in zip(comps, sel):
                if tq not in state.quant:
                    _fail(frame, f"quantisation table {tq} is not defined")
                if (0, td) not in state.huff or (1, ta) not in state.huff:
                    _fail(frame, f"Huffman table DC{td} / AC{ta} is not "
                                 f"defined")
                quant.append(state.quant[tq])
                huff.append((state.huff[(0, td)], state.huff[(1, ta)]))
            segs, pos = _segments(data, pos)
            nmcu = geo.mcus if geo.ncomp == 3 else geo.nblk
            ri = restart if restart else nmcu
            want = -(-nmcu // ri)
            if len(segs) != want:
                _fail(frame, f"{len(segs)} restart intervals, the frame "
                             f"needs {want}")
            scan = Frame(geo, quant, huff, [
                (s, i * ri, min(ri, nmcu - i * ri))
                for i, s in enumerate(segs)])
    if scan is None:
        _fail(frame, "no scan (SOF and SOS) in the frame")
    return scan


# ── packing: what crosses to the card ──────────────────────────────────────

SEG_WORDS = 5       # byte offset, byte count, frame, first MCU, MCU count


@dataclass
class Packed:
    """A chunk of frames as the kernels read it (numpy arrays; the reader
    moves them to the device):

    data    (N,) uint8    segments' bytes, each at a 4-byte boundary, 8
                          zero bytes after the last
    segs    (S, 5) int32  per segment, in frame order: byte offset, byte
                          count, frame, first MCU, MCU count
    tables  (NT, TABLE_WORDS) int32  the chunk's distinct Huffman tables
    slots   (T, NS) int32 per frame, the rows of ``tables`` it reads (-1
                          past its last)
    comp    (T, 3, 2) int32  per frame and component, its (DC, AC) slot
    quant   (T, 3, 64) int32  per frame and component, the quantisation
                          table in natural order
    geo     the chunk's :class:`Geometry`"""
    data: np.ndarray
    segs: np.ndarray
    tables: np.ndarray
    slots: np.ndarray
    comp: np.ndarray
    quant: np.ndarray
    geo: Geometry

    @property
    def t(self) -> int:
        return self.slots.shape[0]

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for a in (self.data, self.segs, self.tables,
                                      self.slots, self.comp, self.quant))


def pack(frames: list, first: int = 0) -> Packed:
    """Parsed frames of one geometry -> :class:`Packed`.  ``first`` is the
    first frame's number in the video (for messages)."""
    if not frames:
        raise ValueError("pack: no frames")
    geo = frames[0].geo
    for i, f in enumerate(frames):
        if f.geo.key() != geo.key():
            _fail(first + i, f"geometry {f.geo.key()} differs from the "
                             f"video's {geo.key()}")
    t = len(frames)
    rows, index = [], {}
    slot_lists, comp = [], np.zeros((t, 3, 2), np.int32)
    quant = np.zeros((t, 3, 64), np.int32)
    for i, f in enumerate(frames):
        mine = []
        for c, tabs in enumerate(f.huff):
            for k, (bits, vals, row) in enumerate(tabs):
                key = (bits, vals)
                if key not in index:
                    index[key] = len(rows)
                    rows.append(row)
                g = index[key]
                if g not in mine:
                    mine.append(g)
                comp[i, c, k] = mine.index(g)
            quant[i, c, ZIGZAG] = f.quant[c]
        slot_lists.append(mine)
    ns = max(len(s) for s in slot_lists)
    slots = np.full((t, ns), -1, np.int32)
    for i, s in enumerate(slot_lists):
        slots[i, :len(s)] = s
    segs, parts, off = [], [], 0
    for i, f in enumerate(frames):
        for s, m0, nm in f.segments:
            segs.append((off, len(s), i, m0, nm))
            pad = -len(s) % 4
            parts += [s, b"\0" * pad]
            off += len(s) + pad
    parts.append(b"\0" * 8)
    return Packed(np.frombuffer(b"".join(parts), np.uint8).copy(),
                  np.array(segs, np.int32).reshape(-1, SEG_WORDS),
                  np.stack(rows), slots, comp, quant, geo)


# ── plain version of og_jpeg_entropy ───────────────────────────────────────

def _lut16(row: np.ndarray, cache: dict) -> list:
    """A table row -> its prefix table as a list (canonical codes rebuilt
    from the row's counts and values), kept in ``cache`` by row."""
    key = row.tobytes()
    if key not in cache:
        cache[key] = _prefix_table(
            row[T_BITS:T_BITS + 4].view(np.uint8),
            row[T_VALS:T_BITS].view(np.uint8).tobytes()).tolist()
    return cache[key]


def _block_bases(geo: Geometry) -> list:
    """Per MCU slot (component, block) of an MCU: (component, row offset,
    column offset, table component) in blocks."""
    if geo.ncomp == 1:
        return [(0, 0, 0)]
    out = []
    for c in range(3):
        for v in range(geo.vs[c]):
            for u in range(geo.hs[c]):
                out.append((c, v, u))
    return out


def entropy_decode_plain(p: Packed):
    """The plain version of ``og_jpeg_entropy``: (coefficients (T, nblk,
    64) int16, natural order, the DC dequantised and predicted as FFmpeg
    predicts it, the AC as decoded levels; errors (T,) int32, non-zero for
    a frame whose stream is corrupt or short).

    Per segment, from its first MCU: each block's DC size symbol and its
    extra bits (sizes up to 16), the predictor ``last = diff * q[0] + last``
    in 32-bit wrapping arithmetic from 1024 at the segment's start, stored
    clipped to int16; then AC symbols (run, size) as FFmpeg reads them: the
    zigzag position advances by run + 1, a value is stored where size > 0
    (an error past position 63), EOB (symbol 0) ends the block, as does
    reaching position 63.  An invalid code, a DC size above 16, or reading
    past the segment's bytes marks the frame."""
    geo = p.geo
    t = p.t
    coef = np.zeros((t, geo.nblk, 64), np.int16)
    flat = coef.reshape(-1)
    err = np.zeros(t, np.int32)
    zz = [int(z) for z in ZIGZAG]
    layout = _block_bases(geo)
    luts = {}
    data = p.data.tobytes()
    for off, nbytes, fi, m0, nm in p.segs.tolist():
        if err[fi]:
            continue
        tabs = [[_lut16(p.tables[p.slots[fi, p.comp[fi, c, k]]], luts)
                 for k in (0, 1)] for c in range(geo.ncomp)]
        q0 = [int(p.quant[fi, c, 0]) for c in range(geo.ncomp)]
        seg = data[off:off + nbytes] + b"\0" * 8
        fbase = fi * geo.nblk * 64
        last = [1024] * geo.ncomp
        v = nb = 0
        pos = 0
        bad = False
        for m in range(m0, m0 + nm):
            if geo.ncomp == 1:
                bases = [(0, m)]
            else:
                my, mx = divmod(m, geo.mcux)
                bases = [(c, geo.blk0[c] + (my * geo.vs[c] + vv) * geo.bw[c]
                          + mx * geo.hs[c] + uu) for c, vv, uu in layout]
            for c, blk in bases:
                dc_lut, ac_lut = tabs[c]
                base = fbase + blk * 64
                # DC
                if nb < 32:
                    v = ((v & ((1 << nb) - 1)) << 32) | int.from_bytes(
                        seg[pos:pos + 4], "big")
                    pos += 4
                    nb += 32
                e = dc_lut[(v >> (nb - 16)) & 0xFFFF]
                if e < 0 or (e & 0xFF) > 16:
                    bad = True
                    break
                nb -= e >> 8
                s = e & 0xFF
                diff = 0
                if s:
                    diff = (v >> (nb - s)) & ((1 << s) - 1)
                    nb -= s
                    if diff < (1 << (s - 1)):
                        diff -= (1 << s) - 1
                val = (diff * q0[c] + last[c]) & 0xFFFFFFFF
                if val >= 1 << 31:
                    val -= 1 << 32
                last[c] = val
                flat[base] = max(-32768, min(32767, val))
                # AC
                i = 0
                while i < 63:
                    if nb < 32:
                        v = ((v & ((1 << nb) - 1)) << 32) | int.from_bytes(
                            seg[pos:pos + 4], "big")
                        pos += 4
                        nb += 32
                    e = ac_lut[(v >> (nb - 16)) & 0xFFFF]
                    if e < 0:
                        bad = True
                        break
                    nb -= e >> 8
                    sym = e & 0xFF
                    if sym == 0:
                        break
                    i += (sym >> 4) + 1
                    s = sym & 15
                    if s:
                        lv = (v >> (nb - s)) & ((1 << s) - 1)
                        nb -= s
                        if lv < (1 << (s - 1)):
                            lv -= (1 << s) - 1
                        if i > 63:
                            bad = True
                            break
                        flat[base + zz[i]] = lv
                if bad:
                    break
                if 8 * pos - nb > 8 * nbytes:
                    bad = True
                    break
            if bad:
                break
        if bad or 8 * pos - nb > 8 * nbytes:
            err[fi] = 1
    return coef, err


# ── plain version of og_jpeg_idct_bgr ─────────────────────────────────────

# FFmpeg's simple IDCT (libavcodec/simple_idct_template.c, 8-bit): the
# cosines in 14 bits, W4 one short of 2**14
W1, W2, W3, W4, W5, W6, W7 = 22725, 21407, 19266, 16383, 12873, 8867, 4520

# swscale's YUV -> RGB coefficients for full-range (yuvj) input, its default
# BT.601 matrix (ff_yuv2rgb_coeffs[SWS_CS_DEFAULT] scaled by 224 / 255,
# then to 13 bits with roundToInt16): y, v->r, u->b, u->g, v->g
C_Y, C_VR, C_UB, C_UG, C_VG = 8192, 11485, 14516, -2819, -5850

# the colour forms, as the converter that swscale picks for the frame:
#   FORM_GRAY    one component: gray8 -> bgr24 through a palette, the gray
#                value in all three channels
#   FORM_PAIRED  4:2:0 / 4:2:2 of even height: the unscaled SIMD converter
#                (libswscale/x86/yuv_2_rgb.asm), chroma shared by each 2x2
#                (2x1) block, pmulhw on values promoted by 3 bits
#   FORM_FULL    4:4:4: the scaler with identity filters and the
#                full-chroma output (yuv2rgb_write_full), 22-bit fixed point
# (4:2:0 / 4:2:2 of odd height, which swscale scales with its bicubic chroma
# filters, is refused at parse time.)
FORM_GRAY, FORM_PAIRED, FORM_FULL = 0, 1, 2


def colour_form(geo: Geometry) -> int:
    if geo.ncomp == 1:
        return FORM_GRAY
    if geo.hs[0] == 1 and geo.vs[0] == 1:
        return FORM_FULL
    return FORM_PAIRED


def _wrap(x, bits):
    half = 1 << (bits - 1)
    return ((x + half) & ((1 << bits) - 1)) - half


def _butterfly(x0, x1, x2, x3, x4, x5, x6, x7, a0):
    """The even / odd halves of one simple-IDCT pass (int64 arrays; a0
    holds the rounded DC term) -> its eight outputs before the shift."""
    a1, a2, a3 = a0, a0, a0
    a0 = a0 + W2 * x2 + W4 * x4 + W6 * x6
    a1 = a1 + W6 * x2 - W4 * x4 - W2 * x6
    a2 = a2 - W6 * x2 - W4 * x4 + W2 * x6
    a3 = a3 - W2 * x2 + W4 * x4 - W6 * x6
    b0 = W1 * x1 + W3 * x3 + W5 * x5 + W7 * x7
    b1 = W3 * x1 - W7 * x3 - W1 * x5 - W5 * x7
    b2 = W5 * x1 - W1 * x3 + W7 * x5 + W3 * x7
    b3 = W7 * x1 - W5 * x3 + W3 * x5 - W1 * x7
    return (a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2, a1 - b1,
            a0 - b0)


def idct_plain(blocks) -> np.ndarray:
    """FFmpeg's simple IDCT of (N, 64) dequantised int16 blocks -> (N, 8, 8)
    uint8, in the form its x86 build runs (``ff_simple_idct8_sse2`` /
    ``_avx``, the C form's arithmetic in 16-bit lanes): rows (a row of only
    a DC term is DC << 3, wrapped to int16; else 32-bit wrapping sums, >> 11,
    saturated to int16), then columns (the DC term biased by 32 in 16-bit
    wrapping arithmetic, 32-bit sums, >> 20, clamped to 0..255).  The C
    form truncates where this saturates; the two differ only on
    coefficients whose rows leave int16, which no encoder of 8-bit samples
    writes."""
    r = np.asarray(blocks, np.int64).reshape(-1, 8, 8)
    x = [r[..., k] for k in range(8)]
    out = _butterfly(*x, W4 * x[0] + (1 << 10))
    rows = np.stack([np.clip(_wrap(v, 32) >> 11, -32768, 32767)
                     for v in out], -1)
    dc_only = (r[..., 1:] == 0).all(-1)
    rows = np.where(dc_only[..., None], _wrap(x[0] * 8, 16)[..., None], rows)
    c = [rows[:, k, :] for k in range(8)]
    out = _butterfly(*c, W4 * _wrap(c[0] + 32, 16))
    cols = np.stack([_wrap(v, 32) >> 20 for v in out], 1)
    return np.clip(cols, 0, 255).astype(np.uint8)


def _colour(form, y, u, v):
    """(H, W) int64 Y and co-sited Cb, Cr -> (H, W, 3) uint8 BGR."""
    u, v = u - 128, v - 128
    if form == FORM_FULL:
        yy = ((y << 9) * C_Y) + (1 << 21)
        b = yy + (u << 9) * C_UB
        g = yy + (v << 9) * C_VG + (u << 9) * C_UG
        r = yy + (v << 9) * C_VR
        bgr = np.stack([b, g, r], -1) >> 22
    else:       # (y * 8 * C_Y) >> 16 is y
        u8, v8 = u << 3, v << 3
        bgr = np.stack([y + ((u8 * C_UB) >> 16),
                        y + ((u8 * C_UG) >> 16) + ((v8 * C_VG) >> 16),
                        y + ((v8 * C_VR) >> 16)], -1)
    return np.clip(bgr, 0, 255).astype(np.uint8)


def idct_bgr_plain(coef, p: Packed) -> np.ndarray:
    """The plain version of ``og_jpeg_idct_bgr``: coefficients (T, nblk, 64)
    int16 as :func:`entropy_decode_plain` leaves them -> (T, H, W, 3) uint8
    BGR, or (T, H, W) uint8 gray for one component.  The AC levels are
    dequantised as FFmpeg dequantises them (level * q stored as int16), the
    blocks go through :func:`idct_plain`, the planes are cropped and
    converted by the frame's :func:`colour_form`."""
    geo = p.geo
    coef = np.asarray(coef)
    t = coef.shape[0]
    deq = coef.astype(np.int64)
    for c in range(geo.ncomp):
        a, n = geo.blk0[c], geo.bw[c] * geo.bh[c]
        q = p.quant[:, c, None, 1:].astype(np.int64)
        deq[:, a:a + n, 1:] = _wrap(deq[:, a:a + n, 1:] * q, 16)
    pix = idct_plain(deq.reshape(-1, 64)).reshape(t, geo.nblk, 8, 8)
    planes = []
    for c in range(geo.ncomp):
        a, bw, bh = geo.blk0[c], geo.bw[c], geo.bh[c]
        planes.append(pix[:, a:a + bw * bh].reshape(t, bh, bw, 8, 8)
                      .transpose(0, 1, 3, 2, 4).reshape(t, bh * 8, bw * 8))
    h, w = geo.h, geo.w
    y = planes[0][:, :h, :w].astype(np.int64)
    form = colour_form(geo)
    if form == FORM_GRAY:
        return y.astype(np.uint8)
    sy, sx = geo.vs[0], geo.hs[0]
    rows = np.arange(h) // sy
    cols = np.arange(w) // sx
    u = planes[1][:, rows][:, :, cols].astype(np.int64)
    v = planes[2][:, rows][:, :, cols].astype(np.int64)
    return _colour(form, y, u, v)
