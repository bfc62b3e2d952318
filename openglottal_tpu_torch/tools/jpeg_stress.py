"""Baseline JPEG streams written from coefficient blocks, for holding the
MJPG decoder (``data/jpeg.py``, ``ops/jpeg_cuda``) on inputs that an
image encoder rarely makes: DC differences of +-2047, AC levels of +-1023,
every zero run up to 62 (ZRL chains), blocks without an EOB, blocks of only
a DC term, 16-bit quantisation tables whose products wrap int16, restart
intervals, every sampling form, frame sizes that are not multiples of 8,
and frames without a DHT (the Annex K tables).  Numpy only, no encoder
library: the tests and ``chip_smoke.py`` (on a machine without cv2 or PIL)
both use it.

    frames = stress_frames("extreme", h=37, w=53, sampling="4:2:0", t=4)
    write_mjpg_avi("s.avi", frames, 53, 37)
"""

from __future__ import annotations

import struct

import numpy as np

from openglottal_tpu_torch.data.jpeg import ANNEX_K, ZIGZAG

_SAMPLING = {"gray": (1, 1), "4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2)}


def _codes(bits, vals) -> dict:
    """symbol -> (code, length) of a canonical Huffman table."""
    out, code, k = {}, 0, 0
    for n in range(1, 17):
        for _ in range(bits[n - 1]):
            out[vals[k]] = (code, n)
            code += 1
            k += 1
        code <<= 1
    return out


class _Bits:
    """MSB-first bit writer with byte stuffing (FF -> FF 00)."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, v: int, n: int) -> None:
        if n == 0:
            return
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.n += n
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def pad(self) -> None:
        """To a byte boundary with one bits."""
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _magnitude(v: int):
    s = abs(int(v)).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def encode(blocks, h: int, w: int, sampling: str, quant, restart: int = 0,
           dht: bool = True, tables=None, cut_blocks: int = 0,
           junk: bytes = b"") -> bytes:
    """A baseline JPEG of quantised coefficients.

    ``blocks``: per component a (bh, bw, 64) int array in natural order,
    the DC absolute (the decoder's DC is 1024 + dc * q[0]); the grids are
    the MCU-padded ones of ``data/jpeg.Geometry`` (gray: ceil(h / 8) x
    ceil(w / 8)).  ``quant``: per component a (64,) natural-order table,
    written as 16-bit where any value exceeds 255.  ``restart``: the restart
    interval in MCUs (0: none).  ``dht=False`` leaves the tables out (a
    decoder takes Annex K's); ``tables``: {(class, id): (bits, values)},
    Annex K's by default.  ``cut_blocks``: the last blocks' bits left out (a
    short stream); ``junk``: bytes (no 0xFF) written after the last block's
    fill bits, which a decoder never reads."""
    tables = ANNEX_K if tables is None else tables
    ncomp = 1 if sampling == "gray" else 3
    hs, vs = _SAMPLING[sampling]
    sel = [0] * ncomp if ncomp == 1 else [0, 1, 1]
    dc = [_codes(*tables[(0, s)]) for s in sel]
    ac = [_codes(*tables[(1, s)]) for s in sel]
    out = bytearray(b"\xff\xd8")
    for c in range(ncomp):
        q = np.asarray(quant[c]).astype(np.int64)[ZIGZAG]
        wide = int(q.max()) > 255
        body = bytes([(1 << 4 if wide else 0) | c]) + (
            q.astype(">u2").tobytes() if wide else q.astype(np.uint8)
            .tobytes())
        out += b"\xff\xdb" + struct.pack(">H", 2 + len(body)) + body
    comps = b"".join(bytes([c + 1, ((hs << 4) | vs) if c == 0 and ncomp == 3
                            else 0x11, c]) for c in range(ncomp))
    sof = struct.pack(">BHHB", 8, h, w, ncomp) + comps
    out += b"\xff\xc0" + struct.pack(">H", 2 + len(sof)) + sof
    if dht:
        for (tc, th), (bits, vals) in sorted(tables.items()):
            if th in sel:
                body = bytes([(tc << 4) | th]) + bytes(bits) + bytes(vals)
                out += b"\xff\xc4" + struct.pack(">H", 2 + len(body)) + body
    if restart:
        out += b"\xff\xdd" + struct.pack(">HH", 4, restart)
    sos = bytes([ncomp]) + b"".join(
        bytes([c + 1, (sel[c] << 4) | sel[c]]) for c in range(ncomp)) + \
        b"\x00\x3f\x00"
    out += b"\xff\xda" + struct.pack(">H", 2 + len(sos)) + sos
    bw = [b.shape[1] for b in blocks]
    if ncomp == 1:
        order = [[(0, r, q)] for r in range(blocks[0].shape[0])
                 for q in range(bw[0])]
    else:
        mcux, mcuy = bw[0] // hs, blocks[0].shape[0] // vs
        order = []
        for my in range(mcuy):
            for mx in range(mcux):
                mcu = [(0, my * vs + v, mx * hs + u) for v in range(vs)
                       for u in range(hs)]
                order.append(mcu + [(1, my, mx), (2, my, mx)])
    bits = _Bits()
    pred = [0] * ncomp
    left = sum(len(mcu) for mcu in order) - cut_blocks
    for i, mcu in enumerate(order):
        if restart and i and i % restart == 0:
            bits.pad()
            bits.out += bytes([0xFF, 0xD0 + (i // restart - 1) % 8])
            pred = [0] * ncomp
        for c, r, q in mcu:
            left -= 1
            if left < 0:
                break
            zz = np.asarray(blocks[c][r, q])[ZIGZAG]
            s, v = _magnitude(int(zz[0]) - pred[c])
            pred[c] = int(zz[0])
            bits.put(dc[c][s][0], dc[c][s][1])
            bits.put(v, s)
            run = 0
            for k in range(1, 64):
                a = int(zz[k])
                if a == 0:
                    run += 1
                    continue
                while run > 15:
                    bits.put(*ac[c][0xF0])
                    run -= 16
                s, v = _magnitude(a)
                bits.put(*ac[c][(run << 4) | s])
                bits.put(v, s)
                run = 0
            if run:
                bits.put(*ac[c][0x00])
    bits.pad()
    if b"\xff" in junk:
        raise ValueError("encode: junk must not hold 0xFF")
    return bytes(out + bits.out + junk + b"\xff\xd9")


def grids(h: int, w: int, sampling: str) -> list:
    """The (bh, bw) block grid of each component."""
    if sampling == "gray":
        return [(-(-h // 8), -(-w // 8))]
    hs, vs = _SAMPLING[sampling]
    mcux, mcuy = -(-w // (8 * hs)), -(-h // (8 * vs))
    return [(mcuy * vs, mcux * hs), (mcuy, mcux), (mcuy, mcux)]


def stress_blocks(kind: str, grid, rng) -> np.ndarray:
    """(bh, bw, 64) quantised levels of one component.

    ``extreme``: DC alternating -1023 / +1024 (differences of 2047), every
    AC position at +-1023 or 0, every run length; ``dense``: all 63 AC
    positions non-zero (no EOB); ``sparse``: a DC term and at most one AC
    level, at position 63 in every third block (runs of 62, ZRL chains);
    ``noise``: small random levels, the shape of real data; ``dc16``: DC
    alternating -20000 / +20000 (DC sizes of 16: a code and its extra bits
    of 32 bits with :data:`DC16_TABLES`) and small AC levels."""
    bh, bw = grid
    n = bh * bw
    b = np.zeros((n, 64), np.int64)
    if kind == "extreme":
        b[:, 0] = np.where(np.arange(n) % 2, 1024, -1023)
        mask = rng.random((n, 63)) < rng.random((n, 1))
        b[:, 1:] = np.where(mask, rng.choice([-1023, 1023], (n, 63)), 0)
    elif kind == "dense":
        b[:, 0] = rng.integers(-200, 200, n)
        v = rng.integers(1, 1024, (n, 63)) * rng.choice([-1, 1], (n, 63))
        b[:, 1:] = v
    elif kind == "sparse":
        b[:, 0] = rng.integers(-1023, 1024, n)
        pos = np.where(np.arange(n) % 3 == 0, 63, rng.integers(1, 64, n))
        keep = rng.random(n) < 0.7
        b[np.arange(n)[keep], ZIGZAG[pos[keep]]] = rng.integers(1, 100,
                                                                keep.sum())
    else:
        b[:, 0] = rng.integers(-60, 60, n)
        b[:, 1:] = np.round(rng.laplace(0, 1.5, (n, 63)) * np.exp(
            -np.arange(1, 64) / 12.0)).astype(np.int64)
        if kind == "dc16":
            b[:, 0] = np.where(np.arange(n) % 2, 20000, -20000)
    return b.reshape(bh, bw, 64)


def stress_frames(kind: str, h: int, w: int, sampling: str, t: int = 2,
                  seed: int = 0, restart: int = 0, quant_max: int = 1,
                  dht: bool = True, **encode_kw) -> list:
    """``t`` JPEG frames of :func:`stress_blocks` coefficients; the
    quantisation tables drawn in 1..quant_max (above 255: 16-bit tables,
    whose products wrap int16 in the decoder); ``encode_kw`` to
    :func:`encode` (tables, cut_blocks, junk)."""
    rng = np.random.default_rng(seed)
    ncomp = 1 if sampling == "gray" else 3
    out = []
    for _ in range(t):
        blocks = [stress_blocks(kind, g, rng) for g in grids(h, w, sampling)]
        quant = [rng.integers(1, quant_max + 1, 64) for _ in range(ncomp)]
        out.append(encode(blocks, h, w, sampling, quant, restart, dht,
                          **encode_kw))
    return out


# Tables whose codes all have one length (DC sizes 0-11 in 4 bits, the 162
# AC symbols of Annex K in 8): a decode started off a symbol boundary keeps
# its offset, so subsequences rarely synchronise by themselves.
_AC_SYMBOLS = tuple(sorted(set(ANNEX_K[(1, 0)][1])))
EQUAL_TABLES = {
    (0, 0): ((0, 0, 0, 12) + (0,) * 12, bytes(range(12))),
    (0, 1): ((0, 0, 0, 12) + (0,) * 12, bytes(range(12))),
    (1, 0): ((0,) * 7 + (162,) + (0,) * 8, bytes(_AC_SYMBOLS)),
    (1, 1): ((0,) * 7 + (162,) + (0,) * 8, bytes(_AC_SYMBOLS))}
# Annex K's DC tables with DC sizes 12-16 added as 16-bit codes (Annex K
# stops at 11): a size-16 DC symbol is 32 bits with its extra bits.
DC16_TABLES = dict(ANNEX_K)
DC16_TABLES[(0, 0)] = (ANNEX_K[(0, 0)][0][:15] + (5,), bytes(range(17)))
DC16_TABLES[(0, 1)] = (ANNEX_K[(0, 1)][0][:15] + (5,), bytes(range(17)))


def sync_stress_cases() -> list:
    """(label, JPEG frames) that stress the split-and-synchronise entropy
    decode (``csrc/jpeg.cu``): tables of equal code lengths, restart
    intervals of one MCU, segments shorter than one subsequence, 32-bit DC
    symbols (a whole subsequence at its smallest length), junk that decodes
    as valid symbols after the last block (never flagged), and a frame cut
    one block short between two good ones (flagged)."""
    cases = []
    for sampling in ("gray", "4:2:0"):
        cases += [
            (f"equal code lengths noise {sampling} 64x64",
             stress_frames("noise", 64, 64, sampling, t=2, seed=1,
                           tables=EQUAL_TABLES)),
            (f"equal code lengths extreme {sampling} 32x48",
             stress_frames("extreme", 32, 48, sampling, t=2, seed=2,
                           tables=EQUAL_TABLES)),
            (f"restart 1 noise {sampling} 48x64",
             stress_frames("noise", 48, 64, sampling, t=2, seed=3,
                           restart=1)),
            (f"shorter than a subsequence sparse {sampling} 16x16",
             stress_frames("sparse", 16, 16, sampling, t=3, seed=4)),
            (f"32-bit DC symbols {sampling} 32x32",
             stress_frames("dc16", 32, 32, sampling, t=2, seed=5,
                           tables=DC16_TABLES)),
            (f"junk after the last block {sampling} 32x48",
             stress_frames("noise", 32, 48, sampling, t=2, seed=6,
                           junk=bytes(48) + bytes(range(1, 200)))),
            (f"one block short {sampling} 32x48",
             [*stress_frames("noise", 32, 48, sampling, t=1, seed=7),
              *stress_frames("noise", 32, 48, sampling, t=1, seed=8,
                             cut_blocks=1),
              *stress_frames("noise", 32, 48, sampling, t=1, seed=9)]),
        ]
    return cases


def write_mjpg_avi(path, jpeg_frames, w: int, h: int,
                   fourcc: bytes = b"MJPG") -> None:
    """JPEG frames as an AVI file (one ``00dc`` chunk each, no index), as
    cv2's MJPG writer lays them out."""
    def chunk(cid, data):
        return cid + struct.pack("<I", len(data)) + data + b"\0" * (
            len(data) & 1)

    def lst(kind, *parts):
        return chunk(b"LIST", kind + b"".join(parts))

    t = len(jpeg_frames)
    bih = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, fourcc, w * h * 3, 0,
                      0, 0, 0)
    avih = struct.pack("<10I", 40000, 0, 0, 0x10, t, 0, 1, 0, w, h) + \
        b"\0" * 16
    strh = b"vids" + fourcc + struct.pack("<IHHIIIIIIIIhhhh", 0, 0, 0, 0, 1,
                                          25, 0, t, 0, 0xFFFFFFFF, 0, 0, 0,
                                          w, h)
    head = lst(b"hdrl", chunk(b"avih", avih),
               lst(b"strl", chunk(b"strh", strh), chunk(b"strf", bih)))
    movi = lst(b"movi", *(chunk(b"00dc", f) for f in jpeg_frames))
    with open(path, "wb") as f:
        f.write(chunk(b"RIFF", b"AVI " + head + movi))


def jpeg_frames_of(path) -> list:
    """The frame chunks (JPEG bytes) of an MJPG AVI file, in file order."""
    from openglottal_tpu_torch.data.video import _raw

    return [data for _, data in _raw(path)]
