"""A model of ``og_jpeg_entropy``'s split-and-synchronise decode
(``openglottal_tpu_torch/csrc/jpeg.cu``), phase for phase, held exactly
equal to the plain version ``data/jpeg.entropy_decode_plain`` (coefficients
and error flags) at several subsequence lengths S, on the committed
fixtures and on the stress streams; the new stress streams' frames held
equal to cv2's (the JAX package's reader).

The model is this file's own and nothing on the main path uses it: it
states the kernel's algorithm where it can run on the CPU.  A segment is
cut into subsequences of S bits.  A: each decodes from a guessed start (the
first from the exact one) up to the first symbol boundary at or past its
end, recording its exit state, the DCs it began and the sums of diff * q0;
an invalid code re-guesses one bit on with the next MCU slot; then, in
rounds, every subsequence whose left neighbour's exit differs from the
start it last used decodes again from it, until no exit changes.  B: an
exclusive scan of the counts and sums.  C: each decodes again from its
start, skips the tail of a block begun before it, writes the blocks whose
DC begins before its end up to the segment's last needed block, and flags
its frame for an error in one of them.  Symbols are read as the kernel
reads them: a table on the top 10 bits (the bits of code and extra bits,
their size, the run, EOB) and the canonical max codes past it.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from openglottal_tpu.data.video import load_frames_bgr as cv2_frames
from openglottal_tpu_torch.data import jpeg
from openglottal_tpu_torch.data.video import load_frames_bgr
from openglottal_tpu_torch.ops.jpeg_cuda import SUB_BITS
from openglottal_tpu_torch.tools.jpeg_stress import (
    jpeg_frames_of,
    stress_frames,
    sync_stress_cases,
    write_mjpg_avi,
)
torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parent / "data" / "mjpg"
FAST_BITS = 10
BAD_SIZE = 31
M32 = 0xFFFFFFFF


def _pack(frames):
    state = jpeg.JpegState()
    return jpeg.pack([jpeg.parse_frame(f, state, i)
                      for i, f in enumerate(frames)])


# ── the model ──────────────────────────────────────────────────────────────

def make_entry(ln, sym, dc):
    """A symbol's entry (csrc/jpeg.cu make_entry): the bits of its code and
    extra bits (0-5), the size of the extra bits (6-10; 31 for a DC size
    above 16), the AC run (11-14), EOB (15)."""
    s = (BAD_SIZE if sym > 16 else sym) if dc else sym & 15
    return ((ln + (0 if s > 16 else s)) | s << 6
            | (0 if dc else sym >> 4) << 11 | (not dc and sym == 0) << 15)


def fast_table(row, dc: bool) -> list:
    """The kernel's one-lookup table of a table row (csrc/jpeg.cu
    fast_entry), by 10-bit prefix: the entry of the code it begins, 0 where
    the code is longer than 10 bits or none begins there."""
    fast9 = row[:jpeg.T_MAXCODE].view(np.uint16).tolist()
    vals = row[jpeg.T_VALS:jpeg.T_BITS].view(np.uint8).tolist()
    max10, delta10 = int(row[jpeg.T_MAXCODE + FAST_BITS]), int(
        row[jpeg.T_DELTA + FAST_BITS])
    out = []
    for x in range(1 << FAST_BITS):
        e9 = fast9[x >> 1]
        if e9:
            out.append(make_entry(e9 >> 8, e9 & 0xFF, dc))
        elif x <= max10:
            out.append(make_entry(FAST_BITS, vals[x + delta10], dc))
        else:
            out.append(0)
    return out


def _extend(v, s):
    return v - (1 << s) + 1 if v < 1 << (s - 1) else v


class Frame:
    """What a block of the kernel holds for its frame: per component and
    class its one-lookup table and its row, the DC quantisers."""

    def __init__(self, p, fi):
        geo = p.geo
        self.ny = 1 if geo.ncomp == 1 else geo.hs[0] * geo.vs[0]
        self.bpm = 1 if geo.ncomp == 1 else self.ny + 2
        self.rows = [p.tables[p.slots[fi, p.comp[fi, t >> 1, t & 1]]]
                     for t in range(2 * geo.ncomp)]
        self.fast = [fast_table(r, t % 2 == 0)
                     for t, r in enumerate(self.rows)]
        self.q0 = [int(p.quant[fi, c, 0]) for c in range(geo.ncomp)]

    def comp(self, slot):
        return 0 if slot < self.ny else slot - self.ny + 1


class Bits:
    """A segment's bits, zeros past its end."""

    def __init__(self, data: bytes):
        self.val, self.n = int.from_bytes(data, "big"), 8 * len(data)

    def peek(self, p, k):
        if p + k <= self.n:
            return (self.val >> (self.n - p - k)) & ((1 << k) - 1)
        if p >= self.n:
            return 0
        return (self.val & ((1 << (self.n - p)) - 1)) << (p + k - self.n)


def decode_sym(fr, bits, p, t, dc):
    """One symbol of table t at bit p -> (symbol, value, next p), or None
    for an invalid code or a DC size above 16 (csrc/jpeg.cu Tables.lookup:
    the 10-bit entry, else the max codes of lengths 11-16; the value read
    from the bits after the code)."""
    e = fr.fast[t][bits.peek(p, FAST_BITS)]
    if not e:
        row, top = fr.rows[t], bits.peek(p, 16)
        ln = next((k for k in range(FAST_BITS + 1, 17)
                   if top >> (16 - k) <= row[jpeg.T_MAXCODE + k]), 0)
        if not ln:
            return None
        e = make_entry(ln, int(row[jpeg.T_VALS:jpeg.T_BITS].view(np.uint8)[
            (top >> (16 - ln)) + row[jpeg.T_DELTA + ln]]), dc)
    s, run = (e >> 6) & 31, (e >> 11) & 15
    if s > 16:
        return None
    ln = (e & 63) - s
    v = _extend(bits.peek(p + ln, s), s) if s else 0
    return (s if dc else run << 4 | s), v, p + ln + s


def sync_decode(fr, bits, st, end):
    """Phase A from state (p, slot, z) while p < end -> (exit state, DCs
    begun, the three sums of diff * q0 mod 2**32, symbols decoded)."""
    p, slot, z = st
    v, rg, steps = [0, 0, 0, 0], 0, 0
    while p < end:
        c = fr.comp(slot)
        steps += 1
        if z < 0:
            v[0] += 1
            r = decode_sym(fr, bits, p, 2 * c, True)
            if r is not None:
                v[1 + c] = (v[1 + c] + r[1] * fr.q0[c]) & M32
                p, z = r[2], 0
                continue
        else:
            r = decode_sym(fr, bits, p, 2 * c + 1, False)
            if r is not None:
                sym = r[0]
                z = -1 if sym == 0 else z + (sym >> 4) + 1
                if not (sym & 15 and z > 63):
                    if z >= 63:
                        z = -1
                    if z < 0:
                        slot = (slot + 1) % fr.bpm
                    p = r[2]
                    continue
        rg = (rg + 1) % fr.bpm            # re-guess one bit on
        p, slot, z = p + 1, rg, 0
    return (p, slot, z), v, steps


def write_decode(fr, bits, st, end, b, needed, nbits, last, write):
    """Phase C from the synchronised start: skip the tail of the block
    begun before it, then decode and write blocks whose DC begins before
    end, up to block `needed`.  True for an error in a needed block."""
    p, slot, z = st
    while z >= 0 and p < end:
        r = decode_sym(fr, bits, p, 2 * fr.comp(slot) + 1, False)
        if r is None:
            return False
        sym, p = r[0], r[2]
        z = -1 if sym == 0 else z + (sym >> 4) + 1
        if sym & 15 and z > 63:
            return False
        if z >= 63:
            z = -1
    while p < end and b < needed:
        slot = b % fr.bpm
        c = fr.comp(slot)
        blk = np.zeros(64, np.int16)
        r = decode_sym(fr, bits, p, 2 * c, True)
        if r is None:
            return True
        last[c] = (r[1] * fr.q0[c] + last[c]) & M32
        d = last[c] - (1 << 32) if last[c] >= 1 << 31 else last[c]
        blk[0], p, i = max(-32768, min(32767, d)), r[2], 0
        while i < 63:
            r = decode_sym(fr, bits, p, 2 * c + 1, False)
            if r is None:
                return True
            sym, p = r[0], r[2]
            if sym == 0:
                break
            i += (sym >> 4) + 1
            if sym & 15:
                if i > 63:
                    return True
                blk[jpeg.ZIGZAG[i]] = r[1]
        if p > nbits:
            return True
        write(b, blk)
        b += 1
    return False


def model_decode(p: jpeg.Packed, sub_bits: int, stats=None):
    """The three phases over every segment of a packed chunk -> what
    entropy_decode_plain returns; ``stats`` gets (subsequences, rounds,
    phase-A symbols) a segment."""
    geo = p.geo
    coef = np.zeros((p.t, geo.nblk, 64), np.int16)
    err = np.zeros(p.t, np.int32)
    layout = jpeg._block_bases(geo)
    frames = {}
    for off, nbytes, fi, m0, nm in p.segs.tolist():
        fr = frames.get(fi) or frames.setdefault(fi, Frame(p, fi))
        bits = Bits(p.data[off:off + nbytes].tobytes())
        nsub = max(1, -(-8 * nbytes // sub_bits))
        ends = [(k + 1) * sub_bits for k in range(nsub - 1)] + [1 << 62]
        start = [(0, 0, -1)] + [(k * sub_bits, 0, 0) for k in range(1, nsub)]
        exit_, v = [None] * nsub, [[0] * 4 for _ in range(nsub)]
        work = 0
        for k in range(nsub - 1):          # A, round 0
            exit_[k], v[k], s = sync_decode(fr, bits, start[k], ends[k])
            work += s
        rounds, changed = 1, True
        while changed:                     # A, rounds
            dirty = [k for k in range(1, nsub) if exit_[k - 1] != start[k]]
            for k in dirty:
                start[k] = exit_[k - 1]
            changed = False
            for k in dirty:
                if k < nsub - 1:
                    e, v[k], s = sync_decode(fr, bits, start[k], ends[k])
                    work += s
                    changed |= e != exit_[k]
                    exit_[k] = e
            rounds += 1
        if stats is not None:
            stats.append((nsub, rounds, work))
        pre = np.zeros((nsub, 4), np.int64)   # B
        for k in range(1, nsub):
            pre[k] = (pre[k - 1] + v[k - 1]) & M32

        def write(b, blk, fi=fi, m0=m0, fr=fr):
            m, slot = m0 + b // fr.bpm, b % fr.bpm
            if geo.ncomp == 1:
                coef[fi, m] = blk
                return
            c, vv, uu = layout[slot]
            my, mx = divmod(m, geo.mcux)
            coef[fi, geo.blk0[c] + (my * geo.vs[c] + vv) * geo.bw[c]
                 + mx * geo.hs[c] + uu] = blk

        for k in range(nsub):              # C
            last = [int(1024 + s) & M32 for s in pre[k, 1:]]
            if write_decode(fr, bits, start[k], ends[k], int(pre[k, 0]),
                            nm * fr.bpm, 8 * nbytes, last, write):
                err[fi] = 1
    return coef, err


def _hold(p, sub_bits, stats=None):
    coef, err = model_decode(p, sub_bits, stats)
    want_coef, want_err = jpeg.entropy_decode_plain(p)
    np.testing.assert_array_equal(err, want_err)
    good = want_err == 0
    np.testing.assert_array_equal(coef[good], want_coef[good])
    return err


# ── the model against the plain version ────────────────────────────────────

@pytest.mark.parametrize("sub_bits", [32, 160, SUB_BITS])
def test_model_equals_plain_on_the_fixtures(sub_bits):
    """Every committed fixture but the refused one, its first frame (the
    two largest, 256² and 240x320, at the wrapper's S only)."""
    for path in sorted(FIXTURES.glob("*.avi")):
        if path.name == "pil_420_odd_37x53.avi" or (
                path.name[:4] in ("real", "wide") and sub_bits < SUB_BITS):
            continue
        assert not _hold(_pack(jpeg_frames_of(path)[:1]), sub_bits).any()


@pytest.mark.parametrize("sub_bits", [32, SUB_BITS])
def test_model_equals_plain_on_the_stress_streams(sub_bits):
    """PR 13's stress kinds (a frame each at 24x29: every sampling, restart
    intervals, 16-bit quantisers, Annex K), the synchronisation stress streams
    (equal code lengths, restart intervals of one MCU, segments shorter
    than a subsequence, 32-bit DC symbols, junk after the last block: not
    flagged; a frame one block short: flagged) and two broken ones."""
    cases = [(k, stress_frames(k, 24, 29, s, t=1, seed=i, restart=r,
                               quant_max=q, dht=d))
             for i, (k, s, r, q, d) in enumerate((
                 ("extreme", "4:2:0", 0, 1, True),
                 ("dense", "4:4:4", 1, 65535, True),
                 ("sparse", "4:2:2", 0, 255, False),
                 ("noise", "gray", 5, 255, False)))]
    cases += sync_stress_cases()
    good = stress_frames("noise", 38, 53, "4:2:0", t=3, seed=11)
    body = good[1].index(b"\xff\xda")
    cases += [("short", [good[0], good[1][:body + 40], good[2]]),
              ("all-ones codes", [good[0], good[1][:body + 20]
                                  + b"\xff\x00" * 64 + b"\xff\xd9",
                                  good[2]])]
    flagged = {}
    for label, frames in cases:
        flagged[label] = _hold(_pack(frames), sub_bits).tolist()
    assert flagged["one block short gray 32x48"] == [0, 1, 0]
    assert flagged["one block short 4:2:0 32x48"] == [0, 1, 0]
    assert flagged["short"] == flagged["all-ones codes"] == [0, 1, 0]
    assert not any(any(flagged[k]) for k in flagged if k.startswith("junk"))


def test_rounds_end_and_the_realistic_stream_synchronises():
    """Round r makes the first r + 1 subsequences exact, so a segment
    needs at most as many rounds as subsequences, also where codes of one
    length never synchronise by themselves; on a cv2-written 256² frame
    the rounds are few against its ~80 subsequences of the wrapper's S."""
    stats = []
    _hold(_pack(jpeg_frames_of(FIXTURES / "real_256_64.avi")[:2]), SUB_BITS,
          stats)
    for nsub, rounds, work in stats:
        assert nsub > 60 and rounds < nsub // 4, stats
    stats = []
    equal = dict(sync_stress_cases())["equal code lengths noise gray 64x64"]
    _hold(_pack(equal), 32, stats)
    assert all(rounds <= nsub + 1 for nsub, rounds, _ in stats), stats


def test_one_lookup_table_decodes_as_the_prefix_table():
    """Every 16-bit prefix of every table of the fixtures and the stress
    streams, as DC and as AC: the 10-bit entry (or the walk past it) gives
    the code length, symbol and extended value of the canonical code."""
    tables = set()
    for path in sorted(FIXTURES.glob("*.avi"))[:4]:
        p = _pack(jpeg_frames_of(path)[:1])
        tables |= {r.tobytes() for r in p.tables}
    for _, frames in sync_stress_cases()[:5]:
        tables |= {r.tobytes() for r in _pack(frames[:1]).tables}
    for raw in sorted(tables):
        row = np.frombuffer(raw, np.int32)
        lut = jpeg._prefix_table(row[jpeg.T_BITS:jpeg.T_BITS + 4].view(
            np.uint8), row[jpeg.T_VALS:jpeg.T_BITS].view(np.uint8).tobytes())
        for dc in (True, False):
            fr = Frame.__new__(Frame)
            fr.rows = [row]
            fr.fast = [fast_table(row, dc)]
            for top in range(0, 1 << 16, 7):
                bits = Bits(top.to_bytes(2, "big") + b"\x5a\xc3")
                e = int(lut[top])
                got = decode_sym(fr, bits, 0, 0, dc)
                sym = e & 0xFF
                size = sym if dc else sym & 15
                if e < 0 or size > 16:
                    assert got is None
                    continue
                ln = e >> 8
                v = _extend(bits.peek(ln, size), size) if size else 0
                assert got == (sym, v, ln + size), (top, dc)


# ── the new stress streams against cv2 ─────────────────────────────────────

def test_sync_stress_streams_equal_cv2_frames(tmp_path):
    """The plain decode of each synchronisation stress stream equals
    cv2's frames (the JAX package's reader); the frame cut one block short
    raises naming it."""
    for i, (label, frames) in enumerate(sync_stress_cases()):
        h, w = (int(x) for x in label.rsplit(" ", 1)[1].split("x"))
        path = tmp_path / f"s{i}.avi"
        write_mjpg_avi(path, frames, w, h)
        if label.startswith("one block short"):
            with pytest.raises(ValueError, match="frame 1"):
                load_frames_bgr(path, device="cpu")
            continue
        np.testing.assert_array_equal(load_frames_bgr(path, device="cpu"),
                                      cv2_frames(path), err_msg=label)
