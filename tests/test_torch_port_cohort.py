"""Cohort serving, port vs JAX package and vs the port's per-video calls, on
the CPU at full width with the demo weights, float32.

Held exactly (bool / int32 outputs, float32 waveforms by value): the batched
gate and the batched threshold chain against ``jax.vmap`` of the JAX
package's scans over padded stacks (compared on the real frames);
``ygvft_parallel_multi`` against the JAX one; the guided-vft and vft cohorts
against the JAX side composed from its modular functions on exactly these
frames (the fused cohort entries pad every video to 128 frames) and against
the port's per-video calls; the table form of the in-box count against
per-chunk counts; the cohort size rule.  ``yolo_unet_areas_gray_multi`` is
held bit-equal to the port's per-video calls on both ``unet`` routes and
against the JAX package's windowed chunk function within 2.0 px, the
borderline pixel count of ``test_torch_port_window.py``.  Part of the
realistic synthetic video: the port's bicubic upsampling against ``cv2``
(an oracle here; the port imports none) and the frames against the JAX
package's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglottal_tpu import pipelines as jpipe
from openglottal_tpu.data.synthetic import synthetic_video as jax_synthetic_video
from openglottal_tpu.models import fold as jfold
from openglottal_tpu.models import gate as jgate
from openglottal_tpu.models import tracker as jtracker
from openglottal_tpu_torch import pipelines as P
from openglottal_tpu_torch.data.synthetic import (
    gate_stress_sequence,
    resize_bicubic,
    synthetic_video,
    thresh_stress_sequence,
)
from openglottal_tpu_torch.models import gate as tgate
from openglottal_tpu_torch.models import tracker as ttracker
from openglottal_tpu_torch.ops import areas_cuda
from openglottal_tpu_torch.pipelines import (
    VFT_INIT,
    YGVFT_INIT,
    GlottalPipelines,
    cohort_k,
    cohort_video_bytes,
)
from openglottal_tpu_torch.utils.io import load_weights_npz

_MEMO = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes side by side; PyTorch's
    intra-op thread pool in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pad(x, n):
    return np.concatenate([x, np.zeros((n - len(x), *x.shape[1:]), x.dtype)])


def _offsets(lengths):
    return [0, *np.cumsum(lengths).tolist()]


# ── the batched gate and threshold chain ────────────────────────────────────

@functools.lru_cache(maxsize=None)
def _jax_scans():
    return {
        "gate": jax.jit(jax.vmap(
            lambda st, h, b: jgate.gate_scan_carry(st, h, b, 256, 256))),
        "chain": jax.jit(jax.vmap(
            lambda th, c, n, a: jtracker._thresh_chain(th, c, n, a, 0.7))),
    }


def _gate_inputs(lengths, seed):
    seqs = [gate_stress_sequence(t, seed=seed + t) for t in lengths]
    return ([s[0] for s in seqs], [s[1] for s in seqs],
            [tgate.GateState(*s[2]) for s in seqs])


def _jax_states(states):
    f = np.float32
    return jgate.GateState(
        jnp.asarray([bool(s.valid) for s in states]),
        jnp.asarray([f(s.cx) for s in states]),
        jnp.asarray([f(s.cy) for s in states]),
        jnp.asarray([int(s.w) for s in states], jnp.int32),
        jnp.asarray([int(s.h) for s in states], jnp.int32),
        jnp.asarray([int(s.miss) for s in states], jnp.int32))


@pytest.mark.parametrize("carried", [False, True])
def test_gate_scan_batch_equals_vmapped_jax_gate(carried):
    """K = 3 ragged sequences (5, 1, 9 frames) in one flat stack, from the
    initial state or from carried-in states, against ``jax.vmap`` of the
    JAX package's gate over the zero-padded stack: outputs equal on the real
    frames; resumed in two segments through the (K, 6) carried state, the
    same outputs, and the carry equals the JAX package's carry of each
    sequence alone."""
    lengths = (5, 1, 9)
    hs, bs, s0 = _gate_inputs(lengths, seed=40)
    starts = s0 if carried else [tgate.gate_init()] * 3
    n = max(lengths)
    jst, (jv, jb) = _jax_scans()["gate"](
        _jax_states(starts), jnp.asarray(np.stack([_pad(h, n) for h in hs])),
        jnp.asarray(np.stack([_pad(b, n) for b in bs])))
    off = _offsets(lengths)
    has, raw = torch.from_numpy(np.concatenate(hs)), torch.from_numpy(
        np.concatenate(bs))
    state = torch.stack([tgate._state_buffer(s, "cpu") for s in starts])
    v, b = tgate.gate_scan_batch(has, raw, off, 256, 256,
                                 state=state.clone() if carried else None)
    for i, t in enumerate(lengths):
        np.testing.assert_array_equal(v[off[i]:off[i + 1]].numpy(),
                                      np.asarray(jv[i, :t]))
        np.testing.assert_array_equal(b[off[i]:off[i + 1]].numpy(),
                                      np.asarray(jb[i, :t]))
    # two segments: the first 3 frames of each (3, 1, 3), then the rest,
    # the carry passed on in the (K, 6) state buffer
    cut = [min(3, t) for t in lengths]
    spans = ([(a, a + c) for a, c in zip(off, cut)],
             [(a + c, a + t) for a, c, t in zip(off, cut, lengths)])
    carry = state.clone()
    segs = [(tgate.gate_scan_batch(
        torch.cat([has[a:b] for a, b in sp]),
        torch.cat([raw[a:b] for a, b in sp]),
        _offsets([b - a for a, b in sp]), 256, 256, state=carry),
        _offsets([b - a for a, b in sp])) for sp in spans]
    for i, t in enumerate(lengths):
        for k in (0, 1):
            got = np.concatenate([out[k][o[i]:o[i + 1]].numpy()
                                  for out, o in segs])
            np.testing.assert_array_equal(got, np.asarray((jv, jb)[k][i, :t]))
        # the carry: the per-video carried gate's (itself held against the
        # JAX package in test_torch_port_gate.py)
        want_st, _ = tgate.gate_scan_carry(
            starts[i], torch.from_numpy(hs[i]), torch.from_numpy(bs[i]),
            256, 256)
        assert torch.equal(carry[i], tgate._state_buffer(want_st, "cpu"))


def test_gate_scan_batch_empty_and_bad_offsets():
    has = torch.zeros(4, dtype=torch.bool)
    raw = torch.zeros((4, 4))
    v, b = tgate.gate_scan_batch(has[:0], raw[:0], [0, 0, 0], 256, 256)
    assert v.shape == (0,) and b.shape == (0, 4)
    for bad in ([0, 5], [1, 4], [0, 3, 2, 4]):
        with pytest.raises(ValueError):
            tgate.gate_scan_batch(has, raw, bad, 256, 256)


def test_thresh_chain_batch_equals_vmapped_jax_chain():
    """K = 3 chains (5, 1, 9 steps, the stress sequences' fallback and
    inactive steps) against ``jax.vmap`` of the JAX package's chain over the
    padded stack: float32 bits equal on the real steps."""
    lengths = (5, 1, 9)
    seqs = [thresh_stress_sequence(t, seed=50 + t) for t in lengths]
    n = max(lengths)
    th0 = np.array([np.float32(s[0]) for s in seqs], np.float32)
    cur, npx, act = ([np.asarray(s[j]) for s in seqs] for j in (1, 2, 3))
    want = _jax_scans()["chain"](
        jnp.asarray(th0), *(jnp.asarray(np.stack([_pad(x, n) for x in xs]))
                            for xs in (cur, npx, act)))
    off = _offsets(lengths)
    got = ttracker.thresh_chain_batch(
        torch.from_numpy(th0), *(torch.from_numpy(np.concatenate(xs))
                                 for xs in (cur, npx, act)), off, 0.7)
    for i, t in enumerate(lengths):
        np.testing.assert_array_equal(
            got[off[i]:off[i + 1]].numpy().view(np.int32),
            np.asarray(want[i, :t]).view(np.int32))


# ── the guided tracker over a cohort ────────────────────────────────────────

def _tracker_video(t, seed):
    frames, _ = synthetic_video(t=t, size=256, seed=seed)
    return frames[..., 0]


def _tracker_boxes(t, seed, big=False):
    """Gate-like boxes around the synthetic glottis, valid on most frames;
    ``big``: one box wider than the 128² window (the full-frame pass)."""
    rng = np.random.default_rng(seed)
    valid = rng.random(t) > 0.2
    cx = 128 + rng.integers(-6, 7, t)
    cy = 128 + rng.integers(-6, 7, t)
    hw, hh = rng.integers(14, 30, t), rng.integers(30, 50, t)
    boxes = np.stack([cx - hw, cy - hh, cx + hw, cy + hh], 1).astype(np.int32)
    if big:
        boxes[t // 2] = [40, 60, 200, 190]
    return valid, boxes


def test_ygvft_parallel_multi_equals_jax():
    """K = 2 videos of 6 and 9 tracked frames at 256² against the JAX
    package's ``ygvft_parallel_multi`` on the zero-padded stack (tail
    inactive): areas exactly equal on the real frames.  One oversized box in
    the second video sends the whole cohort through the full-frame pass (the
    windowed pass, and the per-video calls, are held by the guided-vft
    cohort test below)."""
    big = True
    ts = (6, 9)
    gr = [_tracker_video(t + YGVFT_INIT, s) for t, s in zip(ts, (11, 12))]
    vb = [_tracker_boxes(t, s, big and i == 1)
          for i, (t, s) in enumerate(zip(ts, (21, 22)))]
    init = np.stack([g[:YGVFT_INIT] for g in gr]).astype(np.float32)
    fv = np.array([True, False])
    fb = np.array([[100, 90, 150, 170], [0, 0, 0, 0]], np.int32)
    n = 10      # the guided-vft cohort test's padded length (one compile)
    want = jtracker.ygvft_parallel_multi(
        jnp.asarray(init), jnp.asarray(fv), jnp.asarray(fb),
        jnp.asarray(np.stack([_pad(g[YGVFT_INIT:].astype(np.float32), n)
                              for g in gr])),
        jnp.asarray(np.stack([_pad(v, n) for v, _ in vb])),
        jnp.asarray(np.stack([_pad(b, n) for _, b in vb])),
        jnp.asarray(np.arange(n)[None] < np.array(ts)[:, None]),
        params=jtracker.YGVFTParams())
    off = _offsets(ts)
    got = ttracker.ygvft_parallel_multi(
        torch.from_numpy(init), torch.from_numpy(fv), torch.from_numpy(fb),
        torch.from_numpy(np.concatenate([g[YGVFT_INIT:] for g in gr])),
        torch.from_numpy(np.concatenate([v for v, _ in vb])),
        torch.from_numpy(np.concatenate([b for _, b in vb])), off)
    for i, t in enumerate(ts):
        np.testing.assert_array_equal(got[off[i]:off[i + 1]].numpy(),
                                      np.asarray(want[i, :t]))


# ── the gated cohorts at full width ─────────────────────────────────────────

def _cohort():
    """[12-frame, 3-frame, 9-frame] gray 256² videos (the 3-frame one is too
    short for either tracker)."""
    if "cohort" not in _MEMO:
        _MEMO["cohort"] = [
            np.ascontiguousarray(synthetic_video(t=t, size=256, seed=s)[0]
                                 [..., 0]) for t, s in ((12, 5), (3, 6),
                                                        (9, 7))]
    return _MEMO["cohort"]


def _trees():
    if "trees" not in _MEMO:
        _MEMO["trees"] = {k: load_weights_npz(f"weights/demo_{k}.npz")
                          for k in ("unet", "yolo")}
    return _MEMO["trees"]


def _pipes(window=None):
    key = ("gp", window)
    if key not in _MEMO:
        t = _trees()
        _MEMO[key] = GlottalPipelines(
            unet_variables=t["unet"], yolo_variables=t["yolo"],
            dtype=torch.float32, window_decoder=window, device="cpu")
    return _MEMO[key]


def _jax_gated(videos):
    """The JAX package's detector per video (``_yolo_chunk_gray``) and
    ``jax.vmap`` of its gate over the padded detections -> per video
    (valid, boxes) on the real frames."""
    if "jgated" not in _MEMO:
        yv = jfold.fold_yolo(_trees()["yolo"])
        n = max(len(v) for v in videos)
        # one detector call over every frame (the detector is per frame)
        h, r, _ = jpipe._yolo_chunk_gray(yv, jnp.asarray(np.concatenate(
            videos)), conf=0.25, dtype=jnp.float32, fuse=True)
        cuts = _offsets([len(v) for v in videos])
        has = [_pad(np.asarray(h)[a:b], n) for a, b in zip(cuts, cuts[1:])]
        raw = [_pad(np.asarray(r)[a:b], n) for a, b in zip(cuts, cuts[1:])]
        jv, jb = jax.vmap(lambda h, r: jgate.gate_scan(h, r, 256, 256))(
            jnp.asarray(np.stack(has)), jnp.asarray(np.stack(raw)))
        _MEMO["jgated"] = [(np.asarray(jv[i, :len(v)]),
                            np.asarray(jb[i, :len(v)]))
                           for i, v in enumerate(videos)]
    return _MEMO["jgated"]


def test_guided_vft_cohort_equals_jax_and_per_video():
    videos = _cohort()
    gp = _pipes()
    got = gp.guided_vft_areas_gray_multi(videos, max_k=2)
    assert got[1] is None                       # 3 < YGVFT_INIT + 2
    run = [0, 2]
    for i in run:
        np.testing.assert_array_equal(got[i], gp.guided_vft_areas(videos[i]))
    # the JAX side: gated detections, then ygvft_parallel_multi on the two
    # videos that run, padded to the longer one with an inactive tail
    gated = _jax_gated(videos)
    ts = [len(videos[i]) - YGVFT_INIT for i in run]
    n = max(ts)
    g32 = [videos[i].astype(np.float32) for i in run]
    vin = np.stack([gated[i][0][:YGVFT_INIT] for i in run])
    fi = vin.argmax(1)
    want = jtracker.ygvft_parallel_multi(
        jnp.asarray(np.stack([g[:YGVFT_INIT] for g in g32])),
        jnp.asarray(vin.any(1)),
        jnp.asarray(np.stack([gated[i][1][f] for i, f in zip(run, fi)])),
        jnp.asarray(np.stack([_pad(g[YGVFT_INIT:], n) for g in g32])),
        jnp.asarray(np.stack([_pad(gated[i][0][YGVFT_INIT:], n)
                              for i in run])),
        jnp.asarray(np.stack([_pad(gated[i][1][YGVFT_INIT:], n)
                              for i in run])),
        jnp.asarray(np.arange(n)[None] < np.array(ts)[:, None]),
        params=jtracker.YGVFTParams())
    for row, i in enumerate(run):
        assert got[i].shape == (len(videos[i]),)
        assert (got[i][:YGVFT_INIT] == 0).all()
        np.testing.assert_array_equal(got[i][YGVFT_INIT:],
                                      np.asarray(want[row, :ts[row]]))


def test_vft_cohort_equals_jax_and_per_video():
    """Both videos that run equal to the per-video call, the 12-frame one
    also to the JAX side (its crops and tracker; the per-video path is held
    against the JAX package in test_torch_port_slice.py)."""
    videos = _cohort()
    gp = _pipes()
    got = gp.vft_areas_gray_multi(videos, max_k=2)
    assert got[1] is None                       # 3 < VFT_INIT + 5
    for i in (0, 2):
        np.testing.assert_array_equal(got[i], gp.vft_areas(videos[i]))
    for i in (0,):
        valid, boxes = _jax_gated(videos)[i]
        idx = np.nonzero(valid)[0]
        b0 = boxes[idx[0]]
        h0, w0 = int(b0[3] - b0[1]), int(b0[2] - b0[0])
        crops = jpipe._gather_crops(jnp.asarray(videos[i][idx]),
                                    jnp.asarray(boxes[idx]), h0, w0)
        active = jnp.asarray(np.arange(len(idx)) >= VFT_INIT)
        _, areas_v = jtracker.vft_parallel(crops[:VFT_INIT], crops, active,
                                           params=jtracker.VFTParams())
        want = np.zeros(len(videos[i]), np.float32)
        want[idx] = np.asarray(areas_v)
        want[idx[:VFT_INIT]] = 0.0
        np.testing.assert_array_equal(got[i], want)


def test_gated_cohorts_fall_back_per_video():
    """Non-256² frames go through per-video calls; [] -> []."""
    gp = _pipes()
    small = [_cohort()[2][:YGVFT_INIT + 2, :200, :240]]
    np.testing.assert_array_equal(gp.guided_vft_areas_gray_multi(small)[0],
                                  gp.guided_vft_areas(small[0]))
    assert gp.guided_vft_areas_gray_multi([]) == []
    assert gp.vft_areas_gray_multi([]) == []
    assert gp.yolo_unet_areas_gray_multi([]) == []


# ── pipeline 3 over a cohort ────────────────────────────────────────────────

def _unet_cohort():
    """Three 4-frame gray 256² videos; the third is frames 6-9 of its clip
    (the glottis open wider), frame i moved up by 28 i rows (within the
    gate's drift clamp), so its chunk's boxes do not fit one window."""
    if "unet_cohort" not in _MEMO:
        vids = [np.ascontiguousarray(synthetic_video(t=4, size=256, seed=s)[0]
                                     [..., 0]) for s in (8, 9)]
        moved = synthetic_video(t=10, size=256, seed=10)[0][6:, ..., 0]
        for i in range(1, 4):
            moved[i] = np.roll(moved[i], -28 * i, axis=0)
        vids.append(np.ascontiguousarray(moved))
        _MEMO["unet_cohort"] = vids
    return _MEMO["unet_cohort"]


def _per_video_unet(window):
    """The per-video calls' waveforms.  Windowed: the two videos that fit;
    the per-video call on the third is its full-frame redo, which is the
    full-frame route's call (``test_torch_port_window.py``)."""
    key = ("unet_per_video", window)
    if key not in _MEMO:
        gp = _pipes(window)
        vids = _unet_cohort()[:2] if window is None else _unet_cohort()
        _MEMO[key] = [gp.yolo_unet_areas_resolve(
            gp.yolo_unet_areas_deferred(v)) for v in vids]
        if window is None:
            _MEMO[key].append(_per_video_unet(False)[2])
    return _MEMO[key]


@functools.lru_cache(maxsize=None)
def _jax_windowed_fns():
    """The JAX package's detection summaries, gate and windowed U-Net chunk
    function under ``jax.jit`` (as ``test_torch_port_window.py`` jits
    them, so the persistent compilation cache serves both)."""
    f32 = jnp.float32
    return {
        "fold_unet": jax.jit(jfold.fold_unet),
        "fold_yolo": jax.jit(jfold.fold_yolo),
        "summary": jax.jit(lambda v, g: jpipe._yolo_summary_chunk_fn(
            v, 256, 256, 0.25, f32, True)(g)),
        "gate": jax.jit(lambda has, raw: jgate.gate_scan(has, raw, 256, 256)),
        "windowed": jax.jit(lambda v, g, valid, boxes:
                            jpipe._unet_windowed_areas_chunk_fn(
                                v, 256, 256, f32, True, 160)(g, valid,
                                                              boxes)),
    }


def test_unet_cohort_windowed_equals_per_video_and_jax(monkeypatch):
    """The windowed route, max_k = 2 (sub-batches of 2 and 1): every
    waveform bit-equal to the per-video call; the non-fitting video, and
    only it, redone on the full-frame route in the read loop (equal to the
    full-frame route's per-video call); within 2.0 px of the JAX package's
    windowed chunk function on the first video."""
    vids = _unet_cohort()
    gp = _pipes()
    assert gp.window_decoder
    want = _per_video_unet(None)
    redone = []
    real = gp._unet_gated
    monkeypatch.setattr(gp, "_unet_gated", lambda fd, g, window, *a: (
        redone.append((g.shape[0], window)) or real(fd, g, window, *a)))
    got = gp.yolo_unet_areas_gray_multi(vids, max_k=2)
    monkeypatch.undo()
    assert redone == [(4, False)]
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    f = _jax_windowed_fns()
    uv = f["fold_unet"](_trees()["unet"])
    yv = f["fold_yolo"](_trees()["yolo"])
    g = jnp.asarray(vids[0])
    jareas, fits = f["windowed"](uv, g, *f["gate"](*f["summary"](yv, g)))
    assert bool(fits)
    assert np.abs(got[0] - np.asarray(jareas)).max() <= 2.0


def test_unet_cohort_full_route_fetch_false_equals_per_video():
    """window_decoder=False, fetch=False: per-video device tensors, each
    equal to the per-video call."""
    vids = _unet_cohort()
    got = _pipes(False).yolo_unet_areas_gray_multi(vids, fetch=False,
                                                   max_k=2)
    for g, w in zip(got, _per_video_unet(False)):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), w)


# ── the in-box count over a table of chunks ─────────────────────────────────

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_box_count_table_equals_per_chunk_counts(dtype):
    rng = np.random.default_rng(3)
    chunks = []
    for n, oy, ox in ((7, 10, 20), (1, 0, 0), (5, 33, 4)):
        x = torch.from_numpy(rng.normal(0, 1, (n, 24, 30)).astype(np.float32)
                             ).to(dtype)
        valid = torch.from_numpy(rng.random(n) < 0.7)
        xy = rng.integers(-10, 60, (n, 2))
        boxes = torch.from_numpy(np.concatenate(
            [xy, xy + rng.integers(0, 40, (n, 2))], 1).astype(np.int32))
        chunks.append((x, valid, boxes, torch.tensor(oy), ox))
    out = torch.full((5,), -1.0)
    table = [areas_cuda.CountChunk(*c) for c in chunks[:2]]
    table.append(areas_cuda.CountChunk(*chunks[2], out=out))
    got = areas_cuda.box_count_table(table, 0.25)
    assert got[2] is out
    for g, c in zip(got, chunks):
        torch.testing.assert_close(
            g, areas_cuda.box_count(c[0], 0.25, *c[1:]), rtol=0, atol=0)
    assert areas_cuda.box_count_table([], 0.0) == []


# ── the cohort size rule ────────────────────────────────────────────────────

def test_cohort_k_rule():
    gib = 2 ** 30
    ts = [502] * 100
    # as many 502-frame videos as fit 80 % of 70 GiB, after the fixed part
    k = cohort_k("guided-vft", ts, 70 * gib, 2)
    per = cohort_video_bytes("guided-vft", 502, 2)
    assert k == int((70 * gib * P.COHORT_MEM_SHARE
                     - P.cohort_fixed_bytes("guided-vft", 502, 2)) // per)
    assert 1 <= k < 100
    # more memory: the int32 cap on the tail's (sum T, 258, 258) planes
    big = cohort_k("guided-vft", [502] * 1000, 10 ** 15, 2)
    assert big == (2 ** 31 - 1) // (502 * 258 * 258)
    assert big * 502 * 258 * 258 < 2 ** 31
    # max_k, the cohort's size and at least one video bound it
    assert cohort_k("unet", ts, 70 * gib, 2, max_k=3) == 3
    assert cohort_k("vft", ts[:5], 70 * gib, 2) == 5
    assert cohort_k("unet", ts, 0, 4) == 1
    assert cohort_video_bytes("unet", 502, 4) > cohort_video_bytes(
        "unet", 502, 2)
    with pytest.raises(ValueError):
        cohort_video_bytes("crop-unet", 10, 2)


# ── the realistic synthetic video without cv2 ───────────────────────────────

@pytest.mark.parametrize("size", [256, 320])
def test_bicubic_equals_cv2(size):
    cv2 = pytest.importorskip("cv2")
    for seed in range(3):
        lf = np.random.default_rng(seed).normal(0, 1, (size // 16,
                                                       size // 16))
        np.testing.assert_array_equal(
            resize_bicubic(lf, size, size),
            cv2.resize(lf, (size, size), interpolation=cv2.INTER_CUBIC))


@pytest.mark.parametrize("size,seed,t", [(256, 7, 3), (256, 1, 2),
                                         (320, 2, 2)])
def test_realistic_video_equals_jax_package(size, seed, t):
    a, am = synthetic_video(t=t, size=size, seed=seed, realistic=True)
    b, bm = jax_synthetic_video(t=t, size=size, seed=seed, realistic=True)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(am, bm)
