"""Port vs JAX package on the CPU: what the ``vft`` pipeline adds below the
entry point — the size-locked crop resize, the motion map (blurred absdiff
and recurrence), and both forms (frame-parallel, sequential) of both
trackers.

Inputs are made with numpy from a seed and go through both packages; the
port runs on CPU tensors, where each kernel wrapper takes its plain version.
Every tolerance stands beside its reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglottal_tpu import pipelines as jpipe
from openglottal_tpu.models import tracker as jtracker
from openglottal_tpu.ops import resize as jresize
from openglottal_tpu_torch import pipelines as tpipe
from openglottal_tpu_torch.data.synthetic import synthetic_video
from openglottal_tpu_torch.models import tracker as ttracker
from openglottal_tpu_torch.ops import resize as tresize
from openglottal_tpu_torch.ops import scan_cuda

_MEMO = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes side by side; PyTorch's
    intra-op thread pool in each of them oversubscribes the cores and makes
    the many small tensor ops here an order of magnitude slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)


# ── resize ──────────────────────────────────────────────────────────────────

@pytest.mark.parametrize("in_size,out_size,start,length", [
    (256, 97, 0.0, None), (120, 154, 0.0, None), (64, 20, 10.0, 33.0),
    (64, 200, 5.0, 7.0), (48, 48, 0.0, None)])
def test_linear_matrix_static_exact(in_size, out_size, start, length):
    """Static geometry is float64 numpy in both packages: equal entries."""
    got = tresize._linear_matrix(in_size, out_size, start, length).numpy()
    want = np.asarray(jresize._linear_matrix(in_size, out_size, start, length))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _boxes(n, rng, lo=16, hi=130, size=256):
    bw, bh = rng.integers(lo, hi, n), rng.integers(lo, hi, n)
    x0, y0 = rng.integers(0, size - bw), rng.integers(0, size - bh)
    return np.stack([x0, y0, x0 + bw, y0 + bh], 1).astype(np.int32)


@pytest.mark.parametrize("out_size", [61, 97, 140])
def test_linear_matrix_per_frame_bit_equal(out_size):
    """Per-frame (traced) geometry is float32 on both sides; the port pins
    the reference's compiled forms (reciprocal multiply, one fma), so the
    matrices are equal bit for bit, clamped window edges included."""
    b = _boxes(24, np.random.default_rng(out_size))
    start, length = b[:, 1].astype(np.float32), (b[:, 3] - b[:, 1]).astype(
        np.float32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda s, l: jresize._linear_matrix(256, out_size, start=s, length=l)
    ))(jnp.asarray(start), jnp.asarray(length)))
    got = tresize._linear_matrix(256, out_size, torch.from_numpy(start),
                                 torch.from_numpy(length)).numpy()
    assert got.shape == want.shape == (24, out_size, 256)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("out_hw", [(61, 97), (80, 48)])
def test_gather_crops_exact_after_rounding(out_hw):
    """Crops are rounded to integers, so only a value at an exact .5 could
    differ; with the pinned forms none does (and the unrounded resamples
    agree bit for bit, which is stronger)."""
    rng = np.random.default_rng(3)
    n = 24
    img = rng.integers(0, 256, (n, 256, 256)).astype(np.uint8)
    boxes = _boxes(n, rng)
    want = np.asarray(jpipe._gather_crops(jnp.asarray(img), jnp.asarray(boxes),
                                          *out_hw))
    got = tpipe._gather_crops(torch.from_numpy(img), torch.from_numpy(boxes),
                              *out_hw).numpy()
    assert got.shape == want.shape == (n, *out_hw)
    n_diff = int((got != want).sum())
    assert n_diff == 0, f"{n_diff} of {got.size} crop pixels differ"

    def one(frame, b):
        f = jnp.float32
        return jresize.crop_resize_bilinear(
            frame.astype(f), b[1].astype(f), b[0].astype(f),
            (b[3] - b[1]).astype(f), (b[2] - b[0]).astype(f), *out_hw)
    raw_want = np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(img),
                                                 jnp.asarray(boxes)))
    bt = torch.from_numpy(boxes).float()
    raw_got = tresize.crop_resize_bilinear(
        torch.from_numpy(img), bt[:, 1], bt[:, 0], bt[:, 3] - bt[:, 1],
        bt[:, 2] - bt[:, 0], *out_hw).numpy()
    n_bits = int((_bits(raw_got) != _bits(raw_want)).sum())
    assert n_bits == 0, f"{n_bits} of {raw_got.size} unrounded values differ"


@pytest.mark.parametrize("in_size,out_size", [(256, 139), (8192, 8192),
                                              (8192, 3), (5, 8192)])
def test_integer_window_float64_sums_equal_the_exact_fma(in_size, out_size):
    """The crop's single-rounding float64 sums (integer windows, and uint8
    pixels in the row pass) give the correctly rounded fma of
    ``ops/fma.fma32`` bit for bit, on random windows with whole-axis, edge,
    1- and 0-sample ones among them, up to the 2^13-sample bound."""
    rng = np.random.default_rng(11)
    start = rng.integers(0, in_size, 48)
    length = rng.integers(0, in_size - start + 1)
    start[:3], length[:3] = (0, in_size - 1, 0), (in_size, 1, 0)
    s, ln = torch.from_numpy(start), torch.from_numpy(length)
    exact = tresize._linear_taps(in_size, out_size, s, ln)
    fused = tresize._linear_taps(in_size, out_size, s.float(), ln.float())
    for e, f in zip(exact, fused):
        if e.is_floating_point():
            e, f = e.view(torch.int32), f.view(torch.int32)
        assert torch.equal(e, f)
    img = torch.from_numpy(rng.integers(0, 256, (48, in_size, 2),
                                        dtype=np.uint8))
    cols = tresize._linear_taps(2, 2)
    got = tresize._apply_sep(img, exact, cols)
    want = tresize._apply_sep(img.float(), fused, cols)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_resize_bilinear_static_matches_jax():
    """Whole-image resize with static geometry.  atol 1e-3 on 0..255 values:
    the reference's dense product may fuse or order its two taps otherwise
    than the port's two-tap gather (a last-bit difference, ~1.5e-5)."""
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (3, 60, 44)).astype(np.float32)
    got = tresize.resize_bilinear(torch.from_numpy(img), 97, 31).numpy()
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(img), 97, 31))
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    same = tresize.resize_bilinear(torch.from_numpy(img), 60, 44).numpy()
    np.testing.assert_array_equal(same, img)


# ── the motion map (blurred absdiff + recurrence, one kernel launch) ──────

@pytest.mark.parametrize("alpha", [0.98, 0.3])
def test_lmap_ema_bit_equal_to_the_sequential_scan(alpha):
    """With a 1-tap blur the reference's absdiff is exact, so its scan's
    motion map isolates the recurrence: :func:`motion_map` equals it bit for
    bit, step by step (T = 1 calls, as the sequential trackers make), and
    over a chain with an inactive prefix and tail."""
    rng = np.random.default_rng(int(alpha * 100))
    t, h, w = 6, 16, 16
    p = jtracker.VFTParams(alpha=alpha, gaussian_ksize=1)
    frames = rng.integers(0, 256, (t, h, w)).astype(np.float32)
    prev0 = rng.integers(0, 256, (h, w)).astype(np.float32)
    lmap0 = rng.uniform(0, 50, (h, w)).astype(np.float32)
    carry = (jnp.asarray(prev0), jnp.asarray(lmap0), jnp.float32(100.0))
    one = torch.ones((1,), dtype=torch.bool)
    for i in range(t):
        prev, lmap = np.array(carry[0]), np.array(carry[1])
        carry, _ = jtracker.vft_scan_carry(carry, jnp.asarray(frames[i:i + 1]),
                                           params=p)
        got = ttracker.motion_map(torch.from_numpy(prev),
                                  torch.from_numpy(frames[i:i + 1]),
                                  torch.from_numpy(lmap), one, alpha, 1)[0]
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(carry[1]),
                                      err_msg=f"step {i}")
    active = np.array([False, True, True, True, True, False])
    carry = (jnp.asarray(prev0), jnp.asarray(lmap0), jnp.float32(100.0))
    carry, _ = jtracker.vft_scan_carry(carry, jnp.asarray(frames),
                                       jnp.asarray(active), params=p)
    # the scan keeps prev = prev0 over the inactive step 0; the frame-parallel
    # form sees the frames the scan would, so its frame 0 is prev0 again
    seen = frames.copy()
    seen[0] = prev0
    got = ttracker.motion_map(torch.from_numpy(prev0), torch.from_numpy(seen),
                              torch.from_numpy(lmap0),
                              torch.from_numpy(active), alpha, 1).numpy()
    np.testing.assert_array_equal(_bits(got[-1]), _bits(carry[1]))
    np.testing.assert_array_equal(got[0], lmap0)       # inactive: identity
    np.testing.assert_array_equal(got[-1], got[-2])
    assert scan_cuda.LAUNCHES["motion_map"] == 0       # CPU: no launch counted


def test_lmap_ema_rejects_bad_inputs():
    """:func:`motion_map` refuses mismatched shapes, an even or too large
    ksize and frames no larger than the blur's radius (reflect-101 needs a
    pixel beyond it), before it computes anything."""
    fr = torch.zeros((3, 4, 5))
    p0, l0 = torch.zeros((4, 5)), torch.zeros((4, 5))
    act = torch.ones(3).bool()
    with pytest.raises(ValueError):
        ttracker.motion_map(p0, fr, torch.zeros((4, 4)), act, 0.9, 1)
    with pytest.raises(ValueError):
        ttracker.motion_map(p0, fr, l0, torch.ones(2).bool(), 0.9, 1)
    with pytest.raises(ValueError):
        ttracker.motion_map(p0, fr[0], l0, act, 0.9, 1)
    with pytest.raises(ValueError):
        ttracker.motion_map(p0, fr, l0, act, 0.9, 4)
    with pytest.raises(ValueError):
        ttracker.motion_map(p0, fr, l0, act, 0.9, 33)
    with pytest.raises(ValueError):                     # h = 4 <= r = 6
        ttracker.motion_map(p0, fr, l0, act, 0.9, 13)
    with pytest.raises(ValueError):                     # w = 5 <= r = 5
        ttracker.motion_map(torch.zeros((12, 5)), torch.zeros((3, 12, 5)),
                            torch.zeros((12, 5)), act, 0.9, 11)
    ttracker.motion_map(torch.zeros((12, 6)), torch.zeros((3, 12, 6)),
                        torch.zeros((12, 6)), act, 0.9, 11)   # w = r + 1


def _map_case(t=8, h=48, w=40, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w)).astype(np.float32),
            rng.integers(0, 256, (t, h, w)).astype(np.float32),
            rng.uniform(0, 40, (h, w)).astype(np.float32))


def test_motion_map_matches_the_jax_sequential_carries_at_ksize_13():
    """The served ksize over 8 steps of 48x40 integer-valued frames, against
    the JAX package's sequential scan carried frame by frame: every map
    bit-equal (the blur and the recurrence both rounded as the compiled
    reference rounds them)."""
    prev0, frames, lmap0 = _map_case()
    p = jtracker.VFTParams()
    got = ttracker.motion_map(torch.from_numpy(prev0),
                              torch.from_numpy(frames),
                              torch.from_numpy(lmap0),
                              torch.ones(8, dtype=torch.bool), p.alpha,
                              p.gaussian_ksize).numpy()
    carry = (jnp.asarray(prev0), jnp.asarray(lmap0), jnp.float32(100.0))
    for i in range(frames.shape[0]):
        carry, _ = jtracker.vft_scan_carry(carry, jnp.asarray(frames[i:i + 1]),
                                           params=p)
        np.testing.assert_array_equal(_bits(got[i]), _bits(np.asarray(carry[1])),
                                      err_msg=f"step {i}")


def test_motion_map_t1_calls_chain_bit_equal_to_one_call():
    """T = 1 calls chained through the carry (the sequential trackers) equal
    one call over T (the frame-parallel tracker) bit for bit, inactive steps
    included: the contract the kernel's chunks and rounds keep."""
    prev0, frames, lmap0 = _map_case(t=7, h=20, w=17, seed=8)
    active = torch.tensor([True, False, True, True, True, True, False])
    fr = torch.from_numpy(frames)
    whole = ttracker.motion_map(torch.from_numpy(prev0), fr,
                                torch.from_numpy(lmap0), active, 0.98, 13)
    prev, lm = torch.from_numpy(prev0), torch.from_numpy(lmap0)
    for i in range(fr.shape[0]):
        lm = ttracker.motion_map(prev, fr[i:i + 1], lm, active[i:i + 1],
                                 0.98, 13)[0]
        prev = fr[i]
        np.testing.assert_array_equal(_bits(lm.numpy()),
                                      _bits(whole[i].numpy()),
                                      err_msg=f"step {i}")


# ── the trackers on 12 size-locked crops ────────────────────────────────────

def _crops():
    """14 crops (2 init + 12) of a synthetic video around the glottis, boxes
    jittered in position and size, resized to the first box's size by the
    reference: (14, 80, 48) integer-valued float32."""
    if "crops" not in _MEMO:
        gray = synthetic_video(t=14, size=256, seed=5)[0][..., 0]
        rng = np.random.default_rng(2)
        j = rng.integers(-2, 3, (14, 4))
        boxes = np.array([104, 88, 152, 168]) + j
        boxes[0] = (104, 88, 152, 168)
        _MEMO["crops"] = np.asarray(jpipe._gather_crops(
            jnp.asarray(gray), jnp.asarray(boxes.astype(np.int32)), 80, 48))
    return _MEMO["crops"]


def _jax_vft(kind):
    if kind not in _MEMO:
        c = jnp.asarray(_crops())
        active = jnp.arange(14) >= 2
        fn = jtracker.vft_parallel if kind == "parallel" else jtracker.vft_scan
        m, a = fn(c[:2], c, active, params=jtracker.VFTParams())
        _MEMO[kind] = (np.asarray(m), np.asarray(a))
    return _MEMO[kind]


def _torch_vft(kind):
    key = "t" + kind
    if key not in _MEMO:
        c = torch.from_numpy(_crops())
        active = torch.arange(14) >= 2
        fn = ttracker.vft_parallel if kind == "parallel" else ttracker.vft_scan
        m, a = fn(c[:2], c, active)
        _MEMO[key] = (m.numpy(), a.numpy())
    return _MEMO[key]


def test_vft_initialize_matches_jax():
    """prev is a copy; the motion map is a blur, bit-equal; the threshold is
    a percentile of integer pixels inside the map's largest blob."""
    c = _crops()
    jp, jl, jt = jtracker.vft_initialize(jnp.asarray(c[:2]),
                                         jtracker.VFTParams())
    tp, tl, tt = ttracker.vft_initialize(torch.from_numpy(c[:2].copy()),
                                         ttracker.VFTParams())
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(_bits(tl.numpy()), _bits(np.asarray(jl)))
    assert float(tt) == float(jt)


@pytest.mark.parametrize("kind", ["parallel", "scan"])
def test_vft_tracker_matches_jax(kind):
    """Areas are pixel counts, so atol 0.5 is equality of every frame's
    count (the pin the reference holds between its own two forms); the masks
    are then compared too and the differing frames counted.  The maps
    differ, in the parallel form, by the reference's reassociated prefix; a
    frame could differ only if a map value sat within that noise of the ROI
    cut."""
    jm, ja = _jax_vft(kind)
    tm, ta = _torch_vft(kind)
    assert ja[2:].min() > 0 and (ja[:2] == 0).all()
    np.testing.assert_allclose(ta, ja, atol=0.5, rtol=0)
    differing = [i for i in range(14) if (tm[i] != jm[i]).any()]
    assert not differing, f"masks differ on frames {differing}"


def test_vft_scan_equals_vft_parallel_in_the_port():
    """Both forms of the port take the same pinned recurrences; they differ
    only in batched vs single-frame blur, which here changes no pixel."""
    (pm, pa), (sm, sa) = _torch_vft("parallel"), _torch_vft("scan")
    np.testing.assert_array_equal(pa, sa)
    np.testing.assert_array_equal(pm, sm)


def test_vft_scan_carry_chains_bit_identically():
    """Two chained segments == one scan (the carry is the whole state)."""
    c = torch.from_numpy(_crops())
    p = ttracker.VFTParams()
    carry = ttracker.vft_initialize(c[:2], p)
    whole, (_, a) = ttracker.vft_scan_carry(carry, c[2:8], params=p)
    mid, (_, a1) = ttracker.vft_scan_carry(carry, c[2:5], params=p)
    end, (_, a2) = ttracker.vft_scan_carry(mid, c[5:8], params=p)
    np.testing.assert_array_equal(torch.cat([a1, a2]).numpy(), a.numpy())
    for x, y in zip(whole, end):
        np.testing.assert_array_equal(_bits(x.numpy()), _bits(y.numpy()))


def _guided_case():
    """A 96x96 cut of the video around the glottis with gated-box-like ROIs;
    frame 5 has no box."""
    gray = synthetic_video(t=12, size=256, seed=5)[0][:, 80:176, 80:176, 0]
    rng = np.random.default_rng(4)
    boxes = (np.array([24, 8, 72, 88]) + rng.integers(-2, 3, (12, 4))
             ).astype(np.int32)
    valid = np.ones(12, bool)
    valid[5] = False
    return gray.astype(np.float32), valid, boxes


@pytest.mark.parametrize("kind", ["parallel", "scan"])
def test_ygvft_tracker_matches_jax(kind):
    """Guided tracker, both forms: the ROI is the box, so every stage is an
    integer one but the threshold chain, which is pinned: exact."""
    g, valid, boxes = _guided_case()
    jfn = jtracker.ygvft_parallel if kind == "parallel" else jtracker.ygvft_scan
    tfn = ttracker.ygvft_parallel if kind == "parallel" else ttracker.ygvft_scan
    jm, ja = jfn(jnp.asarray(g[:2]), jnp.asarray(True), jnp.asarray(boxes[0]),
                 jnp.asarray(g[2:]), jnp.asarray(valid[2:]),
                 jnp.asarray(boxes[2:]))
    tm, ta = tfn(torch.from_numpy(g[:2]), torch.tensor(True),
                 torch.from_numpy(boxes[0]), torch.from_numpy(g[2:]),
                 torch.from_numpy(valid[2:]), torch.from_numpy(boxes[2:]))
    ja = np.asarray(ja)
    assert ja[3] == 0 and (np.delete(ja, 3) > 0).all()
    np.testing.assert_array_equal(ta.numpy(), ja)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_ygvft_scan_carry_keeps_the_motion_map():
    """The guided tracker's carry holds the motion map although its output
    never reads it; the reference's carry agrees bit for bit."""
    g, valid, boxes = _guided_case()
    p = jtracker.YGVFTParams()
    jc = jtracker.ygvft_initialize(jnp.asarray(g[:2]), jnp.asarray(True),
                                   jnp.asarray(boxes[0]), p)
    jc, _ = jtracker.ygvft_scan_carry(jc, jnp.asarray(g[2:6]),
                                      jnp.asarray(valid[2:6]),
                                      jnp.asarray(boxes[2:6]), params=p)
    tc = ttracker.ygvft_initialize(torch.from_numpy(g[:2]), torch.tensor(True),
                                   torch.from_numpy(boxes[0]),
                                   ttracker.YGVFTParams())
    tc, _ = ttracker.ygvft_scan_carry(tc, torch.from_numpy(g[2:6]),
                                      torch.from_numpy(valid[2:6]),
                                      torch.from_numpy(boxes[2:6]))
    np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jc[0]))
    np.testing.assert_array_equal(_bits(tc[1].numpy()), _bits(jc[1]))
    assert _bits(tc[2].numpy()) == _bits(jc[2])
