"""Port vs JAX package on the CPU: the nearest half of ``ops/resize.py``,
the letterboxes (static and per frame), the BGR -> gray conversion and the
stateless per-frame gate.  All of them move or pick values, or compute on
integers, so every comparison here is exact.

Inputs are made with numpy from a seed and go through both packages; the
port runs on CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglottal_tpu.data import video as jvideo
from openglottal_tpu.models import gate as jgate
from openglottal_tpu.ops import resize as jresize
from openglottal_tpu_torch.data import video as tvideo
from openglottal_tpu_torch.data.synthetic import gate_stress_sequence
from openglottal_tpu_torch.models import gate as tgate
from openglottal_tpu_torch.ops import resize as tresize


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


# ── nearest ─────────────────────────────────────────────────────────────────

@pytest.mark.parametrize("in_size,out_size", [(120, 154), (154, 120),
                                              (256, 200), (33, 97), (7, 3)])
def test_nearest_matrix_static_exact(in_size, out_size):
    """Static geometry: cv2's double-rounded scale 1 / (out / in) in float64
    on both sides.  120 -> 154 maps i = 77 to 59 (the exact rational floor
    would give 60)."""
    got = tresize._nearest_matrix(in_size, out_size).numpy()
    want = np.asarray(jresize._nearest_matrix(in_size, out_size))
    np.testing.assert_array_equal(got, want)
    if (in_size, out_size) == (120, 154):
        assert got[77].argmax() == 59


def test_nearest_matrix_per_frame_and_resize_exact():
    """Per-frame windows (float32 geometry) as the reference traces them,
    and a whole-image nearest resize with the 120 -> 154 pin."""
    rng = np.random.default_rng(4)
    start = rng.integers(0, 60, 40).astype(np.float32)
    length = rng.integers(1, 40, 40).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda s, l: jresize._nearest_matrix(100, 37, s, l)))(
            jnp.asarray(start), jnp.asarray(length)))
    got = tresize._nearest_matrix(100, 37, torch.from_numpy(start),
                                  torch.from_numpy(length)).numpy()
    np.testing.assert_array_equal(got, want)
    img = rng.integers(0, 256, (2, 120, 154)).astype(np.float32)
    want = np.asarray(jresize.resize_nearest(jnp.asarray(img), 154, 120))
    got = tresize.resize_nearest(torch.from_numpy(img), 154, 120).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


# ── letterbox ───────────────────────────────────────────────────────────────

@pytest.mark.parametrize("h,w", [(300, 200), (200, 240), (120, 154)])
def test_letterbox_and_unletterbox_exact(h, w):
    """Both methods bit-equal on integer-valued frames (the linear one with
    both passes fused, the reference's compiled form for a letterbox); the
    window matrices equal entry by entry; the nearest unletterbox of the
    letterboxed frames equal too."""
    rng = np.random.default_rng(h + w)
    img = rng.integers(0, 256, (3, h, w)).astype(np.float32)
    geo = jresize.letterbox_info(h, w, 256)
    assert tresize.letterbox_info(h, w, 256) == geo
    pt, pl, ch, cw = geo
    for method in ("linear", "nearest"):
        want = np.asarray(jresize.letterbox(jnp.asarray(img), 256,
                                            method=method))
        got = tresize.letterbox(torch.from_numpy(img), 256, method).numpy()
        assert got.shape == (3, 256, 256)
        np.testing.assert_array_equal(_bits(got), _bits(want),
                                      err_msg=method)
        for n, pad, c in ((h, pt, ch), (w, pl, cw)):
            np.testing.assert_array_equal(
                tresize._window_matrix(n, 256, pad, c, method).numpy(),
                np.asarray(jresize._window_matrix(n, 256, pad, c, method)))
        back = tresize.unletterbox(torch.from_numpy(got), *geo, h, w).numpy()
        np.testing.assert_array_equal(
            _bits(back), _bits(jresize.unletterbox(jnp.asarray(want), *geo,
                                                   h, w)))
    np.testing.assert_array_equal(
        tresize.apply_letterbox(torch.from_numpy(img), 256).numpy(),
        tresize.letterbox(torch.from_numpy(img), 256, "nearest").numpy())


def _crop_boxes(n, rng, h, w):
    """Random crops (y1, ch, x1, cw) with 0- and 1-pixel sides, crops at
    the frame's edges and past them, and the whole frame."""
    y1, x1 = rng.integers(-3, h, n), rng.integers(-3, w, n)
    ch, cw = rng.integers(0, h + 5, n), rng.integers(0, w + 5, n)
    ch[:8], cw[8:16] = 0, 1
    ch[16:20], cw[20:24] = 1, 0
    y1[24:28], x1[24:28], ch[24:28], cw[24:28] = 0, 0, h, w
    y1[28:32], ch[28:32] = h - 2, 9           # past the bottom edge
    return [a.astype(np.int32) for a in (y1, ch, x1, cw)]


def test_round_half_even_div_and_dyn_geometry_exact():
    """Banker's rounding on integers (Python's round) and the per-frame
    letterbox geometry, sides clamped to >= 1."""
    n = torch.arange(0, 2000, dtype=torch.int32)
    for d in (1, 2, 3, 8, 13, 256):
        got = tresize._round_half_even_div(n, torch.tensor(d)).tolist()
        assert got == [round(v / d) for v in range(2000)], d
    y1, ch, x1, cw = _crop_boxes(200, np.random.default_rng(1), 240, 320)
    want = jresize.dyn_letterbox_geometry(jnp.asarray(ch), jnp.asarray(cw))
    got = tresize.dyn_letterbox_geometry(torch.from_numpy(ch),
                                         torch.from_numpy(cw))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


@pytest.mark.parametrize("axis", ["rows", "cols"])
def test_dyn_letterbox_index_maps_equal_the_dense_matrices(axis):
    """The per-frame index maps against the reference's dense (256, n) and
    (n, 256) matrices: the zero rows are the rows outside the content (or
    outside the crop), and every other row has its one 1 at the map's
    index."""
    h, w = 240, 320
    y1, ch, x1, cw = _crop_boxes(96, np.random.default_rng(2), h, w)
    start, clen, n = (y1, ch, h) if axis == "rows" else (x1, cw, w)
    geo = jresize.dyn_letterbox_geometry(jnp.asarray(ch), jnp.asarray(cw))
    pad, content = (geo[0], geo[2]) if axis == "rows" else (geo[1], geo[3])
    args = (jnp.asarray(start), jnp.asarray(clen), pad, content)
    targs = [torch.from_numpy(np.array(a)) for a in args]
    for dense_fn, index_fn in (
            (jresize.dyn_letterbox_matrix_nearest,
             tresize.dyn_letterbox_index_nearest),
            (jresize.dyn_unletterbox_matrix_nearest,
             tresize.dyn_unletterbox_index_nearest)):
        dense = np.asarray(jax.vmap(
            lambda s, l, p, c: dense_fn(n, 256, s, l, p, c))(*args))
        idx, ok = index_fn(n, 256, *targs)
        idx, ok = idx.numpy(), ok.numpy()
        np.testing.assert_array_equal(dense.sum(-1), ok.astype(np.float32))
        np.testing.assert_array_equal(dense.argmax(-1)[ok], idx[ok])


# ── colour conversion ───────────────────────────────────────────────────────

def test_bgr_to_gray_u8_exact():
    """cv2's fixed-point BT.601 as the JAX package computes it, on tensors
    and on host arrays (random colours, and every value of two channels
    against a sweep of the third)."""
    rng = np.random.default_rng(0)
    v = np.arange(256, dtype=np.uint8)
    bgr = np.concatenate([
        rng.integers(0, 256, (4, 64, 64, 3)).astype(np.uint8),
        np.stack(np.meshgrid(v, v, v[::37], indexing="ij"), -1)
        .reshape(4, -1, 64, 3)], 1)
    want = np.asarray(jvideo.bgr_to_gray_u8(jnp.asarray(bgr)))
    got = tvideo.bgr_to_gray_u8(torch.from_numpy(bgr))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tvideo.bgr_to_gray_u8(bgr), want)


# ── the stateless gate ──────────────────────────────────────────────────────

@pytest.mark.parametrize("frame_hw,params", [
    ((256, 256), tgate.GateParams()), ((240, 320), tgate.GateParams(30.0, 7, 3)),
    ((200, 240), tgate.GateParams(1e6, 3, 0))])
def test_gate_single_matches_jax(frame_hw, params):
    """The per-frame gate on the stress sequence (boxes outside and larger
    than the frame, odd padding, missing detections with stray boxes) equal
    to the JAX package's vmap of gate_step from gate_init."""
    h_np, b_np, _ = gate_stress_sequence(400, seed=frame_hw[0],
                                         frame_h=frame_hw[0],
                                         frame_w=frame_hw[1])
    jv, jb = jgate.gate_single(jnp.asarray(h_np), jnp.asarray(b_np),
                               *frame_hw, params=jgate.GateParams(*params))
    tv, tb = tgate.gate_single(torch.from_numpy(h_np), torch.from_numpy(b_np),
                               *frame_hw, params)
    assert tb.dtype == torch.int32 and tv.dtype == torch.bool
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
