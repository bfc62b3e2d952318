"""Port vs JAX package on the CPU: the plain versions of the blob kernels and
the blob-filter functions built on them.

Inputs are made with numpy from a seed and go through both packages.  The
port runs on ``device="cpu"`` tensors, where each kernel wrapper takes its
plain PyTorch version; the JAX side runs the non-TPU branch of
``ops/blobs.py`` (the Pallas kernels cannot run on the CPU).  All
comparisons are exact: the outputs are integer labels and bool masks, and the
label convention (component id = min flat index) makes them unique.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglottal_tpu.ops import blobs as jblobs
from openglottal_tpu_torch.data.synthetic import blob_stress_masks
from openglottal_tpu_torch.ops import blobs as tblobs
from openglottal_tpu_torch.ops import blobs_cuda

SHAPES = [(64, 128), (40, 52)]   # the second is ragged (no tile multiple)
_CACHE = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes side by side; PyTorch's
    intra-op thread pool in each of them oversubscribes the cores and makes
    the many small tensor ops here an order of magnitude slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _masks(hw):
    """Stress masks, cut to 6 (resp. 3) frames groups to keep the JAX compile
    count low: all 14 frames in one stack per shape."""
    if hw not in _CACHE:
        _CACHE[hw] = blob_stress_masks(*hw, seed=13)
    return _CACHE[hw]


def _jax_cc(masks, conn):
    key = ("cc", masks.shape, conn, masks.tobytes())
    if key not in _CACHE:
        _CACHE[key] = np.asarray(
            jblobs._propagate_batch(jnp.asarray(masks), 4096, conn))
    return _CACHE[key]


def _jax_top_n_batch(masks, n):
    key = ("topn", masks.shape, n, masks.tobytes())
    if key not in _CACHE:
        _CACHE[key] = np.asarray(
            jblobs.top_n_blobs_batch(jnp.asarray(masks), n))
    return _CACHE[key]


@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("hw", SHAPES)
def test_cc_plain_matches_jax(hw, conn):
    masks = _masks(hw)
    got = blobs_cuda.cc_plain(torch.from_numpy(masks), conn).numpy()
    np.testing.assert_array_equal(got, _jax_cc(masks, conn))


@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("hw", SHAPES)
def test_min_prop_matches_jax(hw, conn):
    masks = _masks(hw)
    t, h, w = masks.shape
    rng = np.random.default_rng(7)
    init = rng.integers(0, h * w + 1, (t, h, w)).astype(np.int32)
    got = blobs_cuda.min_prop_batch(torch.from_numpy(masks),
                                    torch.from_numpy(init), conn).numpy()
    want = np.asarray(jblobs._min_prop_batch(
        jnp.asarray(masks), jnp.asarray(init), conn, 4096))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", SHAPES)
def test_dual_cc_equals_two_singles_and_jax(hw):
    masks = _masks(hw)
    code = np.where(masks, 1, 2).astype(np.uint8)
    got = blobs_cuda.dual_cc_batch(torch.from_numpy(code)).numpy()
    labF, labB = _jax_cc(masks, 8), _jax_cc(~masks, 4)
    np.testing.assert_array_equal(got, np.where(masks, labF, labB))


@pytest.mark.parametrize("hw", SHAPES)
def test_dual_cc_inactive_code(hw):
    """code 0 pixels are walls for both regions and read H*W."""
    masks = _masks(hw)
    rng = np.random.default_rng(3)
    code = rng.integers(0, 3, masks.shape).astype(np.uint8)
    got = blobs_cuda.dual_cc_batch(torch.from_numpy(code)).numpy()
    lab8, lab4 = _jax_cc(code == 1, 8), _jax_cc(code == 2, 4)
    want = np.where(code == 1, lab8, np.where(code == 2, lab4, masks[0].size))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", SHAPES)
def test_dual_min_prop_equals_two_singles_and_jax(hw):
    masks = _masks(hw)
    t, h, w = masks.shape
    rng = np.random.default_rng(11)
    init = rng.integers(0, h * w, (t, h, w)).astype(np.int32)
    code = np.where(masks, 1, 2).astype(np.uint8)
    got = blobs_cuda.dual_min_prop_batch(torch.from_numpy(code),
                                         torch.from_numpy(init)).numpy()
    pf = np.asarray(jblobs._min_prop_batch(jnp.asarray(masks),
                                           jnp.asarray(init), 8, 4096))
    pb = np.asarray(jblobs._min_prop_batch(jnp.asarray(~masks),
                                           jnp.asarray(init), 4, 4096))
    np.testing.assert_array_equal(got, np.where(masks, pf, pb))


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("hw", SHAPES)
def test_top_n_blobs_batch_matches_jax(hw, n):
    masks = _masks(hw)
    got = tblobs.top_n_blobs_batch(torch.from_numpy(masks), n).numpy()
    np.testing.assert_array_equal(got, _jax_top_n_batch(masks, n))


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("hw", SHAPES)
def test_top_n_blobs_batch_split_route_matches_jax(hw, n):
    """The route through two single-region CC passes and two single-region
    broadcasts gives the dual route's (and the reference's) masks exactly."""
    masks = _masks(hw)
    got = tblobs.top_n_blobs_batch(torch.from_numpy(masks), n,
                                   _split=True).numpy()
    np.testing.assert_array_equal(got, _jax_top_n_batch(masks, n))


@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("hw", SHAPES)
def test_cc_batch_and_propagate_batch_match_jax(hw, conn):
    """Spirals, serpentines, noise, an empty and a full frame: exact."""
    masks = _masks(hw)
    want = _jax_cc(masks, conn)
    got = blobs_cuda.cc_batch(torch.from_numpy(masks), conn).numpy()
    np.testing.assert_array_equal(got, want)
    got = tblobs._propagate_batch(torch.from_numpy(masks), conn).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("conn", [4, 8])
def test_connected_components_single_frame_matches_jax(conn):
    """Every stress frame on its own through the single-frame wrapper and
    through the reference's single-frame function: exact, and equal to the
    frame's labels in the batch."""
    masks = _masks(SHAPES[1])
    batch = _jax_cc(masks, conn)
    for i, m in enumerate(masks):
        got = tblobs.connected_components(torch.from_numpy(m), conn).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, batch[i], err_msg=f"frame {i}")
        if i in (0, 6, 7, 12, 13):   # noise, spiral, serpentine, empty, full
            want = np.asarray(jblobs.connected_components(
                jnp.asarray(m), 4096, conn))
            np.testing.assert_array_equal(got, want, err_msg=f"frame {i}")


def test_fill_holes_matches_jax():
    masks = _masks(SHAPES[1])
    for i, m in enumerate(masks):
        got = tblobs.fill_holes(torch.from_numpy(m)).numpy()
        want = np.asarray(jblobs.fill_holes(jnp.asarray(m)))
        np.testing.assert_array_equal(got, want, err_msg=f"frame {i}")


def _nested_frames():
    """Rings inside rings, a pocket enclosed by two blobs, equal-size ties."""
    m = np.zeros((4, 64, 128), bool)
    m[0, 4:60, 4:60] = True
    m[0, 10:54, 10:54] = False
    m[0, 16:48, 16:48] = True
    m[0, 22:42, 22:42] = False
    m[0, 28:36, 28:36] = True
    m[0, 10:30, 80:100] = True          # rival blob
    m[1, 5:25, 5:25] = True             # two equal blobs: smaller label wins
    m[1, 5:25, 60:80] = True
    m[1, 40:50, 40:50] = True
    m[2, 10:40, 10:20] = True           # pocket jointly enclosed by two comps
    m[2, 10:40, 30:40] = True
    m[2, 10:12, 20:30] = True
    m[2, 38:40, 21:30] = True
    m[3, 30:40, 90:100] = True          # three equal blobs, the lowest label
    m[3, 8:18, 40:50] = True            # is not the first in scan order of
    m[3, 8:18, 100:110] = True          # columns; n = 2 keeps the top two
    return m


@pytest.mark.parametrize("n", [1, 2])
def test_top_n_blobs_single_frame_matches_jax(n):
    """Single-frame table form vs the reference's, incl. nesting and
    equal-size ties (the smaller label wins), and vs the batch form."""
    frames = list(_nested_frames()) + list(_masks((64, 128))[[0, 3, 6, 12]])
    frames = np.stack(frames)
    batch = tblobs.top_n_blobs_batch(torch.from_numpy(frames), n).numpy()
    for i, m in enumerate(frames):
        got = tblobs.top_n_blobs(torch.from_numpy(m), n).numpy()
        want = np.asarray(jblobs.top_n_blobs(jnp.asarray(m), n))
        np.testing.assert_array_equal(got, want, err_msg=f"frame {i}")
        np.testing.assert_array_equal(got, batch[i], err_msg=f"frame {i}")
    if n == 1:
        got = tblobs.largest_blob(torch.from_numpy(frames[1])).numpy()
        assert got.sum() == 400 and got[5:25, 5:25].all()
        np.testing.assert_array_equal(
            got, np.asarray(jblobs.largest_blob(jnp.asarray(frames[1]))))


def test_top_n_blobs_ragged_shape_matches_jax():
    """A shape that is no tile multiple (the reference pads it, the port
    does not): same masks."""
    for m in _masks(SHAPES[1])[[1, 4, 8]]:
        got = tblobs.top_n_blobs(torch.from_numpy(m), 2).numpy()
        want = np.asarray(jblobs.top_n_blobs(jnp.asarray(m), 2))
        np.testing.assert_array_equal(got, want)


def test_top_n_blobs_nested_holes_match_jax():
    """Rings inside rings, a pocket enclosed by two blobs, equal-size ties."""
    m = _nested_frames()
    for n in (1, 2):
        got = tblobs.top_n_blobs_batch(torch.from_numpy(m), n).numpy()
        want = np.asarray(jblobs.top_n_blobs_batch(jnp.asarray(m), n))
        np.testing.assert_array_equal(got, want, err_msg=f"n={n}")


def _roi_case(fit: bool):
    rng = np.random.default_rng(5)
    t, h, w = 4, 160, 192
    boxes = np.zeros((t, 4), np.int32)
    masks = np.zeros((t, h, w), bool)
    for i in range(t):
        bw, bh = (40 + 10 * i, 60 + 5 * i) if fit else (130 + i, 90)
        x0 = int(rng.integers(0, w - bw))
        y0 = int(rng.integers(0, h - bh))
        boxes[i] = (x0, y0, x0 + bw, y0 + bh)
        masks[i, y0:y0 + bh, x0:x0 + bw] = rng.random((bh, bw)) < 0.6
    return masks, boxes


@pytest.mark.parametrize("fit", [True, False])
def test_top_n_blobs_batch_roi_matches_jax(fit):
    masks, boxes = _roi_case(fit)
    fits, _, _ = tblobs.roi_window_origin(torch.from_numpy(boxes), 160, 192,
                                          128)
    assert bool(fits) == fit
    got = tblobs.top_n_blobs_batch_roi(torch.from_numpy(masks),
                                       torch.from_numpy(boxes), 2).numpy()
    want = np.asarray(jblobs.top_n_blobs_batch_roi(
        jnp.asarray(masks), jnp.asarray(boxes), 2))
    np.testing.assert_array_equal(got, want)
    # and the windowed pass equals the full-frame pass inside the port
    full = tblobs.top_n_blobs_batch(torch.from_numpy(masks), 2).numpy()
    np.testing.assert_array_equal(got, full)


def test_huge_blob_not_dropped():
    """A blob above 32767 px on a 256x256 frame must still rank first (a
    packed int32 ranking key would overflow there)."""
    h = w = 256
    masks = np.zeros((2, h, w), bool)
    masks[0, 8:248, 8:248] = True
    masks[1, 0:200, 0:250] = True
    masks[1, 230:240, 10:30] = True
    got = tblobs.largest_blob_batch(torch.from_numpy(masks)).numpy()
    assert got[0].sum() == 240 * 240
    np.testing.assert_array_equal(got[0], masks[0])
    assert got[1].sum() == 200 * 250


@pytest.mark.parametrize("fn,args", [
    ("dual_cc_batch", ("code32",)),
    ("dual_min_prop_batch", ("code", "init64")),
    ("min_prop_batch", ("region2d", "init")),
    ("cc_batch", ("region2d",)),
    ("cc_batch", ("code32",)),
    ("cc", ("code",)),
    ("cc", ("init",)),
])
def test_wrappers_reject_bad_inputs(fn, args):
    t = {"code": torch.ones((2, 8, 8), dtype=torch.uint8),
         "code32": torch.ones((2, 8, 8), dtype=torch.int32),
         "init": torch.zeros((2, 8, 8), dtype=torch.int32),
         "init64": torch.zeros((2, 8, 8), dtype=torch.int64),
         "region2d": torch.ones((8, 8), dtype=torch.bool)}
    with pytest.raises((TypeError, ValueError)):
        getattr(blobs_cuda, fn)(*(t[a] for a in args))


def test_cpu_tensors_do_not_count_as_launches():
    blobs_cuda.reset_launch_counts()
    blobs_cuda.dual_cc_batch(torch.ones((1, 8, 8), dtype=torch.uint8))
    blobs_cuda.cc_batch(torch.ones((1, 8, 8), dtype=torch.bool))
    blobs_cuda.cc(torch.ones((8, 8), dtype=torch.bool))
    assert blobs_cuda.LAUNCHES == {"dual_cc_batch": 0,
                                   "dual_min_prop_batch": 0,
                                   "min_prop_batch": 0,
                                   "cc_batch": 0, "cc": 0}


@pytest.mark.parametrize("fn", ["cc_batch", "cc", "min_prop_batch"])
def test_bad_connectivity_is_value_error(fn):
    x = torch.ones((2, 8, 8), dtype=torch.bool)
    args = {"cc_batch": (x, 6), "cc": (x[0], 6),
            "min_prop_batch": (x, torch.zeros((2, 8, 8), dtype=torch.int32),
                               6)}[fn]
    with pytest.raises(ValueError):
        getattr(blobs_cuda, fn)(*args)
