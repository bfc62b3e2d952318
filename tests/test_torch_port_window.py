"""The windowed U-Net decoder of pipeline 3, port vs JAX package on the CPU.

Module level (3 frames of 256², the folded demo U-Net, float32): the split
forward composes back to ``UNet.forward`` bit for bit; the windowed forms
(``mid_window``, ``tail_from_ymw``, ``tail_window_chunk``, ``tail_window``)
match the port's own full-frame tail at every window pixel (atol 2e-5, the
pin of tests/test_unet_window.py) and the JAX package's functions on the same
weights and inputs (atol 1e-4); the window origins equal the JAX package's
exactly; the in-box count's plain version equals the JAX package's count
exactly.

Pipeline level (6 frames of a realistic synthetic video with the demo
weights, float32): the windowed route engages (``ok``) and its areas lie
within 2.0 px per frame of the port's full-frame route and of the JAX
package's windowed chunk functions; random weights with ``conf=0`` make
boxes that do not fit, and the redo is bit-identical to the full-frame
route.  The JAX side runs its chunk functions on exactly these frames, not
the whole-video entry, which pads every video to 128 frames, and jitted with
the weights as arguments, so that a warm compilation cache serves it.
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
from openglottal_tpu.models import unet as junet
from openglottal_tpu.models.gate import gate_scan as jgate_scan
from openglottal_tpu_torch import pipelines as P
from openglottal_tpu_torch.models import unet as tunet
from openglottal_tpu_torch.ops.areas_cuda import box_count, box_count_plain
from openglottal_tpu_torch.pipelines import GlottalPipelines
from openglottal_tpu_torch.utils.convert import unet_state_dict_from_jax
from openglottal_tpu_torch.utils.io import load_weights_npz

WIN_TOL = dict(rtol=0, atol=2e-5)   # windowed vs the port's full-frame tail
JAX_TOL = dict(rtol=0, atol=1e-4)   # port vs JAX package
_MEMO = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes side by side; PyTorch's
    intra-op thread pool in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ── module level ────────────────────────────────────────────────────────────

def _nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@functools.lru_cache(maxsize=None)
def _jax_fns():
    """The JAX package's functions under ``jax.jit``, weights and origins
    as arguments (one compilation each, cached across processes)."""
    f32 = jnp.float32
    return {
        "fold_unet": jax.jit(jfold.fold_unet),
        "fold_yolo": jax.jit(jfold.fold_yolo),
        "split": jax.jit(lambda v, x: _jax_split(v, x)),
        "mid_tail": jax.jit(lambda v, d3, s2, s1, oy, ox: (
            lambda ymw: (ymw, junet._tail_from_ymw(v, ymw, s1, oy, ox, f32,
                                                   160)))(
            junet.unet_mid_window(v, d3, s2, oy, ox, f32, 160))),
        "tail_chunk": jax.jit(lambda v, ym, s1, oy, ox:
                              junet.unet_tail_window_chunk(v, ym, s1, oy, ox,
                                                           f32, 160)),
        "tail_frames": jax.jit(lambda v, ym, s1, oy, ox:
                               junet.unet_tail_window(v, ym, s1, oy, ox,
                                                      f32)),
        "chunk_origin": jax.jit(junet.chunk_window_origin,
                                static_argnums=(2, 3, 4),
                                static_argnames=("lattice", "margin")),
        "origins": jax.jit(junet.window_origins, static_argnums=(2, 3, 4)),
        "summary": jax.jit(lambda v, g: jpipe._yolo_summary_chunk_fn(
            v, 256, 256, 0.25, f32, True)(g)),
        "gate": jax.jit(lambda has, raw: jgate_scan(has, raw, 256, 256)),
        "windowed": jax.jit(lambda v, g, valid, boxes:
                            jpipe._unet_windowed_areas_chunk_fn(
                                v, 256, 256, f32, True, 160)(g, valid,
                                                              boxes)),
    }


def _jax_split(v, x):
    d3, s2, s1 = junet.unet_apply_to_d3(v, x, jnp.float32, True)
    ym = junet.unet_mid_full(v, d3, s2, jnp.float32, True)
    return d3, s2, s1, ym, junet.unet_tail_full(v, ym, s1, jnp.float32, True)


@pytest.fixture(scope="module")
def parts():
    """The folded demo U-Net in both packages and the split forward of 3
    frames through each: {"jv", "tm", "x", "j": JAX parts (NHWC), "t": port
    parts (NCHW)}."""
    jv = _jax_fns()["fold_unet"](load_weights_npz("weights/demo_unet.npz"))
    tm = tunet.UNet(fuse_bn=True).eval()
    tm.load_state_dict(unet_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jv)), strict=True)
    x = np.random.default_rng(3).random((3, 256, 256, 1)).astype(np.float32)
    d3, s2, s1, ym, full = _jax_fns()["split"](jv, jnp.asarray(x))
    with torch.no_grad():
        td3, ts2, ts1 = tm.apply_to_d3(_nchw(x))
        tym = tm.mid_full(td3, ts2)
        tfull = tm.tail_full(tym, ts1)
    return {"jv": jv, "tm": tm, "x": x,
            "j": {"d3": d3, "s2": s2, "s1": s1, "ym": ym, "full": full},
            "t": {"d3": td3, "s2": ts2, "s1": ts1, "ym": tym,
                  "full": tfull}}


def test_split_composition_is_bit_equal_to_forward(parts):
    tm, t = parts["tm"], parts["t"]
    with torch.no_grad():
        want = tm(_nchw(parts["x"]))
        ym, s1 = tm.apply_to_mid(_nchw(parts["x"]))
    assert t["d3"].shape == (3, 128, 64, 64) and t["s2"].shape == (3, 64, 128,
                                                                   128)
    assert torch.equal(t["full"].float(), want)
    assert torch.equal(ym, t["ym"]) and torch.equal(s1, t["s1"])
    # and the port's full forward is the JAX package's within the networks'
    # tolerance (measured 1.1e-6)
    np.testing.assert_allclose(_nhwc(want), np.asarray(parts["j"]["full"]),
                               **JAX_TOL)


@pytest.mark.parametrize("origin", [(66, 38), (6, 6), (90, 90), (6, 90)])
def test_mid_window_and_tail_match_full_and_jax(parts, origin):
    """Both decoder levels windowed, as served (origins as 0-d tensors): the
    mid window equals the full y_mid's (win/2+2)² slice and the logits the
    full tail's window.  Measured (mid window / logits): 0 / 0 against the
    port's full-frame forms, 5.2e-6 / 1.1e-6 against the JAX package."""
    oy, ox = origin
    tm, t, j = parts["tm"], parts["t"], parts["j"]
    with torch.no_grad():
        ymw = tm.mid_window(t["d3"], t["s2"], torch.tensor(oy),
                            torch.tensor(ox), 160)
        logits = tm.tail_from_ymw(ymw, t["s1"], torch.tensor(oy),
                                  torch.tensor(ox), 160)
    assert ymw.shape == (3, 64, 82, 82) and logits.shape == (3, 1, 160, 160)
    np.testing.assert_allclose(
        ymw.numpy(), t["ym"][:, :, oy // 2 - 1:oy // 2 + 81,
                             ox // 2 - 1:ox // 2 + 81].numpy(), **WIN_TOL)
    np.testing.assert_allclose(
        logits.numpy(), t["full"][:, :, oy:oy + 160, ox:ox + 160].numpy(),
        **WIN_TOL)
    jymw, jlog = _jax_fns()["mid_tail"](parts["jv"], j["d3"], j["s2"],
                                        j["s1"], jnp.int32(oy), jnp.int32(ox))
    np.testing.assert_allclose(_nhwc(ymw), np.asarray(jymw), **JAX_TOL)
    np.testing.assert_allclose(_nhwc(logits), np.asarray(jlog), **JAX_TOL)


@pytest.mark.parametrize("origin", [(64, 38), (2, 2), (94, 94), (2, 94)])
def test_tail_window_chunk_matches_full_and_jax(parts, origin):
    """One interior window for the chunk (measured 0 against the port's
    full tail, 1.1e-6 against the JAX package)."""
    oy, ox = origin
    tm, t, j = parts["tm"], parts["t"], parts["j"]
    with torch.no_grad():
        got = tm.tail_window_chunk(t["ym"], t["s1"], torch.tensor(oy),
                                   torch.tensor(ox), 160)
    np.testing.assert_allclose(
        got.numpy(), t["full"][:, :, oy:oy + 160, ox:ox + 160].numpy(),
        **WIN_TOL)
    want = _jax_fns()["tail_chunk"](parts["jv"], j["ym"], j["s1"],
                                    jnp.int32(oy), jnp.int32(ox))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **JAX_TOL)


@pytest.mark.parametrize("oys,oxs", [([0, 64, 128], [128, 2, 66]),
                                     ([0, 0, 0], [0, 0, 0]),
                                     ([128, 128, 128], [0, 128, 64])])
def test_tail_window_per_frame_matches_full_and_jax(parts, oys, oxs):
    """A window per frame anywhere in the frame, corners and edges included
    (the zero-halo emulation): measured 0 against the port's full tail,
    1.1e-6 against the JAX package."""
    tm, t, j = parts["tm"], parts["t"], parts["j"]
    with torch.no_grad():
        got = tm.tail_window(t["ym"], t["s1"], torch.tensor(oys),
                             torch.tensor(oxs), 128)
    for i, (y, x) in enumerate(zip(oys, oxs)):
        np.testing.assert_allclose(
            got[i].numpy(), t["full"][i, :, y:y + 128, x:x + 128].numpy(),
            **WIN_TOL)
    want = _jax_fns()["tail_frames"](parts["jv"], j["ym"], j["s1"],
                                     jnp.asarray(oys, jnp.int32),
                                     jnp.asarray(oxs, jnp.int32))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **JAX_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels", [32, 3])
def test_window_cut_equals_the_slice(dtype, channels):
    """Windows cut at device origins (one for all frames, one per frame)
    equal the slices at those offsets, from channels_last tensors (gathered
    as 8-byte words where a pixel's channels fill them: 32 channels) and
    from NCHW ones (single values), and come out channels_last."""
    x = torch.from_numpy(np.random.default_rng(9).normal(
        0, 1, (3, channels, 20, 24)).astype(np.float32)).to(dtype)
    for t in (x, x.contiguous(memory_format=torch.channels_last)):
        got = tunet._cut(t, torch.tensor(4), torch.tensor(6), 10, 12)
        assert torch.equal(got, t[:, :, 4:14, 6:18])
        assert got.is_contiguous(memory_format=torch.channels_last)
        got = tunet._cut(t, torch.tensor([4, 0, 10]), torch.tensor([6, 12, 0]),
                         10, 12)
        for i, (r, c) in enumerate(((4, 6), (0, 12), (10, 0))):
            assert torch.equal(got[i], t[i, :, r:r + 10, c:c + 12])


def _origin_cases(n_pad=64):
    """(boxes (N, 4) int32, valid (N,) bool) cases: no valid frame, border
    boxes, oversize boxes, boxes that move across the chunk, random.  Each
    is padded to ``n_pad`` frames with invalid frames (which take no part in
    a window's choice; one compilation serves every case); the first N are
    the case's."""
    rng = np.random.default_rng(11)
    cases = [
        (np.array([[60, 80, 140, 170]]), np.array([True])),
        (np.array([[40, 60, 100, 120], [50, 70, 110, 130],
                   [200, 200, 250, 250]]), np.array([True, True, False])),
        (np.array([[10, 10, 90, 90], [20, 30, 80, 70]]),
         np.array([False, False])),                          # none valid
        (np.array([[0, 0, 100, 100], [2, 3, 90, 80]]),
         np.array([True, True])),                            # at the border
        (np.array([[156, 150, 256, 256]]), np.array([True])),
        (np.array([[5, 40, 200, 150]]), np.array([True])),    # oversize
        (np.array([[10, 10, 170, 60]]), np.array([True])),    # 160 wide
        (np.stack([np.array([30 + 2 * k, 40 + k, 110 + 2 * k, 120 + k])
                   for k in range(60)]), np.ones(60, bool)),  # moving
        (np.stack([np.array([20 + 3 * k, 50, 90 + 3 * k, 130])
                   for k in range(40)]), np.ones(40, bool)),  # moves too far
    ]
    for _ in range(40):
        n = int(rng.integers(1, 9))
        xy = rng.integers(-10, 250, (n, 2))
        wh = rng.integers(0, 170, (n, 2))
        cases.append((np.concatenate([xy, xy + wh], 1),
                      rng.random(n) < 0.8))
    out = []
    for b, v in cases:
        pad = n_pad - len(v)
        junk = rng.integers(0, 256, (pad, 4))
        out.append((np.concatenate([b, junk]).astype(np.int32),
                    np.concatenate([v, np.zeros(pad, bool)]), len(v)))
    return out


@pytest.mark.parametrize("lattice,margin", [(4, 6), (2, 2)])
def test_chunk_window_origin_equals_jax(lattice, margin):
    for boxes, valid, _ in _origin_cases():
        want = _jax_fns()["chunk_origin"](jnp.asarray(boxes),
                                          jnp.asarray(valid), 256, 256, 160,
                                          lattice=lattice, margin=margin)
        got = tunet.chunk_window_origin(torch.from_numpy(boxes),
                                        torch.from_numpy(valid), 256, 256,
                                        160, lattice=lattice, margin=margin)
        assert all(g.dim() == 0 for g in got)
        assert [bool(got[0]), int(got[1]), int(got[2])] == [
            bool(want[0]), int(want[1]), int(want[2])], (boxes, valid)


def test_window_origins_equals_jax():
    for boxes, valid, n in _origin_cases():
        b, v = boxes[:n], valid[:n]
        for win in (128, 160):
            want = _jax_fns()["origins"](jnp.asarray(boxes),
                                         jnp.asarray(valid), 256, 256, win)
            got = tunet.window_origins(torch.from_numpy(boxes),
                                       torch.from_numpy(valid), 256, 256, win)
            assert bool(got[0]) == bool(want[0])
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
            np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
            # the case alone: fits as the padded case (padding is invalid)
            alone = tunet.window_origins(torch.from_numpy(b),
                                         torch.from_numpy(v), 256, 256, win)
            assert bool(alone[0]) == bool(want[0])


def _jax_window_count(logits, valid, boxes, oy, ox, win):
    """The count of openglottal_tpu/pipelines.py
    _unet_windowed_areas_chunk_fn, as written there."""
    m = logits > 0
    rows = oy + jnp.arange(win)
    cols = ox + jnp.arange(win)
    rm = (rows[None] >= boxes[:, 1:2]) & (rows[None] < boxes[:, 3:4])
    cm = (cols[None] >= boxes[:, 0:1]) & (cols[None] < boxes[:, 2:3])
    area = (m & rm[:, :, None] & cm[:, None, :]).sum((1, 2))
    return jnp.where(valid, area.astype(jnp.float32), 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_box_count_plain_equals_the_jax_count(dtype):
    """Boxes inside, across and outside the window, at its edges, empty and
    invalid; windowed (origin as 0-d tensors and as ints) and whole-frame
    (``_box_area_sums`` of ``logits > 0``)."""
    rng = np.random.default_rng(5)
    n = 24
    logits = rng.normal(0, 1, (n, 160, 160)).astype(np.float32)
    logits[:, ::7] = 0.0                      # exactly at the threshold
    xy = rng.integers(-40, 250, (n, 2))
    boxes = np.concatenate([xy, xy + rng.integers(0, 200, (n, 2))], 1)
    boxes[0] = [30, 50, 190, 210]             # the window exactly
    boxes[1] = [31, 51, 189, 209]             # one pixel inside each edge
    boxes[2] = [0, 0, 30, 50]                 # ends at the window's origin
    boxes[3] = [100, 100, 100, 140]           # empty
    boxes = boxes.astype(np.int32)
    valid = rng.random(n) < 0.8
    x = torch.from_numpy(logits).to(dtype)
    xf = x.float().numpy()                    # the values the count sees
    v, b = torch.from_numpy(valid), torch.from_numpy(boxes)
    want = np.asarray(_jax_window_count(jnp.asarray(xf), jnp.asarray(valid),
                                        jnp.asarray(boxes), 50, 30, 160))
    for oy, ox in ((torch.tensor(50), torch.tensor(30)), (50, 30)):
        got = box_count(x, 0.0, v, b, oy, ox)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    want_full = np.asarray(jpipe._box_area_sums(
        jnp.asarray(xf > 0), jnp.asarray(valid), jnp.asarray(boxes)))
    np.testing.assert_array_equal(box_count_plain(x, 0.0, v, b).numpy(),
                                  want_full)


# ── pipeline level ──────────────────────────────────────────────────────────

def _video(t=6, seed=7):
    key = ("video", t, seed)
    if key not in _MEMO:
        frames, _ = jax_synthetic_video(t=t, size=256, seed=seed,
                                        realistic=True)
        _MEMO[key] = np.ascontiguousarray(frames[..., 0])
    return _MEMO[key]


def _trees():
    if "trees" not in _MEMO:
        _MEMO["trees"] = {k: load_weights_npz(f"weights/demo_{k}.npz")
                          for k in ("unet", "yolo")}
    return _MEMO["trees"]


def _demo(window=None):
    key = ("demo", window)
    if key not in _MEMO:
        t = _trees()
        _MEMO[key] = GlottalPipelines(
            unet_variables=t["unet"], yolo_variables=t["yolo"],
            dtype=torch.float32, window_decoder=window, device="cpu")
    return _MEMO[key]


def _windowed():
    """The default pipelines on the 6 frames: (pending handle, resolved
    areas)."""
    if "windowed" not in _MEMO:
        gp = _demo()
        pending = gp.yolo_unet_areas_deferred(_video())
        _MEMO["windowed"] = (pending, gp.yolo_unet_areas_resolve(pending))
    return _MEMO["windowed"]


def _full():
    """window_decoder=False on the 6 frames: areas on the host."""
    if "full" not in _MEMO:
        _MEMO["full"] = _demo(False).yolo_unet_areas(_video()).numpy()
    return _MEMO["full"]


def _jax_windowed(gray):
    """The JAX package's windowed pass on these frames: detection summaries,
    gate, then the windowed U-Net chunk function -> (areas, fits)."""
    f = _jax_fns()
    t = _trees()
    yv, uv = f["fold_yolo"](t["yolo"]), f["fold_unet"](t["unet"])
    g = jnp.asarray(gray)
    valid, boxes = f["gate"](*f["summary"](yv, g))
    areas, fits = f["windowed"](uv, g, valid, boxes)
    return np.asarray(areas), bool(fits)


def test_windowed_route_engages_and_matches_full_and_jax():
    """6 frames (not a multiple of 128): ``ok``, and per-frame areas within
    2.0 px of the port's full-frame route and of the JAX package's windowed
    chunk functions (measured 0 and 0)."""
    gp = _demo()
    assert gp.window_decoder and gp._windowed(None, gp._to_gray(_video()))
    pending, got = _windowed()
    assert pending[1] is not None and bool(pending[1])
    assert _full().max() > 0
    assert np.abs(got - _full()).max() <= 2.0
    want, fits = _jax_windowed(_video())
    assert fits
    assert np.abs(got - want).max() <= 2.0


def test_extract_features_takes_the_windowed_route(monkeypatch):
    gp = _demo()
    calls = []
    real = gp._window_areas
    monkeypatch.setattr(gp, "_window_areas",
                        lambda *a: calls.append(1) or real(*a))
    feats = gp.extract_features(_video(), "unet")
    assert calls == [1]
    np.testing.assert_array_equal(feats["_area"], _windowed()[1])


def test_windowed_route_carries_the_gate_across_chunks(monkeypatch):
    """Chunks of 4 frames (4 + 2): the gate carried from chunk to chunk
    gives the whole video's gate, each chunk fits its own window, and the
    areas stay within 2.0 px of the full-frame route."""
    gp = _demo()
    gray = gp._to_gray(_video())
    monkeypatch.setattr(P, "CHUNK", 4)
    areas, ok, valid, boxes, _ = gp._unet_gated(None, gray, True)
    monkeypatch.undo()
    v1, b1 = gp._gated(None, gray)
    assert bool(ok)
    assert torch.equal(valid, v1) and torch.equal(boxes, b1)
    assert np.abs(areas.numpy() - _full()).max() <= 2.0


def test_deferred_then_resolve_round_trip():
    """resolve reads the deferred handle's areas and flag; the full-frame
    route's handle has no flag."""
    gp = _demo()
    pending, got = _windowed()
    areas, ok, frames_dev, gray = pending
    assert frames_dev is None and torch.equal(gray, gp._to_gray(_video()))
    assert ok.dim() == 0 and ok.dtype == torch.bool
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_array_equal(got, areas.numpy())
    gf = _demo(False)
    pf = gf.yolo_unet_areas_gray_deferred(_video())
    assert pf[1] is None
    np.testing.assert_array_equal(gf.yolo_unet_areas_resolve(pf), _full())


def _random_tree(tree, seed):
    """A weight tree of ``tree``'s structure and shapes with random values
    from numpy: kernels N(0, 1/fan_in), BatchNorm scales and variances in
    [0.5, 1.5), everything else N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def walk(t, path=()):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
            elif k == "kernel":
                fan_in = int(np.prod(v.shape[:-1]))
                out[k] = rng.normal(0, fan_in ** -0.5, v.shape
                                    ).astype(np.float32)
            elif k in ("scale", "var"):
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        return out

    return walk(tree)


def test_random_weights_do_not_fit_and_the_redo_is_the_full_route(
        monkeypatch):
    """The port's counterpart of test_fallback_bit_identical_to_unwindowed:
    random weights and conf=0 give boxes that do not fit the window; ``ok``
    is False and the result is bit-identical to window_decoder=False, by
    resolve and by yolo_unet_areas."""
    uv = _random_tree(_trees()["unet"], 0)
    yv = _random_tree(_trees()["yolo"], 1)
    gray = _video(t=4, seed=4)
    mk = lambda w: GlottalPipelines(unet_variables=uv, yolo_variables=yv,
                                    conf=0.0, dtype=torch.float32,
                                    window_decoder=w, device="cpu")
    pw, pf = mk(None), mk(False)
    assert pw.window_decoder and not pf.window_decoder
    pending = pw.yolo_unet_areas_deferred(gray)
    assert not bool(pending[1])
    want = pf.yolo_unet_areas(gray).numpy()
    np.testing.assert_array_equal(pw.yolo_unet_areas_resolve(pending), want)
    # yolo_unet_areas redoes the same way (its speculative pass reused)
    monkeypatch.setattr(pw, "yolo_unet_areas_deferred", lambda f: pending)
    np.testing.assert_array_equal(pw.yolo_unet_areas(gray).numpy(), want)


def test_window_decoder_option_follows_the_jax_rule():
    """``True`` no longer raises; ``None`` turns the window on only with
    folded weights and both models; colour input and other sizes keep the
    full-frame route; the window needs folded weights."""
    t = _trees()
    w = dict(unet_variables=t["unet"], yolo_variables=t["yolo"],
             device="cpu")
    assert GlottalPipelines(window_decoder=True, **w).window_decoder
    assert not GlottalPipelines(fold_bn=False, **w).window_decoder
    assert not GlottalPipelines(unet_variables=t["unet"],
                                device="cpu").window_decoder
    with pytest.raises(ValueError):
        GlottalPipelines(window_decoder=True, fold_bn=False, **w)
    gp = _demo()
    colour = torch.zeros((2, 256, 256, 3), dtype=torch.uint8)
    assert not gp._windowed(colour, gp._to_gray(colour))
    assert not gp._windowed(None, torch.zeros((2, 240, 320),
                                              dtype=torch.uint8))
