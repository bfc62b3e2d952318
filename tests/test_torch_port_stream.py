"""Streaming serving of the port on the CPU (float32, the demo weights, at
full width), its video reader, prefetch, config, command line and the
frame-at-a-time API, against the port's own whole-video calls and against
the JAX package.

Exact: the streamed waveforms of all five pipelines against the port's
whole-video calls on 23 gray 256² frames in three splits, and on colour
chunks (``unet`` on its full-frame route, the trackers in their sequential
forms); the tracker streams against the JAX package's chained
``gate_scan_carry`` and ``vft_scan_carry`` / ``ygvft_scan_carry``; the
frame-at-a-time trackers, detector and gate against the JAX ``compat``
classes.  Within the borderline pixel count (in-box pixels whose JAX logit
lies within 1e-3 of 0): the streamed ``unet`` against the JAX U-Net.

The networks are memoised by the bytes of their input (``_Memo``): a
stream must feed them exactly the slices the whole-video call fed them
(every one of its calls a hit), which is what makes its values the whole
call's on the card, where cuDNN chooses its algorithms per shape.
"""

import hashlib
import json
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglottal_tpu import compat as jcompat
from openglottal_tpu import pipelines as jpipe
from openglottal_tpu.config import Config as JConfig
from openglottal_tpu.models import fold as jfold
from openglottal_tpu.models.gate import TemporalGate as JTemporalGate
from openglottal_tpu.models.gate import gate_init as jgate_init
from openglottal_tpu.models.gate import gate_scan_carry as jgate_scan_carry
from openglottal_tpu.models.tracker import VFTParams as JVFTParams
from openglottal_tpu.models.tracker import YGVFTParams as JYGVFTParams
from openglottal_tpu.models.tracker import vft_scan_carry as jvft_scan_carry
from openglottal_tpu.models.tracker import (
    ygvft_scan_carry as jygvft_scan_carry,
)
from openglottal_tpu.models.unet import UNet as JUNet
from openglottal_tpu_torch import cli, compat, config
from openglottal_tpu_torch.data.prefetch import prefetch_to_device
from openglottal_tpu_torch.data.synthetic import synthetic_video
from openglottal_tpu_torch.data.video import iter_frames_bgr, load_frames_bgr
from openglottal_tpu_torch.models.gate import TemporalGate
from openglottal_tpu_torch.pipelines import (
    VFT_INIT,
    YGVFT_INIT,
    GlottalPipelines,
    _box_area_sums,
)
from openglottal_tpu_torch.utils.io import load_weights_npz

T = 23
SPLITS = ([9, 8, 6], [1, 1, 21], [23])
PIPELINES = ("unet", "unet-only", "crop-unet", "vft", "guided-vft")
WEIGHTS = dict(unet_variables="weights/demo_unet.npz",
               crop_unet_variables="weights/demo_unet.npz",
               yolo_variables="weights/demo_yolo.npz")
_MEMO = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes side by side; PyTorch's
    intra-op thread pool in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _memo(key, make):
    if key not in _MEMO:
        _MEMO[key] = make()
    return _MEMO[key]


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    return type(out)(_clone(o) for o in out)


class _Memo:
    """A network call memoised by the bytes, shape and dtype of its input;
    ``keys`` lists the inputs of the calls since the last ``reset``."""

    def __init__(self, fn):
        self.fn, self.out, self.keys = fn, {}, []

    def reset(self):
        self.keys = []

    def __call__(self, x):
        key = (tuple(x.shape), str(x.dtype), hashlib.sha1(
            x.contiguous().numpy().tobytes()).hexdigest())
        self.keys.append(key)
        if key not in self.out:
            self.out[key] = self.fn(x)
        return _clone(self.out[key])


def _pipe():
    """The port: f32, the CPU, sequential trackers, ``unet`` on its
    full-frame route, its three networks memoised."""
    def make():
        gp = GlottalPipelines(dtype=torch.float32, device="cpu",
                              parallel_trackers=False, window_decoder=False,
                              **WEIGHTS)
        gp.unet.logits = _Memo(gp.unet.logits)
        gp.crop_unet.forward = _Memo(gp.crop_unet.forward)
        gp.yolo.forward = _Memo(gp.yolo.forward)
        return gp
    return _memo("gp", make)


def _nets(gp):
    return (gp.unet.logits, gp.crop_unet.forward, gp.yolo.forward)


def _video():
    """23 gray 256² frames as three equal channels (they cross as one)."""
    return _memo("video", lambda: synthetic_video(t=T, size=256, seed=9)[0])


def _tint(frames):
    f = frames.astype(np.int16)
    f[..., 0] = f[..., 0] * 7 // 8
    f[..., 2] = np.minimum(f[..., 2] + 12, 255)
    return f.astype(np.uint8)


def _colour():
    """6 colour 256² frames (their three channels unequal)."""
    return _memo("colour", lambda: _tint(synthetic_video(t=6, size=256,
                                                         seed=5)[0]))


def _chunked(video, sizes):
    i = 0
    for n in sizes:
        yield video[i:i + n]
        i += n
    assert i == len(video)


def _whole(pipeline, video):
    """The port's whole-video waveform and the network inputs it took."""
    def make():
        gp = _pipe()
        for m in _nets(gp):
            m.reset()
        if pipeline == "unet":
            a = gp.yolo_unet_areas(video).numpy()
        elif pipeline == "unet-only":
            a = gp.unet_only_areas(video).numpy()
        elif pipeline == "crop-unet":
            a = _box_area_sums(*gp.crop_unet_masks(video)).numpy()
        elif pipeline == "vft":
            a = gp.vft_areas(video)
        else:
            a = gp.guided_vft_areas(video)
        return a, [list(m.keys) for m in _nets(gp)]
    key = hashlib.sha1(np.ascontiguousarray(video).tobytes()).hexdigest()
    return _memo(("whole", pipeline, key), make)


def _stream(pipeline, video, splits, prefetch=2):
    gp = _pipe()
    for m in _nets(gp):
        m.reset()
    a = gp.stream_areas(_chunked(video, splits), pipeline, prefetch=prefetch)
    return a, [list(m.keys) for m in _nets(gp)]


# ── stream == whole video, exact ────────────────────────────────────────────

@pytest.mark.parametrize("splits", SPLITS, ids=lambda s: "-".join(map(str, s)))
@pytest.mark.parametrize("pipeline", PIPELINES)
def test_stream_equals_whole_video(pipeline, splits):
    """The streamed waveform equals the whole-video call's bit for bit, and
    the stream ran its networks on exactly the whole call's slices."""
    want, want_keys = _whole(pipeline, _video())
    got, keys = _stream(pipeline, _video(), splits)
    assert got.dtype == np.float32 and got.shape == (T,)
    assert (want > 0).sum() >= T // 2
    np.testing.assert_array_equal(got, want)
    assert keys == want_keys


@pytest.mark.parametrize("pipeline", ["unet", "crop-unet", "guided-vft"])
def test_colour_stream_equals_whole_video(pipeline):
    """Colour chunks detect on their BGR frames and segment on gray."""
    want, want_keys = _whole(pipeline, _colour())
    got, keys = _stream(pipeline, _colour(), [2, 3, 1])
    assert (want > 0).sum() >= 3
    np.testing.assert_array_equal(got, want)
    assert keys == want_keys


def test_stream_without_prefetch_and_mixed_chunks():
    """``prefetch=0`` gives the same waveform; a gray chunk followed by
    colour ones joins them in one slice, as three equal channels."""
    want, _ = _whole("guided-vft", _video())
    got, _ = _stream("guided-vft", _video(), [9, 8, 6], prefetch=0)
    np.testing.assert_array_equal(got, want)
    gp = _pipe()
    col = _colour()
    mixed = iter([np.ascontiguousarray(col[:2, ..., 1]), col[2:]])
    got = gp.stream_areas(mixed, "guided-vft")
    ref = col.copy()
    ref[:2] = col[:2, ..., 1:2]
    np.testing.assert_array_equal(got, _whole("guided-vft", ref)[0])


def test_stream_features_and_contracts():
    gp = _pipe()
    feats = gp.stream_features(_chunked(_video(), [9, 8, 6]), "vft")
    np.testing.assert_array_equal(feats["_area"], _whole("vft", _video())[0])
    assert gp.stream_areas(iter([]), "unet").size == 0
    assert gp.stream_features(iter([]), "unet") is None
    assert gp.stream_areas(iter([]), "vft").size == 0
    assert gp.stream_areas(iter([np.zeros((0, 256, 256), np.uint8)]),
                           "guided-vft").size == 0
    with pytest.raises(ValueError):
        gp.stream_areas(iter([]), "nope")
    for bad in (np.zeros((4, 128, 128, 3), np.uint8),
                np.zeros((4, 256, 200), np.uint8)):
        for pipeline in ("unet", "vft"):
            with pytest.raises(ValueError, match="256"):
                gp.stream_areas(iter([bad]), pipeline)
    with pytest.raises(ValueError):
        GlottalPipelines(device="cpu", yolo_variables=WEIGHTS[
            "yolo_variables"]).stream_areas(iter([]), "unet")


# ── the port against the JAX package ────────────────────────────────────────

def _jyolo():
    return _memo("jyolo", lambda: jfold.fold_yolo(
        load_weights_npz("weights/demo_yolo.npz")))


def _jax_gate_chained(video, splits):
    """The JAX detector on the frames, then ``gate_scan_carry`` chained over
    the split -> (valid, boxes) as numpy."""
    def make():
        if video.shape[-1] == 3 and not (video[..., 0] == video[..., 1]).all():
            has, raw, _ = jpipe._yolo_chunk(_jyolo(), jnp.asarray(video),
                                            conf=0.25, dtype=jnp.float32,
                                            fuse=True)
        else:
            has, raw, _ = jpipe._yolo_chunk_gray(
                _jyolo(), jnp.asarray(video[..., 0]), conf=0.25,
                dtype=jnp.float32, fuse=True)
        state, vs, bs, i = jgate_init(), [], [], 0
        for n in splits:
            state, (v, b) = jgate_scan_carry(state, has[i:i + n],
                                             raw[i:i + n], 256, 256)
            vs.append(np.asarray(v))
            bs.append(np.asarray(b))
            i += n
        return np.concatenate(vs), np.concatenate(bs)
    key = hashlib.sha1(np.ascontiguousarray(video).tobytes()).hexdigest()
    return _memo(("jgate", key, tuple(splits)), make)


def _pad(x, n):
    return np.concatenate([x, np.zeros((n - len(x),) + x.shape[1:], x.dtype)])


def _jax_vft_chained(video, splits):
    """The JAX package's vft stream composed from its pieces: the crop size
    locked at the first gated box, the first VFT_INIT crops seeding the
    carry, ``vft_scan_carry`` chained over each segment's crops (padded to
    32, the padding inactive)."""
    valid, boxes = _jax_gate_chained(video, splits)
    gray = video[..., 0]
    idx = np.nonzero(valid)[0]
    b0 = boxes[idx[0]]
    h0, w0 = int(b0[3] - b0[1]), int(b0[2] - b0[0])
    areas = np.zeros(len(video), np.float32)
    carry, init, i = None, [], 0
    for n in splits:
        seg = idx[(idx >= i) & (idx < i + n)]
        i += n
        if not len(seg):
            continue
        crops = np.asarray(jpipe._gather_crops(
            jnp.asarray(gray[seg]), jnp.asarray(boxes[seg]), h0, w0))
        k = 0
        if carry is None:
            k = min(VFT_INIT - len(init), len(seg))
            init += list(crops[:k])
            if len(init) == VFT_INIT:
                carry = jpipe._vft_init_jit(jnp.asarray(np.stack(init)),
                                            p=JVFTParams())
        if carry is not None and k < len(seg):
            m = len(seg) - k
            carry, (_, a) = jvft_scan_carry(
                carry, jnp.asarray(_pad(crops[k:], 32)),
                jnp.asarray(np.arange(32) < m), params=JVFTParams())
            areas[seg[k:]] = np.asarray(a)[:m]
    return areas


def _jax_ygvft_chained(video, splits):
    """The JAX package's guided-vft stream composed from its pieces: the
    first YGVFT_INIT frames seed the carry, ``ygvft_scan_carry`` chained
    over each segment's remaining frames (padded to 32)."""
    valid, boxes = _jax_gate_chained(video, splits)
    gray = video[..., 0].astype(np.float32)
    fi = int(np.argmax(valid[:YGVFT_INIT]))
    carry = jpipe._ygvft_init_jit(
        jnp.asarray(gray[:YGVFT_INIT]),
        jnp.asarray(bool(valid[:YGVFT_INIT].any())),
        jnp.asarray(boxes[fi]), p=JYGVFTParams())
    areas = np.zeros(len(video), np.float32)
    i = 0
    for n in splits:
        a_, b_ = max(i, YGVFT_INIT), i + n
        i += n
        if a_ >= b_:
            continue
        m = b_ - a_
        carry, (_, a) = jygvft_scan_carry(
            carry, jnp.asarray(_pad(gray[a_:b_], 32)),
            jnp.asarray(_pad(valid[a_:b_], 32)),
            jnp.asarray(_pad(boxes[a_:b_], 32)),
            jnp.asarray(np.arange(32) < m), params=JYGVFTParams())
        areas[a_:b_] = np.asarray(a)[:m]
    return areas


@pytest.mark.parametrize("pipeline", ["vft", "guided-vft"])
def test_tracker_stream_equals_jax_chained_carries(pipeline):
    """Split [1, 1, 21]: the seeds straddle the first two chunks.  The
    port's streamed waveform equals the JAX package's chained carries."""
    splits = [1, 1, 21]
    want = (_jax_vft_chained if pipeline == "vft"
            else _jax_ygvft_chained)(_video(), splits)
    got, _ = _stream(pipeline, _video(), splits)
    assert (want > 0).sum() >= T // 2
    np.testing.assert_array_equal(got, want)


def test_stream_gate_equals_jax_gate_scan_carry():
    """The port's gate carried across the chunks of a split (``GateCarry``,
    on the JAX detector's outputs) equals the JAX ``gate_scan_carry``
    chain."""
    from openglottal_tpu_torch.models.gate import GateCarry

    splits = [9, 8, 6]
    want_v, want_b = _jax_gate_chained(_video(), splits)
    has, raw, _ = jpipe._yolo_chunk_gray(
        _jyolo(), jnp.asarray(_video()[..., 0]), conf=0.25,
        dtype=jnp.float32, fuse=True)
    has, raw = torch.from_numpy(np.array(has)), torch.from_numpy(np.array(raw))
    gate = GateCarry(256, 256)
    out, i = [], 0
    for n in splits:
        out.append(gate(has[i:i + n], raw[i:i + n]))
        i += n
    np.testing.assert_array_equal(torch.cat([o[0] for o in out]).numpy(),
                                  want_v)
    np.testing.assert_array_equal(torch.cat([o[1] for o in out]).numpy(),
                                  want_b)


def test_colour_unet_stream_within_the_borderline_pixel_count():
    """Colour chunks [2, 3, 1] through ``unet``: per frame, the streamed
    areas differ from the JAX package's (its BGR detector, its gate chained,
    its U-Net on gray, the in-box count) by at most the in-box pixels whose
    JAX logit lies within 1e-3 of 0."""
    from openglottal_tpu.data.video import bgr_to_gray_u8 as jgray

    col = _colour()
    valid, boxes = _jax_gate_chained(col, [2, 3, 1])
    uv = jfold.absorb_u8_scale(
        jfold.fold_unet(load_weights_npz("weights/demo_unet.npz")),
        jfold.UNET_STEM)
    gray = np.asarray(jgray(col))
    logits = np.asarray(JUNet(dtype=jnp.float32, fuse_bn=True).apply(
        uv, jnp.asarray(gray, jnp.float32)[..., None], train=False))[..., 0]
    v, b = torch.from_numpy(valid), torch.from_numpy(boxes)
    want = _box_area_sums(torch.from_numpy(logits > 0), v, b).numpy()
    slack = _box_area_sums(torch.from_numpy(np.abs(logits) < 1e-3), v,
                           b).numpy()
    got, _ = _stream("unet", col, [2, 3, 1])
    assert want.max() > 0
    assert (np.abs(got - want) <= slack).all(), (got, want, slack)


# ── prefetch (the cases of tests/test_prefetch.py) ──────────────────────────

def test_prefetch_order_and_values():
    items = [np.full((16, 16), i, np.float32) for i in range(7)]
    out = list(prefetch_to_device(items, size=2))
    assert len(out) == 7
    for i, a in enumerate(out):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), items[i])


def test_prefetch_overlaps_ahead_of_consumer():
    """After the first item is taken, at least two more are made while the
    consumer stalls."""
    import time

    puts = []

    def put(x):
        puts.append(time.perf_counter())
        return x

    items = [np.zeros((8, 8), np.float32) for _ in range(4)]
    gen = prefetch_to_device(items, size=2, put=put)
    next(gen)
    time.sleep(0.2)
    assert len(puts) >= 3
    list(gen)


def test_prefetch_custom_put_and_exception():
    def boom(x):
        raise RuntimeError("decode failed")

    gen = prefetch_to_device([1, 2], put=boom)
    with pytest.raises(RuntimeError, match="decode failed"):
        next(gen)


def test_prefetch_abandoned_generator_retires_producer():
    import threading
    import time

    n_before = threading.active_count()
    items = [np.zeros((8, 8), np.float32) for _ in range(10)]
    gen = prefetch_to_device(items, size=1)
    next(gen)
    gen.close()
    deadline = time.time() + 5.0
    while threading.active_count() > n_before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= n_before, "producer thread leaked"


def test_prepare_prefetched_matches_prepare():
    gp = _pipe()
    vids = [_video()[:4], _colour()[:3], _video()[5:7, ..., 0]]
    got = list(gp.prepare_prefetched(vids, size=2))
    assert len(got) == 3
    for v, (fdev, gray) in zip(vids, got):
        f2, g2 = gp.prepare(v)
        assert torch.equal(gray, g2)
        assert (fdev is None) == (f2 is None)
        if fdev is not None:
            assert torch.equal(fdev, f2)


# ── the AVI reader ──────────────────────────────────────────────────────────

def _riff(cid: bytes, data: bytes) -> bytes:
    return cid + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)


def _list(kind: bytes, *parts: bytes) -> bytes:
    return _riff(b"LIST", kind + b"".join(parts))


def _write_dib(path, frames, bits=24, top_down=False, palette=None):
    """An uncompressed BI_RGB AVI written by hand: 24-bit BGR or 8-bit
    palettised, rows bottom up (or top down), each padded to 4 bytes; a
    JUNK chunk, a second (audio) stream list, and no idx1."""
    t, h, w = frames.shape[:3]
    stride = (w * bits // 8 + 3) // 4 * 4
    bih = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bits,
                      0, stride * h, 0, 0,
                      0 if palette is None else len(palette), 0)
    if palette is not None:
        bih += np.concatenate([palette, np.zeros((len(palette), 1), np.uint8)],
                              1).tobytes()
    strh = b"vids" + b"DIB " + b"\0" * 48
    avih = struct.pack("<10I", 250, 0, 0, 0, t, 0, 2, 0, w, h) + b"\0" * 16
    aud = _list(b"strl", _riff(b"strh", b"auds" + b"\0" * 52),
                _riff(b"strf", b"\0" * 18))
    chunks = []
    for f in frames:
        rows = f if top_down else f[::-1]
        raw = rows.reshape(h, -1)
        pad = np.zeros((h, stride - raw.shape[1]), np.uint8)
        chunks.append(_riff(b"00dc", np.concatenate([raw, pad], 1).tobytes()))
    chunks.append(_riff(b"01wb", b"\1\2\3"))      # audio, odd size
    body = (_list(b"hdrl", _riff(b"avih", avih),
                  _list(b"strl", _riff(b"strh", strh), _riff(b"strf", bih)),
                  aud)
            + _riff(b"JUNK", b"\0" * 27)
            + _list(b"movi", *chunks))
    with open(path, "wb") as f:
        f.write(_riff(b"RIFF", b"AVI " + body))


def _frames(t, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (t, h, w, 3),
                                                dtype=np.uint8)


def test_avi_y800_written_by_cv2_equals_cv2_decode(tmp_path):
    import cv2

    gray = _frames(23, 30, 42, 1)[..., 0]
    path = str(tmp_path / "v.avi")
    wr = cv2.VideoWriter(path, 0, 30, (42, 30), isColor=False)
    for f in gray:
        wr.write(f)
    wr.release()
    cap, want = cv2.VideoCapture(path), []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        want.append(f)
    cap.release()
    got = load_frames_bgr(path)
    np.testing.assert_array_equal(got, np.stack(want))
    np.testing.assert_array_equal(got[..., 2], gray)
    chunks = list(iter_frames_bgr(path, chunk=7))
    assert [len(c) for c in chunks] == [7, 7, 7, 2]
    np.testing.assert_array_equal(np.concatenate(chunks), got)


@pytest.mark.parametrize("layout", ["bottom_up", "top_down", "palette"])
def test_avi_bi_rgb_written_by_hand(tmp_path, layout):
    """A 10-pixel-wide frame pads its rows (30 -> 32 bytes, 10 -> 12)."""
    path = str(tmp_path / "d.avi")
    if layout == "palette":
        pal = _frames(1, 1, 256, 2)[0, 0]
        idx = _frames(5, 7, 10, 3)[..., 0]
        _write_dib(path, idx, bits=8, palette=pal)
        want = pal[idx]
    else:
        want = _frames(5, 7, 10, 4)
        _write_dib(path, want, top_down=layout == "top_down")
    np.testing.assert_array_equal(load_frames_bgr(path), want)
    chunks = list(iter_frames_bgr(path, chunk=2))
    assert [len(c) for c in chunks] == [2, 2, 1]
    if layout == "bottom_up":
        import cv2

        cap = cv2.VideoCapture(path)
        ok, f = cap.read()
        cap.release()
        if ok:      # cv2 as a second reader of the hand-written file
            np.testing.assert_array_equal(f, want[0])


def test_avi_other_codecs_raise_and_missing_files_are_empty(tmp_path):
    """A codec the reader does not decode (I420 here; MJPG is decoded,
    tests/test_torch_port_mjpg.py) raises naming its fourcc."""
    from openglottal_tpu_torch.tools.jpeg_stress import write_mjpg_avi

    path = str(tmp_path / "m.avi")
    write_mjpg_avi(path, [f.tobytes() for f in _frames(3, 24, 32, 5)], 32,
                   24, fourcc=b"I420")
    with pytest.raises(ValueError, match="I420"):
        load_frames_bgr(path)
    with pytest.raises(ValueError, match="I420"):
        list(iter_frames_bgr(path))
    assert load_frames_bgr(str(tmp_path / "none.avi")).shape == (0, 0, 0, 3)
    (tmp_path / "empty.avi").write_bytes(b"")
    assert load_frames_bgr(str(tmp_path / "empty.avi")).shape == (0, 0, 0, 3)
    assert list(iter_frames_bgr(str(tmp_path / "none.avi"))) == []
    (tmp_path / "x.mp4").write_bytes(b"\0\0\0\x18ftypmp42" + b"\0" * 20)
    with pytest.raises(ValueError, match="AVI"):
        load_frames_bgr(str(tmp_path / "x.mp4"))


# ── config (the cases of tests/test_config.py) ──────────────────────────────

def test_config_defaults_equal_the_jax_package():
    import dataclasses

    assert dataclasses.asdict(config.Config()) == dataclasses.asdict(
        JConfig())
    cfg, jcfg = config.Config(), JConfig()
    assert tuple(cfg.gate_params()) == tuple(jcfg.gate_params())
    assert tuple(cfg.vft_params()) == tuple(jcfg.vft_params())
    assert tuple(cfg.ygvft_params()) == tuple(jcfg.ygvft_params())
    assert type(cfg.vft_params()).__module__.startswith(
        "openglottal_tpu_torch")


def test_config_round_trip_overrides_unknown_keys(tmp_path):
    path = tmp_path / "cfg.yaml"
    config.save_default_yaml(path)
    assert config.load_config(path) == config.Config()
    js = tmp_path / "cfg.json"
    js.write_text(json.dumps({"detector": {"conf": 0.02},
                              "unet": {"features": [8, 16]}}))
    cfg = config.load_config(js, overrides={"training.unet.epochs": 5})
    assert cfg.detector.conf == 0.02 and cfg.unet.features == (8, 16)
    assert cfg.training.unet.epochs == 5 and cfg.vft.beta == 0.7
    with pytest.raises(KeyError):
        config.load_config(None, overrides={"detector.bogus": 1})
    js.write_text(json.dumps({"detector": {"bogus": 1}}))
    with pytest.raises(KeyError):
        config.load_config(js)


# ── the command line ────────────────────────────────────────────────────────

def _avi_of(tmp_path, video):
    import cv2

    path = str(tmp_path / "clip.avi")
    wr = cv2.VideoWriter(path, 0, 30, video.shape[1:3][::-1], isColor=False)
    for f in video[..., 0]:
        wr.write(f)
    wr.release()
    return path


def test_cli_run_stream_writes_the_features(tmp_path):
    """``run --stream 7 --device cpu`` (vft; bfloat16, the command's
    dtype) writes the features of ``extract_features`` on the decoded
    frames; so does ``run`` without ``--stream``."""
    avi = _avi_of(tmp_path, _video())
    frames = load_frames_bgr(avi)
    np.testing.assert_array_equal(frames, _video())
    gp = GlottalPipelines(yolo_variables=WEIGHTS["yolo_variables"],
                          device="cpu")
    want = gp.extract_features(frames, "vft")
    assert want is not None
    for extra, out in ((["--stream", "7"], "s"), ([], "w")):
        cli.main(["run", avi, "--pipeline", "vft", "--yolo-weights",
                  WEIGHTS["yolo_variables"], "--device", "cpu",
                  "-o", str(tmp_path / out)] + extra)
        got = json.loads((tmp_path / out / "features.json").read_text())
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k], np.float64),
                                          np.asarray(v, np.float64), k)


@pytest.mark.parametrize("argv,message", [
    (["--pipeline", "unet"], "--yolo-weights"),
    (["--pipeline", "unet-only"], "--unet-weights"),
    (["--pipeline", "crop-unet", "--yolo-weights", "y.npz"],
     "--crop-weights"),
    (["--pipeline", "vft", "--yolo-weights", "y.npz", "--qparams", "q.npz"],
     "int8"),
])
def test_cli_parser_errors(argv, message, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["run", "clip.avi", "--device", "cpu"] + argv)
    assert e.value.code == 2
    assert message in capsys.readouterr().err


# ── the frame-at-a-time API against the JAX package's compat ────────────────

def _gray12():
    return _memo("gray12", lambda: np.ascontiguousarray(_video()[:12, ..., 0]))


def test_vocal_fold_tracker_equals_jax_compat():
    gray = _gray12()
    ours, theirs = compat.VocalFoldTracker(device="cpu"), \
        jcompat.VocalFoldTracker()
    ours.initialize([gray[0], gray[1]])
    theirs.initialize([gray[0], gray[1]])
    assert ours.thresh == theirs.thresh
    for f in gray[2:]:
        a, b = ours.process_frame(f), theirs.process_frame(f)
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
        assert ours.thresh == theirs.thresh
    np.testing.assert_array_equal(ours.lmap, theirs.lmap)


def test_yolo_guided_vft_equals_jax_compat():
    gray = _gray12()
    _, boxes = _jax_gate_chained(_video(), [23])
    ours = compat.YOLOGuidedVFT(glottal_percentile=30, device="cpu")
    theirs = jcompat.YOLOGuidedVFT(glottal_percentile=30)
    ours.initialize([gray[0], gray[1]], tuple(boxes[0]))
    theirs.initialize([gray[0], gray[1]], tuple(boxes[0]))
    assert ours.thresh == theirs.thresh
    for t in range(2, 12):
        bb = None if t == 6 else tuple(boxes[t])
        a = ours.process_frame(gray[t], bb)
        np.testing.assert_array_equal(a, theirs.process_frame(gray[t], bb))
        assert ours.thresh == theirs.thresh
        if bb is None:
            assert not a.any()


def test_temporal_detector_and_gate_equal_jax_compat():
    """TemporalDetector.detect on 12 BGR frames (at their size, float32,
    BatchNorm unfolded) gives the JAX compat's boxes; TemporalGate equals
    the JAX one in both forms."""
    path = WEIGHTS["yolo_variables"]
    ours = compat.TemporalDetector(path, conf=0.25, device="cpu")
    theirs = jcompat.TemporalDetector(path, conf=0.25)
    assert ours.crop_size is None
    got = [ours.detect(f) for f in _video()[:12]]
    want = [theirs.detect(f) for f in _video()[:12]]
    assert got == want and all(b is not None for b in got)
    assert ours.crop_size == theirs.crop_size
    frame = _video()[0]
    np.testing.assert_array_equal(ours.crop(frame, got[0]),
                                  theirs.crop(frame, want[0]))
    assert ours.crop(frame, None) is frame
    ours.reset()
    assert ours.crop_size is None

    rng = np.random.default_rng(3)
    has = rng.random(40) < 0.7
    x1, y1 = rng.uniform(0, 200, 40), rng.uniform(0, 200, 40)
    raw = np.stack([x1, y1, x1 + rng.uniform(5, 60, 40),
                    y1 + rng.uniform(5, 60, 40)], -1).astype(np.float32)
    for seq in (True, False):
        v, b = TemporalGate(25.0, 6, 2)(torch.from_numpy(has),
                                        torch.from_numpy(raw), 256, 256, seq)
        jv, jb = JTemporalGate(25.0, 6, 2)(jnp.asarray(has), jnp.asarray(raw),
                                           256, 256, seq)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


def test_resize_to_against_cv2():
    """The compat trackers' resize of frames of another size than the
    first == cv2's INTER_LINEAR bit for bit: uint8 through its 11-bit
    fixed point, float32 through its per-pass fma."""
    import cv2

    rng = np.random.default_rng(0)
    for h, w, oh, ow in ((40, 50, 48, 40), (100, 90, 64, 70),
                         (256, 256, 48, 40)):
        f = rng.integers(0, 256, (h, w), dtype=np.uint8)
        a = compat._resize_to(f, ow, oh)
        b = cv2.resize(f, (ow, oh), interpolation=cv2.INTER_LINEAR)
        assert a.dtype == np.uint8 and a.shape == (oh, ow)
        np.testing.assert_array_equal(a, b)
        ff = f.astype(np.float32) * np.float32(1.37) + np.float32(0.1)
        fa = compat._resize_to(ff, ow, oh)
        assert fa.dtype == np.float32
        np.testing.assert_array_equal(
            fa.view(np.int32),
            cv2.resize(ff, (ow, oh), interpolation=cv2.INTER_LINEAR
                       ).view(np.int32))
    assert compat._resize_to(f, w, h) is f
