"""MJPG video read by the port on the CPU (the plain versions of the two
decode kernels, ``ops/jpeg_cuda``) against the JAX package's reader
(``cv2.VideoCapture``: FFmpeg's decoder and swscale's conversion).

Exact: every frame of clips written by ``cv2.VideoWriter`` (colour,
``isColor=False``, sizes that cv2 cuts to even ones, 240x320, the realistic
256² video), of PIL frames wrapped in an AVI (4:4:4, 4:2:2, 4:2:0 of odd
width, one component, restart intervals, the DHT removed so that the Annex
K tables apply, qualities 1 to 100) and of the stress streams of
``tools/jpeg_stress`` (coefficients no image encoder writes: FFmpeg's x86
IDCT saturates its rows, wraps its DC bias and its dequantised levels);
the committed fixtures against the digests of cv2's frames.  Refused
(ROADMAP.md, C): 4:2:x frames of odd height, which swscale scales through
its bicubic chroma filters, not ported.  End to end: ``cli run``
(whole and ``--stream``) on a 12-frame MJPG clip equal to the port's own
call on the decoded frames, and the port's ``unet`` (float32) against the
JAX package's ``extract_features``.  Refused with ``ValueError``:
progressive, lossless, arithmetic-coded, 12-bit and hierarchical frames,
truncated and corrupt streams, and other codecs.
"""

import hashlib
import io
import json
import re
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from openglottal_tpu import pipelines as jpipe
from openglottal_tpu.data.video import load_frames_bgr as cv2_frames
from openglottal_tpu_torch import cli
from openglottal_tpu_torch.data import jpeg
from openglottal_tpu_torch.data.synthetic import synthetic_video
from openglottal_tpu_torch.data.video import (
    is_monochrome,
    iter_frames,
    iter_frames_bgr,
    load_frames_bgr,
    read_frames,
)
from openglottal_tpu_torch.ops import jpeg_cuda
from openglottal_tpu_torch.pipelines import GlottalPipelines, _box_area_sums
from openglottal_tpu_torch.tools.jpeg_stress import (
    jpeg_frames_of,
    stress_frames,
    write_mjpg_avi,
)
from openglottal_tpu_torch.utils.io import load_weights_npz

FIXTURES = Path(__file__).resolve().parent / "data" / "mjpg"
WEIGHTS = dict(unet_variables="weights/demo_unet.npz",
               yolo_variables="weights/demo_yolo.npz")

def _content(t, h, w, kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "blur":
        return np.stack([cv2.GaussianBlur(f, (0, 0), 1.5) for f in
                         rng.integers(0, 256, (t, h, w, 3), dtype=np.uint8)])
    if kind == "noise":
        return rng.integers(0, 256, (t, h, w, 3), dtype=np.uint8)
    f = rng.integers(0, 2, (t, h // 4 + 1, w // 4 + 1, 3),
                     dtype=np.uint8) * 255
    f = np.repeat(np.repeat(f, 4, 1), 4, 2)[:, :h, :w]
    f[:, :h // 3] = 255
    f[:, h // 3:h // 2] = 0
    return np.ascontiguousarray(f)


def _cv2_clip(path, frames, color=True):
    h, w = frames.shape[1:3]
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 30,
                         (w, h), isColor=color)
    for f in frames:
        wr.write(f)
    wr.release()
    return str(path)


def _pil_jpeg(bgr, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(bgr[..., ::-1]) if bgr.ndim == 3
                    else bgr).save(b, "JPEG", **kw)
    return b.getvalue()


def _strip_dht(frame: bytes) -> bytes:
    out, pos = bytearray(frame[:2]), 2
    while frame[pos + 1] != 0xDA:
        n = int.from_bytes(frame[pos + 2:pos + 4], "big")
        if frame[pos + 1] != 0xC4:
            out += frame[pos:pos + 2 + n]
        pos += 2 + n
    return bytes(out + frame[pos:])


def _pil_clip(path, frames, strip=False, **kw):
    js = [_pil_jpeg(f, **kw) for f in frames]
    if strip:
        js = [_strip_dht(j) for j in js]
    write_mjpg_avi(path, js, frames.shape[2], frames.shape[1])
    return str(path)


def _equal_to_cv2(path):
    want = cv2_frames(path)
    got = load_frames_bgr(path, device="cpu")
    np.testing.assert_array_equal(got, want)
    return got


# ── frames equal to cv2's ───────────────────────────────────────────────────

@pytest.mark.parametrize("h,w,color,kind", [
    (64, 80, True, "sharp"), (64, 80, True, "noise"),
    (64, 80, False, "blur"), (37, 53, True, "sharp"),
    (240, 320, True, "blur")])
def test_cv2_written_clips_equal_cv2_frames(tmp_path, h, w, color, kind):
    frames = _content(3, h, w, kind)
    if not color:
        frames = frames[..., 1]
    got = _equal_to_cv2(_cv2_clip(tmp_path / "c.avi", frames, color))
    # cv2 writes even sizes: 37x53 becomes 36x52 (MCU padding cropped)
    assert got.shape == (3, h - h % 2, w - w % 2, 3)


def test_realistic_256_clip_reads_and_streams(tmp_path):
    """6 frames of the realistic synthetic video: ``read_frames`` /
    ``iter_frames`` / ``iter_frames_bgr`` agree with cv2 and with each
    other; the decoded channels differ (a colour clip, as cv2 sees it)."""
    real = synthetic_video(t=6, size=256, seed=3, realistic=True)[0]
    path = _cv2_clip(tmp_path / "r.avi", real)
    want = _equal_to_cv2(path)
    assert not is_monochrome(want)
    x = read_frames(path, device="cpu")
    assert x.dtype == torch.uint8 and x.shape == (6, 256, 256, 3)
    np.testing.assert_array_equal(x.numpy(), want)
    chunks = list(iter_frames(path, chunk=4, device="cpu"))
    assert [len(c) for c in chunks] == [4, 2]
    np.testing.assert_array_equal(torch.cat(chunks).numpy(), want)
    np.testing.assert_array_equal(
        np.concatenate(list(iter_frames_bgr(path, chunk=5, device="cpu"))),
        want)


@pytest.mark.parametrize("sub,h,w,quality", [
    (0, 37, 53, 90), (1, 38, 54, 75), (2, 38, 53, 50), (2, 64, 80, 1),
    (1, 64, 80, 5), (0, 64, 80, 100)])
@pytest.mark.parametrize("kind", ["sharp", "noise"])
def test_pil_frames_equal_cv2_frames(tmp_path, sub, h, w, quality, kind):
    """4:4:4 / 4:2:2 / 4:2:0, odd widths, qualities 1 to 100."""
    _equal_to_cv2(_pil_clip(tmp_path / "p.avi", _content(2, h, w, kind),
                            quality=quality, subsampling=sub))


def test_pil_gray_restart_and_annex_k_equal_cv2(tmp_path):
    gray = _content(2, 37, 53, "sharp")[..., 0]
    path = _pil_clip(tmp_path / "g.avi", gray, quality=95)
    got = _equal_to_cv2(path)
    np.testing.assert_array_equal(got[..., 0], got[..., 2])
    assert read_frames(path, device="cpu").shape == (2, 37, 53)
    col = _content(2, 48, 64, "noise")
    rst = _pil_clip(tmp_path / "r.avi", col, quality=85, subsampling=2,
                    restart_marker_blocks=3)
    assert b"\xff\xdd" in jpeg_frames_of(rst)[0]
    _equal_to_cv2(rst)
    bare = _pil_clip(tmp_path / "k.avi", col, strip=True, quality=85,
                     subsampling=2)
    assert b"\xff\xc4" not in jpeg_frames_of(bare)[0]
    _equal_to_cv2(bare)


@pytest.mark.parametrize("kind", ["extreme", "dense", "sparse", "noise"])
@pytest.mark.parametrize("sampling", ["gray", "4:4:4", "4:2:2", "4:2:0"])
def test_stress_streams_equal_cv2_frames(tmp_path, kind, sampling):
    """DC differences of +-2047, AC levels of +-1023, every zero run,
    blocks without an EOB, 16-bit quantisation tables (products that wrap
    int16), restart intervals of 1 MCU, frames without a DHT."""
    for i, ((h, w), restart, qmax, dht) in enumerate((
            ((16, 32), 0, 1, True), ((38, 53), 1, 65535, True),
            ((8, 8), 3, 255, False))):
        frames = stress_frames(kind, h, w, sampling, t=2, seed=i,
                               restart=restart, quant_max=qmax, dht=dht)
        path = tmp_path / f"s{i}.avi"
        write_mjpg_avi(path, frames, w, h)
        _equal_to_cv2(path)


@pytest.mark.parametrize("sub", [1, 2])
def test_odd_height_within_the_stated_difference(tmp_path, sub):
    """4:2:x of odd height, which cv2 converts through swscale's scaler
    (bicubic chroma, not ported): no difference is stated, so the frames
    are refused, naming the sampling, by every reader, while 4:4:4 and
    one component of the same odd height stay exact."""
    frames = _content(2, 37, 53, "sharp")
    path = _pil_clip(tmp_path / "o.avi", frames, quality=75, subsampling=sub)
    name = {1: "4:2:2", 2: "4:2:0"}[sub]
    for read in (load_frames_bgr, read_frames,
                 lambda p, device: list(iter_frames(p, 1, device))):
        with pytest.raises(ValueError, match=f"{name} of odd height"):
            read(path, device="cpu")
    _equal_to_cv2(_pil_clip(tmp_path / "f.avi", frames, quality=75,
                            subsampling=0))
    _equal_to_cv2(_pil_clip(tmp_path / "g.avi", frames[..., sub]))


def test_committed_fixtures_equal_their_cv2_digests():
    """tests/data/mjpg (make_fixtures.py): every frame's sha256 equal to
    the digest of cv2's frame (of the 64-frame realistic clip its first 16
    frames here; chip_smoke.py holds all of them, on the card); the one
    fixture the port refuses (4:2:0 of odd height) raises as recorded."""
    digests = json.loads((FIXTURES / "digests.json").read_text())
    assert len(digests) >= 12
    for name, d in digests.items():
        if "refused" in d:
            with pytest.raises(ValueError, match=re.escape(d["refused"])):
                next(iter_frames_bgr(FIXTURES / name, chunk=16,
                                     device="cpu"))
            continue
        got = next(iter_frames_bgr(FIXTURES / name, chunk=16, device="cpu"))
        assert list(got.shape[1:]) == d["shape"][1:], name
        assert len(got) == min(16, d["shape"][0]), name
        sha = [hashlib.sha256(f.tobytes()).hexdigest() for f in got]
        assert d["max_abs_diff"] == 0 and sha == d["sha256"][:16], name


# ── the kernels' host side ──────────────────────────────────────────────────

def test_wrappers_on_cpu_tensors_are_the_plain_versions(tmp_path):
    """``decode`` of a packed chunk on the CPU == the plain functions; the
    launch counts stay 0 (no kernel ran); the packed chunk carries only the
    compressed segments, the tables and the per-frame rows."""
    frames = stress_frames("noise", 40, 56, "4:2:2", t=3, restart=2)
    state = jpeg.JpegState()
    p = jpeg.pack([jpeg.parse_frame(f, state, i)
                   for i, f in enumerate(frames)])
    assert p.segs.shape[1] == jpeg.SEG_WORDS and (p.segs[:, 0] % 4 == 0).all()
    assert p.data.nbytes < sum(len(f) for f in frames) + 8 * len(p.segs) + 8
    jpeg_cuda.reset_launch_counts()
    got = jpeg_cuda.decode(p, "cpu")
    coef, err = jpeg.entropy_decode_plain(p)
    assert not err.any()
    np.testing.assert_array_equal(got.numpy(), jpeg.idct_bgr_plain(coef, p))
    assert jpeg_cuda.LAUNCHES == {"jpeg_entropy": 0, "jpeg_idct_bgr": 0}
    # a packed chunk whose rows leave its bytes or tables is refused before
    # any kernel could read past them
    for field, row, col, value in (("segs", -1, 0, len(p.data)),
                                   ("segs", 0, 4, 10 ** 6),
                                   ("slots", 0, 0, len(p.tables))):
        bad = jpeg.Packed(p.data, p.segs.copy(), p.tables, p.slots.copy(),
                          p.comp, p.quant, p.geo)
        getattr(bad, field)[row, col] = value
        with pytest.raises(ValueError, match="out of bounds"):
            jpeg_cuda.upload(bad, "cpu")


# ── refusals ────────────────────────────────────────────────────────────────

def _with_sof(frame: bytes, marker: int, precision: int = 8) -> bytes:
    i = frame.index(b"\xff\xc0")
    return (frame[:i + 1] + bytes([marker]) + frame[i + 2:i + 4]
            + bytes([precision]) + frame[i + 5:])


@pytest.mark.parametrize("marker,precision,name", [
    (0xC2, 8, "SOF2"), (0xC3, 8, "SOF3"), (0xC9, 8, "SOF9"),
    (0xCA, 8, "SOF10"), (0xC5, 8, "SOF5"), (0xCD, 8, "SOF13"),
    (0xC0, 12, "12-bit"), (0xC1, 12, "12-bit")])
def test_refused_frame_kinds_raise(tmp_path, marker, precision, name):
    frame = _pil_jpeg(_content(1, 16, 16, "noise")[0], quality=80)
    path = tmp_path / "x.avi"
    write_mjpg_avi(path, [frame, _with_sof(frame, marker, precision)], 16, 16)
    with pytest.raises(ValueError, match=name):
        load_frames_bgr(path, device="cpu")


def test_hierarchical_and_arithmetic_markers_raise():
    frame = _pil_jpeg(_content(1, 16, 16, "noise")[0], quality=80)
    for marker, name in ((0xDE, "DHP"), (0xCC, "DAC")):
        bad = frame[:2] + bytes([0xFF, marker, 0, 4, 0, 0]) + frame[2:]
        with pytest.raises(ValueError, match=name):
            jpeg.parse_frame(bad)


def test_truncated_and_corrupt_streams_raise_naming_the_frame(tmp_path):
    frames = stress_frames("noise", 32, 48, "4:2:0", t=3)
    body = frames[1].index(b"\xff\xda")
    cases = {"short": frames[1][:body + 30] + b"\xff\xd9",
             "corrupt": frames[1][:body + 20] + b"\xff\x00" * 40 + b"\xff\xd9"}
    for name, bad in cases.items():
        path = tmp_path / f"{name}.avi"
        write_mjpg_avi(path, [frames[0], bad, frames[2]], 48, 32)
        with pytest.raises(ValueError, match="frame 1"):
            load_frames_bgr(path, device="cpu")
        with pytest.raises(ValueError, match="frame 1"):
            list(iter_frames(path, chunk=2, device="cpu"))
    # a restart interval short of its MCUs is refused when the frame is cut
    rst = stress_frames("noise", 32, 48, "4:2:0", t=1, restart=1)[0]
    cut = rst[:rst.rindex(b"\xff\xd0")] + b"\xff\xd9"
    with pytest.raises(ValueError, match="restart intervals"):
        jpeg.parse_frame(cut)


def test_interlaced_fields_raise(tmp_path):
    """A frame of under 3/4 of the stream's rows is one of two interlaced
    fields to FFmpeg; the port refuses it."""
    frame = _pil_jpeg(_content(1, 16, 16, "noise")[0], quality=80)
    write_mjpg_avi(tmp_path / "i.avi", [frame], 16, 32)
    with pytest.raises(ValueError, match="interlaced"):
        load_frames_bgr(tmp_path / "i.avi", device="cpu")


def test_other_codecs_still_raise(tmp_path):
    for fourcc in (b"I420", b"H264", b"XVID"):
        path = tmp_path / "o.avi"
        write_mjpg_avi(path, [b"\0" * 64], 8, 8, fourcc=fourcc)
        with pytest.raises(ValueError, match=fourcc.decode()):
            load_frames_bgr(path, device="cpu")
    (tmp_path / "x.mp4").write_bytes(b"\0\0\0\x18ftypmp42" + b"\0" * 20)
    with pytest.raises(ValueError, match="AVI"):
        read_frames(tmp_path / "x.mp4", device="cpu")


def test_mjpg_needs_a_device_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves")
    path = _cv2_clip(tmp_path / "c.avi", _content(2, 16, 16, "blur"))
    with pytest.raises(RuntimeError, match="CUDA"):
        load_frames_bgr(path)
    assert read_frames(tmp_path / "none.avi", device="cpu").shape == (
        0, 0, 0, 3)


# ── end to end ──────────────────────────────────────────────────────────────

def _clip12(tmp_path):
    real = synthetic_video(t=12, size=256, seed=5, realistic=True)[0]
    return _cv2_clip(tmp_path / "clip.avi", real)


def test_cli_run_whole_and_stream_on_mjpg(tmp_path):
    """``run`` and ``run --stream 5`` (unet, the command's bfloat16, the
    CPU) write the features of the port's ``extract_features`` on the
    decoded frames."""
    clip = _clip12(tmp_path)
    frames = read_frames(clip, device="cpu")
    gp = GlottalPipelines(**WEIGHTS, device="cpu")
    want = gp.extract_features(frames, "unet")
    assert want is not None
    for extra, out in ((["--stream", "5"], "s"), ([], "w")):
        cli.main(["run", clip, "--pipeline", "unet", "--yolo-weights",
                  WEIGHTS["yolo_variables"], "--unet-weights",
                  WEIGHTS["unet_variables"], "--device", "cpu", "-o",
                  str(tmp_path / out)] + extra)
        got = json.loads((tmp_path / out / "features.json").read_text())
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k], np.float64),
                                          np.asarray(v, np.float64), k)


def test_unet_on_mjpg_frames_against_the_jax_package(tmp_path, monkeypatch):
    """The port's ``unet`` (float32) on the frames it decoded against the
    JAX package's ``extract_features(load_frames_bgr(clip), "unet")`` (its
    CHUNK shrunk to 12: its whole-video graphs pad to CHUNK frames): per
    frame within the in-box pixels whose JAX logit lies within 1e-3 of 0
    (the borderline pixel count of tests/test_torch_port_entry.py)."""
    import jax
    import jax.numpy as jnp

    from openglottal_tpu.data.video import bgr_to_gray_u8 as jgray
    from openglottal_tpu.models import fold as jfold
    from openglottal_tpu.models.unet import UNet as JUNet

    clip = _clip12(tmp_path)
    monkeypatch.setattr(jpipe, "CHUNK", 12)
    jweights = {k: load_weights_npz(v) for k, v in WEIGHTS.items()}
    frames = cv2_frames(clip)
    want = jpipe.GlottalPipelines(**jweights, dtype=jnp.float32
                                  ).extract_features(frames, "unet")["_area"]
    gp = GlottalPipelines(**WEIGHTS, dtype=torch.float32, device="cpu")
    got = gp.extract_features(read_frames(clip, device="cpu"), "unet")
    uv = jfold.absorb_u8_scale(jfold.fold_unet(jweights["unet_variables"]),
                               jfold.UNET_STEM)
    apply = jax.jit(lambda v, x: JUNet(dtype=jnp.float32, fuse_bn=True
                                       ).apply(v, x, train=False))
    logits = np.asarray(apply(uv, jnp.asarray(np.asarray(jgray(frames)),
                                              jnp.float32)[..., None]))[..., 0]
    valid, boxes = gp.gated_boxes(frames)
    slack = _box_area_sums(torch.from_numpy(np.abs(logits) < 1e-3), valid,
                           boxes).numpy()
    assert want.max() > 0
    assert (np.abs(got["_area"] - want) <= slack).all(), (
        got["_area"], want, slack)
