"""The entry points on the input users give them, port vs JAX package on the
CPU at full width with the demo weights (float32): colour (BGR) video and
frames other than 256², through all five pipelines.

Exact: the letterbox branch of the gate on a 300x200 clip (gray and
colour), the trackers of a 12-frame colour clip, the BGR and gray entries of
one gray clip.  Within the borderline pixel count (pixels whose JAX
probability or logit lies within 1e-3 of the cut, where the two packages'
float32 convolutions may round to either side): the U-Net on 200x240
frames and the crop U-Net.  Contracts: every branch of ``run_pipeline_full``
and ``extract_features``.

The JAX side runs the modular functions on exactly these frames (the
whole-video entries pad every video to 128 frames); its results are
memoised per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglottal_tpu import pipelines as jpipe
from openglottal_tpu.data.video import bgr_to_gray_u8 as jbgr_to_gray
from openglottal_tpu.models import fold as jfold
from openglottal_tpu.models.gate import gate_scan as jgate_scan
from openglottal_tpu.models.gate import gate_single as jgate_single
from openglottal_tpu.models.tracker import VFTParams as JVFTParams
from openglottal_tpu.models.tracker import YGVFTParams as JYGVFTParams
from openglottal_tpu.models.tracker import vft_parallel as jvft_parallel
from openglottal_tpu.models.tracker import ygvft_parallel as jygvft_parallel
from openglottal_tpu.models.unet import UNet as JUNet
from openglottal_tpu.ops import resize as jresize
from openglottal_tpu_torch.data.synthetic import synthetic_video
from openglottal_tpu_torch.ops.resize import (
    dyn_letterbox_geometry,
    dyn_letterbox_index_nearest,
    gather_rows_cols,
)
from openglottal_tpu_torch.pipelines import (
    PIPELINES,
    VFT_INIT,
    YGVFT_INIT,
    GlottalPipelines,
    is_monochrome,
)
from openglottal_tpu_torch.utils.io import load_weights_npz

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


def _memo(key, make):
    if key not in _MEMO:
        _MEMO[key] = make()
    return _MEMO[key]


def _pipes():
    return _memo("gp", lambda: GlottalPipelines(
        unet_variables="weights/demo_unet.npz",
        crop_unet_variables="weights/demo_unet.npz",
        yolo_variables="weights/demo_yolo.npz", dtype=torch.float32,
        device="cpu"))


def _jyolo():
    return _memo("yv", lambda: jfold.fold_yolo(
        load_weights_npz("weights/demo_yolo.npz")))


def _junet():
    return _memo("uv", lambda: jfold.fold_unet(
        load_weights_npz("weights/demo_unet.npz")))


def _tint(frames):
    """A colour video from a gray one: the three channels made unequal."""
    f = frames.astype(np.int16)
    f[..., 0] = f[..., 0] * 7 // 8
    f[..., 2] = np.minimum(f[..., 2] + 12, 255)
    return f.astype(np.uint8)


def _colour12():
    """12 frames of 256² colour video."""
    def make():
        f = _tint(synthetic_video(t=12, size=256, seed=5)[0])
        assert not is_monochrome(f)
        return f
    return _memo("colour12", make)


def _clip300x200(colour: bool):
    """6 frames of 300x200 (h x w) video, gray as three equal channels or
    colour."""
    def make():
        f = synthetic_video(t=6, size=300, seed=3,
                            center=(150.0, 150.0))[0][:, :, 50:250]
        f = np.ascontiguousarray(f)
        return _tint(f) if colour else f
    return _memo(("300x200", colour), make)


def _clip240x320():
    """4 frames of 240x320 (h x w) colour video."""
    return _memo("240x320", lambda: _tint(np.ascontiguousarray(
        synthetic_video(t=4, size=320, seed=5,
                        center=(160.0, 160.0))[0][:, 40:280])))


# ── the detector and gate on colour and non-256² frames ─────────────────────

def _jax_gated_300x200(colour: bool):
    """The reference's letterbox branch of ``_gated`` composed from its
    modular pieces on the 6 frames: letterbox to 256² (each channel of
    colour input), round to uint8, the detector, boxes mapped back and
    clipped.  Returns (has, unprojected raw boxes)."""
    def make():
        vid = _clip300x200(colour)
        h, w = vid.shape[1:3]
        pt, pl, _, _ = jresize.letterbox_info(h, w, 256)
        scale = max(h, w) / 256.0

        def boxed(x):
            b = jresize.letterbox(jnp.asarray(x, jnp.float32), 256,
                                  method="linear")
            return jnp.clip(jnp.round(b), 0, 255).astype(jnp.uint8)
        if colour:
            x = jnp.stack([boxed(vid[..., c]) for c in range(3)], -1)
            has, raw, _ = jpipe._yolo_chunk(_jyolo(), x, conf=0.25,
                                            dtype=jnp.float32, fuse=True)
        else:
            has, raw, _ = jpipe._yolo_chunk_gray(
                _jyolo(), boxed(vid[..., 0]), conf=0.25, dtype=jnp.float32,
                fuse=True)
        raw = jnp.stack([(raw[:, 0] - pl) * scale, (raw[:, 1] - pt) * scale,
                         (raw[:, 2] - pl) * scale, (raw[:, 3] - pt) * scale],
                        -1)
        raw = jnp.clip(raw, 0, jnp.asarray([w, h, w, h], jnp.float32))
        return has, raw
    return _memo(("jgated", colour), make)


@pytest.mark.parametrize("colour", [False, True])
def test_gated_letterbox_branch_exact(colour):
    """300x200 frames: letterboxed to 256² for the detector and its boxes
    mapped back; the gate's outputs (sequential and per frame) equal the
    reference's."""
    vid = _clip300x200(colour)
    gp = _pipes()
    fdev, gray = gp.prepare(vid)
    assert (fdev is None) == (not colour)
    has, raw = _jax_gated_300x200(colour)
    assert bool(has.any())
    for sequential, jfn in ((True, jgate_scan), (False, jgate_single)):
        jv, jb = jfn(has, raw, 300, 200, params=jpipe.GateParams())
        v, b = gp._gated(fdev, gray, sequential=sequential)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
        v, b = gp.gated_boxes(vid, sequential)     # the public gate
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


def test_bgr_and_gray_entries_give_the_same_boxes():
    """A gray clip given as three equal channels through the BGR detector
    (channels reversed) and as one channel through the gray detector: the
    same gate outputs, letterboxed (300x200) and at 256²."""
    gp = _pipes()
    for vid in (_clip300x200(False),
                np.ascontiguousarray(synthetic_video(t=6, size=256,
                                                     seed=5)[0])):
        gray = torch.from_numpy(np.ascontiguousarray(vid[..., 0]))
        v_bgr, b_bgr = gp._gated(torch.from_numpy(vid), None)
        v_gray, b_gray = gp._gated(None, gray)
        np.testing.assert_array_equal(v_bgr.numpy(), v_gray.numpy())
        np.testing.assert_array_equal(b_bgr.numpy(), b_gray.numpy())
        assert v_gray.any()
    v, b = gp.gated_boxes(vid)
    np.testing.assert_array_equal(v.numpy(), v_gray.numpy())
    np.testing.assert_array_equal(b.numpy(), b_gray.numpy())


# ── the trackers on colour video ────────────────────────────────────────────

def _jax_colour12():
    """The reference on the 12-frame colour clip: the BGR detector, the
    gate, and both trackers' waveforms given those gate outputs."""
    def make():
        vid = _colour12()
        gray = np.asarray(jbgr_to_gray(vid))
        has, raw, _ = jpipe._yolo_chunk(_jyolo(), jnp.asarray(vid), conf=0.25,
                                        dtype=jnp.float32, fuse=True)
        valid, boxes = (np.asarray(a) for a in jgate_scan(has, raw, 256, 256))
        g32 = gray.astype(np.float32)
        fi = int(np.argmax(valid[:YGVFT_INIT]))
        _, ga = jygvft_parallel(
            jnp.asarray(g32[:YGVFT_INIT]), jnp.asarray(bool(valid[:2].any())),
            jnp.asarray(boxes[fi]), jnp.asarray(g32[YGVFT_INIT:]),
            jnp.asarray(valid[YGVFT_INIT:]), jnp.asarray(boxes[YGVFT_INIT:]),
            params=JYGVFTParams())
        guided = np.zeros(12, np.float32)
        guided[YGVFT_INIT:] = np.asarray(ga)
        idx = np.nonzero(valid)[0]
        b0 = boxes[idx[0]]
        crops = jpipe._gather_crops(jnp.asarray(gray[idx]),
                                    jnp.asarray(boxes[idx]),
                                    int(b0[3] - b0[1]), int(b0[2] - b0[0]))
        _, va = jvft_parallel(crops[:VFT_INIT], crops,
                              jnp.arange(len(idx)) >= VFT_INIT,
                              params=JVFTParams())
        vft = np.zeros(12, np.float32)
        vft[idx] = np.asarray(va)
        vft[idx[:VFT_INIT]] = 0.0
        return gray, valid, boxes, guided, vft
    return _memo("jcolour12", make)


def test_colour_clip_trackers_exact():
    """12 colour frames: gray on the device equal to the reference's, the
    BGR detector's gate outputs equal, and both trackers' waveforms equal
    given the reference's gate outputs (so the BGR entry points' too)."""
    gray, valid, boxes, guided, vft = _jax_colour12()
    gp = _pipes()
    vid = _colour12()
    fdev, g = gp.prepare(vid)
    assert fdev is not None
    np.testing.assert_array_equal(g.numpy(), gray)
    v, b = gp._gated(fdev, g)
    np.testing.assert_array_equal(v.numpy(), valid)
    np.testing.assert_array_equal(b.numpy(), boxes)
    assert guided[YGVFT_INIT:].min() > 0 and vft[VFT_INIT:].min() > 0
    tv, tb = torch.from_numpy(valid.copy()), torch.from_numpy(boxes.copy())
    np.testing.assert_array_equal(gp._ygvft_compute(g, tv, tb, 12)[0], guided)
    np.testing.assert_array_equal(gp._vft_compute(g, tv, tb, 12)[0], vft)


# ── the U-Nets ──────────────────────────────────────────────────────────────

def _small_gray():
    """3 frames of 200x240 (h x w) gray video, smaller than 256 on its long
    side."""
    return _memo("200x240", lambda: np.ascontiguousarray(
        synthetic_video(t=3, size=240, seed=7)[0][:, 20:220, :, 0]))


def test_segment_video_and_unet_only_within_the_borderline_pixel_count():
    """200x240 frames: bilinear to 256², the U-Net's probabilities, bilinear
    back, > 0.5.  Per frame, the masks may differ from the reference's only
    in pixels whose reference probability lies within 1e-3 of 0.5; the
    ``unet-only`` areas are the masks' pixel counts."""
    g = _small_gray()
    x = jresize.resize_bilinear(jnp.asarray(g, jnp.float32), 256, 256)
    probs = jpipe._unet_probs_chunk(_junet(), x, dtype=jnp.float32, fuse=True)
    back = np.asarray(jresize.resize_bilinear(probs, 200, 240))
    want = back > 0.5
    slack = (np.abs(back - 0.5) < 1e-3).sum((1, 2))
    gp = _pipes()
    masks = gp.segment_video(g).numpy()
    assert masks.shape == want.shape and want.sum((1, 2)).min() > 0
    differ = (masks != want).sum((1, 2))
    assert (differ <= slack).all(), (differ, slack)
    areas = gp.unet_only_areas(g).numpy()
    np.testing.assert_array_equal(areas, masks.sum((1, 2)).astype(np.float32))


def _crop_case():
    """4 gray 256² frames and their gate boxes: three crops of different
    shapes and one frame without a box (zero box, not valid)."""
    gray = np.ascontiguousarray(_colour12()[:4, ..., 1])
    boxes = np.array([[60, 40, 180, 200], [90, 60, 170, 230],
                      [100, 90, 156, 146], [0, 0, 0, 0]], np.int32)
    return gray, np.array([True, True, True, False]), boxes


def test_crop_unet_chunk_within_the_borderline_pixel_count():
    """Each gated crop letterboxed to 256² (nearest; the letterboxed input
    equal to the reference's), the crop U-Net, the mask projected back:
    per frame, differences only in pixels whose reference logit lies within
    1e-3 of 0, projected back the same way; the frame without a box
    empty."""
    gray, valids, boxes = _crop_case()
    uv = _junet()
    want = np.asarray(jpipe._crop_unet_chunk(
        uv, jnp.asarray(gray), jnp.asarray(valids), jnp.asarray(boxes),
        dtype=jnp.float32, fuse=True))
    # the reference's letterboxed crops and their logits
    jb = jnp.asarray(boxes)
    ch, cw = jb[:, 3] - jb[:, 1], jb[:, 2] - jb[:, 0]
    pt, pl, c_h, c_w = jresize.dyn_letterbox_geometry(ch, cw)
    mats = [jax.vmap(lambda s, l, p, c, n=n, f=f: f(n, 256, s, l, p, c))(
                *a) for n, f, a in (
        (256, jresize.dyn_letterbox_matrix_nearest, (jb[:, 1], ch, pt, c_h)),
        (256, jresize.dyn_letterbox_matrix_nearest, (jb[:, 0], cw, pl, c_w)),
        (256, jresize.dyn_unletterbox_matrix_nearest, (jb[:, 1], ch, pt, c_h)),
        (256, jresize.dyn_unletterbox_matrix_nearest,
         (jb[:, 0], cw, pl, c_w)))]
    g = jnp.asarray(gray, jnp.float32)
    boxed = jnp.einsum("cjw,ciw->cij", mats[1],
                       jnp.einsum("cih,chw->ciw", mats[0], g))
    logits = JUNet(dtype=jnp.float32, fuse_bn=True).apply(
        jfold.absorb_u8_scale(uv, jfold.UNET_STEM), boxed[..., None],
        train=False)[..., 0]
    near = (jnp.abs(logits) < 1e-3).astype(jnp.float32)
    near = jnp.einsum("cwj,chj->chw", mats[3],
                      jnp.einsum("chi,cij->chj", mats[2], near))
    slack = (np.asarray(near) > 0.5).sum((1, 2))
    # the port's letterboxed crops (index maps and gathers)
    tg, tbx = torch.from_numpy(gray), torch.from_numpy(boxes)
    tch, tcw = tbx[:, 3] - tbx[:, 1], tbx[:, 2] - tbx[:, 0]
    geo = dyn_letterbox_geometry(tch, tcw)
    rows = dyn_letterbox_index_nearest(256, 256, tbx[:, 1], tch, geo[0],
                                       geo[2])
    cols = dyn_letterbox_index_nearest(256, 256, tbx[:, 0], tcw, geo[1],
                                       geo[3])
    np.testing.assert_array_equal(
        gather_rows_cols(tg, *rows, *cols).numpy(), np.asarray(boxed))
    got = _pipes()._crop_unet_chunk(tg, torch.from_numpy(valids), tbx).numpy()
    assert want[:3].sum((1, 2)).min() > 0
    assert not got[3].any() and not want[3].any()
    differ = (got != want).sum((1, 2))
    assert (differ <= slack).all(), (differ, slack)


def test_crop_unet_frame_without_a_box_is_empty():
    """A zero box (``ch = cw = 0`` clamped to 1 in the geometry) projects no
    pixel back, valid or not."""
    gray = torch.full((2, 256, 256), 128, dtype=torch.uint8)
    boxes = torch.zeros((2, 4), dtype=torch.int32)
    got = _pipes()._crop_unet_chunk(gray, torch.tensor([False, True]), boxes)
    assert got.shape == (2, 256, 256) and not got.any()


# ── contracts of the outputs ────────────────────────────────────────────────

@pytest.mark.parametrize("pipeline", PIPELINES)
def test_run_pipeline_full_and_extract_features(pipeline):
    """Every branch on 4 frames of 240x320 colour video: shapes and dtypes;
    ``unet-only`` without gate outputs; masks consistent with the areas
    (equal counts where the areas count the masks; ``unet`` shows masks only
    on gated frames; ``vft`` pastes crop masks inside the frame's box); and
    ``extract_features`` on the same frames gives the same waveform (vft: too
    few frames, None)."""
    gp = _pipes()
    vid = _clip240x320()
    t = len(vid)
    masks, valid, boxes, areas = gp.run_pipeline_full(vid, pipeline)
    assert masks.shape == (t, 240, 320) and masks.dtype == torch.bool
    assert areas.shape == (t,) and areas.dtype == torch.float32
    if pipeline == "unet-only":
        assert valid is None and boxes is None
    else:
        assert valid.shape == (t,) and boxes.shape == (t, 4)
        assert valid.all()
    counts = masks.sum((1, 2)).to(torch.float32)
    if pipeline in ("unet-only", "crop-unet", "guided-vft"):
        np.testing.assert_array_equal(areas.numpy(), counts.numpy())
    if pipeline in ("unet", "crop-unet", "guided-vft", "vft"):
        rows = torch.arange(240)[None, :, None]
        cols = torch.arange(320)[None, None, :]
        inbox = ((rows >= boxes[:, 1, None, None])
                 & (rows < boxes[:, 3, None, None])
                 & (cols >= boxes[:, 0, None, None])
                 & (cols < boxes[:, 2, None, None]))
        assert not (masks & ~inbox).any() or pipeline == "unet"
        if pipeline == "unet":
            np.testing.assert_array_equal(
                areas.numpy(), (masks & inbox).sum((1, 2)).float().numpy())
    if pipeline == "vft":
        assert not masks[:VFT_INIT].any() and not areas[:VFT_INIT].any()
    assert areas.max() > 0
    feats = gp.extract_features(vid, pipeline)
    if pipeline == "vft":
        assert feats is None
    else:
        np.testing.assert_array_equal(feats["_area"], areas.numpy())


def test_run_pipeline_full_unknown_raises():
    with pytest.raises(ValueError):
        _pipes().run_pipeline_full(_clip240x320(), "nope")
