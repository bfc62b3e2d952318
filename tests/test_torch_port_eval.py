"""Evaluation, port vs JAX package on the CPU: the metrics
(``ops/metrics.py``), the Otsu threshold (``ops/histogram.py``), the count
kernels' plain versions (``ops/eval_cuda.py``) and ``eval.py``
(``evaluate_patient``, ``aggregate``, the mask functions).

Bit-equal: dice / iou, the Otsu threshold on 600 masked histograms (the
degenerate ones among them), the count kernels' plain versions against
``frame_metrics_batch`` / ``box_masked`` / ``otsu_in_box_masks`` on stress
inputs, and ``evaluate_patient``'s ``yolo+otsu`` rows and every ``det``
array.  ``dice_loss``: value and gradient within 1e-6 (float32 sums taken in
another order).  The U-Net rows of ``evaluate_patient``: within 0.01 a frame
(a few pixels at the mask's edge whose float32 logits round to either side
of 0 in the two packages' convolutions; 0 measured).  The JAX side of
``evaluate_patient`` runs with its CHUNK shrunk to 12 (its whole-video
graphs pad every video to CHUNK frames); its results are memoised.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglottal_tpu import eval as jeval
from openglottal_tpu import pipelines as jpipe
from openglottal_tpu.data.video import bgr_to_gray_u8 as jbgr_to_gray
from openglottal_tpu.ops import metrics as jmetrics
from openglottal_tpu.ops.histogram import otsu_threshold as jotsu
from openglottal_tpu_torch import eval as teval
from openglottal_tpu_torch.data.synthetic import synthetic_video
from openglottal_tpu_torch.ops import metrics
from openglottal_tpu_torch.ops.eval_cuda import (
    frame_counts,
    frame_counts_plain,
    otsu_counts,
)
from openglottal_tpu_torch.ops.histogram import (
    masked_histogram_u8,
    otsu_threshold,
    otsu_threshold_from_hist,
)
from openglottal_tpu_torch.pipelines import YGVFT_INIT, GlottalPipelines
from openglottal_tpu_torch.utils.io import load_weights_npz

_MEMO = {}
_WEIGHTS = dict(unet_variables="weights/demo_unet.npz",
                crop_unet_variables="weights/demo_unet.npz",
                yolo_variables="weights/demo_yolo.npz")


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


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


# ── dice, iou, dice_loss (the cases of tests/test_metrics.py) ──────────────

def _metric_cases():
    rng = np.random.default_rng(0)
    a = np.zeros((8, 8))
    a[0, 0] = 1
    b = np.zeros((8, 8))
    b[7, 7] = 1
    r1 = np.random.default_rng(1)
    return [(np.zeros((16, 16)), np.zeros((16, 16))),        # empty, empty
            (a, b),                                           # disjoint
            (rng.random((32, 32)) > 0.5, rng.random((32, 32)) > 0.5),
            (r1.random((4, 16, 16)) > 0.5, r1.random((4, 16, 16)) > 0.5),
            (rng.normal(0, 1, (3, 2, 9, 7)), rng.integers(0, 3, (3, 2, 9, 7)))]


@pytest.mark.parametrize("case", range(5))
def test_dice_iou_bit_equal(case):
    p, g = _metric_cases()[case]
    for ours, ref in ((metrics.dice, jmetrics.dice),
                      (metrics.iou, jmetrics.iou)):
        got = ours(torch.from_numpy(np.asarray(p)), torch.from_numpy(g))
        want = ref(jnp.asarray(p), jnp.asarray(g))
        assert got.shape == want.shape
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_dice_loss_value_and_gradient():
    """Within 1e-6: the soft sums run in another order."""
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 2, (2, 8, 8, 1)).astype(np.float32)
    target = (rng.random((2, 8, 8, 1)) > 0.4).astype(np.float32)
    want, wgrad = jax.value_and_grad(jmetrics.dice_loss)(
        jnp.asarray(logits), jnp.asarray(target))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = metrics.dice_loss(x, torch.from_numpy(target))
    got.backward()
    assert abs(got.item() - float(want)) < 1e-6
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(wgrad), atol=1e-6)
    zero = metrics.dice_loss(torch.zeros(2, 8, 8, 1, requires_grad=True),
                             torch.ones(2, 8, 8, 1))
    assert 0 <= zero.item() <= 1


# ── the Otsu threshold ──────────────────────────────────────────────────────

def _otsu_cases(n=600, h=40, w=48, seed=0):
    """Random in-box pixel sets: uniform, one normal, a bimodal glottis,
    one value, two values, coarse quantisations; masks of every density,
    every 50th empty."""
    rng = np.random.default_rng(seed)
    vals, masks = [], []
    for k in range(n):
        kind = k % 6
        if kind == 0:
            v = rng.integers(0, 256, (h, w))
        elif kind == 1:
            v = rng.normal(rng.uniform(20, 230), rng.uniform(1, 40), (h, w))
        elif kind == 2:
            v = rng.normal(170, 10, (h, w))
            v[10:30, 10:30] = rng.normal(40, 8, (20, 20))
        elif kind == 3:
            v = np.full((h, w), rng.integers(0, 256))
        elif kind == 4:
            v = rng.choice(rng.integers(0, 256, 2), (h, w))
        else:
            v = (rng.integers(0, 256, (h, w)) // rng.integers(1, 64)
                 * rng.integers(1, 4))
        m = rng.random((h, w)) < rng.uniform(0, 1)
        if k % 50 == 7:
            m[:] = False
        vals.append(np.clip(v, 0, 255).astype(np.uint8))
        masks.append(m)
    return np.stack(vals), np.stack(masks)


def test_otsu_threshold_bit_equal_to_jitted_reference():
    """600 masked histograms (the empty mask, one value and two values
    among them), one by one and as one batch."""
    vals, masks = _otsu_cases()
    ref = jax.jit(jotsu)
    want = np.array([float(ref(jnp.asarray(v), jnp.asarray(m)))
                     for v, m in zip(vals, masks)], np.float32)
    v_t, m_t = torch.from_numpy(vals), torch.from_numpy(masks)
    hists = torch.stack([masked_histogram_u8(v_t[i], m_t[i])
                         for i in range(len(vals))])
    np.testing.assert_array_equal(_bits(otsu_threshold_from_hist(hists)),
                                  _bits(want))
    for i in range(0, len(vals), 37):
        assert float(otsu_threshold(v_t[i], m_t[i])) == want[i]
    assert float(otsu_threshold(v_t[0])) == float(ref(jnp.asarray(vals[0])))


# ── the count kernels' plain versions ───────────────────────────────────────

def _stress_inputs(h, w, dtype, seed):
    """Masks, gt, valid, boxes of 10 frames at (h, w): all-zero and all-one
    frames, empty boxes, boxes across and at the frame's edges, one-pixel
    boxes, a box past the frame, invalid frames."""
    rng = np.random.default_rng(seed)
    t = 10
    pred = rng.random((t, h, w)) < 0.4
    gt = rng.random((t, h, w)) < 0.3
    pred[0] = False
    pred[1] = True
    gt[1] = True
    gt[2] = False
    boxes = np.stack([rng.integers(-10, w, t), rng.integers(-10, h, t),
                      rng.integers(0, w + 10, t), rng.integers(0, h + 10, t)],
                     1)
    boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2])
    boxes[0] = [0, 0, w, h]
    boxes[3] = [5, 5, 5, 9]                    # empty
    boxes[4] = [w - 1, h - 1, w, h]            # one pixel, at the corner
    boxes[5] = [0, 0, 1, 1]                    # one pixel, at the origin
    boxes[6] = [-30, -30, w + 30, h + 30]      # past the frame
    boxes[7] = [w, h, w + 5, h + 5]            # outside
    valid = rng.random(t) < 0.8
    valid[:7] = True
    valid[8] = False
    pred_x = (pred * rng.integers(1, 256, (t, h, w))).astype(np.uint8) if (
        dtype == "uint8") else pred
    gt_x = gt.astype(np.uint8) * 255 if dtype == "uint8" else gt
    return (torch.from_numpy(np.asarray(pred_x)),
            torch.from_numpy(np.asarray(gt_x)), torch.from_numpy(valid),
            torch.from_numpy(boxes.astype(np.int32)))


@pytest.mark.parametrize("shape", [(256, 256), (37, 53), (240, 320)])
@pytest.mark.parametrize("dtype", ["bool", "uint8"])
def test_frame_counts_plain_bit_equal_to_reference(shape, dtype):
    """Unmasked and box-masked counts, alone and from one call, against the
    JAX package's frame_metrics_batch and box_masked."""
    pred, gt, valid, boxes = _stress_inputs(*shape, dtype, seed=shape[1])
    jp, jg = jnp.asarray(pred.numpy()), jnp.asarray(gt.numpy())
    jv, jb = jnp.asarray(valid.numpy()), jnp.asarray(boxes.numpy())
    for counts, (jpred, jgt) in (
            (frame_counts(pred, gt), (jp, jg)),
            (frame_counts(pred, gt, valid, boxes),
             (jeval.box_masked(jp > 0, jv, jb), jg))):
        d, i = teval.metrics_from_counts(counts)
        wd, wi = jeval.frame_metrics_batch(jpred, jgt)
        np.testing.assert_array_equal(_bits(d), _bits(wd))
        np.testing.assert_array_equal(_bits(i), _bits(wi))
    both = frame_counts(pred, gt, valid, boxes, unmasked=True)
    assert both.shape == (2, 10, 3)
    assert torch.equal(both[0], frame_counts(pred, gt, valid, boxes))
    assert torch.equal(both[1], frame_counts(pred, gt))
    masked = teval.box_masked(pred != 0, valid, boxes)
    np.testing.assert_array_equal(
        masked.numpy(), np.asarray(jeval.box_masked(jp > 0, jv, jb)))
    assert torch.equal(frame_counts(pred, gt, valid, boxes),
                       frame_counts_plain(masked, gt))
    d, i = teval.frame_metrics_batch(pred, gt)
    wd, wi = jeval.frame_metrics_batch(jp, jg)
    np.testing.assert_array_equal(_bits(d), _bits(wd))
    np.testing.assert_array_equal(_bits(i), _bits(wi))


@pytest.mark.parametrize("shape", [(256, 256), (37, 53)])
def test_otsu_counts_plain_bit_equal_to_reference(shape):
    """Thresholds, masks and counts against otsu_in_box_masks and
    frame_metrics_batch, on stress boxes over bimodal frames (and all-zero,
    all-255 frames)."""
    _, gt, valid, boxes = _stress_inputs(*shape, "bool", seed=7)
    rng = np.random.default_rng(shape[0])
    g = rng.normal(170, 12, (10,) + shape)
    g[:, 5:30, 8:40] = rng.normal(45, 9, (10, min(25, shape[0] - 5), 32))
    g = np.clip(g, 0, 255).astype(np.uint8)
    g[8] = 0
    g[9] = 255
    gray = torch.from_numpy(g)
    jmasks = jeval.otsu_in_box_masks(jnp.asarray(g), jnp.asarray(
        valid.numpy()), jnp.asarray(boxes.numpy()))
    masks = teval.otsu_in_box_masks(gray, valid, boxes)
    np.testing.assert_array_equal(masks.numpy(), np.asarray(jmasks))
    thr, counts = otsu_counts(gray, gt, valid, boxes)
    d, i = teval.metrics_from_counts(counts)
    wd, wi = jeval.frame_metrics_batch(jmasks, jnp.asarray(gt.numpy()))
    np.testing.assert_array_equal(_bits(d), _bits(wd))
    np.testing.assert_array_equal(_bits(i), _bits(wi))
    inbox = teval.box_masked(torch.ones_like(gt), torch.ones_like(valid),
                             boxes)
    for t in range(10):
        want = float(jotsu(jnp.asarray(g[t]), jnp.asarray(inbox[t].numpy())))
        assert float(thr[t]) == want
    _, only = otsu_counts(gray, None, valid, boxes)
    assert torch.equal(only[:, 1], masks.sum((1, 2)).to(torch.int32))
    assert not only[:, 0].any() and not only[:, 2].any()


def test_otsu_in_box_matches_cv2():
    """As tests/test_eval_core.py holds the JAX package: the inverted Otsu
    mask inside each box equals cv2's THRESH_OTSU on the crop."""
    rng = np.random.default_rng(18)
    g = rng.normal(170, 10, (2, 96, 128)).clip(0, 255)
    g[:, 30:60, 40:80] = rng.normal(40, 8, (2, 30, 40)).clip(0, 255)
    g = g.astype(np.uint8)
    boxes = np.array([[20, 10, 100, 80], [30, 20, 110, 90]], np.int32)
    got = teval.otsu_in_box_masks(torch.from_numpy(g),
                                  torch.ones(2, dtype=torch.bool),
                                  torch.from_numpy(boxes)).numpy()
    for t in range(2):
        x1, y1, x2, y2 = boxes[t]
        _, want_roi = cv2.threshold(g[t, y1:y2, x1:x2], 0, 255,
                                    cv2.THRESH_BINARY_INV + cv2.THRESH_OTSU)
        want = np.zeros_like(g[t])
        want[y1:y2, x1:x2] = want_roi
        np.testing.assert_array_equal(got[t], want > 0)


def test_count_wrappers_refuse_bad_input():
    m = torch.zeros(2, 8, 8, dtype=torch.bool)
    with pytest.raises(ValueError):
        frame_counts(m.float(), m)
    with pytest.raises(ValueError):
        frame_counts(m, m[:, :4])
    with pytest.raises(ValueError):
        frame_counts(m, m, torch.ones(2, dtype=torch.bool))
    with pytest.raises(ValueError):
        frame_counts(m, m, unmasked=True)
    with pytest.raises(ValueError):
        otsu_counts(m, m, torch.ones(2, dtype=torch.bool),
                    torch.zeros(2, 4, dtype=torch.int32))


# ── evaluate_patient and aggregate ──────────────────────────────────────────

def _pipes():
    return _memo("gp", lambda: GlottalPipelines(
        **_WEIGHTS, dtype=torch.float32, device="cpu"))


def _jpipes():
    return _memo("jgp", lambda: jpipe.GlottalPipelines(
        **{k: load_weights_npz(v) for k, v in _WEIGHTS.items()},
        dtype=jnp.float32))


def _clip(kind):
    """12 frames of 256² colour video, or 4 frames of 240x320 (h x w), with
    their synthetic_video masks as the ground truth."""
    def make():
        if kind == "256":
            f, m = synthetic_video(t=12, size=256, seed=5)
        else:
            f, m = synthetic_video(t=4, size=320, seed=6,
                                   center=(160.0, 160.0))
            f, m = f[:, 40:280], m[:, 40:280]
        f = f.astype(np.int16)
        f[..., 0] = f[..., 0] * 7 // 8           # colour: unequal channels
        f[..., 2] = np.minimum(f[..., 2] + 12, 255)
        return np.ascontiguousarray(f.astype(np.uint8)), np.ascontiguousarray(m)
    return _memo(("clip", kind), make)


def _jax_rows(kind):
    """The JAX package's evaluate_patient on the clip.  Its gated_boxes
    runs the detector at the frame's own size, which fails at 240 rows (the
    feature maps of 240 / 32 do not line up); there the gate is the JAX
    package's letterboxed ``_gated``, as in the port."""
    def make():
        f, m = _clip(kind)
        jp = _jpipes()
        old = jpipe.CHUNK
        jpipe.CHUNK = 12      # both clips: one set of compiled graphs
        try:
            if kind != "256":
                jp.gated_boxes = lambda fr, sequential=True: jp._gated(
                    fr, jbgr_to_gray(fr), sequential)
            return jeval.evaluate_patient(jp, f, m)
        finally:
            jpipe.CHUNK = old
            jp.__dict__.pop("gated_boxes", None)
    return _memo(("jrows", kind), make)


@pytest.mark.parametrize("kind", ["256", "240x320"])
def test_evaluate_patient_matches_jax_package(kind):
    f, m = _clip(kind)
    want = _jax_rows(kind)
    got = teval.evaluate_patient(_pipes(), f, m)
    assert list(got) == list(want) == teval.PIPELINES
    for name, w in want.items():
        g = got[name]
        n = len(f) - (YGVFT_INIT if name == "yolo+motion" else 0)
        assert g["dice"].shape == g["iou"].shape == w["dice"].shape == (n,)
        assert g["dice"].dtype == g["iou"].dtype == np.float32
        if w["det"] is None:
            assert g["det"] is None
        else:
            np.testing.assert_array_equal(g["det"], w["det"])
        if name == "yolo+otsu":
            np.testing.assert_array_equal(_bits(g["dice"]), _bits(w["dice"]))
            np.testing.assert_array_equal(_bits(g["iou"]), _bits(w["iou"]))
        else:
            np.testing.assert_allclose(g["dice"], w["dice"], atol=0.01)
            np.testing.assert_allclose(g["iou"], w["iou"], atol=0.01)
    agg, wagg = teval.aggregate({"p": got}), jeval.aggregate({"p": want})
    assert list(agg) == list(wagg)
    for name, row in agg.items():
        assert row["n_frames"] == wagg[name]["n_frames"]
        assert row["det_recall"] == wagg[name]["det_recall"]
        assert abs(row["dice"] - wagg[name]["dice"]) <= 0.01


def test_evaluate_patient_contracts():
    """Without a detector only unet-only; crop=False and no crop U-Net drop
    yolo-crop+unet; sequential=False drops yolo+motion and gates each frame
    on its own; gray input and a uint8 ground truth are taken."""
    f, m = _clip("256")
    f, m = f[:3], m[:3]
    only = GlottalPipelines(unet_variables=_WEIGHTS["unet_variables"],
                            dtype=torch.float32, device="cpu")
    rows = teval.evaluate_patient(only, f, m)
    assert list(rows) == ["unet-only"] and rows["unet-only"]["det"] is None
    rows = teval.evaluate_patient(_pipes(), f, m.astype(np.uint8) * 255,
                                  crop=False)
    assert list(rows) == ["unet-only", "yolo+otsu", "yolo+unet",
                          "yolo+motion"]
    no_crop = GlottalPipelines(unet_variables=_WEIGHTS["unet_variables"],
                               yolo_variables=_WEIGHTS["yolo_variables"],
                               dtype=torch.float32, device="cpu")
    rows = teval.evaluate_patient(no_crop, f[..., 1], m, sequential=False)
    assert list(rows) == ["unet-only", "yolo+otsu", "yolo+unet"]
    gray = torch.from_numpy(np.ascontiguousarray(f[..., 1]))
    valid, _ = no_crop.gated_boxes(gray, False)
    np.testing.assert_array_equal(rows["yolo+otsu"]["det"], valid.numpy())


def test_aggregate_matches_reference():
    """tests/test_eval_core.py's bookkeeping case, and a pipeline present in
    one patient only."""
    per = {"p1": {"unet-only": {"dice": np.array([1.0, 0.4]),
                                "iou": np.array([1.0, 0.3]), "det": None}},
           "p2": {"unet-only": {"dice": np.array([0.6]),
                                "iou": np.array([0.5]),
                                "det": np.array([True])},
                  "yolo+otsu": {"dice": np.array([0.2, 0.9]),
                                "iou": np.array([0.1, 0.8]),
                                "det": np.array([True, False])}}}
    assert teval.aggregate(per) == jeval.aggregate(per)
    row = teval.aggregate(per)["unet-only"]
    assert abs(row["dice"] - np.mean([1.0, 0.4, 0.6])) < 1e-9
    assert row["n_frames"] == 3 and abs(row["dice50"] - 200 / 3) < 1e-6
