"""The slice as a whole, port vs JAX package on the CPU, at full width with
the demo weights: ``guided-vft`` on 12 frames and ``unet`` on 4 frames of a
synthetic video, float32; plus the entry point's edge contracts, the device
rule and the import hygiene of the port.

The JAX side runs the modular functions on exactly these frames
(``_yolo_chunk_gray`` -> ``gate_scan`` -> ``ygvft_parallel``), not the fused
whole-video entry, which pads every video to 128 frames.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglottal_tpu import pipelines as jpipe
from openglottal_tpu.data.synthetic import synthetic_video as jax_synthetic_video
from openglottal_tpu.models import fold as jfold
from openglottal_tpu.models.gate import gate_scan as jgate_scan
from openglottal_tpu.models.tracker import YGVFTParams as JYGVFTParams
from openglottal_tpu.models.tracker import ygvft_parallel as jygvft_parallel
from openglottal_tpu.models.unet import UNet as JUNet
from openglottal_tpu_torch.data.synthetic import synthetic_video
from openglottal_tpu_torch.models.tracker import ygvft_parallel
from openglottal_tpu_torch.pipelines import (
    YGVFT_INIT,
    GlottalPipelines,
    _box_area_sums,
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


def _video():
    if "video" not in _MEMO:
        frames, _ = synthetic_video(t=12, size=256, seed=5)
        _MEMO["video"] = frames
    return _MEMO["video"]


def _pipes():
    if "gp" not in _MEMO:
        _MEMO["gp"] = GlottalPipelines(
            unet_variables="weights/demo_unet.npz",
            yolo_variables="weights/demo_yolo.npz",
            dtype=torch.float32, device="cpu")
    return _MEMO["gp"]


def _jax_detect_gate():
    """JAX detector + gate on the 12 frames (folded, float32)."""
    if "jdg" not in _MEMO:
        gray = _video()[..., 0]
        yv = jfold.fold_yolo(load_weights_npz("weights/demo_yolo.npz"))
        has, raw, conf = jpipe._yolo_chunk_gray(
            yv, jnp.asarray(gray), conf=0.25, dtype=jnp.float32, fuse=True)
        valid, boxes = jgate_scan(has, raw, 256, 256)
        _MEMO["jdg"] = tuple(np.array(a) for a in
                             (has, raw, conf, valid, boxes))
    return _MEMO["jdg"]


def _jax_tracker(valid, boxes):
    gray = _video()[..., 0].astype(np.float32)
    vin = valid[:YGVFT_INIT]
    fi = int(np.argmax(vin))
    masks, areas = jygvft_parallel(
        jnp.asarray(gray[:YGVFT_INIT]), jnp.asarray(bool(vin.any())),
        jnp.asarray(boxes[fi]), jnp.asarray(gray[YGVFT_INIT:]),
        jnp.asarray(valid[YGVFT_INIT:]), jnp.asarray(boxes[YGVFT_INIT:]),
        params=JYGVFTParams())
    return np.asarray(masks), np.asarray(areas)


def test_synthetic_video_is_the_same_video():
    a, am = synthetic_video(t=5, size=64, seed=9, center=(32.0, 32.0))
    b, bm = jax_synthetic_video(t=5, size=64, seed=9, center=(32.0, 32.0))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(am, bm)
    assert is_monochrome(a) and not is_monochrome(a[..., 0])


def test_detector_matches_jax_on_the_slice_video():
    """Full-width detector, folded, f32: confidences within 1e-4, raw boxes
    within 1e-3 px (conv summation order), same has flags."""
    jhas, jraw, jconf, _, _ = _jax_detect_gate()
    has, raw, conf = _pipes().detect_video_gray(_video()[..., 0])
    assert jhas.all(), "the demo detector fires on every frame of this video"
    np.testing.assert_array_equal(has.numpy(), jhas)
    np.testing.assert_allclose(conf.numpy(), jconf, atol=1e-4, rtol=0)
    np.testing.assert_allclose(raw.numpy(), jraw, atol=1e-3, rtol=0)


def test_gate_outputs_exact_on_the_slice_video():
    _, jraw, _, jvalid, jboxes = _jax_detect_gate()
    gp = _pipes()
    valid, boxes = gp._detect_gate(gp._to_gray(_video()[..., 0]))
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    bad = np.nonzero((boxes.numpy() != jboxes).any(1))[0]
    assert bad.size == 0, (
        f"gate boxes differ on frames {bad.tolist()}: the raw boxes agree to "
        f"1e-3 px, so a difference means a coordinate sits within float noise "
        f"of an integer where the gate truncates; raw (JAX) = "
        f"{jraw[bad].tolist()}")


def test_tracker_exact_given_the_jax_gate_outputs():
    """Same (valid, boxes) into both trackers: masks and areas identical."""
    _, _, _, jvalid, jboxes = _jax_detect_gate()
    jmasks, jareas = _jax_tracker(jvalid, jboxes)
    gray = torch.from_numpy(_video()[..., 0].copy())
    vin = torch.from_numpy(jvalid[:YGVFT_INIT])
    fi = int(np.argmax(jvalid[:YGVFT_INIT]))
    masks, areas = ygvft_parallel(
        gray[:YGVFT_INIT], vin.any(), torch.from_numpy(jboxes[fi]),
        gray[YGVFT_INIT:], torch.from_numpy(jvalid[YGVFT_INIT:]),
        torch.from_numpy(jboxes[YGVFT_INIT:]))
    assert jareas.min() > 0, "every tracked frame has a non-empty blob mask"
    np.testing.assert_array_equal(masks.numpy(), jmasks)
    np.testing.assert_array_equal(areas.numpy(), jareas)


def test_guided_vft_areas_end_to_end_exact():
    _, _, _, jvalid, jboxes = _jax_detect_gate()
    _, jareas = _jax_tracker(jvalid, jboxes)
    areas = _pipes().guided_vft_areas_gray(_video()[..., 0])
    assert areas.dtype == np.float32 and areas.shape == (12,)
    assert (areas[:YGVFT_INIT] == 0).all()
    np.testing.assert_array_equal(areas[YGVFT_INIT:], jareas)
    feats = _pipes().extract_features(_video(), "guided-vft")   # (T,H,W,3)
    np.testing.assert_array_equal(feats["_area"], areas)


def test_unet_areas_within_the_borderline_pixel_count():
    """4 frames through detector + gate + U-Net: per-frame areas may differ
    from the JAX package's by at most the number of in-box pixels whose JAX
    logit lies within 1e-3 of the decision threshold 0."""
    gray = _video()[:4, ..., 0]
    uv = jfold.absorb_u8_scale(
        jfold.fold_unet(load_weights_npz("weights/demo_unet.npz")),
        jfold.UNET_STEM)
    logits = np.asarray(JUNet(dtype=jnp.float32, fuse_bn=True).apply(
        uv, jnp.asarray(gray, jnp.float32)[..., None], train=False))[..., 0]
    _, _, _, jvalid, jboxes = _jax_detect_gate()
    # the gate is causal, so its first 4 outputs are those of a 4-frame scan
    v, b = torch.from_numpy(jvalid[:4]), torch.from_numpy(jboxes[:4])
    want = _box_area_sums(torch.from_numpy(logits > 0), v, b).numpy()
    slack = _box_area_sums(torch.from_numpy(np.abs(logits) < 1e-3), v, b
                           ).numpy()
    np.testing.assert_array_equal(
        want, np.asarray(jpipe._box_area_sums(
            jnp.asarray(logits > 0), jnp.asarray(jvalid[:4]),
            jnp.asarray(jboxes[:4]))))
    got = _pipes().yolo_unet_areas_gray(gray).numpy()
    assert want.min() > 0
    assert (np.abs(got - want) <= slack).all(), (got, want, slack)


# ── edge contracts of the entry point ───────────────────────────────────────

def test_empty_video_is_none():
    gp = _pipes()
    assert gp.extract_features(np.zeros((0, 256, 256), np.uint8),
                               "guided-vft") is None
    assert gp.extract_features([], "unet") is None


def test_too_few_frames_for_guided_vft_is_none():
    assert _pipes().extract_features(_video()[:3, ..., 0], "guided-vft") is None


def test_no_detections_is_none():
    gp = GlottalPipelines(unet_variables="weights/demo_unet.npz",
                          yolo_variables="weights/demo_yolo.npz", conf=0.999,
                          dtype=torch.float32, device="cpu")
    frames = _video()[:4, ..., 0]
    assert gp.extract_features(frames, "guided-vft") is None
    assert gp.extract_features(frames, "unet") is None


def test_unknown_pipeline_is_value_error():
    with pytest.raises(ValueError):
        _pipes().extract_features(_video()[:4], "nope")


@pytest.mark.parametrize("pipeline", ["vft", "crop-unet", "unet-only"])
def test_later_pipelines_raise_not_implemented(pipeline):
    with pytest.raises(NotImplementedError):
        _pipes().extract_features(_video()[:4], pipeline)


@pytest.mark.parametrize("case", ["colour", "size", "mesh", "quant", "window",
                                  "crop"])
def test_later_options_raise_not_implemented(case):
    if case == "colour":
        f = _video()[:4].copy()
        f[..., 1] += 1
        with pytest.raises(NotImplementedError):
            _pipes().extract_features(f, "unet")
    elif case == "size":
        with pytest.raises(NotImplementedError):
            _pipes().extract_features(np.zeros((4, 128, 128), np.uint8), "unet")
    else:
        kw = {"mesh": {"mesh": object()}, "quant": {"quant": "int8"},
              "window": {"window_decoder": True},
              "crop": {"crop_unet_variables": {}}}[case]
        with pytest.raises(NotImplementedError):
            GlottalPipelines(device="cpu", **kw)


def test_device_none_raises_without_cuda():
    """No silent CPU run: without a CUDA device the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves")
    with pytest.raises(RuntimeError):
        GlottalPipelines()


def test_port_imports_no_jax_no_reference_package_no_cv2():
    code = (
        "import sys, importlib, pkgutil\n"
        "import openglottal_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'orbax', 'cv2', 'openglottal_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'torch' in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(_repo_root()))
    assert r.returncode == 0, r.stderr[-2000:]


def _repo_root():
    from pathlib import Path
    return Path(__file__).resolve().parent.parent
