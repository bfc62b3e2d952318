"""The slices as a whole, port vs JAX package on the CPU, at full width with
the demo weights: ``guided-vft`` and ``vft`` on 12 frames and ``unet`` on 4
frames of a synthetic video, float32; plus the entry point's edge contracts,
the sequential tracker forms, the device rule and the import hygiene of the
port.

The JAX side runs the modular functions on exactly these frames
(``_yolo_chunk_gray`` -> ``gate_scan`` -> ``ygvft_parallel``, or ->
``_gather_crops`` -> ``vft_parallel``), not the fused whole-video entries,
which pad every video to 128 frames.
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
from openglottal_tpu.models.tracker import VFTParams as JVFTParams
from openglottal_tpu.models.tracker import YGVFTParams as JYGVFTParams
from openglottal_tpu.models.tracker import vft_parallel as jvft_parallel
from openglottal_tpu.models.tracker import ygvft_parallel as jygvft_parallel
from openglottal_tpu.models.unet import UNet as JUNet
from openglottal_tpu_torch.data.synthetic import synthetic_video
from openglottal_tpu_torch.models.tracker import ygvft_parallel
from openglottal_tpu_torch.pipelines import (
    VFT_INIT,
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
    valid, boxes = gp._gated(None, gp._to_gray(_video()[..., 0]))
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


def _jax_vft_areas(valid, boxes):
    """The reference's modular vft path on the 12 frames, given the gate's
    outputs: size-locked crops of the valid frames, one frame-parallel
    tracker pass, init crops zeroed.  Returns (areas (12,), (h0, w0))."""
    gray = _video()[..., 0]
    idx = np.nonzero(valid)[0]
    b0 = boxes[idx[0]]
    w0, h0 = int(b0[2] - b0[0]), int(b0[3] - b0[1])
    crops = jpipe._gather_crops(jnp.asarray(gray[idx]),
                                jnp.asarray(boxes[idx]), h0, w0)
    _, areas_v = jvft_parallel(crops[:VFT_INIT], crops,
                               jnp.arange(len(idx)) >= VFT_INIT,
                               params=JVFTParams())
    areas = np.zeros(len(gray), np.float32)
    areas[idx] = np.asarray(areas_v)
    areas[idx[:VFT_INIT]] = 0.0
    return areas, (h0, w0)


def test_vft_areas_end_to_end_exact():
    """Detector -> gate -> size-locked crops -> tracker, both packages from
    the same 12 frames.  The gate boxes are equal (held above), the crops are
    equal after rounding, so the only float stage that may differ is the
    motion map (the reference's reassociated prefix); areas are pixel counts
    and every frame's count must be equal."""
    _, _, _, jvalid, jboxes = _jax_detect_gate()
    jareas, (h0, w0) = _jax_vft_areas(jvalid, jboxes)
    gp = _pipes()
    areas = gp.vft_areas_gray(_video()[..., 0])
    assert areas.dtype == np.float32 and areas.shape == (12,)
    assert (areas[:VFT_INIT] == 0).all() and areas[VFT_INIT:].min() > 0
    differing = np.nonzero(areas != jareas)[0]
    assert differing.size == 0, (
        f"vft areas differ on frames {differing.tolist()} "
        f"(crop size {h0}x{w0}): {areas[differing]} vs {jareas[differing]}")
    gray = gp._to_gray(_video()[..., 0])
    valid, boxes = gp._gated(None, gray)
    _, cmasks, idx, hw0 = gp._vft_compute(gray, valid, boxes, 12,
                                          want_masks=True)
    assert hw0 == (h0, w0) and cmasks.shape == (12, h0, w0)
    np.testing.assert_array_equal(idx, np.arange(12))
    feats = gp.extract_features(_video(), "vft")            # (T, H, W, 3)
    np.testing.assert_array_equal(feats["_area"], areas)
    np.testing.assert_array_equal(gp.vft_areas(_video()), areas)


def test_vft_contracts():
    """Fewer than VFT_INIT + 5 frames -> None; fewer than VFT_INIT + 1 gated
    frames, or an empty first box -> all-zero areas (a silent waveform, so
    no features)."""
    gp = _pipes()
    gray = _video()[..., 0]
    assert gp.vft_areas_gray(gray[:6]) is None
    assert gp.extract_features(gray[:6], "vft") is None
    assert gp.vft_areas_gray(gray[:7]) is not None
    g = gp._to_gray(gray)
    boxes = torch.tensor([[100, 90, 150, 170]] * 12, dtype=torch.int32)
    two = torch.zeros(12, dtype=torch.bool)
    two[[3, 7]] = True
    areas, cm, idx, hw0 = gp._vft_compute(g, two, boxes, 12)
    assert not areas.any() and cm is None and hw0 == (0, 0)
    assert idx.tolist() == [3, 7]
    empty_first = boxes.clone()
    empty_first[0] = torch.tensor([100, 90, 100, 170])
    areas, _, _, hw0 = gp._vft_compute(g, torch.ones(12, dtype=torch.bool),
                                       empty_first, 12)
    assert not areas.any() and hw0 == (0, 0)
    # frames without a box are skipped, not tracked: they emit 0
    some = torch.ones(12, dtype=torch.bool)
    some[[0, 5]] = False
    areas, _, idx, _ = gp._vft_compute(g, some, boxes, 12)
    assert idx.tolist() == [1, 2, 3, 4, 6, 7, 8, 9, 10, 11]
    assert (areas[[0, 5, 1, 2]] == 0).all() and areas[[3, 4, 6, 11]].min() > 0


@pytest.mark.parametrize("pipeline", ["vft", "guided-vft"])
def test_sequential_trackers_agree_with_parallel(pipeline):
    """``parallel_trackers=False`` routes through the per-frame scans; areas
    within 2.0 px of the frame-parallel form (the reference's own pin
    between its forms; here the recurrences are the same, so only the
    single-frame vs batched blur can differ)."""
    gp = _pipes()
    if "seq" not in _MEMO:
        _MEMO["seq"] = GlottalPipelines(
            yolo_variables="weights/demo_yolo.npz", dtype=torch.float32,
            device="cpu", parallel_trackers=False)
    seq = _MEMO["seq"]
    assert gp.parallel_trackers and not seq.parallel_trackers
    frames = _video()[:9, ..., 0]
    a_par = gp.extract_features(frames, pipeline)["_area"]
    a_seq = seq.extract_features(frames, pipeline)["_area"]
    assert a_par[2:].min() > 0
    np.testing.assert_allclose(a_seq, a_par, atol=2.0, rtol=0)


@pytest.mark.parametrize("pipeline", ["vft", "guided-vft"])
def test_split_blob_route_gives_the_same_waveform(pipeline, monkeypatch):
    """``vft_parallel`` sends its blob filters through single-region CC
    passes, ``ygvft_parallel`` through the dual-region ones; with each
    tracker's route swapped for the other no area changes."""
    from openglottal_tpu_torch.models import tracker as tracker_mod
    from openglottal_tpu_torch.ops import blobs as blobs_mod

    frames = _video()[:9, ..., 0]
    a = _pipes().extract_features(frames, pipeline)["_area"]
    routes = []

    def swapped(masks, n, use_plain=False, _split=False):
        routes.append(_split)
        return blobs_mod.top_n_blobs_batch(masks, n, use_plain, not _split)

    monkeypatch.setattr(tracker_mod, "top_n_blobs_batch", swapped)
    monkeypatch.setattr(tracker_mod, "largest_blob_batch",
                        lambda masks, use_plain=False, _split=False:
                        swapped(masks, 1, use_plain, _split))
    b = _pipes().extract_features(frames, pipeline)["_area"]
    assert routes == ([True, True] if pipeline == "vft" else [False])
    np.testing.assert_array_equal(a, b)


def test_ygvft_eval_masks_shape_and_areas():
    gp = _pipes()
    gray = gp._to_gray(_video()[:6, ..., 0])
    valid, boxes = gp._gated(None, gray)
    masks = gp.ygvft_eval_masks(gray, valid, boxes)
    assert masks.shape == (6 - YGVFT_INIT, 256, 256)
    assert masks.dtype == torch.bool
    areas = gp.guided_vft_areas_gray(_video()[:6, ..., 0])
    np.testing.assert_array_equal(masks.sum((1, 2)).numpy(),
                                  areas[YGVFT_INIT:])


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


@pytest.mark.parametrize("case", ["mesh", "quant"])
def test_later_options_raise_not_implemented(case):
    """Meshes wait for a later slice.  int8 serving is served
    (tests/test_torch_port_quant.py): without folded weights it raises
    ValueError, as the JAX package's constructor does."""
    if case == "mesh":
        with pytest.raises(NotImplementedError):
            GlottalPipelines(device="cpu", mesh=object())
        return
    with pytest.raises(ValueError, match="folded"):
        GlottalPipelines(device="cpu", quant="int8")


def test_device_none_raises_without_cuda():
    """No silent CPU run: without a CUDA device the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves")
    with pytest.raises(RuntimeError):
        GlottalPipelines()


_BANNED = ("jax", "jaxlib", "flax", "orbax", "cv2", "PIL",
           "openglottal_tpu")


def _imports_of(path):
    """(line, module) of every import in a Python source, at any depth (an
    import inside a function too), and of every ``import_module`` /
    ``__import__`` call on a string literal."""
    import ast

    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.append((node.lineno, node.module or ""))
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            found.append((node.lineno, node.args[0].value))
    return found


# optional packages the card's machine lacks: imported only inside the
# functions that need them (plots, HDF5), never when a module is imported
_LAZY_ONLY = ("matplotlib", "h5py")


def _module_level_imports(path):
    """(line, module) of the imports of a source that run when it is
    imported: those outside every function body."""
    import ast

    tree = ast.parse(path.read_text(), str(path))
    inside = {id(n) for f in ast.walk(tree)
              if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
              for n in ast.walk(f)}
    found = []
    for node in ast.walk(tree):
        if id(node) in inside:
            continue
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.append((node.lineno, node.module or ""))
    return found


def test_port_imports_no_jax_no_reference_package_no_cv2():
    """Importing every module of the port and chip_smoke.py loads none of
    the banned packages, nor matplotlib or h5py; no source of the port, nor
    chip_smoke.py, imports a banned package anywhere, a lazy import inside
    a function included; and matplotlib and h5py are imported only inside
    functions (the scripts of ``scripts/`` among the sources scanned)."""
    code = (
        "import sys, importlib, pkgutil\n"
        "import openglottal_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{_BANNED + _LAZY_ONLY!r}]\n"
        "assert not bad, bad\n"
        "assert 'torch' in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(_repo_root()))
    assert r.returncode == 0, r.stderr[-2000:]
    root = _repo_root()
    sources = sorted((root / "openglottal_tpu_torch").rglob("*.py"))
    sources.append(root / "chip_smoke.py")
    assert len(sources) > 20
    scripts = {p.stem for p in sources if p.parent.name == "scripts"}
    assert {"selftest_e2e", "prepare_girafe_splits", "prepare_bagls_splits",
            "eval_girafe", "eval_bagls", "sweep_bagls_conf", "analyze_gaw",
            "plot_gaw"} <= scripts
    bad = [f"{p.relative_to(root)}:{line} imports {mod}"
           for p in sources for line, mod in _imports_of(p)
           if mod.split(".")[0] in _BANNED]
    assert not bad, bad
    eager = [f"{p.relative_to(root)}:{line} imports {mod} at module level"
             for p in sources for line, mod in _module_level_imports(p)
             if mod.split(".")[0] in _LAZY_ONLY]
    assert not eager, eager
    lazy = {p.stem for p in sources for _, mod in _imports_of(p)
            if mod.split(".")[0] == "matplotlib"}
    assert lazy == {"analyze_gaw", "plot_gaw"}


def _repo_root():
    from pathlib import Path
    return Path(__file__).resolve().parent.parent
