"""BAGLS scripts, port vs JAX package, on the CPU: ``prepare_bagls_splits``,
``eval_bagls`` and ``sweep_bagls_conf``.

On a BAGLS-shaped tree written by the JAX package's
``scripts/make_synthetic_zenodo.py`` (cv2 PNGs of four sizes, letterboxed
on reading): the split JSON is byte-equal to the JAX script's;
``load_letterboxed`` is bit-equal to the JAX script's cv2 reads and resizes;
``detection_stats`` is equal on random and edge boxes; ``eval_bagls`` with
the demo weights in float32 gives per-frame Dice and IoU within
``EVAL_TOL`` (0.01 a frame, the mask tolerance of test_torch_port_eval.py)
of the JAX script's, the same detections and detection counts, and the
JSON layout with its timestamp suffix; ``sweep_bagls_conf`` gives the JAX
script's rows (layout, every τ's ``det_recall`` equal, Dice within the
tolerance) and its ``per_frame_dice_tau_*`` export.  Both packages' scripts
run through their command lines (the JAX package's pipelines in float32
with its CHUNK shrunk; the port's on ``--device cpu`` in float32).
"""

import functools
import importlib.util
import json
import runpy
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglottal_tpu import pipelines as jpipe
from openglottal_tpu_torch import cli
from openglottal_tpu_torch import pipelines as tpipe
from openglottal_tpu_torch.scripts import eval_bagls, prepare_bagls_splits

ROOT = Path(__file__).resolve().parents[1]
EVAL_TOL = 0.01
WEIGHTS = ["--unet-weights", str(ROOT / "weights" / "demo_unet.npz"),
           "--yolo-weights", str(ROOT / "weights" / "demo_yolo.npz"),
           "--crop-weights", str(ROOT / "weights" / "demo_unet.npz")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bagls(tmp_path_factory):
    """BAGLS/test (6 pairs) and BAGLS/training (5 pairs and an image
    without its mask), realistic synthetic frames of four sizes."""
    root = tmp_path_factory.mktemp("bagls")
    zen = _jax_script("make_synthetic_zenodo")
    zen.write_bagls(root / "test", 6, 7000, True)
    zen.write_bagls(root / "training", 5, 5000, True)
    (root / "training" / "9.png").write_bytes(
        (root / "training" / "0.png").read_bytes())
    return root


@pytest.fixture
def f32(monkeypatch):
    """Both packages' pipelines in float32 (the JAX package's CHUNK shrunk
    so that its graphs are small)."""
    monkeypatch.setattr(jpipe, "CHUNK", 8)
    monkeypatch.setattr(jpipe, "GlottalPipelines", functools.partial(
        jpipe.GlottalPipelines, dtype=jnp.float32))
    monkeypatch.setattr(tpipe, "GlottalPipelines", functools.partial(
        tpipe.GlottalPipelines, dtype=torch.float32))


def _run_jax(monkeypatch, name, argv):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    runpy.run_path(str(ROOT / "scripts" / f"{name}.py"), run_name="__main__")


@pytest.mark.parametrize("extra", [[], ["--max-images", "3"],
                                   ["--val-frac", "0.5", "--seed", "7"]])
def test_bagls_split_byte_equal_to_jax(bagls, tmp_path, monkeypatch, extra):
    d = str(bagls / "training")
    _run_jax(monkeypatch, "prepare_bagls_splits",
             ["--data-dir", d, "--output", str(tmp_path / "jax.json"), *extra])
    prepare_bagls_splits.main(["--data-dir", d, "--output",
                               str(tmp_path / "port.json"), *extra])
    want = (tmp_path / "jax.json").read_bytes()
    assert (tmp_path / "port.json").read_bytes() == want
    assert "9.png" not in want.decode()        # no mask, not in the split


def test_load_letterboxed_bit_equal_to_jax(bagls):
    jax_eval = _jax_script("eval_bagls")
    for max_images in (0, 4):
        want = jax_eval.load_letterboxed(bagls / "test", max_images)
        got = eval_bagls.load_letterboxed(bagls / "test", max_images)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    assert got[0].shape == (4, 256, 256, 3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detection_stats_equal(seed):
    jax_eval = _jax_script("eval_bagls")
    rng = np.random.default_rng(seed)
    n = 40
    gts = np.zeros((n, 32, 48), bool)
    for i in range(n):
        if rng.random() < 0.8:
            y, x = rng.integers(0, 32), rng.integers(0, 48)
            gts[i, y:y + rng.integers(1, 6), x:x + rng.integers(1, 6)] = True
    valid = rng.random(n) < 0.7
    boxes = rng.integers(-10, 60, (n, 4)).astype(np.float32)
    boxes[::7] = [0, 0, 48, 32]                 # whole frame
    boxes[1::9] = [60, 40, 70, 50]              # outside
    got = eval_bagls.detection_stats(valid, boxes, gts)
    assert got == jax_eval.detection_stats(valid, boxes, gts)
    assert min(got["tp"], got["fp"], got["fn"]) > 0    # every branch taken


def _saved(out_dir: Path, stem: str) -> dict:
    (path,) = sorted(out_dir.glob(f"{stem}_*.json"))
    # <stem>_YYYYmmdd_HHMMSS.json
    stamp = path.stem[len(stem) + 1:]
    assert len(stamp) == 15 and stamp[8] == "_" and stamp.replace(
        "_", "").isdigit()
    return json.loads(path.read_text())


def test_eval_bagls_matches_jax_script(bagls, tmp_path, monkeypatch, f32):
    argv = ["--test-dir", str(bagls / "test"), *WEIGHTS, "--crop-pad", "6"]
    _run_jax(monkeypatch, "eval_bagls",
             [*argv, "--output-json", str(tmp_path / "jax" / "b.json")])
    cli.main(["eval-bagls", *argv, "--output-json",
              str(tmp_path / "port" / "b.json"), "--device", "cpu"])
    want = _saved(tmp_path / "jax", "b")
    got = _saved(tmp_path / "port", "b")
    assert list(got) == list(want) == ["unet-only", "yolo+unet",
                                       "yolo-crop+unet", "det_stats"]
    assert got["det_stats"] == want["det_stats"]
    for p in ("unet-only", "yolo+unet", "yolo-crop+unet"):
        assert got[p]["det"] == want[p]["det"]
        for k in ("dice", "iou"):
            assert len(got[p][k]) == len(want[p][k]) == 6
            np.testing.assert_allclose(got[p][k], want[p][k], atol=EVAL_TOL,
                                       rtol=0, err_msg=f"{p} {k}")


def test_sweep_bagls_matches_jax_script(bagls, tmp_path, monkeypatch, f32):
    argv = ["--test-dir", str(bagls / "test"), *WEIGHTS, "--max-images", "4",
            "--export-dice-tau", "0.05"]
    _run_jax(monkeypatch, "sweep_bagls_conf",
             [*argv, "--output-json", str(tmp_path / "jax.json")])
    out = cli.main(["sweep-bagls", *argv, "--output-json",
                    str(tmp_path / "port.json"), "--device", "cpu"])
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert out == got
    assert list(got) == list(want) == ["sweep", "per_frame_dice_tau_0.05"]
    assert [r["tau"] for r in got["sweep"]] == [r["tau"] for r in
                                                want["sweep"]]
    for g, w in zip(got["sweep"], want["sweep"]):
        assert g.keys() == w.keys() and g["full"].keys() == w["full"].keys()
        assert g["det_recall"] == w["det_recall"]
        for part in ("full", "crop"):
            for k in ("dice", "iou"):
                assert abs(g[part][k] - w[part][k]) <= EVAL_TOL
    np.testing.assert_allclose(got["per_frame_dice_tau_0.05"],
                               want["per_frame_dice_tau_0.05"],
                               atol=EVAL_TOL, rtol=0)


def test_eval_commands_default_to_the_card(bagls):
    """Without --device the commands run on the CUDA device, and raise
    where there is none (no silent CPU run)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves")
    for cmd in ("eval-bagls", "sweep-bagls"):
        with pytest.raises(RuntimeError):
            cli.main([cmd, "--test-dir", str(bagls / "test"), *WEIGHTS])
