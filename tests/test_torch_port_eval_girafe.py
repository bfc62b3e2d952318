"""GIRAFE scripts, port vs JAX package, on the CPU:
``prepare_girafe_splits`` and ``eval_girafe``.

On a GIRAFE-shaped tree written by the JAX package's
``scripts/make_synthetic_zenodo.py`` (the four fixed test patients and one
training patient, three annotated frames each, cv2 PNGs; Raw_Data with
metadata.json): the split JSON is byte-equal to the JAX script's; the
frames the port's script reads are bit-equal to ``cv2.imread``'s
(IMREAD_COLOR, IMREAD_GRAYSCALE > 0); the pathology map is equal; and
``eval_girafe`` with the demo weights in float32 writes the JAX script's
``--output-json`` layout with every pipeline's per-frame Dice within
``EVAL_TOL`` (0.01 a frame, the mask tolerance of test_torch_port_eval.py)
and the same frame counts and detection recall.  Both scripts run through
their command lines (the JAX package's pipelines in float32 with its CHUNK
shrunk; the port's on ``--device cpu`` in float32).
"""

import functools
import importlib.util
import json
import runpy
import sys
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglottal_tpu import pipelines as jpipe
from openglottal_tpu_torch import cli
from openglottal_tpu_torch import pipelines as tpipe
from openglottal_tpu_torch.scripts import eval_girafe, prepare_girafe_splits

ROOT = Path(__file__).resolve().parents[1]
EVAL_TOL = 0.01
TEST_IDS = ["57A3", "61", "63", "64"]


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
def girafe(tmp_path_factory):
    root = tmp_path_factory.mktemp("girafe")
    zen = _jax_script("make_synthetic_zenodo")
    for idx, pid in enumerate(["01"] + TEST_IDS):
        zen.write_patient(root, pid, idx, 3, 6, True)
    return root


def _run_jax(monkeypatch, name, argv):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    runpy.run_path(str(ROOT / "scripts" / f"{name}.py"), run_name="__main__")


@pytest.mark.parametrize("extra", [[], ["--val-frac", "0.34", "--seed", "3"]])
def test_girafe_split_byte_equal_to_jax(girafe, tmp_path, monkeypatch, extra):
    d = str(girafe / "Training" / "imagesTr")
    _run_jax(monkeypatch, "prepare_girafe_splits",
             ["--images-dir", d, "--output", str(tmp_path / "jax.json"),
              *extra])
    prepare_girafe_splits.main(["--images-dir", d, "--output",
                                str(tmp_path / "port.json"), *extra])
    want = (tmp_path / "jax.json").read_bytes()
    assert (tmp_path / "port.json").read_bytes() == want
    assert len(json.loads(want)["test"]) == 12


def test_girafe_reads_bit_equal_to_cv2(girafe):
    img_dir = girafe / "Training" / "imagesTr"
    lbl_dir = girafe / "Training" / "labelsTr"
    names = sorted(p.name for p in img_dir.iterdir())
    frames, gts = eval_girafe.load_patient_frames(img_dir, lbl_dir, names)
    want_f = np.stack([cv2.imread(str(img_dir / n)) for n in names])
    want_g = np.stack([cv2.imread(str(lbl_dir / n), cv2.IMREAD_GRAYSCALE) > 0
                       for n in names])
    np.testing.assert_array_equal(frames, want_f)
    np.testing.assert_array_equal(gts, want_g)
    assert frames.shape == (15, 256, 256, 3) and gts.any()


def test_pathology_map_equal(girafe):
    raw = girafe / "Raw_Data"
    want = _jax_script("eval_girafe").load_patient_to_pathology(raw)
    assert eval_girafe.load_patient_to_pathology(raw) == want
    assert len(want) == 5


def test_eval_girafe_matches_jax_script(girafe, tmp_path, monkeypatch):
    monkeypatch.setattr(jpipe, "CHUNK", 4)
    monkeypatch.setattr(jpipe, "GlottalPipelines", functools.partial(
        jpipe.GlottalPipelines, dtype=jnp.float32))
    monkeypatch.setattr(tpipe, "GlottalPipelines", functools.partial(
        tpipe.GlottalPipelines, dtype=torch.float32))
    split = tmp_path / "training.json"
    prepare_girafe_splits.main(["--images-dir",
                                str(girafe / "Training" / "imagesTr"),
                                "--output", str(split)])
    argv = ["--images-dir", str(girafe / "Training" / "imagesTr"),
            "--labels-dir", str(girafe / "Training" / "labelsTr"),
            "--training-json", str(split),
            "--raw-data-dir", str(girafe / "Raw_Data"),
            "--unet-weights", str(ROOT / "weights" / "demo_unet.npz"),
            "--yolo-weights", str(ROOT / "weights" / "demo_yolo.npz")]
    _run_jax(monkeypatch, "eval_girafe",
             [*argv, "--output-json", str(tmp_path / "jax.json")])
    out = cli.main(["eval-girafe", *argv, "--output-json",
                    str(tmp_path / "port.json"), "--device", "cpu"])
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert list(got) == list(want) == ["aggregate", "per_frame_dice"]
    pipes = ["unet-only", "yolo+otsu", "yolo+unet", "yolo-crop+unet",
             "yolo+motion"]
    assert list(got["aggregate"]) == list(want["aggregate"]) == pipes
    assert list(out["per_patient"]) == [f"patient{p}" for p in TEST_IDS]
    for p in pipes:
        g, w = got["aggregate"][p], want["aggregate"][p]
        assert g.keys() == w.keys()
        assert g["n_frames"] == w["n_frames"] == (12 if p != "yolo+motion"
                                                  else 4)
        assert g["det_recall"] == w["det_recall"]
        np.testing.assert_allclose(got["per_frame_dice"][p],
                                   want["per_frame_dice"][p], atol=EVAL_TOL,
                                   rtol=0, err_msg=p)
