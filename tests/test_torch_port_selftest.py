"""The end-to-end self-test (``scripts/selftest_e2e.py``), port vs JAX
package, on the CPU.

``make_dataset`` (frames, masks, boxes) is bit-equal to the JAX script's at
a reduced count, in both domains; the command line keeps the JAX script's
flags and defaults (read from its source with ``ast``) and adds
``--device``; the gates are the JAX script's names and expressions (held on
the JAX package's committed artifact, where every gate passes, and on edge
reports); a tiny form of the whole self-test (U-Net features 8-64, float32,
one epoch each, a few frames) runs and writes a report with every key of
the JAX script's.  The gates' values are not checked here: a tiny run does
not train.
"""

import ast
import functools
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from openglottal_tpu_torch.scripts import selftest_e2e as st

ROOT = Path(__file__).resolve().parents[1]
JAX_SCRIPT = ROOT / "scripts" / "selftest_e2e.py"
ROW_KEYS = {"dice", "iou", "dice50", "det_recall", "n_frames"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_selftest_e2e",
                                                  JAX_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_main_ast():
    tree = ast.parse(JAX_SCRIPT.read_text())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")


def _jax_gate_names() -> list:
    """The gate names of the JAX script's main, in order: the ``gates``
    dict literal's keys, then each ``gates[...] = `` under --realistic."""
    names = []
    for node in ast.walk(_jax_main_ast()):
        if isinstance(node, ast.Assign):
            t = node.targets[0]
            if isinstance(t, ast.Name) and t.id == "gates":
                names += [k.value for k in node.value.keys]
            elif (isinstance(t, ast.Subscript)
                  and isinstance(t.value, ast.Name) and t.value.id == "gates"):
                names.append(t.slice.value)
    return names


def _jax_report_keys() -> list:
    """The keys the JAX script's main writes into ``report`` beside the
    aggregate rows."""
    return [n.targets[0].slice.value for n in ast.walk(_jax_main_ast())
            if isinstance(n, ast.Assign)
            and isinstance(n.targets[0], ast.Subscript)
            and isinstance(n.targets[0].value, ast.Name)
            and n.targets[0].value.id == "report"]


def _jax_flags() -> dict:
    """--flag -> default of the JAX script's argparse calls."""
    out = {}
    for node in ast.walk(_jax_main_ast()):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            default = (ast.literal_eval(kw["default"]) if "default" in kw
                       else False)
            out[node.args[0].value] = default
    return out


@pytest.mark.parametrize("realistic", [False, True])
def test_make_dataset_bit_equal_to_jax_script(realistic):
    want = _jax_script().make_dataset(2, 3, seed0=100, realistic=realistic)
    got = st.make_dataset(2, 3, seed0=100, realistic=realistic)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_command_line_keeps_the_jax_flags_and_defaults():
    args = st.build_parser().parse_args([])
    flags = _jax_flags()
    assert flags == {"--epochs-unet": 60, "--patience-unet": 15,
                     "--epochs-crop": 40, "--epochs-yolo": 20,
                     "--realistic": False, "--output-dir": "outputs/selftest"}
    for flag, default in flags.items():
        assert getattr(args, flag[2:].replace("-", "_")) == default, flag
    assert args.device is None
    assert st.build_parser().parse_args(["--realistic"]).realistic


def test_gate_names_are_the_jax_scripts():
    names = _jax_gate_names()
    assert len(names) == 10
    assert list(st.GATES) == names
    assert list(st.REALISTIC_ONLY) == names[7:]
    report = json.loads((ROOT / "results" /
                         "selftest_eval_realistic_r5.json").read_text())
    assert list(st.evaluate_gates(report, realistic=True)) == names
    assert list(st.evaluate_gates(report, realistic=False)) == names[:7]


def test_gates_on_the_jax_artifact_all_pass():
    """The JAX package's committed realistic self-test passes every gate
    (its run printed SELFTEST PASS); the port's gate expressions agree."""
    report = json.loads((ROOT / "results" /
                         "selftest_eval_realistic_r5.json").read_text())
    assert all(st.evaluate_gates(report, realistic=True).values())
    assert st.gate_value(report, "int8_delta<0.01") == pytest.approx(
        0.9941307537257671 - 0.9939606510102749)
    assert st.gate_value(report, "ordering_margin>0.15") == pytest.approx(
        0.994095292687416 - 0.2860454682726413)


@pytest.mark.parametrize("gate,key,value,passes", [
    ("unet_only>0.85", ("unet-only", "dice"), 0.85, False),
    ("yolo+unet>0.8", ("yolo+unet", "dice"), 0.8000001, True),
    ("recall>0.9", ("yolo_final_recall",), None, False),
    ("int8_delta<0.01", ("unet_only_dice_int8",), 0.98, False),
    ("crop_recovery", ("crop_dice_zeroshot",), 0.5, False),
    ("int8full_rel_l1<0.05", ("int8full_waveform_rel_l1",), 0.05, False),
    ("windowed_rel_l1<0.05", ("windowed_waveform_rel_l1",), 0.0499, True),
    ("otsu<0.5", ("yolo+otsu", "dice"), 0.5, False),
    ("motion<0.6", ("yolo+motion", "dice"), 0.59, True),
])
def test_gate_edges(gate, key, value, passes):
    report = json.loads((ROOT / "results" /
                         "selftest_eval_realistic_r5.json").read_text())
    node = report
    for k in key[:-1]:
        node = node[k]
    node[key[-1]] = value
    assert st.evaluate_gates(report, realistic=True)[gate] is passes


def test_tiny_selftest_writes_every_key_of_the_jax_report(tmp_path,
                                                          monkeypatch):
    # f32 on the CPU: the trainers and the pipelines narrowed from outside,
    # as the self-test itself always runs in bfloat16
    from openglottal_tpu_torch import pipelines
    from openglottal_tpu_torch.train import unet_trainer, yolo_trainer

    for mod, name in ((unet_trainer, "UNetTrainer"),
                      (yolo_trainer, "YoloTrainer"),
                      (pipelines, "GlottalPipelines")):
        monkeypatch.setattr(mod, name, functools.partial(
            getattr(mod, name), dtype=torch.float32))
    out = st.run_selftest(tmp_path / "st", realistic=True, epochs_unet=1,
                          patience_unet=1, epochs_crop=1, epochs_yolo=1,
                          device="cpu", train=(1, 4), val=(1, 2),
                          test=(2, 3), features=(8, 16, 32, 64),
                          verbose=False)
    report = out["report"]
    written = json.loads((tmp_path / "st" / "report.json").read_text())
    assert written == json.loads(json.dumps(report))
    pipelines = ["unet-only", "yolo+otsu", "yolo+unet", "yolo-crop+unet",
                 "yolo+motion"]
    assert list(report) == pipelines + _jax_report_keys()
    jax_art = json.loads((ROOT / "results" /
                          "selftest_eval_realistic_r5.json").read_text())
    assert set(report) == set(jax_art)
    for p in pipelines:
        assert set(report[p]) == ROW_KEYS
    assert report["unet-only"]["n_frames"] == 6
    assert report["yolo+motion"]["n_frames"] == 2     # YGVFT_INIT seed frames
    assert list(out["gates"]) == _jax_gate_names()
    assert all(np.isfinite(v) for v in (
        report["int8full_waveform_rel_l1"], report["windowed_waveform_rel_l1"],
        report["unet_only_dice_int8"], report["crop_dice_zeroshot"]))
    assert out["epochs_run"] == {"unet": 1, "unet_crop": 1, "yolo": 1}
    assert {"train_unet", "train_unet_crop", "train_yolo", "eval_patient_0",
            "eval_patient_1", "crop_zeroshot", "int8_masks",
            "wave_int8full", "wave_bf16_fullframe"} <= set(
                out["stage_seconds"])
    for sub in ("unet", "unet_crop", "yolo"):
        assert (tmp_path / "st" / sub / "best.pt").exists()
