"""The cohort GAW scripts, port vs JAX package, on the CPU:
``analyze_gaw`` and ``plot_gaw``.

Two patient directories written by the JAX package's
``scripts/make_synthetic_zenodo.py`` (an MJPG AVI written by cv2 and a
metadata.json each: Healthy, Paresis) and one whose AVI holds no frame: the
port's ``analyze_gaw`` (demo weights, float32, ``--device cpu``) records
the JAX script's patients with the same keys, statuses and features (the
waveforms' features within ``FEAT_RTOL``, f0 × 4000), skips the empty
video with the JAX script's warning, and writes
``gaw_features.json``, ``gaw_stats.json`` (empty: fewer than three patients
a group) and the boxplot; without matplotlib the boxplot is skipped with a
note.  ``plot_gaw`` writes one PNG a patient and ``--resume`` skips those
that exist.
"""

import functools
import importlib.util
import json
import runpy
import shutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglottal_tpu import pipelines as jpipe
from openglottal_tpu_torch import cli
from openglottal_tpu_torch import pipelines as tpipe
from openglottal_tpu_torch.scripts import analyze_gaw

ROOT = Path(__file__).resolve().parents[1]
FEAT_RTOL = 1e-4     # float32 reductions and an FFT in two libraries
WEIGHTS = ["--unet-weights", str(ROOT / "weights" / "demo_unet.npz"),
           "--yolo-weights", str(ROOT / "weights" / "demo_yolo.npz")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = tmp_path_factory.mktemp("gaw")
    spec = importlib.util.spec_from_file_location(
        "jax_script_make_synthetic_zenodo",
        ROOT / "scripts" / "make_synthetic_zenodo.py")
    zen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(zen)
    for idx, pid in enumerate(["01", "02"]):
        zen.write_patient(root, pid, idx, 1, 12, True)
    bad = root / "Raw_Data" / "patient03"
    bad.mkdir()
    (bad / "patient03.avi").write_bytes(b"RIFF\x04\x00\x00\x00AVI junk")
    (bad / "metadata.json").write_text('{"disorder status": "Healthy"}')
    return root / "Raw_Data"


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(jpipe, "CHUNK", 12)
    monkeypatch.setattr(jpipe, "GlottalPipelines", functools.partial(
        jpipe.GlottalPipelines, dtype=jnp.float32))
    monkeypatch.setattr(tpipe, "GlottalPipelines", functools.partial(
        tpipe.GlottalPipelines, dtype=torch.float32))


def test_analyze_gaw_matches_jax_script(raw, tmp_path, monkeypatch, f32,
                                        capsys):
    monkeypatch.setattr(sys, "argv", [
        "analyze_gaw.py", "--raw-data-dir", str(raw), *WEIGHTS,
        "--output-dir", str(tmp_path / "jax")])
    runpy.run_path(str(ROOT / "scripts" / "analyze_gaw.py"),
                   run_name="__main__")
    capsys.readouterr()
    out = cli.main(["analyze-gaw", "--raw-data-dir", str(raw), *WEIGHTS,
                    "--output-dir", str(tmp_path / "port"), "--device",
                    "cpu"])
    printed = capsys.readouterr().out
    assert "WARNING: patient03: unreadable video, skipping" in printed
    want = json.loads((tmp_path / "jax" / "gaw_features.json").read_text())
    got = json.loads((tmp_path / "port" / "gaw_features.json").read_text())
    assert got == json.loads(json.dumps(out["records"]))
    assert [r["patient"] for r in got] == [r["patient"] for r in want] == [
        "patient01", "patient02"]
    for g, w in zip(got, want):
        assert list(g) == list(w) == ["patient", "status",
                                      *analyze_gaw.FEATURES]
        assert g["status"] == w["status"]
        for k in analyze_gaw.FEATURES:
            if w[k] is None:
                assert g[k] is None, k
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=FEAT_RTOL,
                                           err_msg=k)
    for name in ("gaw_stats.json", "gaw_boxplots.png"):
        assert (tmp_path / "port" / name).exists()
    assert json.loads((tmp_path / "port" / "gaw_stats.json").read_text()) \
        == json.loads((tmp_path / "jax" / "gaw_stats.json").read_text()) == {}


def test_group_stats_equal_to_scipy_on_six_records():
    from scipy.stats import mannwhitneyu

    rng = np.random.default_rng(0)
    recs = [{"patient": f"p{i}", "status": s,
             **{k: float(rng.normal(i, 1)) for k in analyze_gaw.FEATURES}}
            for i, s in enumerate(["Healthy"] * 3 + ["Polyps", "Nodules",
                                                     "Cysts", "Unknown"])]
    recs[0]["f0"] = None
    stats = analyze_gaw.group_stats(recs)
    assert "f0" not in stats          # two healthy values left: skipped
    a = [r["cv"] for r in recs[:3]]
    b = [r["cv"] for r in recs[3:6]]
    assert stats["cv"] == {"healthy_mean": float(np.mean(a)),
                           "patho_mean": float(np.mean(b)),
                           "p": float(mannwhitneyu(a, b).pvalue)}


def test_boxplot_without_matplotlib(tmp_path, monkeypatch, capsys):
    recs = [{"patient": f"p{i}", "status": s,
             **{k: float(i) for k in analyze_gaw.FEATURES}}
            for i, s in enumerate(["Healthy", "Polyps"])]
    assert analyze_gaw.boxplot(recs, tmp_path / "a.png")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert not analyze_gaw.boxplot(recs, tmp_path / "b.png")
    assert "Boxplot skipped: matplotlib is not importable" in \
        capsys.readouterr().out
    assert (tmp_path / "a.png").exists() and not (tmp_path / "b.png").exists()


def test_plot_gaw_writes_one_png_a_patient(raw, tmp_path, f32):
    one = tmp_path / "raw"
    shutil.copytree(raw / "patient01", one / "patient01")
    argv = ["plot-gaw", "--raw-data-dir", str(one), *WEIGHTS, "--output-dir",
            str(tmp_path / "plots"), "--device", "cpu"]
    written = cli.main(argv)
    assert [p.name for p in written] == ["patient01.png"]
    assert written[0].read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    written[0].write_bytes(b"kept")
    assert cli.main(argv + ["--resume"]) == []
    assert written[0].read_bytes() == b"kept"
