"""Clinical GAW study over GIRAFE's Raw_Data cohort, on the card.

Counterpart of ``scripts/analyze_gaw.py`` (the reference's analyze_gaw.py):
each patient's YOLO+UNet area waveform -> kinematic features (f0 × 4000,
GIRAFE's capture rate), Healthy against Pathological from
``patient*/metadata.json`` "disorder status", a Mann-Whitney U test per
feature (scipy), ``gaw_features.json`` and ``gaw_stats.json``, and a
boxplot figure.

Patients are decoded lazily by the port's AVI reader (``data/video.
read_frames``, MJPG decoded on the card), a patient's fault kept to that
patient (a warning, and the study goes on); the frames come through
``data/prefetch.prefetch_to_device``, so the next patient's read overlaps
this one's work; each waveform is queued without a host read
(``GlottalPipelines.yolo_unet_areas_deferred``, which prepares the frames
as ``pipe.prepare`` does) and read back (``yolo_unet_areas_resolve``, one
read a patient) only once the next patient's work is queued.

The boxplot needs ``matplotlib``, imported inside the function that draws
it; where it is missing (the card's machine has none) the script prints
that the plot was skipped and why, and finishes (the reference raises
there).  Runs on the card unless ``--device cpu``.

    python -m openglottal_tpu_torch.cli analyze-gaw --raw-data-dir D \\
        --unet-weights W --yolo-weights W [--conf 0.25] \\
        [--output-dir results/gaw]
"""

from __future__ import annotations

import argparse
import json
from collections import deque
from pathlib import Path

import numpy as np

FEATURES = ["area_mean", "area_std", "area_range", "open_quotient",
            "f0", "periodicity", "cv"]
CAPTURE_FPS = 4000.0  # GIRAFE HSV (reference analyze_gaw.py:98-99)
PATHOLOGICAL = {"Paresis", "Polyps", "Diplophonia", "Nodules", "Paralysis",
                "Cysts", "Carcinoma", "Multinodular Goiter", "Other"}


def patient_status(pdir: Path) -> str:
    meta_file = pdir / "metadata.json"
    if meta_file.exists():
        return json.loads(meta_file.read_text()).get("disorder status",
                                                     "Unknown")
    return "Unknown"


def group_stats(records: list) -> dict:
    """feature -> {healthy_mean, patho_mean, p} by a two-sided Mann-Whitney
    U test, for features with at least 3 values in each group."""
    from scipy.stats import mannwhitneyu

    healthy = [r for r in records if r["status"] == "Healthy"]
    patho = [r for r in records if r["status"] in PATHOLOGICAL]
    print(f"\nHealthy {len(healthy)} vs Pathological {len(patho)}")
    results = {}
    for feat in FEATURES:
        a = [r[feat] for r in healthy if r[feat] is not None]
        b = [r[feat] for r in patho if r[feat] is not None]
        if len(a) < 3 or len(b) < 3:
            continue
        _, pval = mannwhitneyu(a, b, alternative="two-sided")
        results[feat] = {"healthy_mean": float(np.mean(a)),
                         "patho_mean": float(np.mean(b)), "p": float(pval)}
        sig = " *" if pval < 0.05 else ""
        print(f"  {feat:<15} H {np.mean(a):8.3f}±{np.std(a):6.3f}  "
              f"P {np.mean(b):8.3f}±{np.std(b):6.3f}  p={pval:.4f}{sig}")
    return results


def boxplot(records: list, out_png: Path) -> bool:
    """Healthy against Pathological per feature -> ``out_png``; False (and a
    note why) where matplotlib cannot be imported."""
    try:
        import matplotlib
    except ImportError as e:
        print(f"Boxplot skipped: matplotlib is not importable ({e})")
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    healthy = [r for r in records if r["status"] == "Healthy"]
    patho = [r for r in records if r["status"] in PATHOLOGICAL]
    fig, axes = plt.subplots(2, 4, figsize=(14, 7))
    for ax, feat in zip(axes.ravel(), FEATURES):
        a = [r[feat] for r in healthy if r[feat] is not None]
        b = [r[feat] for r in patho if r[feat] is not None]
        ax.boxplot([a, b], tick_labels=["Healthy", "Pathological"])
        ax.set_title(feat)
    axes.ravel()[-1].axis("off")
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    print(f"Saved {out_png}")
    return True


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="analyze-gaw",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--raw-data-dir", required=True,
                   help="GIRAFE Raw_Data directory (patient*/ with AVI + "
                        "metadata.json).")
    p.add_argument("--unet-weights", required=True)
    p.add_argument("--yolo-weights", required=True)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--output-dir", default="results/gaw")
    p.add_argument("--boxplot", action="store_true", default=True)
    p.add_argument("--device", default=None,
                   help="Torch device (default: the CUDA device).")
    return p


def main(argv: list[str] | None = None) -> dict:
    """Returns {"records", "stats"} as written to the two JSON files."""
    args = build_parser().parse_args(argv)

    from openglottal_tpu_torch.data.prefetch import prefetch_to_device
    from openglottal_tpu_torch.data.video import read_frames
    from openglottal_tpu_torch.features import kinematic_features
    from openglottal_tpu_torch.pipelines import GlottalPipelines
    from openglottal_tpu_torch.utils.io import (
        load_unet_weights,
        load_yolo_weights,
    )

    pipe = GlottalPipelines(
        unet_variables=load_unet_weights(args.unet_weights),
        yolo_variables=load_yolo_weights(args.yolo_weights),
        conf=args.conf, device=args.device)

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    records = []
    names: deque = deque()    # (name, status) of each video handed over

    def videos():
        """Each readable patient's frames, decoded onto the pipelines'
        device; a video that fails to decode, or has no frames, is skipped
        with a warning (the reference's per-patient fault tolerance)."""
        for pdir in sorted(Path(args.raw_data_dir).iterdir()):
            if not pdir.is_dir():
                continue
            avis = sorted(pdir.glob("*.avi"))
            if not avis:
                continue
            try:
                frames = read_frames(avis[0], device=pipe.device)
            except Exception as e:  # noqa: BLE001
                print(f"  WARNING: {pdir.name}: failed "
                      f"({type(e).__name__}: {e})")
                continue
            if len(frames) == 0:
                print(f"  WARNING: {pdir.name}: unreadable video, skipping")
                continue
            names.append((pdir.name, patient_status(pdir)))
            yield frames

    def finish(name, status, pending):
        """Read one patient's queued waveform back and record its
        features."""
        try:
            feats = kinematic_features(pipe.yolo_unet_areas_resolve(pending))
        except Exception as e:  # noqa: BLE001
            print(f"  WARNING: {name}: failed ({type(e).__name__}: {e})")
            return
        if feats is None:
            print(f"  WARNING: {name}: silent waveform")
            return
        if feats["f0"] is not None:
            feats["f0"] = feats["f0"] * CAPTURE_FPS
        rec = {"patient": name, "status": status,
               **{k: feats[k] for k in FEATURES}}
        records.append(rec)
        print(f"  {name:<16} {status:<12} "
              + " ".join(f"{k}={feats[k]:.3f}" if isinstance(feats[k], float)
                         else f"{k}=None" for k in FEATURES), flush=True)

    # patient i + 1 is read and moved while patient i's work runs; patient
    # i's waveform is read back once patient i + 1's work is queued
    waiting = None
    for frames in prefetch_to_device(videos(), size=2, device=pipe.device):
        name, status = names.popleft()
        try:
            pending = pipe.yolo_unet_areas_deferred(frames)
        except Exception as e:  # noqa: BLE001
            print(f"  WARNING: {name}: failed ({type(e).__name__}: {e})")
            continue
        if waiting is not None:
            finish(*waiting)
        waiting = (name, status, pending)
    if waiting is not None:
        finish(*waiting)

    with open(out_dir / "gaw_features.json", "w") as f:
        json.dump(records, f, indent=2)
    print(f"\nSaved {len(records)} patient records to "
          f"{out_dir / 'gaw_features.json'}")

    results = group_stats(records)
    with open(out_dir / "gaw_stats.json", "w") as f:
        json.dump(results, f, indent=2)

    if args.boxplot and any(r["status"] == "Healthy" for r in records) and \
            any(r["status"] in PATHOLOGICAL for r in records):
        boxplot(records, out_dir / "gaw_boxplots.png")
    return {"records": records, "stats": results}


if __name__ == "__main__":
    main()
