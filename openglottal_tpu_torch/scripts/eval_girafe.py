"""Per-patient evaluation on GIRAFE's test split, on the card.

Counterpart of ``scripts/eval_girafe.py`` (the reference's Table-3 report):
the published baselines beside the five pipelines, per-frame Dice / IoU /
Dice ≥ 0.5 and Det.Recall (``eval.evaluate_patient`` per test patient,
sequential gate, then ``eval.aggregate``), the Dice of each pathology from
``--raw-data-dir`` (``patient*/metadata.json`` "disorder status"), and the
``--output-json`` file ({"aggregate", "per_frame_dice"}).  Frames are read
by the port's PNG reader (``data/png.imread_bgr`` / ``imread_gray``, equal
to ``cv2.imread``'s IMREAD_COLOR / IMREAD_GRAYSCALE).  ``--crop-weights``
is the crop-trained U-Net of ``yolo-crop+unet`` (``--unet-weights`` when not
given, as the reference has it).  Weights are ``.npz`` files or torch
``.pt`` / ``.pth`` checkpoints.  Runs on the card unless ``--device cpu``.

    python -m openglottal_tpu_torch.cli eval-girafe --images-dir D \\
        --labels-dir D --training-json J --unet-weights W [--yolo-weights W] \\
        [--crop-weights W] [--raw-data-dir D] [--output-json F]
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict
from pathlib import Path

import numpy as np

GIRAFE_BASELINE = [
    ("InP (GIRAFE paper)", None, 0.713, None, None),
    ("U-Net (GIRAFE paper)", None, 0.643, None, None),
    ("SwinUNetV2 (paper)", None, 0.621, None, None),
]
TEST_PATIENTS = ["patient57A3", "patient61", "patient63", "patient64"]
LABELS = {
    "unet-only": "U-Net only", "yolo+otsu": "YOLO+OTSU",
    "yolo+unet": "YOLO+UNet",
    "yolo-crop+unet": "YOLO-Crop+UNet *", "yolo+motion": "YOLO+Motion",
}


def load_patient_to_pathology(raw_data_dir: Path) -> dict:
    out = {}
    for pdir in sorted(raw_data_dir.iterdir()):
        meta_file = pdir / "metadata.json"
        if pdir.is_dir() and meta_file.exists():
            out[pdir.name] = json.loads(meta_file.read_text()).get(
                "disorder status", "Unknown")
    return out


def print_table(agg: dict) -> None:
    sep = "─" * 76
    print(f"\n{sep}")
    print(f"  {'Method':<25}  {'Det.Recall':>10}  {'Dice':>8}  {'IoU':>8}  "
          f"{'Dice≥0.5':>10}")
    print(sep)
    for label, det_rec, dice, iou, d50 in GIRAFE_BASELINE:
        dr = f"{det_rec:.3f}" if det_rec is not None else "  n/a  "
        d = f"{dice:.3f}" if dice is not None else "  n/a  "
        io = f"{iou:.3f}" if iou is not None else "  n/a  "
        d5 = f"{d50:.1f}%" if d50 is not None else "  n/a  "
        print(f"  {label:<25}  {dr:>10}  {d:>8}  {io:>8}  {d5:>10}")
    print("  " + "· " * 37)
    for pipe, row in agg.items():
        dr = "1.000 *" if pipe == "unet-only" else (
            f"{row['det_recall']:.3f}" if row["det_recall"] is not None
            else "n/a")
        print(f"  {LABELS[pipe]:<25}  {dr:>10}  {row['dice']:>8.3f}  "
              f"{row['iou']:>8.3f}  {row['dice50']:>9.1f}%")
    print(sep)
    print("  * U-Net only: no YOLO gate — always processes 100% of frames.")


def load_patient_frames(images_dir: Path, labels_dir: Path, fnames):
    """(frames (T, H, W, 3) BGR uint8, gt (T, H, W) bool) of one patient's
    files, a file either of whose images cannot be read skipped with a
    warning."""
    from openglottal_tpu_torch.data.png import imread_bgr, imread_gray

    frames, gts = [], []
    for fname in fnames:
        img = imread_bgr(images_dir / fname)
        gt = imread_gray(labels_dir / fname)
        if img is None or gt is None:
            print(f"    WARNING: could not read {fname}, skipping.")
            continue
        frames.append(img)
        gts.append(gt > 0)
    return np.stack(frames), np.stack(gts)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="eval-girafe",
        description="GIRAFE test evaluation: Det.Recall, Dice, IoU, "
                    "Dice≥0.5.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--images-dir", required=True)
    p.add_argument("--labels-dir", required=True)
    p.add_argument("--training-json", required=True)
    p.add_argument("--raw-data-dir", default=None)
    p.add_argument("--unet-weights", required=True)
    p.add_argument("--yolo-weights", default=None)
    p.add_argument("--crop-weights", default=None,
                   help="Crop-trained U-Net for yolo-crop+unet (falls back to "
                        "--unet-weights like the reference).")
    p.add_argument("--max-hold-frames", type=int, default=3)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--output-json", default=None)
    p.add_argument("--device", default=None,
                   help="Torch device (default: the CUDA device).")
    return p


def main(argv: list[str] | None = None) -> dict:
    """Returns {"aggregate", "per_patient"} (the rows ``aggregate`` gives
    and each patient's ``evaluate_patient`` result)."""
    args = build_parser().parse_args(argv)

    from openglottal_tpu_torch.eval import aggregate, evaluate_patient
    from openglottal_tpu_torch.models.gate import GateParams
    from openglottal_tpu_torch.pipelines import GlottalPipelines
    from openglottal_tpu_torch.utils.io import (
        load_unet_weights,
        load_yolo_weights,
    )

    pipe = GlottalPipelines(
        unet_variables=load_unet_weights(args.unet_weights),
        crop_unet_variables=load_unet_weights(args.crop_weights
                                              or args.unet_weights),
        yolo_variables=(load_yolo_weights(args.yolo_weights)
                        if args.yolo_weights else None),
        conf=args.conf,
        gate_params=GateParams(30.0, 8, args.max_hold_frames),
        device=args.device,
    )

    splits = json.loads(Path(args.training_json).read_text())
    test_fnames = splits["test"]
    print(f"Test frames   : {len(test_fnames)} across {len(TEST_PATIENTS)} "
          f"patients\n")

    by_patient = defaultdict(list)
    for fname in sorted(test_fnames):
        by_patient["_".join(fname.split("_")[:-1])].append(fname)

    per_patient = {}
    for patient, fnames in by_patient.items():
        print(f"  Processing {patient} ({len(fnames)} frames)...", flush=True)
        frames, gts = load_patient_frames(Path(args.images_dir),
                                          Path(args.labels_dir), fnames)
        per_patient[patient] = evaluate_patient(pipe, frames, gts,
                                                sequential=True)

    agg = aggregate(per_patient)
    print_table(agg)

    if args.raw_data_dir and Path(args.raw_data_dir).is_dir():
        patho_of = load_patient_to_pathology(Path(args.raw_data_dir))
        by_patho = defaultdict(lambda: defaultdict(list))
        for patient, res in per_patient.items():
            for pname, r in res.items():
                by_patho[patho_of.get(patient, "Unknown")][pname].extend(
                    r["dice"].tolist())
        print("\nDice by pathology (mean over frames):")
        pipes = list(LABELS)
        print("  " + "".join(f"{LABELS[q]:>16}" for q in pipes))
        for patho in sorted(by_patho):
            row = [f"{np.mean(by_patho[patho][q]):.3f}"
                   if by_patho[patho].get(q) else "  n/a  " for q in pipes]
            print(f"  {patho:<12}" + "".join(f"{r:>16}" for r in row))

    if args.output_json:
        out = {"aggregate": {k: {kk: vv for kk, vv in v.items()
                                 if kk not in ("dices", "ious")}
                             for k, v in agg.items()},
               "per_frame_dice": {k: v["dices"] for k, v in agg.items()}}
        Path(args.output_json).parent.mkdir(parents=True, exist_ok=True)
        with open(args.output_json, "w") as f:
            json.dump(out, f, indent=2)
        print(f"Raw results saved to {args.output_json}")
    return {"aggregate": agg, "per_patient": per_patient}


if __name__ == "__main__":
    main()
