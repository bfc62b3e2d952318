"""Single-pass YOLO confidence-threshold sweep on BAGLS, on the card.

Counterpart of ``scripts/sweep_bagls_conf.py`` (the reference's
sweep_bagls_conf.py): one detection pass at conf 0.001
(``GlottalPipelines.detect_video``), each frame gated on its own
(``models/gate.gate_single``: padding and clamp, no temporal state), the
full-frame and crop U-Net masks computed once, then every τ of ``TAUS``
re-thresholded after the fact: per τ the detection recall over frames with
ground truth and the Dice / IoU / Dice ≥ 0.5 of the box-masked full-frame
masks and of the crop masks.  The crop Dice of each frame at
``--export-dice-tau`` is written as ``per_frame_dice_tau_<τ>``.  Images are
read by ``eval_bagls.load_letterboxed``.  Runs on the card unless
``--device cpu``.

    python -m openglottal_tpu_torch.cli sweep-bagls --test-dir D \\
        --unet-weights W --crop-weights W --yolo-weights W \\
        [--max-images N] [--export-dice-tau 0.02] [--output-json F]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

TAUS = [0.001, 0.005, 0.01, 0.02, 0.03, 0.05, 0.10, 0.25]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sweep-bagls",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--test-dir", required=True)
    p.add_argument("--unet-weights", required=True)
    p.add_argument("--crop-weights", required=True)
    p.add_argument("--yolo-weights", required=True)
    p.add_argument("--max-images", type=int, default=0)
    p.add_argument("--export-dice-tau", type=float, default=0.02)
    p.add_argument("--output-json", default="results/bagls_sweep.json")
    p.add_argument("--device", default=None,
                   help="Torch device (default: the CUDA device).")
    return p


def main(argv: list[str] | None = None) -> dict:
    """Returns what it writes: {"sweep": rows, per_frame_dice_tau_<τ>}."""
    args = build_parser().parse_args(argv)

    import torch

    from openglottal_tpu_torch.data.video import bgr_to_gray_u8
    from openglottal_tpu_torch.eval import box_masked, frame_metrics_batch
    from openglottal_tpu_torch.models.gate import gate_single
    from openglottal_tpu_torch.pipelines import GlottalPipelines
    from openglottal_tpu_torch.scripts.eval_bagls import load_letterboxed
    from openglottal_tpu_torch.utils.io import (
        load_unet_weights,
        load_yolo_weights,
    )

    pipe = GlottalPipelines(
        unet_variables=load_unet_weights(args.unet_weights),
        crop_unet_variables=load_unet_weights(args.crop_weights),
        yolo_variables=load_yolo_weights(args.yolo_weights),
        conf=0.001, device=args.device)

    frames, gts = load_letterboxed(Path(args.test_dir), args.max_images)
    print(f"Sweeping τ over {len(frames)} frames")
    fdev = torch.from_numpy(frames).to(pipe.device)
    gray = bgr_to_gray_u8(fdev)
    gt_dev = torch.from_numpy(gts).to(pipe.device)

    # ── one pass: raw detections and both U-Nets' masks ─────────────────
    has, raw_boxes, confs = pipe.detect_video(fdev)
    masks_full = pipe.segment_video(gray)
    valid_all, boxes_all = gate_single(has, raw_boxes, 256, 256,
                                       params=pipe.gate_params)
    crop_masks, _, _ = pipe.crop_unet_masks(fdev, gray_u8=gray,
                                            valid=valid_all, boxes=boxes_all)
    has_h = has.cpu().numpy()
    confs = confs.float().cpu().numpy()
    gt_any = gts.reshape(len(gts), -1).any(1)

    rows = []
    export = None
    for tau in TAUS:
        det = has_h & (confs > tau)
        det_dev = torch.from_numpy(det).to(pipe.device)
        d_full, i_full = (x.cpu().numpy() for x in frame_metrics_batch(
            box_masked(masks_full, det_dev, boxes_all), gt_dev))
        d_crop, i_crop = (x.cpu().numpy() for x in frame_metrics_batch(
            crop_masks & det_dev[:, None, None], gt_dev))
        recall = float(det[gt_any].mean()) if gt_any.any() else float("nan")
        rows.append({
            "tau": tau, "det_recall": recall,
            "full": {"dice": float(d_full.mean()), "iou": float(i_full.mean()),
                     "dice50": float((d_full >= 0.5).mean() * 100)},
            "crop": {"dice": float(d_crop.mean()), "iou": float(i_crop.mean()),
                     "dice50": float((d_crop >= 0.5).mean() * 100)},
        })
        print(f"  τ={tau:<6} recall={recall:.3f}  "
              f"crop dice={rows[-1]['crop']['dice']:.3f} "
              f"iou={rows[-1]['crop']['iou']:.3f} "
              f"d50={rows[-1]['crop']['dice50']:.1f}%", flush=True)
        if abs(tau - args.export_dice_tau) < 1e-9:
            export = d_crop.tolist()

    out = {"sweep": rows}
    if export is not None:
        out[f"per_frame_dice_tau_{args.export_dice_tau}"] = export
    Path(args.output_json).parent.mkdir(parents=True, exist_ok=True)
    with open(args.output_json, "w") as f:
        json.dump(out, f)
    print(f"Saved {args.output_json}")
    return out


if __name__ == "__main__":
    main()
