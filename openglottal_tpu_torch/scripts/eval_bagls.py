"""BAGLS test-set evaluation, on the card.

Counterpart of ``scripts/eval_bagls.py`` (the reference protocol): N.png /
N_seg.png pairs, image and ground truth letterboxed alike to 256²
(:func:`load_letterboxed`), the detector RESET PER FRAME (BAGLS test frames
are not a temporal sequence: ``gated_boxes(..., sequential=False)``), three
pipelines (``unet-only``, ``yolo+unet``, and ``yolo-crop+unet`` with a
separate ``--crop-weights`` model, its boxes grown by ``--crop-pad``),
detection TP / FP / FN by ground-truth pixels inside the predicted box
(:func:`detection_stats`), and a JSON file named with a timestamp suffix.
Weights are ``.npz`` files or torch ``.pt`` / ``.pth`` checkpoints.  Runs on
the card unless ``--device cpu``.

    python -m openglottal_tpu_torch.cli eval-bagls --test-dir D \\
        --unet-weights W [--yolo-weights W] [--crop-weights W] \\
        [--crop-pad N] [--max-images N] [--output-json F]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

PIPELINES = ["unet-only", "yolo+unet", "yolo-crop+unet"]
LABELS = {"unet-only": "U-Net only", "yolo+unet": "YOLO+UNet",
          "yolo-crop+unet": "YOLO-Crop+UNet"}


def load_letterboxed(test_dir: Path, max_images: int = 0, canvas: int = 256):
    """Image + GT pairs letterboxed as the reference does them: the image
    3-channel INTER_LINEAR (``ops/resize.resize_linear_cv2``), the GT 2-D
    INTER_NEAREST (``resize_nearest_cv2``), both to canvas², read by the
    port's PNG reader.  Returns (frames (N, canvas, canvas, 3) uint8, gts
    (N, canvas, canvas) bool)."""
    from openglottal_tpu_torch.data.png import imread_bgr, imread_gray
    from openglottal_tpu_torch.ops.resize import (
        letterbox_info,
        resize_linear_cv2,
        resize_nearest_cv2,
    )

    img_files = sorted(
        f for f in Path(test_dir).iterdir()
        if f.suffix == ".png" and not f.name.endswith("_seg.png"))
    if max_images:
        img_files = img_files[:max_images]
    frames, gts = [], []
    for img_path in img_files:
        seg_path = img_path.with_name(img_path.stem + "_seg.png")
        if not seg_path.exists():
            continue
        img = imread_bgr(img_path)
        gt = imread_gray(seg_path)
        if img is None or gt is None:
            continue
        h, w = img.shape[:2]
        if (h, w) != (canvas, canvas):
            pt, pl, ch, cw = letterbox_info(h, w, canvas)
            ib = np.zeros((canvas, canvas, 3), np.uint8)
            ib[pt:pt + ch, pl:pl + cw] = resize_linear_cv2(img, cw, ch)
            gb = np.zeros((canvas, canvas), np.uint8)
            gb[pt:pt + ch, pl:pl + cw] = resize_nearest_cv2(gt, cw, ch)
            img, gt = ib, gb
        frames.append(img)
        gts.append(gt > 0)
    return np.stack(frames), np.stack(gts)


def detection_stats(valid, boxes, gts) -> dict:
    """TP / FP / FN by GT pixels inside the predicted box (the reference's
    eval_bagls.py:173-191)."""
    stats = {"tp": 0, "fp": 0, "fn": 0, "n_pos_gt": 0}
    for v, b, g in zip(valid, boxes, gts):
        gt_pos = bool(g.any())
        if gt_pos:
            stats["n_pos_gt"] += 1
        if v:
            x1, y1, x2, y2 = (int(max(0, min(g.shape[1], b[0]))),
                              int(max(0, min(g.shape[0], b[1]))),
                              int(max(0, min(g.shape[1], b[2]))),
                              int(max(0, min(g.shape[0], b[3]))))
            if g[y1:y2, x1:x2].any():
                stats["tp"] += 1
            else:
                stats["fp"] += 1
        elif gt_pos:
            stats["fn"] += 1
    return stats


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="eval-bagls", description="BAGLS test evaluation.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--test-dir", required=True)
    p.add_argument("--unet-weights", required=True)
    p.add_argument("--yolo-weights", default=None)
    p.add_argument("--crop-weights", default=None)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--crop-pad", type=int, default=0)
    p.add_argument("--max-images", type=int, default=0)
    p.add_argument("--output-json", default=None)
    p.add_argument("--device", default=None,
                   help="Torch device (default: the CUDA device).")
    return p


def main(argv: list[str] | None = None) -> dict:
    """Returns {pipeline: {"dice", "iou", "det"}} (numpy arrays, ``det``
    None for ``unet-only``), with "det_stats" when a detector was given."""
    args = build_parser().parse_args(argv)

    import torch

    from openglottal_tpu_torch.data.video import bgr_to_gray_u8
    from openglottal_tpu_torch.eval import box_masked, frame_metrics_batch
    from openglottal_tpu_torch.pipelines import GlottalPipelines
    from openglottal_tpu_torch.utils.io import (
        load_unet_weights,
        load_yolo_weights,
    )

    pipe = GlottalPipelines(
        unet_variables=load_unet_weights(args.unet_weights),
        crop_unet_variables=(load_unet_weights(args.crop_weights)
                             if args.crop_weights else None),
        yolo_variables=(load_yolo_weights(args.yolo_weights)
                        if args.yolo_weights else None),
        conf=args.conf, device=args.device)

    frames, gts = load_letterboxed(Path(args.test_dir), args.max_images)
    print(f"Evaluating {len(frames)} letterboxed frames")
    frames_dev = torch.from_numpy(frames).to(pipe.device)
    gray = bgr_to_gray_u8(frames_dev)
    gt_dev = torch.from_numpy(gts).to(pipe.device)

    def metrics(masks):
        d, i = frame_metrics_batch(masks, gt_dev)
        return d.cpu().numpy(), i.cpu().numpy()

    agg = {}
    masks_u = pipe.segment_video(gray)
    d, i = metrics(masks_u)
    agg["unet-only"] = {"dice": d, "iou": i, "det": None}

    det_stats = None
    if args.yolo_weights:
        valid, boxes = pipe.gated_boxes(frames_dev, sequential=False)
        det = valid.cpu().numpy()
        det_stats = detection_stats(det, boxes.cpu().numpy(), gts)
        d, i = metrics(box_masked(masks_u, valid, boxes))
        agg["yolo+unet"] = {"dice": d, "iou": i, "det": det}
        if args.crop_weights:
            b = boxes
            if args.crop_pad:
                pad = torch.tensor([-1, -1, 1, 1], dtype=boxes.dtype,
                                   device=boxes.device) * args.crop_pad
                b = (boxes + pad).clamp(0, 256)
            cm, _, _ = pipe.crop_unet_masks(frames_dev, gray_u8=gray,
                                            valid=valid, boxes=b)
            d, i = metrics(cm)
            agg["yolo-crop+unet"] = {"dice": d, "iou": i, "det": det}

    sep = "─" * 72
    print(f"\n{sep}")
    print(f"  {'Method':<20}  {'Det.Recall':>10}  {'Dice':>8}  {'IoU':>8}  "
          f"{'Dice≥0.5':>10}")
    print(sep)
    for pname, r in agg.items():
        dr = "1.000" if r["det"] is None else f"{r['det'].mean():.3f}"
        dice50 = np.mean(r["dice"] >= 0.5) * 100
        print(f"  {LABELS[pname]:<20}  {dr:>10}  {r['dice'].mean():>8.3f}  "
              f"{r['iou'].mean():>8.3f}  {dice50:>9.1f}%")
    print(sep)
    if det_stats:
        tp, fp, fn = det_stats["tp"], det_stats["fp"], det_stats["fn"]
        prec = tp / max(tp + fp, 1)
        rec = tp / max(tp + fn, 1)
        print(f"  Detector: precision {prec:.3f}  recall {rec:.3f}  "
              f"(TP {tp}, FP {fp}, FN {fn})")

    if args.output_json:
        stamp = time.strftime("%Y%m%d_%H%M%S")
        out_path = Path(args.output_json)
        out_path = out_path.with_name(
            f"{out_path.stem}_{stamp}{out_path.suffix}")
        payload = {
            pname: {"dice": r["dice"].tolist(), "iou": r["iou"].tolist(),
                    "det": (r["det"].tolist() if r["det"] is not None
                            else None)}
            for pname, r in agg.items()
        }
        if det_stats:
            payload["det_stats"] = det_stats
        out_path.parent.mkdir(parents=True, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(payload, f)
        print(f"Saved {out_path}")
    return {**agg, **({"det_stats": det_stats} if det_stats else {})}


if __name__ == "__main__":
    main()
