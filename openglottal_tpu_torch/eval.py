"""Evaluation of the five pipelines against ground-truth masks.

Counterpart of ``openglottal_tpu/eval.py`` (the GIRAFE / BAGLS protocols):
per patient, one detector pass and one gate, one U-Net pass, the crop U-Net
and the guided tracker, then per-frame Dice / IoU of each pipeline's masks
with the reference's TP/FP/FN form (empty and empty = 1.0).  ``aggregate``
turns patients' rows into one summary row per pipeline.

On the card the per-frame counts are the hand-written kernels of
``csrc/eval.cu`` (``ops/eval_cuda``): ``og_frame_counts`` counts a mask, or
its box-masked form, or both in one pass (``unet-only`` and ``yolo+unet``
read the same U-Net masks), and ``og_otsu_counts`` takes each frame's in-box
histogram, its Otsu threshold and the counts of the ``yolo+otsu`` mask in
one launch; neither writes a mask.  :func:`evaluate_patient` crosses the
frames and the ground truth to the device once each and reads its results
back once (plus the guided tracker's own read); Dice and IoU are computed
from the integer counts with the reference's float32 formula, so they are
bit-equal to the reference's wherever the masks are.

The gate is ``GlottalPipelines.gated_boxes``: frames other than 256² go to
the detector letterboxed, as the serving pipelines send them (the JAX
package's ``gated_boxes`` runs its detector at the frame's own size, which
fails where a side is not a multiple of 32; at 256² the two are the same).
"""

from __future__ import annotations

import numpy as np
import torch

from openglottal_tpu_torch.ops.eval_cuda import (
    frame_counts,
    inbox_masks,
    otsu_counts,
)
from openglottal_tpu_torch.pipelines import YGVFT_INIT, GlottalPipelines

PIPELINES = ["unet-only", "yolo+otsu", "yolo+unet", "yolo-crop+unet",
             "yolo+motion"]


def metrics_from_counts(counts):
    """(..., 3) integer (tp, fp, fn) -> (dice, iou) float32, the reference's
    formula: 2tp / max(2tp + fp + fn, 1e-9) and tp / max(tp + fp + fn,
    1e-9), 1.0 where the denominator is 0.  Counts below 2**24 are exact in
    float32, so the results are bit-equal to the reference's float32 sums."""
    c = counts.to(torch.float32)
    tp, fp, fn = c[..., 0], c[..., 1], c[..., 2]
    dd = 2 * tp + fp + fn
    di = tp + fp + fn
    dice = torch.where(dd > 0, 2 * tp / torch.clamp(dd, min=1e-9), 1.0)
    iou = torch.where(di > 0, tp / torch.clamp(di, min=1e-9), 1.0)
    return dice, iou


def _binary(x):
    """A mask as the count kernels take it: bool / uint8 as they are, any
    other type binarised with ``> 0``."""
    return x if x.dtype in (torch.bool, torch.uint8) else x > 0


def frame_metrics_batch(pred, gt):
    """Per-frame (dice, iou), float32 on ``pred``'s device, with
    empty and empty = 1.0.  pred, gt: (T, H, W) binary."""
    return metrics_from_counts(frame_counts(_binary(pred), _binary(gt)))


def box_masked(masks, valids, boxes):
    """The masks zeroed outside each frame's gated box and on frames
    without one (YOLO + U-Net)."""
    return (masks & inbox_masks(boxes, *masks.shape[1:])
            & valids.to(torch.bool)[:, None, None])


def otsu_in_box_masks(gray_u8, valids, boxes):
    """The YOLO + Otsu baseline's masks: each frame's Otsu threshold of its
    in-box pixels, inverted (the glottis is dark), inside the box; empty on
    frames without a box.  The thresholds come from ``og_otsu_counts`` on
    the card."""
    thr, _ = otsu_counts(gray_u8, None, valids, boxes)
    return ((gray_u8.to(torch.float32) <= thr[:, None, None])
            & inbox_masks(boxes, *gray_u8.shape[1:])
            & valids.to(torch.bool)[:, None, None])


def _upload(x, device):
    """One host-to-device copy of an array or tensor, contiguous (as the
    count kernels take it)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device).contiguous()


@torch.no_grad()
def evaluate_patient(pipe: GlottalPipelines, frames_bgr, gt_masks,
                     sequential: bool = True, crop: bool = True):
    """All five pipelines on one patient's (sorted) frames.

    frames_bgr: (T, H, W, 3) BGR or (T, H, W) gray uint8; gt_masks: (T, H,
    W) bool or uint8.  Returns {pipeline: {"dice": (T,) float32, "iou": (T,)
    float32, "det": (T,) bool or None}} as numpy arrays.  ``yolo+motion``
    leaves out the YGVFT_INIT seed frames (its arrays are shorter by
    YGVFT_INIT), from its scores and from its detection frames alike; without
    detector weights only ``unet-only`` is returned; ``crop=False`` or no
    crop U-Net leaves ``yolo-crop+unet`` out; ``sequential=False`` gates each
    frame on its own and leaves ``yolo+motion`` out."""
    frames_dev, gray = pipe.prepare(frames_bgr)
    gt = _upload(gt_masks, pipe.device)
    if gt.dtype not in (torch.bool, torch.uint8):
        gt = gt > 0
    counts = {}
    unet_masks = pipe.segment_video(gray)
    if pipe.yolo is None:
        counts["unet-only"] = frame_counts(unet_masks, gt)
        return _read(counts, None)

    valid, boxes = pipe.gated_boxes(
        gray if frames_dev is None else frames_dev, sequential)
    masked, whole = frame_counts(unet_masks, gt, valid, boxes, unmasked=True)
    counts["unet-only"] = whole
    counts["yolo+otsu"] = otsu_counts(gray, gt, valid, boxes)[1]
    counts["yolo+unet"] = masked
    if crop and pipe.crop_unet is not None:
        cm, _, _ = pipe.crop_unet_masks(frames_dev, gray_u8=gray,
                                        valid=valid, boxes=boxes)
        counts["yolo-crop+unet"] = frame_counts(cm, gt)
    if sequential and gray.shape[0] > YGVFT_INIT:
        masks = pipe.ygvft_eval_masks(gray, valid, boxes)
        counts["yolo+motion"] = frame_counts(masks, gt[YGVFT_INIT:])
    return _read(counts, valid)


def _read(counts: dict, valid) -> dict:
    """One device-to-host read of every pipeline's counts (and the gate's
    valid flags) -> the per-pipeline rows."""
    parts = [c.reshape(-1).to(torch.int32) for c in counts.values()]
    if valid is not None:
        parts.append(valid.to(torch.int32))
    host = torch.cat(parts).cpu()
    det = None if valid is None else host[-valid.shape[0]:].numpy() != 0
    out, at = {}, 0
    for name, c in counts.items():
        n = c.shape[0]
        d, i = metrics_from_counts(host[at:at + 3 * n].view(n, 3))
        at += 3 * n
        row_det = None
        if det is not None and name != "unet-only":
            row_det = det[YGVFT_INIT:] if name == "yolo+motion" else det
        out[name] = {"dice": d.numpy(), "iou": i.numpy(), "det": row_det}
    return out


def aggregate(per_patient: dict, pipelines=PIPELINES) -> dict:
    """patient -> pipeline -> metrics  =>  pipeline -> summary row."""
    agg = {}
    for p in pipelines:
        dices, ious, n_det, n_tot = [], [], 0, 0
        for res in per_patient.values():
            if p not in res:
                continue
            dices.extend(res[p]["dice"].tolist())
            ious.extend(res[p]["iou"].tolist())
            if res[p]["det"] is not None:
                n_det += int(res[p]["det"].sum())
                n_tot += len(res[p]["det"])
        if not dices:
            continue
        agg[p] = {
            "dice": float(np.mean(dices)),
            "iou": float(np.mean(ious)),
            "dice50": float(np.mean([x >= 0.5 for x in dices]) * 100),
            "det_recall": (n_det / n_tot) if n_tot else None,
            "n_frames": len(dices),
            "dices": dices,
            "ious": ious,
        }
    return agg
