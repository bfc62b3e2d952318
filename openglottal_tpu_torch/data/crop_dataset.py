"""Crop-mode training dataset materialisation (reference
scripts/train_unet_crop.py:75-346).

Counterpart of ``openglottal_tpu/data/crop_dataset.py``.  Two crop sources:

  * GT mode: tight ground-truth mask bbox + ``pad`` px each side (reference
    GTCroppedGlottisDataset, :216-346).
  * YOLO mode: detector boxes, per frame and stateless (training images are
    independent frames), through the port's gate entry
    ``GlottalPipelines.gated_boxes(..., sequential=False)``; frames with no
    detection are skipped (reference CroppedGlottisDataset, :75-214).

Crops (image + mask) are letterboxed to 256² with the reference's geometry
(INTER_NEAREST for 2-D arrays) and cached as .npz keyed by the sha256 of the
file list + parameters (reference :54-70; the JAX package's keys).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from openglottal_tpu_torch.data.dataset import (
    cache_key,
    label_name,
    materialize_split,
)
from openglottal_tpu_torch.data.png import imread_gray
from openglottal_tpu_torch.ops.resize import letterbox_info, resize_nearest_cv2

SIZE = 256


def _letterbox_crop(img, msk):
    h, w = img.shape[:2]
    pt, pl, ch, cw = letterbox_info(h, w, SIZE)
    out_i = np.zeros((SIZE, SIZE), img.dtype)
    out_m = np.zeros((SIZE, SIZE), msk.dtype)
    out_i[pt:pt + ch, pl:pl + cw] = resize_nearest_cv2(img, cw, ch)
    out_m[pt:pt + ch, pl:pl + cw] = resize_nearest_cv2(msk, cw, ch)
    return out_i, out_m


def _gt_crop(img, msk, pad: int):
    """The letterboxed crop of the tight mask bbox + pad."""
    ys, xs = np.nonzero(msk > 0)
    h, w = img.shape
    y1, y2 = max(0, ys.min() - pad), min(h, ys.max() + 1 + pad)
    x1, x2 = max(0, xs.min() - pad), min(w, xs.max() + 1 + pad)
    ci, cm = _letterbox_crop(img[y1:y2, x1:x2], msk[y1:y2, x1:x2])
    return ci, (cm > 0).astype(np.uint8)


def _stack(images, masks):
    if not images:
        empty = np.zeros((0, SIZE, SIZE), np.uint8)
        return empty, empty.copy()
    return np.stack(images), np.stack(masks)


def _cached(cache_dir, name, key):
    if cache_dir is None:
        return None, None
    cache = Path(cache_dir) / f"{name}_{key}.npz"
    if cache.exists():
        z = np.load(cache)
        return cache, (z["images"], z["masks"])
    return cache, None


def materialize_gt_crops(fnames, img_dir, lbl_dir, pad: int = 8,
                         label_suffix: str = "", cache_dir=None):
    """GT-bbox crops: tight mask bbox + pad (train_unet_crop.py:216-346).
    Returns (images (N,256,256) u8, masks (N,256,256) u8); empty-mask frames
    are skipped."""
    cache, hit = _cached(cache_dir, "crops_gt", cache_key(
        sorted(fnames), str(img_dir), str(lbl_dir), pad, label_suffix, "gt"))
    if hit is not None:
        return hit
    img_dir, lbl_dir = Path(img_dir), Path(lbl_dir)
    images, masks = [], []
    for fname in fnames:
        img = imread_gray(img_dir / fname)
        msk = imread_gray(lbl_dir / label_name(fname, label_suffix))
        if img is None or msk is None or msk.max() == 0:
            continue
        ci, cm = _gt_crop(img, msk, pad)
        images.append(ci)
        masks.append(cm)
    images, masks = _stack(images, masks)
    if cache is not None:
        cache.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(cache, images=images, masks=masks)
    return images, masks


def materialize_yolo_crops(fnames, img_dir, lbl_dir, pipe,
                           label_suffix: str = "", cache_dir=None,
                           batch: int = 256):
    """YOLO-ROI crops: per-frame stateless detection (the gate's geometry
    without temporal state), no-detection frames skipped
    (train_unet_crop.py:75-214).  ``pipe``: a ``GlottalPipelines`` with a
    detector."""
    cache, hit = _cached(cache_dir, "crops_yolo", cache_key(
        sorted(fnames), str(img_dir), str(lbl_dir), label_suffix,
        float(pipe.conf), "yolo"))
    if hit is not None:
        return hit
    # full frames letterboxed to 256² first (the detector's input size)
    frames, gts = materialize_split(fnames, img_dir, lbl_dir, label_suffix,
                                    cache_dir=cache_dir)
    images, masks = [], []
    for i in range(0, len(frames), batch):
        chunk = frames[i:i + batch]
        valid, boxes = pipe.gated_boxes(chunk, sequential=False)
        valid, boxes = valid.cpu().numpy(), boxes.cpu().numpy()
        for j in range(len(chunk)):
            if not valid[j]:
                continue      # skip no-detection frames (reference :120-127)
            x1, y1, x2, y2 = (int(v) for v in boxes[j])
            if x2 <= x1 or y2 <= y1:
                continue
            ci, cm = _letterbox_crop(chunk[j, y1:y2, x1:x2],
                                     gts[i + j, y1:y2, x1:x2])
            images.append(ci)
            masks.append((cm > 0).astype(np.uint8))
    images, masks = _stack(images, masks)
    if cache is not None:
        cache.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(cache, images=images, masks=masks)
    return images, masks


def materialize_gt_crops_arrays(gray_u8: np.ndarray, masks: np.ndarray,
                                pad: int = 8):
    """GT-bbox crops from in-memory arrays (same geometry as
    :func:`materialize_gt_crops`).  gray_u8: (N, H, W) uint8; masks: (N, H,
    W) {0,1}.  Empty-mask frames are skipped."""
    images, out_masks = [], []
    for img, msk in zip(np.asarray(gray_u8), np.asarray(masks)):
        if msk.max() == 0:
            continue
        ci, cm = _gt_crop(img, msk.astype(np.uint8), pad)
        images.append(ci)
        out_masks.append(cm)
    return _stack(images, out_masks)
