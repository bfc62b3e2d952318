"""YOLO detection dataset construction from segmentation masks.

Counterpart of ``openglottal_tpu/data/yolo_dataset.py``.  Reference:
openglottal/data.py:28-166: ``mask_to_yolo`` (tight bbox + 10 px dilation,
normalised "0 cx cy w h" label line) and ``build_yolo_dataset``
(images/{train,val,test} + labels/... + dataset.yaml layout, kept
byte-compatible with the reference toolchain); the trainer takes the
in-memory (images, boxes) form from ``load_yolo_arrays``.  PNGs are read by
``data/png.py``; colour frames are letterboxed by
``ops/resize.resize_linear_cv2`` (cv2's INTER_LINEAR, bit-equal), masks by
``resize_nearest_cv2``.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np

from openglottal_tpu_torch.data.png import imread_bgr, imread_gray
from openglottal_tpu_torch.ops.resize import (
    letterbox_info,
    resize_linear_cv2,
    resize_nearest_cv2,
)

IMG_W = IMG_H = 256  # all GIRAFE frames are 256x256 (data.py:24)
DILATE = 10          # px added each side of the tight mask bbox (data.py:25)


def mask_to_yolo(mask_path, dilate: int = DILATE, img_wh=None) -> str:
    """Binary mask -> normalised YOLO label line, "" if empty
    (data.py:28-68)."""
    mask = imread_gray(mask_path)
    if mask is None or mask.max() == 0:
        return ""
    w, h = img_wh if img_wh is not None else (IMG_W, IMG_H)
    ys, xs = np.where(mask > 0)
    x1 = max(0, xs.min() - dilate)
    x2 = min(w, xs.max() + dilate)
    y1 = max(0, ys.min() - dilate)
    y2 = min(h, ys.max() + dilate)
    cx = (x1 + x2) / 2 / w
    cy = (y1 + y2) / 2 / h
    bw = (x2 - x1) / w
    bh = (y2 - y1) / h
    return f"0 {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}"


def build_yolo_dataset(images_dir, labels_dir, training_json, output_dir,
                       dilate: int = DILATE, force: bool = False,
                       mask_suffix: str = "") -> Path:
    """Materialise the images/ + labels/ + dataset.yaml layout
    (data.py:71-166)."""
    images_dir = Path(images_dir)
    labels_dir = Path(labels_dir)
    output_dir = Path(output_dir)
    with open(training_json) as f:
        splits = json.load(f)
    split_map = {"train": splits["training"], "val": splits["Val"],
                 "test": splits.get("test", [])}

    def _complete() -> bool:
        return all((output_dir / sub / split).exists()
                   for sub in ("images", "labels") for split in split_map)

    if _complete() and not force:
        print("Dataset already exists — skipping build. Pass force=True to "
              "rebuild.")
    else:
        for split, fnames in split_map.items():
            img_out = output_dir / "images" / split
            lbl_out = output_dir / "labels" / split
            img_out.mkdir(parents=True, exist_ok=True)
            lbl_out.mkdir(parents=True, exist_ok=True)
            for fname in fnames:
                shutil.copy(images_dir / fname, img_out / fname)
                stem = Path(fname).stem
                mask_path = (labels_dir / f"{stem}{mask_suffix}.png"
                             if mask_suffix else labels_dir / fname)
                img_wh = None
                if mask_suffix and mask_path.exists():
                    m = imread_gray(mask_path)
                    if m is not None:
                        img_wh = (m.shape[1], m.shape[0])
                label = mask_to_yolo(mask_path, dilate=dilate, img_wh=img_wh)
                (lbl_out / f"{stem}.txt").write_text(label)
        print(f"Dataset built at {output_dir}")

    yaml_path = output_dir / "dataset.yaml"
    yaml_path.write_text(
        f"path: {output_dir.resolve()}\n"
        f"train: images/train\n"
        f"val:   images/val\n"
        f"test:  images/test\n"
        f"nc: 1\n"
        f"names: ['glottis']\n"
    )
    return yaml_path


def load_yolo_arrays(fnames, img_dir, lbl_dir, dilate: int = DILATE,
                     mask_suffix: str = "", size: int = 256):
    """In-memory detection training data for ``YoloTrainer``: (images (N,
    size, size, 3) uint8 RGB, boxes (N, 4) xyxy pixels, -1 rows = no
    object).  Other-sized images are letterboxed (INTER_LINEAR for the
    frame, INTER_NEAREST for its mask)."""
    img_dir, lbl_dir = Path(img_dir), Path(lbl_dir)
    n = len(fnames)
    images = np.zeros((n, size, size, 3), np.uint8)
    boxes = np.full((n, 4), -1.0, np.float32)
    for i, fname in enumerate(fnames):
        stem = Path(fname).stem
        img = imread_bgr(img_dir / fname)
        msk_path = (lbl_dir / f"{stem}{mask_suffix}.png" if mask_suffix
                    else lbl_dir / fname)
        msk = imread_gray(msk_path)
        h, w = img.shape[:2]
        if (h, w) != (size, size):
            pt, pl, ch, cw = letterbox_info(h, w, size)
            canvas = np.zeros((size, size, 3), np.uint8)
            canvas[pt:pt + ch, pl:pl + cw] = resize_linear_cv2(img, cw, ch)
            images[i] = canvas[..., ::-1]
            if msk is not None and msk.max() > 0:
                mb = np.zeros((size, size), np.uint8)
                mb[pt:pt + ch, pl:pl + cw] = resize_nearest_cv2(msk, cw, ch)
                msk = mb
        else:
            images[i] = img[..., ::-1]
        if msk is not None and msk.max() > 0:
            ys, xs = np.where(msk > 0)
            boxes[i] = [max(0, xs.min() - dilate), max(0, ys.min() - dilate),
                        min(size, xs.max() + dilate),
                        min(size, ys.max() + dilate)]
    return images, boxes
