"""Weight loading and conversion, and the reference's ``openglottal.utils``
surface under the same names (``from openglottal_tpu_torch.utils import
letterbox, dice, unet_segment_frame, ...``), as the JAX package offers it.

Host letterboxing runs on ``ops/resize``'s cv2-exact resizes (no cv2);
metrics delegate to ``ops/metrics`` (empty and empty = 1.0).  An ``interp``
argument takes ``"nearest"`` / ``"linear"`` or cv2's codes for them
(INTER_NEAREST = 0, INTER_LINEAR = 1), so reference code passing
``cv2.INTER_NEAREST`` keeps working.
"""

from __future__ import annotations

import numpy as np
import torch

from openglottal_tpu_torch.data.video import load_frames_bgr  # noqa: F401
from openglottal_tpu_torch.models.unet import segment_frames
from openglottal_tpu_torch.ops import metrics
from openglottal_tpu_torch.ops.resize import (
    letterbox_info,
    letterbox_np,
    resize_linear_cv2,
    resize_nearest_cv2,
)
from openglottal_tpu_torch.utils.io import (  # noqa: F401
    load_unet_weights,
    load_yolo_weights,
    resolve_weights_path,
    save_features_json,
    save_weights_npz,
)

_INTERP = {"nearest": resize_nearest_cv2, 0: resize_nearest_cv2,
           "linear": resize_linear_cv2, 1: resize_linear_cv2}


def _resize(img, w: int, h: int, interp):
    if interp not in _INTERP:
        raise ValueError(f"interp must be 'nearest', 'linear' or cv2's "
                         f"INTER_NEAREST / INTER_LINEAR, got {interp!r}")
    return _INTERP[interp](img, w, h)


def letterbox(img: np.ndarray, size: int = 256, value: int = 0) -> np.ndarray:
    """Aspect-preserving resize and symmetric pad to (size, size):
    INTER_LINEAR for 3-channel images, INTER_NEAREST for 2-D arrays."""
    return letterbox_np(img, size, value)


def letterbox_with_info(img: np.ndarray, size: int = 256, value: int = 0):
    """:func:`letterbox` and its geometry: (boxed, pad_top, pad_left,
    content_h, content_w)."""
    pt, pl, ch, cw = letterbox_info(img.shape[0], img.shape[1], size)
    return letterbox_np(img, size, value), pt, pl, ch, cw


def letterbox_apply_geometry(img: np.ndarray, size: int, pad_top: int,
                             pad_left: int, content_h: int, content_w: int,
                             value: int = 0, interp=None) -> np.ndarray:
    """A previous letterbox's geometry applied to another array (a mask):
    INTER_NEAREST for 2-D arrays and INTER_LINEAR otherwise, unless
    ``interp`` says."""
    if interp is None:
        interp = "nearest" if img.ndim == 2 else "linear"
    resized = _resize(img, content_w, content_h, interp)
    out = np.full((size, size) + img.shape[2:], value, dtype=img.dtype)
    out[pad_top:pad_top + content_h, pad_left:pad_left + content_w] = resized
    return out


def unletterbox(letterboxed: np.ndarray, pad_top: int, pad_left: int,
                content_h: int, content_w: int, target_h: int, target_w: int,
                interp=None) -> np.ndarray:
    """The content region of a letterboxed array, resized back to (target_h,
    target_w) (INTER_NEAREST unless ``interp`` says)."""
    crop = letterboxed[pad_top:pad_top + content_h,
                       pad_left:pad_left + content_w]
    if (content_h, content_w) == (target_h, target_w):
        return crop
    return _resize(crop, target_w, target_h,
                   "nearest" if interp is None else interp)


def dice(pred, gt) -> float:
    """Dice of two binary masks; empty and empty = 1.0."""
    return float(metrics.dice(torch.as_tensor(np.asarray(pred)),
                              torch.as_tensor(np.asarray(gt))))


def iou(pred, gt) -> float:
    """IoU of two binary masks; an empty union = 1.0."""
    return float(metrics.iou(torch.as_tensor(np.asarray(pred)),
                             torch.as_tensor(np.asarray(gt))))


def dice_loss(logits, target, eps: float = 1e-6):
    """Soft Dice loss on logits (a 0-d tensor, differentiable through
    autograd when ``logits`` requires grad)."""
    return metrics.dice_loss(torch.as_tensor(logits), torch.as_tensor(target),
                             eps)


def unet_segment_frame(frame_gray: np.ndarray, variables, device=None,
                       threshold: float = 0.5) -> np.ndarray:
    """Segment one (H, W) uint8 frame -> uint8 mask (255 = glottis),
    resized through 256² as the reference does.  ``variables`` is the U-Net
    weight tree (in place of the reference's torch module); ``device=None``
    is the CUDA device.  Videos should use ``models/unet.segment_frames`` or
    the pipelines."""
    mask = segment_frames(variables, np.asarray(frame_gray)[None],
                          threshold=threshold, device=device)[0]
    return mask.cpu().numpy().astype(np.uint8) * 255
