"""Colour conversion of decoded video.

Counterpart of ``openglottal_tpu/data/video.py``'s ``bgr_to_gray_u8``: the
reference's formula, cv2's fixed-point BT.601 coefficients, bit for bit.
(It is the reference's formula that is matched, not cv2 itself: cv2 5.0.0's
``cvtColor`` differs from it by 1 on 0.26 % of colours.)  (The decoders,
``load_frames_bgr`` / ``iter_frames_bgr``, need cv2 and are not ported.)
"""

from __future__ import annotations

import numpy as np
import torch


def bgr_to_gray_u8(frames_bgr):
    """(..., 3) uint8 BGR -> (...) uint8 gray:
    (R*4899 + G*9617 + B*1868 + (1 << 13)) >> 14, on the array's device (a
    tensor) or on the host (a numpy array)."""
    if isinstance(frames_bgr, torch.Tensor):
        x = frames_bgr.to(torch.int32)
        out_dtype = torch.uint8
    else:
        x = np.asarray(frames_bgr).astype(np.int32)
        out_dtype = np.uint8
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    gray = (r * 4899 + g * 9617 + b * 1868 + (1 << 13)) >> 14
    return gray.to(out_dtype) if isinstance(gray, torch.Tensor) else \
        gray.astype(out_dtype)
