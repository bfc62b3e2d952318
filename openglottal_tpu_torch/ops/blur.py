"""Separable Gaussian blur with cv2.GaussianBlur semantics.

Counterpart of ``openglottal_tpu/ops/blur.py``:

  * sigma <= 0  =>  sigma = 0.3*((ksize-1)*0.5 - 1) + 0.8
  * ksize in {1,3,5,7} with sigma <= 0 uses cv2's fixed small-kernel table
  * border mode BORDER_REFLECT_101 (``F.pad(mode="reflect")``)

Reflect-pad, then k shifted multiply-adds per axis in the reference's order
(rows first, taps accumulated from tap 0), rounded as the reference's
compiled CPU code rounds them (found by comparing bits): per axis,

    acc = fma(k0, x0, round32(k1 * x1)),  then  acc = fma(k_t, x_t, acc)

for t = 2 .. K-1 (``ops/fma.fma32``); a 1-tap blur is the one product.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from openglottal_tpu_torch.ops.fma import fma32

_SMALL_TAB = {
    1: np.array([1.0]),
    3: np.array([0.25, 0.5, 0.25]),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625]),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]),
}


def gaussian_kernel_1d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """cv2.getGaussianKernel, float64 -> float32."""
    if sigma <= 0 and ksize in _SMALL_TAB:
        return _SMALL_TAB[ksize].astype(np.float32)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    c = (ksize - 1) * 0.5
    x = np.arange(ksize, dtype=np.float64)
    k = np.exp(-((x - c) ** 2) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, ksize: int, sigma: float = 0.0):
    """Blur a (..., H, W) float tensor along the trailing two axes."""
    k = [float(v) for v in gaussian_kernel_1d(ksize, sigma)]
    r = ksize // 2
    x = img.to(torch.float32)
    h, w = x.shape[-2], x.shape[-1]
    lead = x.shape[:-2]
    # F.pad's reflect mode wants a (N, C, H, W)-like tensor
    x = F.pad(x.reshape(1, -1, h, w), (r, r, r, r), mode="reflect")
    rows = _taps(k, lambda d: x[..., d:d + h, :])
    out = _taps(k, lambda d: rows[..., :, d:d + w])
    return out.reshape(*lead, h, w)


def _taps(k, tap):
    """sum_t k[t] * tap(t), rounded as the reference rounds it: tap 0 fused
    over the rounded product of tap 1, then one fused step per tap."""
    if len(k) == 1:
        return k[0] * tap(0)
    acc = fma32(k[0], tap(0), k[1] * tap(1))
    for d in range(2, len(k)):
        acc = fma32(k[d], tap(d), acc)
    return acc
