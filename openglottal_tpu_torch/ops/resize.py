"""Bilinear resize and crop-resize with cv2.INTER_LINEAR semantics.

Counterpart of the linear half of ``openglottal_tpu/ops/resize.py`` — what
the ``vft`` pipeline's size-locked crops need (``_linear_matrix``,
``_apply_sep``, ``resize_bilinear``, ``crop_resize_bilinear``).

Semantics: src = (dst + 0.5) * in/out - 0.5, border replicate, no
antialiasing; a crop window replicates the CROP border, not pixels outside
it.  The reference writes each 2-D resize as ``A_h @ img @ A_w.T`` with dense
interpolation matrices because that feeds a matrix unit.  Every row of such a
matrix has at most two non-zero taps, so here a resize is a two-tap gather:
rows first, then columns, with the float32 rounding between, as in the
reference.  ``_linear_matrix`` still builds the dense matrix (from the same
taps), so that the geometry can be held against the reference entry by entry.

Rounding is written down, not left to a compiler.  Static geometry is
computed in numpy float64 like cv2's coordinate math.  Per-frame geometry
(tensor ``start`` / ``length``) is float32 and takes the forms the
reference's compiled CPU code takes, found by comparing bits:

  * ``length / out`` is ``length * float32(1 / out)``;
  * ``f = fma(i + 0.5, that ratio, start) - 0.5``;
  * the row pass is ``fma(w1, x1, round32(w0 * x0))`` (taps in index order);
  * the column pass is ``round32(w0 * x0) + round32(w1 * x1)``.

A fused multiply-add of float32 values is taken in float64, where the
product is exact, and rounded once to float32 — on any device.
"""

from __future__ import annotations

import numpy as np
import torch


def _is_static(*vals) -> bool:
    return all(isinstance(v, (int, float, np.integer, np.floating))
               for v in vals)


def _fma32(a, b, c):
    """float32 fma(a, b, c) via float64 (exact product, one final rounding up
    to the rare double rounding of the sum)."""
    return (a.double() * b.double() + c.double()).float()


def _linear_taps(in_size: int, out_size: int, start=0.0, length=None,
                 device=None):
    """Taps of the bilinear interpolation of a source window
    [start, start+length) of an axis of ``in_size`` samples to ``out_size``
    points: (lo0, lo1, w0, w1), each (..., out_size) — int64 source indices
    (lo0 <= lo1) and float32 weights.  Leading dimensions come from tensor
    ``start`` / ``length`` (one window per frame).  Where both taps clamp to
    the same sample the weights are merged (w0 + w1 in the geometry's own
    precision, as the dense matrix entry would be) and w1 is 0."""
    if length is None:
        length = float(in_size)
    if _is_static(start, length):
        i = np.arange(out_size, dtype=np.float64)
        f = float(start) + (i + 0.5) * (float(length) / out_size) - 0.5
        lo = np.floor(f)
        w = f - lo
        win_lo, win_hi = float(start), float(start) + float(length) - 1.0
        lo0 = np.clip(np.clip(lo, win_lo, win_hi), 0, in_size - 1)
        lo1 = np.clip(np.clip(lo + 1, win_lo, win_hi), 0, in_size - 1)
        same = lo0 == lo1
        w0 = np.where(same, 1.0, 1.0 - w)      # merged in float64
        w1 = np.where(same, 0.0, w)
        return (torch.from_numpy(lo0.astype(np.int64)).to(device),
                torch.from_numpy(lo1.astype(np.int64)).to(device),
                torch.from_numpy(w0.astype(np.float32)).to(device),
                torch.from_numpy(w1.astype(np.float32)).to(device))
    start = torch.as_tensor(start, device=device).to(torch.float32)
    length = torch.as_tensor(length, device=start.device
                             ).to(torch.float32)
    dev = start.device
    i05 = torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5
    ratio = length * float(np.float32(1.0) / np.float32(out_size))
    f = _fma32(i05, ratio[..., None], start[..., None]) - 0.5
    lo = torch.floor(f)
    w1 = f - lo
    w0 = 1.0 - w1
    win_lo = start[..., None]
    win_hi = (start + length - 1.0)[..., None]

    def clamp(x):
        x = torch.minimum(torch.maximum(x, win_lo), win_hi)
        return x.clamp(0, in_size - 1).long()

    lo0, lo1 = clamp(lo), clamp(lo + 1)
    same = lo0 == lo1
    w0 = torch.where(same, w0 + w1, w0)
    w1 = torch.where(same, torch.zeros_like(w1), w1)
    return lo0, lo1, w0, w1


def _dense(taps, in_size: int):
    lo0, lo1, w0, w1 = taps
    j = torch.arange(in_size, device=lo0.device)
    a = (j == lo0[..., None]).to(torch.float32) * w0[..., None]
    return a + (j == lo1[..., None]).to(torch.float32) * w1[..., None]


def _linear_matrix(in_size: int, out_size: int, start=0.0, length=None,
                   device=None):
    """Bilinear interpolation matrix (..., out_size, in_size), float32: the
    dense form of :func:`_linear_taps` (static geometry in float64, per-frame
    geometry in float32)."""
    return _dense(_linear_taps(in_size, out_size, start, length, device),
                  in_size)


def _apply_sep(img, taps_h, taps_w):
    """out = A_h @ img @ A_w.T over the trailing two axes of ``img``, the
    matrices given by their taps: rows first, then columns, each result
    rounded to float32.  Taps with leading dimensions pair with the leading
    dimensions of ``img`` (one geometry per frame)."""
    x = img.to(torch.float32)
    lo0, lo1, w0, w1 = taps_h
    if lo0.dim() == 1:
        xa, xb = x.index_select(-2, lo0), x.index_select(-2, lo1)
    else:
        ix = lo0[..., None].expand(*lo0.shape, x.shape[-1])
        xa = x.gather(-2, ix)
        xb = x.gather(-2, lo1[..., None].expand_as(ix))
    x = _fma32(w1[..., None], xb, w0[..., None] * xa)
    lo0, lo1, w0, w1 = taps_w
    if lo0.dim() == 1:
        xa, xb = x.index_select(-1, lo0), x.index_select(-1, lo1)
    else:
        ix = lo0[..., None, :].expand(*lo0.shape[:-1], x.shape[-2],
                                      lo0.shape[-1])
        xa = x.gather(-1, ix)
        xb = x.gather(-1, lo1[..., None, :].expand_as(ix))
    return w0[..., None, :] * xa + w1[..., None, :] * xb


def resize_bilinear(img, out_h: int, out_w: int):
    """cv2.INTER_LINEAR resize of ``img`` (..., H, W) -> (..., out_h, out_w),
    float32."""
    h, w = img.shape[-2], img.shape[-1]
    return _apply_sep(img, _linear_taps(h, out_h, device=img.device),
                      _linear_taps(w, out_w, device=img.device))


def crop_resize_bilinear(img, y1, x1, ch, cw, out_h: int, out_w: int):
    """Bilinear-resample the window [y1:y1+ch, x1:x1+cw] of ``img`` to
    (out_h, out_w).  Equivalent to ``cv2.resize(img[y1:y1+ch, x1:x1+cw],
    (out_w, out_h), INTER_LINEAR)`` for integer window coordinates.  The
    window may be given per frame: ``img`` (N, H, W) with (N,) tensors."""
    h, w = img.shape[-2], img.shape[-1]
    return _apply_sep(
        img, _linear_taps(h, out_h, y1, ch, device=img.device),
        _linear_taps(w, out_w, x1, cw, device=img.device))
