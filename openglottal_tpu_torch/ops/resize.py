"""Resize, crop-resize and letterbox with cv2 semantics (INTER_LINEAR,
INTER_NEAREST, the reference's letterbox geometry).

Counterpart of ``openglottal_tpu/ops/resize.py``.  The host-side
:func:`letterbox_np`, which calls cv2 in the reference, runs on
:func:`resize_linear_cv2` and :func:`resize_nearest_cv2`: cv2's
INTER_LINEAR and INTER_NEAREST without cv2 (also for the compat trackers).

Semantics: bilinear src = (dst + 0.5) * in/out - 0.5, border replicate, no
antialiasing; nearest src = floor(dst * in/out); a crop window replicates
the CROP border, not pixels outside it; a letterbox scales the longest side
to ``size`` and pads symmetrically with zeros.  The reference writes each
2-D resize as ``A_h @ img @ A_w.T`` with dense interpolation matrices
because that feeds a matrix unit.  Every row of such a matrix has at most
two non-zero taps (one for nearest), so here a resize is a gather: rows
first, then columns, with the float32 rounding between, as in the
reference.  Rows of a letterbox matrix outside the content are zero: here
an ``inside`` mask.  The per-frame letterboxes of the crop pipeline are
index maps with a validity mask.  ``_linear_matrix`` / ``_nearest_matrix``
still build the dense matrices (from the same taps), so that the geometry
can be held against the reference entry by entry.

Rounding is written down, not left to a compiler.  Static geometry is
computed in numpy float64 like cv2's coordinate math.  Per-frame geometry
(tensor ``start`` / ``length``) is float32 and takes the forms the
reference's compiled CPU code takes, found by comparing bits:

  * ``length / out`` is ``length * float32(1 / out)``;
  * ``f = fma(i + 0.5, that ratio, start) - 0.5`` (bilinear);
  * the row pass is ``fma(w1, x1, round32(w0 * x0))`` (taps in index order);
  * the column pass is ``round32(w0 * x0) + round32(w1 * x1)`` for a
    per-frame crop, and fused like the row pass for a letterbox.

How the reference rounds a static whole-image bilinear resize depends on
the shapes (its dot's blocking): fused on some output sizes, unfused on
others, and on some (256 -> 139) neither.  :func:`resize_bilinear` takes
the crop's form, which matches the reference only on some shapes, so its
users are held within the borderline pixel count.  Nearest resizes and the
per-frame letterbox index maps move values unchanged, so they are exact.

A fused multiply-add of float32 values is ``ops/fma.fma32``, on any device,
with two exceptions, where the float64 sum is exact and so rounds once
(the trackers' crops, integer windows of uint8 pixels, take both):

  * the coordinates of an integer window [start, start + length) of an
    axis of at most 2^13 samples: i + 0.5 (at most 14 bits) times the
    ratio (a float32 of at least 2^-13 unless 0, so its last bit is at
    least 2^-36) lies on a grid of 2^-37, as does the integer start, and
    their sum lies below 2^15: at most 52 significant bits;
  * the row pass of a per-frame crop of uint8 pixels.  A per-frame weight
    is a multiple of 2^-24 in [0, 1]: f is either g - 0.5 for a float32
    g >= 0.5 (a multiple of 2^-24, subtracted exactly), whose fraction is
    exact, or lies in [-0.5, 0), where the weight round32(f + 1) is a
    float32 in [0.5, 1].  Times a pixel in 0..255 the product is a
    multiple of 2^-24 below 2^8, round32(w0 * x0) stays one, and their
    sum lies below 2^9: 33 significant bits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from openglottal_tpu_torch.ops.fma import fma32


def _is_static(*vals) -> bool:
    return all(isinstance(v, (int, float, np.integer, np.floating))
               for v in vals)


def _device(device) -> torch.device:
    return torch.device(device if device is not None else "cpu")


# Static geometry is made on the host and copied to the device once per
# shape and device (a copy from the host synchronises it): the cached
# tensors are shared, and their users only read them.
@functools.lru_cache(maxsize=64)
def _static_linear_taps(in_size: int, out_size: int, start: float,
                        length: float, device: torch.device):
    i = np.arange(out_size, dtype=np.float64)
    f = start + (i + 0.5) * (length / out_size) - 0.5
    lo = np.floor(f)
    w = f - lo
    win_lo, win_hi = start, start + length - 1.0
    lo0 = np.clip(np.clip(lo, win_lo, win_hi), 0, in_size - 1)
    lo1 = np.clip(np.clip(lo + 1, win_lo, win_hi), 0, in_size - 1)
    same = lo0 == lo1
    w0 = np.where(same, 1.0, 1.0 - w)      # merged in float64
    w1 = np.where(same, 0.0, w)
    return (torch.from_numpy(lo0.astype(np.int64)).to(device),
            torch.from_numpy(lo1.astype(np.int64)).to(device),
            torch.from_numpy(w0.astype(np.float32)).to(device),
            torch.from_numpy(w1.astype(np.float32)).to(device))


def _linear_taps(in_size: int, out_size: int, start=0.0, length=None,
                 device=None):
    """Taps of the bilinear interpolation of a source window
    [start, start+length) of an axis of ``in_size`` samples to ``out_size``
    points: (lo0, lo1, w0, w1), each (..., out_size) — int64 source indices
    (lo0 <= lo1) and float32 weights.  Leading dimensions come from tensor
    ``start`` / ``length`` (one window per frame).  Where both taps clamp to
    the same sample the weights are merged (w0 + w1 in the geometry's own
    precision, as the dense matrix entry would be) and w1 is 0.  Integer
    ``start`` / ``length`` tensors on axes of at most 2^13 samples make the
    coordinates' float64 sum exact (the module's docstring)."""
    if length is None:
        length = float(in_size)
    if _is_static(start, length):
        return _static_linear_taps(in_size, out_size, float(start),
                                   float(length), _device(device))
    start = torch.as_tensor(start, device=device)
    length = torch.as_tensor(length, device=start.device)
    integral = not (start.is_floating_point() or length.is_floating_point())
    fma = (_fma32_exact_sum if integral and max(in_size, out_size) <= 1 << 13
           else fma32)
    start, length = start.to(torch.float32), length.to(torch.float32)
    dev = start.device
    i05 = torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5
    ratio = length * float(np.float32(1.0) / np.float32(out_size))
    f = fma(i05, ratio[..., None], start[..., None]) - 0.5
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


def _fma32_exact_sum(a, b, c):
    """fma(a, b, c) for operands whose a*b + c is exact in float64 (see the
    module's docstring): one rounding to float32."""
    return (a.double() * b.double() + c.double()).float()


def _apply_sep(img, taps_h, taps_w, fused_cols: bool = False):
    """out = A_h @ img @ A_w.T over the trailing two axes of ``img``, the
    matrices given by their taps: rows first, then columns, each result
    rounded to float32 (the column pass fused as the row pass with
    ``fused_cols``).  Taps with leading dimensions pair with the leading
    dimensions of ``img`` (one geometry per frame)."""
    x = img.to(torch.float32)
    lo0, lo1, w0, w1 = taps_h
    if lo0.dim() == 1:
        xa, xb = x.index_select(-2, lo0), x.index_select(-2, lo1)
    else:
        ix = lo0[..., None].expand(*lo0.shape, x.shape[-1])
        xa = x.gather(-2, ix)
        xb = x.gather(-2, lo1[..., None].expand_as(ix))
    per_frame_u8 = lo0.dim() > 1 and img.dtype == torch.uint8
    fma_rows = _fma32_exact_sum if per_frame_u8 else fma32
    x = fma_rows(w1[..., None], xb, w0[..., None] * xa)
    lo0, lo1, w0, w1 = taps_w
    if lo0.dim() == 1:
        xa, xb = x.index_select(-1, lo0), x.index_select(-1, lo1)
    else:
        ix = lo0[..., None, :].expand(*lo0.shape[:-1], x.shape[-2],
                                      lo0.shape[-1])
        xa = x.gather(-1, ix)
        xb = x.gather(-1, lo1[..., None, :].expand_as(ix))
    if fused_cols:
        return fma32(w1[..., None, :], xb, w0[..., None, :] * xa)
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


# ── nearest ─────────────────────────────────────────────────────────────────

@functools.lru_cache(maxsize=64)
def _static_nearest_taps(in_size: int, out_size: int, start: float,
                         length: float, device: torch.device):
    i = np.arange(out_size, dtype=np.float64)
    scale = 1.0 / (out_size / length)
    f = start + i * scale
    src = np.clip(np.clip(np.floor(f), start, start + length - 1.0), 0,
                  in_size - 1)
    return torch.from_numpy(src.astype(np.int64)).to(device)


def _nearest_taps(in_size: int, out_size: int, start=0.0, length=None,
                  device=None):
    """Source index (..., out_size), int64, of each nearest-neighbour output
    sample of the window [start, start+length) of an axis of ``in_size``
    samples: floor(start + i * scale), clamped to the window and the axis.
    Static geometry in float64 with cv2's scale 1 / (out / in), rounded
    twice as cv2 rounds it (120 -> 154 maps i = 77 to 59, not the exact
    rational 60); per-frame geometry in float32 with the crop's forms."""
    if length is None:
        length = float(in_size)
    if _is_static(start, length):
        return _static_nearest_taps(in_size, out_size, float(start),
                                    float(length), _device(device))
    start = torch.as_tensor(start, device=device).to(torch.float32)
    length = torch.as_tensor(length, device=start.device).to(torch.float32)
    i = torch.arange(out_size, dtype=torch.float32, device=start.device)
    ratio = length * float(np.float32(1.0) / np.float32(out_size))
    f = fma32(i, ratio[..., None], start[..., None])
    lo = torch.minimum(torch.maximum(torch.floor(f), start[..., None]),
                       (start + length - 1.0)[..., None])
    return lo.clamp(0, in_size - 1).long()


def _nearest_matrix(in_size: int, out_size: int, start=0.0, length=None,
                    device=None):
    """Nearest-neighbour matrix (..., out_size, in_size), float32: the dense
    form of :func:`_nearest_taps`."""
    src = _nearest_taps(in_size, out_size, start, length, device)
    j = torch.arange(in_size, device=src.device)
    return (j == src[..., None]).to(torch.float32)


def _gather2(img, rows, cols):
    """img[..., rows[:, None], cols[None, :]] over the trailing two axes."""
    return img.index_select(-2, rows).index_select(-1, cols)


def resize_nearest(img, out_h: int, out_w: int):
    """cv2.INTER_NEAREST resize of ``img`` (..., H, W) -> (..., out_h,
    out_w), float32."""
    h, w = img.shape[-2], img.shape[-1]
    return _gather2(img.to(torch.float32),
                    _nearest_taps(h, out_h, device=img.device),
                    _nearest_taps(w, out_w, device=img.device))


# ── cv2.resize(INTER_LINEAR) on the host ────────────────────────────────────

def _cv2_linear_taps(in_size: int, out_size: int, f32_coord: bool):
    """cv2's linear taps of one axis: (i0, i1, fraction).  f = (d + 0.5) *
    in/out - 0.5 in float64 (rounded to float32 before the floor on the
    fixed-point path); the indices are clamped to the axis, the fraction is
    not (a clamped pair repeats one pixel)."""
    d = np.arange(out_size, dtype=np.float64)
    f = (d + 0.5) * (in_size / out_size) - 0.5
    if f32_coord:
        f = f.astype(np.float32).astype(np.float64)
    s = np.floor(f)
    i0 = np.clip(s, 0, in_size - 1).astype(np.int64)
    i1 = np.clip(s + 1, 0, in_size - 1).astype(np.int64)
    return i0, i1, (f - s).astype(np.float32)


def resize_linear_cv2(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_LINEAR)``
    of an (H, W) or (H, W, C) array, without cv2.  Rows first, then
    columns, as OpenCV 5.0's resize:

      * uint8: 11-bit weights a = rint(f * 2048); the row pass keeps
        x0 * (2048 - a) + x1 * a exactly; the column pass takes 16-bit
        high products of (row >> 4) with each weight, and
        (sum + 2) >> 2.  Equal to cv2 bit for bit, any size or channel
        count;
      * anything else in float32: each pass is fma(x1 - x0, f, x0),
        rounded once (``ops/fma.fma32``).  Equal to cv2 on 2-D frames of
        two rows or more; integer types are rounded back to their range.
    """
    img = np.asarray(img)
    h, w = img.shape[:2]
    extra = (1,) * (img.ndim - 2)
    if img.dtype == np.uint8:
        x0, x1, fx = _cv2_linear_taps(w, out_w, True)
        y0, y1, fy = _cv2_linear_taps(h, out_h, True)
        a = np.rint(fx * np.float32(2048)).astype(np.int64).reshape(
            (1, -1) + extra)
        b = np.rint(fy * np.float32(2048)).astype(np.int64).reshape(
            (-1, 1) + extra)
        x = img.astype(np.int64)
        rows = x[:, x0] * (2048 - a) + x[:, x1] * a
        t = ((rows[y0] >> 4) * (2048 - b) >> 16) + ((rows[y1] >> 4) * b >> 16)
        return np.clip((t + 2) >> 2, 0, 255).astype(np.uint8)

    def lerp(v0, v1, f):
        v0 = torch.from_numpy(np.ascontiguousarray(v0))
        v1 = torch.from_numpy(np.ascontiguousarray(v1))
        return fma32(torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(f, v0.shape))), v1 - v0, v0).numpy()

    x = img.astype(np.float32)
    x0, x1, fx = _cv2_linear_taps(w, out_w, False)
    y0, y1, fy = _cv2_linear_taps(h, out_h, False)
    rows = lerp(x[:, x0], x[:, x1], fx.reshape((1, -1) + extra))
    out = lerp(rows[y0], rows[y1], fy.reshape((-1, 1) + extra))
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        out = np.clip(np.rint(out), info.min, info.max)
    return out.astype(img.dtype)


def resize_nearest_cv2(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_NEAREST)``
    of an (H, W) or (H, W, C) array, without cv2: source index
    min(floor(d * (1 / (out / in))), in - 1) per axis, in float64 as cv2
    computes it (:func:`_nearest_taps`); values move unchanged."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    cpu = torch.device("cpu")
    rows = _static_nearest_taps(h, out_h, 0.0, float(h), cpu).numpy()
    cols = _static_nearest_taps(w, out_w, 0.0, float(w), cpu).numpy()
    return img[rows][:, cols]


# ── letterbox (static geometry) ─────────────────────────────────────────────

def letterbox_info(h: int, w: int, size: int = 256):
    """Static letterbox geometry: (pad_top, pad_left, content_h, content_w)
    as Python ints (longest side scaled to ``size``, pad_top = pad // 2)."""
    scale = size / max(h, w)
    content_h = int(round(h * scale))
    content_w = int(round(w * scale))
    return (size - content_h) // 2, (size - content_w) // 2, content_h, \
        content_w


def letterbox_np(img: np.ndarray, size: int = 256, value: int = 0):
    """Host-side letterbox of one (H, W) or (H, W, C) array to (size, size)
    (+ C): INTER_LINEAR for C channels, INTER_NEAREST for 2-D arrays (the
    reference's choice for images and masks), padded with ``value``; equal
    to the reference's cv2 letterbox on uint8 arrays."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    pt, pl, ch, cw = letterbox_info(h, w, size)
    resize = resize_linear_cv2 if img.ndim == 3 else resize_nearest_cv2
    out = np.full((size, size) + img.shape[2:], value, dtype=img.dtype)
    out[pt:pt + ch, pl:pl + cw] = resize(img, cw, ch)
    return out


@functools.lru_cache(maxsize=64)
def _window_taps(in_size: int, size: int, pad: int, content: int,
                 method: str, device=None):
    """The letterbox matrix of one axis (input axis -> ``size`` rows, rows
    outside [pad, pad + content) zero) as taps plus an inside mask: the
    content rows' taps of a ``content``-point resize placed at rows [pad,
    pad + content), and ``inside`` (size,) bool.  Taps: (lo0, lo1, w0, w1)
    for ``method="linear"``, the source index for ``"nearest"``; rows
    outside take index 0 (and weight 0).  Cached, as the static taps."""
    inside = torch.zeros(size, dtype=torch.bool, device=device)
    inside[pad:pad + content] = True

    def place(v):
        out = torch.zeros(size, dtype=v.dtype, device=device)
        out[pad:pad + content] = v
        return out

    if method == "linear":
        return tuple(place(v) for v in _linear_taps(in_size, content,
                                                    device=device)), inside
    if method == "nearest":
        return place(_nearest_taps(in_size, content, device=device)), inside
    raise ValueError(f"letterbox method must be 'linear' or 'nearest', got "
                     f"{method!r}")


def _window_matrix(in_size: int, size: int, pad: int, content: int,
                   method: str, device=None):
    """Dense (size, in_size) letterbox matrix of one axis (for tests)."""
    taps, inside = _window_taps(in_size, size, pad, content, method, device)
    if method == "linear":
        a = _dense(taps, in_size)
    else:
        a = (torch.arange(in_size, device=device) == taps[:, None]).to(
            torch.float32)
    return a * inside[:, None]


def letterbox(img, size: int = 256, method: str = "linear"):
    """Aspect-preserving resize of ``img`` (..., H, W) to fit (size, size)
    and symmetric zero padding, float32.  ``method`` "linear" (INTER_LINEAR,
    the reference's choice for images) or "nearest" (INTER_NEAREST, its
    choice for masks)."""
    h, w = img.shape[-2], img.shape[-1]
    pt, pl, ch, cw = letterbox_info(h, w, size)
    dev = img.device
    taps_h, in_h = _window_taps(h, size, pt, ch, method, dev)
    taps_w, in_w = _window_taps(w, size, pl, cw, method, dev)
    if method == "linear":
        out = _apply_sep(img, taps_h, taps_w, fused_cols=True)
    else:
        out = _gather2(img.to(torch.float32), taps_h, taps_w)
    return torch.where(in_h[:, None] & in_w[None, :], out,
                       torch.zeros((), dtype=out.dtype, device=dev))


def apply_letterbox(img, size: int, method: str = "nearest"):
    """Letterbox a mask or image with the geometry implied by its own shape
    (the geometry is a function of (h, w, size) alone)."""
    return letterbox(img, size, method)


def unletterbox(boxed, pad_top: int, pad_left: int, content_h: int,
                content_w: int, target_h: int, target_w: int,
                method: str = "nearest"):
    """The content region of a letterboxed (..., size, size) array, resized
    to (target_h, target_w) (INTER_NEAREST by default)."""
    crop = boxed[..., pad_top:pad_top + content_h,
                 pad_left:pad_left + content_w]
    if (content_h, content_w) == (target_h, target_w):
        return crop
    if method == "linear":
        return resize_bilinear(crop, target_h, target_w)
    return resize_nearest(crop, target_h, target_w)


# ── per-frame letterbox geometry (the crop pipeline) ────────────────────────
#
# The crop pipeline letterboxes each frame's gated crop to size² and projects
# the predicted mask back.  Crop sizes are per frame, so the geometry is made
# of tensors; the coordinate math is integer, and the resamplings are index
# maps with a validity mask, applied by gathers.

def _round_half_even_div(n, d):
    """round(n / d) with banker's rounding (Python's ``round``), integer
    tensors, d > 0."""
    q = torch.div(n, d, rounding_mode="floor")
    r = n - q * d
    up = (2 * r > d) | ((2 * r == d) & (q % 2 == 1))
    return q + up.to(q.dtype)


def dyn_letterbox_geometry(ch, cw, size: int = 256):
    """Letterbox geometry of (ch, cw) crops -> (size, size): (pad_t, pad_l,
    content_h, content_w) int32 tensors, sides clamped to >= 1."""
    ch = ch.to(torch.int32).clamp(min=1)
    cw = cw.to(torch.int32).clamp(min=1)
    md = torch.maximum(ch, cw)
    content_h = _round_half_even_div(size * ch, md).clamp(min=1)
    content_w = _round_half_even_div(size * cw, md).clamp(min=1)
    return ((size - content_h) // 2, (size - content_w) // 2, content_h,
            content_w)


def _local_floor(offset, num, den):
    """floor(offset * (num / max(den, 1))) in float32 as the reference
    computes it (one division, one product), int32.  offset (..., n), the
    rest (...)."""
    scale = (num.to(torch.float32)
             / den.clamp(min=1).to(torch.float32))[..., None]
    return torch.floor(offset.to(torch.float32) * scale).to(torch.int32)


def dyn_letterbox_index_nearest(in_size: int, size: int, start, clen, pad,
                                content):
    """Nearest letterbox of the window [start, start+clen) of an axis into
    rows [pad, pad+content) of a ``size`` axis, per frame: (src (..., size)
    int64, inside (..., size) bool) — the source index of each row and
    whether the row holds content (the dense matrix's non-zero rows).
    cv2 resizeNN float32 semantics: src = floor(i * f32(in / out))."""
    start, clen, pad, content = (torch.as_tensor(v).to(torch.int32)[..., None]
                                 for v in (start, clen, pad, content))
    i = torch.arange(size, dtype=torch.int32, device=start.device)
    inside = (i >= pad) & (i < pad + content)
    local = _local_floor(i - pad, clen[..., 0], content[..., 0])
    src = start + torch.minimum(local.clamp(min=0), (clen - 1).clamp(min=0))
    return src.clamp(0, in_size - 1).long(), inside


def dyn_unletterbox_index_nearest(in_size: int, size: int, start, clen, pad,
                                  content):
    """Nearest projection of rows [pad, pad+content) of a letterboxed
    ``size`` axis back onto the window [start, start+clen) of the original
    axis (unletterbox and paste in one), per frame: (src (..., in_size)
    int64 index into the ``size`` axis, valid (..., in_size) bool)."""
    start, clen, pad, content = (torch.as_tensor(v).to(torch.int32)[..., None]
                                 for v in (start, clen, pad, content))
    r = torch.arange(in_size, dtype=torch.int32, device=start.device)
    valid = (r >= start) & (r < start + clen)
    local = _local_floor(r - start, content[..., 0], clen[..., 0])
    j = pad + torch.minimum(local.clamp(min=0), (content - 1).clamp(min=0))
    return j.clamp(0, size - 1).long(), valid


def gather_rows_cols(img, rows, row_ok, cols, col_ok):
    """Per-frame index-map resample: out[c, i, j] = img[c, rows[c, i],
    cols[c, j]] where row_ok[c, i] and col_ok[c, j], else 0.  img (C, H, W);
    rows / row_ok (C, n); cols / col_ok (C, m)."""
    c, h, w = img.shape
    x = img.gather(1, rows[:, :, None].expand(c, rows.shape[1], w))
    x = x.gather(2, cols[:, None, :].expand(c, rows.shape[1], cols.shape[1]))
    ok = row_ok[:, :, None] & col_ok[:, None, :]
    return torch.where(ok, x, torch.zeros((), dtype=x.dtype, device=x.device))
