"""Per-frame evaluation counts: the hand-written CUDA kernels of
``csrc/eval.cu`` (``og_frame_counts``, ``og_otsu_counts``), their wrappers
and their plain PyTorch versions.

Replace the counts of ``openglottal_tpu/eval.py``:

  ``frame_counts``  <- ``frame_metrics_batch`` (:29-41), with ``box_masked``
                       (:61-73) fused in when ``valid`` / ``boxes`` are given
  ``otsu_counts``   <- ``otsu_in_box_masks`` (:44-58) and
                       ``frame_metrics_batch`` of its masks

A mask is a (T, H, W) bool or uint8 tensor; a pixel is in it when its byte
is non-zero (``> 0`` for both types).  Counts are (tp, fp, fn) per frame as
int32: #(p & g), #(p & ~g), #(~p & g).  ``valid`` (T,) bool and ``boxes``
(T, 4) integer (x0, y0, x1, y1) mask the prediction to its frame's box
(rows y0 <= r < y1, columns x0 <= c < x1) and to the valid frames.  The
Otsu threshold is the float32 sequence of
``ops/histogram.otsu_threshold_from_hist`` on each frame's in-box
histogram (valid or not, as the reference takes it), and its mask is
``(gray <= t) & inbox & valid``.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream without
synchronising and counts its launches in ``LAUNCHES``.  A CUDA tensor goes
to the kernel or the call raises; a CPU tensor goes to the plain version.
``use_plain=True`` is a test hook that forces the plain version on any
device.
"""

from __future__ import annotations

import ctypes

import torch

from openglottal_tpu_torch.ops import _build
from openglottal_tpu_torch.ops.histogram import otsu_threshold_from_hist

LAUNCHES = {"frame_counts": 0, "otsu_counts": 0}

# Measurement hook, as in ``blobs_cuda``: a list here receives
# (wrapper name, inputs, keyword arguments) of every launch.
RECORD: list | None = None

_MASK_DTYPES = (torch.bool, torch.uint8)
_configured = False


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _configured
    lib = _build.load("eval")
    if not _configured:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.og_frame_counts.argtypes = [p] * 5 + [i, i, i, i, p]
        lib.og_otsu_counts.argtypes = [p] * 6 + [i, i, i, p]
        lib.og_frame_counts.restype = ctypes.c_int
        lib.og_otsu_counts.restype = ctypes.c_int
        _configured = True
    return lib


# ── plain versions ──────────────────────────────────────────────────────────

def inbox_masks(boxes, h: int, w: int):
    """(T, H, W) bool: each frame's box, rows y0 <= r < y1 and columns
    x0 <= c < x1 of (x0, y0, x1, y1)."""
    b = boxes.to(torch.int64)
    dev = boxes.device
    rows = torch.arange(h, device=dev)[None]
    cols = torch.arange(w, device=dev)[None]
    rm = (rows >= b[:, 1:2]) & (rows < b[:, 3:4])
    cm = (cols >= b[:, 0:1]) & (cols < b[:, 2:3])
    return rm[:, :, None] & cm[:, None, :]


def _counts(p, g):
    """(T, 3) int32 (tp, fp, fn) of two (T, H, W) bool masks."""
    return torch.stack([(p & g).sum((1, 2)), (p & ~g).sum((1, 2)),
                        (~p & g).sum((1, 2))], 1).to(torch.int32)


def frame_counts_plain(pred, gt, valid=None, boxes=None,
                       unmasked: bool = False):
    """The plain version of :func:`frame_counts`: eager masks and sums."""
    p, g = pred != 0, gt != 0
    if boxes is None:
        return _counts(p, g)
    keep = inbox_masks(boxes, *p.shape[1:]) & valid.to(torch.bool)[:, None,
                                                                     None]
    masked = _counts(p & keep, g)
    return torch.stack([masked, _counts(p, g)]) if unmasked else masked


def otsu_counts_plain(gray, gt, valid, boxes):
    """The plain version of :func:`otsu_counts`: the in-box histograms by a
    scatter-add, the threshold walk, the eager mask and sums."""
    t, h, w = gray.shape
    inbox = inbox_masks(boxes, h, w)
    v = torch.where(inbox, gray.to(torch.int64), 256).reshape(t, -1)
    hist = torch.zeros((t, 257), dtype=torch.int64, device=gray.device)
    hist.scatter_add_(1, v, torch.ones_like(v))
    thr = otsu_threshold_from_hist(hist[:, :256].to(torch.float32))
    m = ((gray.to(torch.float32) <= thr[:, None, None]) & inbox
         & valid.to(torch.bool)[:, None, None])
    if gt is None:
        z = torch.zeros((t,), dtype=torch.int32, device=gray.device)
        return thr, torch.stack([z, m.sum((1, 2)).to(torch.int32), z], 1)
    return thr, _counts(m, gt != 0)


# ── wrappers ────────────────────────────────────────────────────────────────

def _check_mask(name: str, x, shape=None):
    if x.dim() != 3 or (shape is not None and tuple(x.shape) != shape):
        want = "(T, H, W)" if shape is None else str(shape)
        raise ValueError(f"{name}: expected {want}, got {tuple(x.shape)}")
    if x.dtype not in _MASK_DTYPES:
        raise ValueError(f"{name}: expected bool or uint8, got {x.dtype}")


def _frame_args(what: str, x, valid, boxes):
    """valid (T,) bool and boxes (T, 4) int32, contiguous on x's device."""
    t = x.shape[0]
    if valid.shape != (t,) or boxes.shape != (t, 4):
        raise ValueError(f"{what}: valid {tuple(valid.shape)} and boxes "
                         f"{tuple(boxes.shape)} are not ({t},) and ({t}, 4)")
    if valid.device != x.device or boxes.device != x.device:
        raise ValueError(f"{what}: valid and boxes must lie on {x.device}")
    v = valid if valid.dtype == torch.bool else valid != 0
    return v.contiguous(), boxes.to(torch.int32).contiguous()


def _check_cuda(what: str, *xs):
    dev = xs[0].device
    for x in xs:
        if x.device != dev:
            raise ValueError(f"{what}: inputs lie on different devices")
        if not x.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")


def frame_counts(pred, gt, valid=None, boxes=None, unmasked: bool = False,
                 use_plain: bool = False):
    """Per-frame (tp, fp, fn) of ``pred`` against ``gt`` -> (T, 3) int32.

    With ``valid`` and ``boxes``, of ``pred & inbox & valid`` (the
    reference's ``box_masked`` fused in; the masked mask is not written);
    ``unmasked=True`` then returns (2, T, 3): the box-masked counts and the
    unmasked counts of the same ``pred``, from one pass.  On CUDA tensors one
    launch of ``og_frame_counts``; on CPU tensors the plain version."""
    _check_mask("frame_counts: pred", pred)
    _check_mask("frame_counts: gt", gt, tuple(pred.shape))
    if (valid is None) != (boxes is None):
        raise ValueError("frame_counts: give valid and boxes together")
    if unmasked and boxes is None:
        raise ValueError("frame_counts: unmasked=True needs valid and boxes")
    if boxes is not None:
        valid, boxes = _frame_args("frame_counts", pred, valid, boxes)
    if use_plain or not pred.is_cuda:
        return frame_counts_plain(pred, gt, valid, boxes, unmasked)
    _check_cuda("frame_counts", pred, gt)
    t, h, w = pred.shape
    mode = 0 if boxes is None else (2 if unmasked else 1)
    out = torch.empty((t, 6 if mode == 2 else 3), dtype=torch.int32,
                      device=pred.device)
    with torch.cuda.device(pred.device):
        err = _lib().og_frame_counts(
            pred.data_ptr(), gt.data_ptr(),
            None if valid is None else valid.data_ptr(),
            None if boxes is None else boxes.data_ptr(), out.data_ptr(),
            t, h, w, mode, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "frame_counts")
    LAUNCHES["frame_counts"] += 1
    if RECORD is not None:
        RECORD.append(("frame_counts", (pred, gt, valid, boxes),
                       {"unmasked": unmasked}))
    if mode == 2:
        return out.view(t, 2, 3).transpose(0, 1)
    return out


def otsu_counts(gray, gt, valid, boxes, use_plain: bool = False):
    """The in-box Otsu baseline of each frame and its counts -> (thr (T,)
    float32, (T, 3) int32 (tp, fp, fn) of ``(gray <= thr) & inbox & valid``
    against ``gt``).  ``gt=None``: only the thresholds are wanted, and the
    counts are (0, #mask, 0).  On CUDA tensors one launch of
    ``og_otsu_counts``; on CPU tensors the plain version."""
    _check_mask("otsu_counts: gray", gray)
    if gray.dtype != torch.uint8:
        raise ValueError(f"otsu_counts: gray must be uint8, got {gray.dtype}")
    if gt is not None:
        _check_mask("otsu_counts: gt", gt, tuple(gray.shape))
    valid, boxes = _frame_args("otsu_counts", gray, valid, boxes)
    if use_plain or not gray.is_cuda:
        return otsu_counts_plain(gray, gt, valid, boxes)
    _check_cuda("otsu_counts", gray, *(() if gt is None else (gt,)))
    t, h, w = gray.shape
    thr = torch.empty((t,), dtype=torch.float32, device=gray.device)
    out = torch.empty((t, 3), dtype=torch.int32, device=gray.device)
    with torch.cuda.device(gray.device):
        err = _lib().og_otsu_counts(
            gray.data_ptr(), None if gt is None else gt.data_ptr(),
            valid.data_ptr(), boxes.data_ptr(), thr.data_ptr(),
            out.data_ptr(), t, h, w, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "otsu_counts")
    LAUNCHES["otsu_counts"] += 1
    if RECORD is not None:
        RECORD.append(("otsu_counts", (gray, gt, valid, boxes), {}))
    return thr, out
