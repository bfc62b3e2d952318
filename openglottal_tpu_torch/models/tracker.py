"""YOLO-guided vocal-fold tracker, frame-parallel formulation.

Counterpart of the guided half of ``openglottal_tpu/models/tracker.py``
(``ygvft_initialize``, ``ygvft_parallel``).  The ROI is the gated detector
box; the intensity threshold is a beta-EMA of the ``glottal_percentile`` of
the ROI pixels; the output is (dark AND in-ROI) pixels filtered to the
``max_glottal_components`` largest blobs.

Frames arrive as (T, H, W) tensors of integer pixel values.  Everything but
the scalar threshold chain is per-frame independent and batched over T.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from openglottal_tpu_torch.ops import _build, scan_cuda
from openglottal_tpu_torch.ops.blobs import (
    gather_windows,
    roi_window_origin,
    scatter_windows,
    top_n_blobs_batch,
)
from openglottal_tpu_torch.ops.blur import gaussian_blur
from openglottal_tpu_torch.ops.histogram import (
    masked_histogram_u8,
    masked_percentile_u8_batch,
    percentile_from_hist,
)


class YGVFTParams(NamedTuple):
    """Defaults = reference YGVFT_PARAMS."""

    alpha: float = 0.98
    beta: float = 0.7
    glottal_percentile: float = 30.0
    gaussian_ksize: int = 13
    max_glottal_components: int = 2


def _roi_percentile(frame, roi, pct, fallback, min_px):
    """percentile(frame[roi], pct) if count > min_px else fallback."""
    val, n = percentile_from_hist(masked_histogram_u8(frame, roi), pct)
    if not isinstance(fallback, torch.Tensor):   # filled on the device
        fallback = torch.full((), float(fallback), device=val.device)
    return torch.where(n > min_px, val, fallback)


def _bbox_mask(h: int, w: int, valid, box, device=None):
    """Inside-bbox mask; empty when not valid.  ``valid`` and ``box`` may be
    tensors (0-d and (4,)) or host values."""
    box = torch.as_tensor(box, device=device)
    valid = torch.as_tensor(valid, device=box.device)
    rows = torch.arange(h, device=box.device)[:, None]
    cols = torch.arange(w, device=box.device)[None, :]
    m = ((rows >= box[1]) & (rows < box[3]) & (cols >= box[0])
         & (cols < box[2]))
    return m & valid


def ygvft_initialize(init_frames, first_valid, first_box, p: YGVFTParams):
    """Seed carry (prev, lmap, thresh): lmap from the mean absdiff; threshold
    from the percentile of the LAST init frame inside the first bbox (whole
    frame if no bbox yet)."""
    ff = init_frames.to(torch.float32)
    n, h, w = ff.shape
    avg = (ff[1:] - ff[:-1]).abs().sum(0) / (n - 1)
    lmap = gaussian_blur(avg, p.gaussian_ksize)
    roi = _bbox_mask(h, w, first_valid, first_box, device=ff.device)
    sel = torch.where(roi.any(), roi, torch.ones_like(roi))
    thresh = _roi_percentile(ff[-1], sel, p.glottal_percentile, 127.0,
                             min_px=0)
    return ff[-1], lmap, thresh


def thresh_chain_plain(thresh0, cur, n_px, active, beta: float):
    """Plain version of the threshold chain: a Python loop over numpy scalars
    on the host.  One step is fma(beta, th, round32((1-beta)*c)) — see
    :func:`_thresh_chain`; the fused multiply-add is emulated in float64,
    where the product of two float32 values is exact."""
    dev = cur.device
    f32 = np.float32
    th = f32(torch.as_tensor(thresh0).detach().cpu().item())
    cur_np = cur.detach().to(torch.float32).cpu().numpy()
    npx_np = n_px.detach().to(torch.float32).cpu().numpy()
    act_np = active.detach().cpu().numpy().astype(bool)
    b, omb = f32(beta), f32(1.0 - beta)
    out = np.empty(cur_np.shape, np.float32)
    for i in range(cur_np.shape[0]):
        c = cur_np[i] if npx_np[i] > 10 else th
        th2 = f32(np.float64(b) * np.float64(th) + np.float64(f32(omb * c)))
        th = th2 if act_np[i] else th
        out[i] = th
    return torch.from_numpy(out).to(dev)


def _thresh_chain(thresh0, cur, n_px, active, beta: float,
                  use_plain: bool = False):
    """Sequential scalar threshold EMA th = beta*th + (1-beta)*c, bit-identical
    to the reference's scan (incl. the fallback step computing
    beta*t + (1-beta)*t, which is not exactly t in f32).  A differently
    rounded chain drifts by ~1 ulp — enough to flip (integer_pixel < thresh)
    for a whole pixel population when the threshold rides an integer boundary
    — so the rounding is pinned, not left to a compiler: the reference's scan
    as XLA lowers it on the CPU rounds (1-beta)*c to float32 and then takes
    ONE fused multiply-add, fma(beta, th, that product) (measured: the
    unfused form differs from it in the last bit on ~40% of steps).  Both
    versions here compute exactly that.  The T steps run in order: on a CUDA
    tensor as ONE launch of a one-thread kernel (``csrc/scan.cu``
    ``og_thresh_chain``), on a CPU tensor as the plain host loop."""
    if cur.dim() != 1 or n_px.shape != cur.shape or active.shape != cur.shape:
        raise ValueError("thresh_chain: cur, n_px, active must be (T,)")
    if use_plain or not cur.is_cuda:
        return thresh_chain_plain(thresh0, cur, n_px, active, beta)
    dev = cur.device
    th0 = torch.as_tensor(thresh0, dtype=torch.float32, device=dev
                          ).reshape(1).contiguous()
    cur_c = cur.to(torch.float32).contiguous()
    npx_c = n_px.to(torch.float32).contiguous()
    act_c = active.to(torch.uint8).contiguous()
    out = torch.empty_like(cur_c)
    so = scan_cuda.lib()
    with torch.cuda.device(dev):
        err = so.og_thresh_chain(
            th0.data_ptr(), cur_c.data_ptr(), npx_c.data_ptr(),
            act_c.data_ptr(), out.data_ptr(), cur_c.shape[0],
            float(np.float32(beta)), float(np.float32(1.0 - beta)),
            scan_cuda.stream())
    _build.check(err, "thresh_chain")
    scan_cuda.launched("thresh_chain", (th0, cur, n_px, active), beta=beta)
    return out


def _prev_chain(init_last, frames):
    """prev_t for each step: frames[t-1], seeded with the last init frame."""
    return torch.cat([init_last[None], frames[:-1]], dim=0)


def ygvft_parallel(init_frames, first_valid, first_box, frames, valids, boxes,
                   active=None, params: YGVFTParams = YGVFTParams(),
                   use_plain: bool = False):
    """Frame-parallel YOLO-guided VFT.  Returns (masks (T, H, W) bool,
    areas (T,) f32).

    ``active`` may only disable a contiguous TAIL.

    Every data-dependent stage is confined to the per-frame bbox ROI, so on
    frames >= 128x128 the whole tail (masked percentile, threshold compare,
    top-n blob filter) runs on a 128x128 window positioned to contain each
    box plus a 1-px in-frame margin — bit-identical to the full-frame pass.
    When any box exceeds win-2 on a side the full-frame pass runs instead;
    that is a host branch on one scalar (one small device-to-host read).

    The motion map (absdiff -> blur -> alpha-EMA) is dead state for the
    guided tracker — its ROI is always the bbox — so the per-frame maps are
    NOT computed here (the JAX package traces them and lets XLA remove them).
    """
    p = params
    t, h, w = frames.shape
    dev = frames.device
    if active is None:
        active = torch.ones((t,), dtype=torch.bool, device=dev)
    _, _, thresh0 = ygvft_initialize(init_frames, first_valid, first_box, p)
    boxes = boxes.to(torch.int32)
    valids = valids.bool()

    def roi_for(rows, cols):
        return ((rows >= boxes[:, 1, None, None])
                & (rows < boxes[:, 3, None, None])
                & (cols >= boxes[:, 0, None, None])
                & (cols < boxes[:, 2, None, None])
                & valids[:, None, None])

    def tail(ffx, roix):
        cur, n_px = masked_percentile_u8_batch(ffx, roix, p.glottal_percentile)
        thresh = _thresh_chain(thresh0, cur, n_px, active, p.beta, use_plain)
        raw = (ffx < thresh[:, None, None]) & roix & active[:, None, None]
        masks_x = top_n_blobs_batch(raw, p.max_glottal_components, use_plain)
        return masks_x, masks_x.sum((1, 2)).to(torch.float32)

    win = 128
    fits = None
    if h >= win and w >= win:
        fits, oy, ox = roi_window_origin(boxes, h, w, win)
    if fits is None or not bool(fits):
        rows = torch.arange(h, device=dev)[None, :, None]
        cols = torch.arange(w, device=dev)[None, None, :]
        return tail(frames.to(torch.float32), roi_for(rows, cols))

    ff_w = gather_windows(frames, oy, ox, win).to(torch.float32)
    ar = torch.arange(win, device=dev)
    rows = oy[:, None, None] + ar[None, :, None]
    cols = ox[:, None, None] + ar[None, None, :]
    masks_w, areas = tail(ff_w, roi_for(rows, cols))
    return scatter_windows(masks_w, oy, ox, h, w), areas
