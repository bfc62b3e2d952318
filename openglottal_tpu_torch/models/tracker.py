"""Classical motion trackers over the frame axis.

Counterpart of ``openglottal_tpu/models/tracker.py``:

  * VFT: EMA motion map of Gaussian-blurred absdiffs; ROI = largest blob
    above ``roi_threshold_ratio`` * peak; intensity threshold = beta-EMA of
    the ``glottal_percentile`` of the ROI pixels; output = (dark AND in-ROI)
    pixels filtered to the ``max_glottal_components`` largest blobs.
  * YOLO-guided VFT: the same machinery, but the ROI is the gated detector
    box; empty mask when there is none.

Frames arrive as (T, H, W) tensors of integer pixel values; the carry is
(prev_frame, motion_map, threshold).  Each tracker has two forms with the
same outputs.  The frame-parallel form (``vft_parallel``, ``ygvft_parallel``)
batches every per-frame stage over T and runs the two recurrences — the
per-pixel motion map, with the blurred absdiff that feeds it, and the scalar
threshold — as one kernel launch each (``csrc/scan.cu``).  The sequential
form (``*_step``, ``*_scan_carry``, ``*_scan``) is a Python loop over frames
that carries the state explicitly: the debug form, and what segment-wise
streaming needs.  Both forms go
through the same kernels (the sequential one at T = 1) with the same pinned
float32 rounding, so their motion maps and thresholds agree bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from openglottal_tpu_torch.ops import _build, scan_cuda
from openglottal_tpu_torch.ops.blobs import (
    gather_windows,
    largest_blob,
    largest_blob_batch,
    roi_window_origin,
    scatter_windows,
    top_n_blobs,
    top_n_blobs_batch,
)
from openglottal_tpu_torch.ops.blur import gaussian_blur
from openglottal_tpu_torch.ops.fma import fma32
from openglottal_tpu_torch.ops.histogram import (
    masked_histogram_u8,
    masked_percentile_u8_batch,
    percentile_from_hist,
)


class VFTParams(NamedTuple):
    """Defaults = reference VFT_PARAMS."""

    alpha: float = 0.98
    beta: float = 0.7
    roi_threshold_ratio: float = 0.07
    gaussian_ksize: int = 13
    glottal_percentile: float = 5.0
    max_glottal_components: int = 2


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


def _roi_threshold(lmap, ratio: float):
    """ROI threshold of a motion map (..., H, W): ratio * peak, or 1 where
    the map is all zero.  Returns (...,)."""
    peak = lmap.amax((-2, -1))
    return torch.where(peak > 0, peak * ratio, torch.ones_like(peak))


def _init_map(ff, ksize: int, use_plain: bool):
    """The seed motion map of (N, H, W) init frames: their blurred mean
    absdiff.  On a CUDA tensor the blur is one ``og_motion_map`` launch at
    T = 1 from a zero frame and a zero map with alpha = 1: its absdiff is the
    mean itself (>= 0) and its step fma(0, 0, round32(1 * d)) is d, so its
    one map is :func:`gaussian_blur` of the mean, bit for bit, in one launch
    instead of ~50 eager ones."""
    avg = (ff[1:] - ff[:-1]).abs().sum(0) / (ff.shape[0] - 1)
    if use_plain or not avg.is_cuda:
        return gaussian_blur(avg, ksize)
    zero = torch.zeros_like(avg)
    one = torch.ones((1,), dtype=torch.bool, device=avg.device)
    return motion_map(zero, avg[None], zero, one, 1.0, ksize)[0]


def vft_initialize(init_frames, p: VFTParams, use_plain: bool = False):
    """Seed carry from N init frames: (N, H, W) integer-valued grayscale,
    already resized to the locked crop size.  The motion map is the blurred
    mean absdiff; the threshold is the percentile of the FIRST init frame
    inside the map's largest blob.  Returns carry (prev, lmap, thresh)."""
    ff = init_frames.to(torch.float32)
    lmap = _init_map(ff, p.gaussian_ksize, use_plain)
    rm = largest_blob(lmap > _roi_threshold(lmap, p.roi_threshold_ratio),
                      use_plain)
    thresh = _roi_percentile(ff[0], rm, p.glottal_percentile, 127.0, min_px=0)
    return ff[-1], lmap, thresh


def lmap_ema_plain(lmap0, d, active, alpha: float):
    """Plain version of the motion-map recurrence over a (T, H, W) stack of
    blurred absdiffs: a loop over T, one step = fma(1-alpha, lmap,
    round32(alpha*d)) — see :func:`motion_map` (``ops/fma.fma32``)."""
    a = float(np.float32(alpha))
    b = float(np.float32(1.0 - alpha))
    lm = lmap0.to(torch.float32)
    out = torch.empty_like(d, dtype=torch.float32)
    for i in range(d.shape[0]):
        nxt = fma32(b, lm, d[i].to(torch.float32) * a)
        lm = torch.where(active[i], nxt, lm)
        out[i] = lm
    return out


def motion_map_plain(prev0, frames, lmap0, active, alpha: float, ksize: int):
    """Plain version of :func:`motion_map`: the eager absdiff and blur, then
    the recurrence's loop."""
    ff = frames.to(torch.float32)
    d = gaussian_blur((ff - _prev_chain(prev0.to(torch.float32), ff)).abs(),
                      ksize)
    return lmap_ema_plain(lmap0, d, active.bool(), alpha)


MAX_KSIZE = 31     # the most taps the kernel's blur takes


def motion_map(prev0, frames, lmap0, active, alpha: float, ksize: int,
               use_plain: bool = False):
    """Every motion map of a (T, H, W) stack of integer-valued frames:
    d_t = gaussian_blur(|frames[t] - prev_t|, ksize) with prev_t = prev0 for
    t = 0 and frames[t-1] after (:func:`_prev_chain`), then lmap_t =
    alpha*d_t + (1-alpha)*lmap_{t-1} from ``lmap0``, identity on inactive
    steps.  Returns the T maps, float32.

    The T steps run in order per pixel, so the result is the sequential
    tracker's and not a reassociated prefix.  The rounding of a step is
    pinned to the form the reference's sequential scan takes as compiled for
    the CPU: round32(alpha*d), then ONE fused multiply-add fma(1-alpha, lmap,
    that product) (found by comparing bits; the unfused form and the other
    fused form both differ from it); the blur rounds as the reference's
    (``ops/blur.py``).  On a CUDA tensor it is ONE launch of ``csrc/scan.cu``
    ``og_motion_map``, which computes the blurred absdiff too (it never
    reaches device memory), bit-equal to the plain version; on a CPU tensor
    the plain version.  ``ksize`` is odd and at most 31, and each side of
    the frame is longer than its radius ``ksize // 2``."""
    if (frames.dim() != 3 or prev0.shape != frames.shape[1:]
            or lmap0.shape != frames.shape[1:]
            or active.shape != frames.shape[:1]):
        raise ValueError("motion_map: want prev0 (H, W), frames (T, H, W), "
                         "lmap0 (H, W), active (T,)")
    if len({frames.device, prev0.device, lmap0.device, active.device}) != 1:
        raise ValueError("motion_map: tensors lie on different devices")
    t, h, w = frames.shape
    if t == 0 or h == 0 or w == 0:
        raise ValueError(f"motion_map: empty shape {tuple(frames.shape)}")
    if ksize < 1 or ksize % 2 == 0 or ksize > MAX_KSIZE:
        raise ValueError(f"motion_map: ksize {ksize} is not odd in "
                         f"[1, {MAX_KSIZE}]")
    if min(h, w) <= ksize // 2:
        raise ValueError(f"motion_map: frame {h}x{w} is not larger than the "
                         f"blur's radius {ksize // 2} (reflect-101 border)")
    if use_plain or not frames.is_cuda:
        return motion_map_plain(prev0, frames, lmap0, active, alpha, ksize)
    ff = frames.to(torch.float32).contiguous()
    p0 = prev0.to(torch.float32).contiguous()
    l0 = lmap0.to(torch.float32).contiguous()
    # a bool or uint8 ``active`` goes by its storage (the kernel reads any
    # non-zero byte as active); other dtypes are compared with 0
    act = (active if active.dtype in (torch.bool, torch.uint8)
           else active != 0).contiguous()
    out = torch.empty_like(ff)
    so = scan_cuda.lib()
    with torch.cuda.device(frames.device):
        err = so.og_motion_map(
            ff.data_ptr(), p0.data_ptr(), l0.data_ptr(), act.data_ptr(),
            out.data_ptr(), t, h, w, scan_cuda.taps(ksize), ksize,
            float(np.float32(alpha)), float(np.float32(1.0 - alpha)),
            scan_cuda.stream())
    _build.check(err, "motion_map")
    scan_cuda.launched("motion_map", (prev0, frames, lmap0, active),
                       alpha=alpha, ksize=ksize)
    return out


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


def _ygvft_thresh0(ff, first_valid, first_box, p: YGVFTParams):
    """The guided tracker's seed threshold: the percentile of the LAST init
    frame inside the first bbox (whole frame if no bbox yet)."""
    h, w = ff.shape[1:]
    roi = _bbox_mask(h, w, first_valid, first_box, device=ff.device)
    sel = torch.where(roi.any(), roi, torch.ones_like(roi))
    return _roi_percentile(ff[-1], sel, p.glottal_percentile, 127.0,
                           min_px=0)


def ygvft_initialize(init_frames, first_valid, first_box, p: YGVFTParams,
                     use_plain: bool = False):
    """Seed carry (prev, lmap, thresh): lmap from the mean absdiff (as
    :func:`vft_initialize`); the threshold by :func:`_ygvft_thresh0`."""
    ff = init_frames.to(torch.float32)
    lmap = _init_map(ff, p.gaussian_ksize, use_plain)
    return ff[-1], lmap, _ygvft_thresh0(ff, first_valid, first_box, p)


def thresh_chain_plain(thresh0, cur, n_px, active, beta: float):
    """Plain version of the threshold chain: a Python loop over numpy scalars
    on the host.  One step is fma(beta, th, round32((1-beta)*c)) — see
    :func:`_thresh_chain` (``ops/fma.fma32`` on 0-d tensors)."""
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
        th2 = f32(fma32(float(b), torch.tensor(th),
                        torch.tensor(f32(omb * c))).item())
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
    tensor as ONE launch of a one-block kernel whose one thread walks the
    chain (``csrc/scan.cu`` ``og_thresh_chain``), on a CPU tensor as the plain
    host loop."""
    if cur.dim() != 1 or n_px.shape != cur.shape or active.shape != cur.shape:
        raise ValueError("thresh_chain: cur, n_px, active must be (T,)")
    if use_plain or not cur.is_cuda:
        return thresh_chain_plain(thresh0, cur, n_px, active, beta)
    dev = cur.device
    th0 = torch.as_tensor(thresh0, dtype=torch.float32, device=dev
                          ).reshape(1).contiguous()
    cur_c = cur.to(torch.float32).contiguous()
    npx_c = n_px.to(torch.float32).contiguous()
    out = torch.empty_like(cur_c)
    if out.shape[0] == 0:
        return out
    # a bool or uint8 ``active`` goes by its storage (the kernel reads any
    # non-zero byte as active); other dtypes are compared with 0
    act_c = (active if active.dtype in (torch.bool, torch.uint8)
             else active != 0).contiguous()
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


def thresh_chain_batch(thresh0, cur, n_px, active, offsets, beta: float,
                       use_plain: bool = False):
    """K threshold chains at once: chain i is steps [offsets[i], offsets[i +
    1]) of the flat (sum T,) ``cur``, ``n_px`` and ``active``, from the seed
    ``thresh0[i]`` ((K,) float32), each stepped exactly as
    :func:`_thresh_chain` steps it alone (the same pinned rounding).
    ``offsets``: K + 1 host ints, non-decreasing from 0 (a chain of 0 steps
    is allowed).  On a CUDA tensor ONE launch of ``og_thresh_chain_batch``
    (one block per chain; one warp each when no chain is longer than 32
    steps); on a CPU tensor a loop of :func:`thresh_chain_plain`.  Returns
    (sum T,) float32."""
    if cur.dim() != 1 or n_px.shape != cur.shape or active.shape != cur.shape:
        raise ValueError("thresh_chain_batch: cur, n_px, active must be (T,)")
    off = scan_cuda.check_offsets(offsets, cur.shape[0])
    k = len(off) - 1
    th0 = torch.as_tensor(thresh0, dtype=torch.float32, device=cur.device
                          ).reshape(-1)
    if th0.shape[0] != k:
        raise ValueError(f"thresh_chain_batch: {th0.shape[0]} seeds for {k} "
                         f"chains")
    if use_plain or not cur.is_cuda:
        outs = [thresh_chain_plain(th0[i], cur[off[i]:off[i + 1]],
                                   n_px[off[i]:off[i + 1]],
                                   active[off[i]:off[i + 1]], beta)
                for i in range(k)]
        return (torch.cat(outs) if outs
                else torch.empty((0,), dtype=torch.float32, device=cur.device))
    th0 = th0.contiguous()
    cur_c = cur.to(torch.float32).contiguous()
    npx_c = n_px.to(torch.float32).contiguous()
    act_c = (active if active.dtype in (torch.bool, torch.uint8)
             else active != 0).contiguous()
    out = torch.empty_like(cur_c)
    so = scan_cuda.lib()
    with torch.cuda.device(cur.device):
        err = so.og_thresh_chain_batch(
            th0.data_ptr(), cur_c.data_ptr(), npx_c.data_ptr(),
            act_c.data_ptr(), out.data_ptr(), scan_cuda.offsets_arg(off), k,
            float(np.float32(beta)), float(np.float32(1.0 - beta)),
            scan_cuda.stream())
    _build.check(err, "thresh_chain_batch")
    scan_cuda.launched("thresh_chain_batch", (th0, cur, n_px, active),
                       offsets=off, beta=beta)
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
    guided tracker — its ROI is always the bbox — so neither the seed map nor
    the per-frame maps are computed here (the JAX package traces them and
    lets XLA remove them).
    """
    p = params
    t, h, w = frames.shape
    dev = frames.device
    if active is None:
        active = torch.ones((t,), dtype=torch.bool, device=dev)
    thresh0 = _ygvft_thresh0(init_frames.to(torch.float32), first_valid,
                             first_box, p)
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


def _ygvft_thresh0_batch(last_frames, first_valid, first_box,
                         p: YGVFTParams):
    """:func:`_ygvft_thresh0` of K videos at once: the percentile of each
    video's last init frame ((K, H, W) float) inside its first bbox (whole
    frame if none), as one batched masked percentile
    (``masked_percentile_u8_batch`` finds the same two order statistics as
    ``percentile_from_hist`` and mixes them with the same float32 ops)."""
    k, h, w = last_frames.shape
    dev = last_frames.device
    rows = torch.arange(h, device=dev)[None, :, None]
    cols = torch.arange(w, device=dev)[None, None, :]
    b = first_box
    roi = ((rows >= b[:, 1, None, None]) & (rows < b[:, 3, None, None])
           & (cols >= b[:, 0, None, None]) & (cols < b[:, 2, None, None])
           & first_valid.bool()[:, None, None])
    sel = roi | ~roi.flatten(1).any(1)[:, None, None]
    val, n = masked_percentile_u8_batch(last_frames, sel, p.glottal_percentile)
    return torch.where(n > 0, val, torch.full_like(val, 127.0))


def ygvft_parallel_multi(init_frames, first_valid, first_box, frames, valids,
                         boxes, offsets, params: YGVFTParams = YGVFTParams(),
                         use_plain: bool = False):
    """Frame-parallel guided VFT over a cohort of K videos, areas only (the
    cohort form; masks are never materialised).  JAX package:
    ``ygvft_parallel_multi``, over videos padded to one length; here the
    videos are ragged and no frame is computed for padding.

    init_frames (K, I, H, W); first_valid (K,) bool; first_box (K, 4) int;
    frames (sum T, H, W), valids (sum T,), boxes (sum T, 4): the videos'
    tracked frames, video i at [offsets[i], offsets[i + 1]) (``offsets``:
    K + 1 host ints).  Returns areas (sum T,) float32.

    Each video's areas are :func:`ygvft_parallel`'s on that video, bit for
    bit: its seed threshold comes from its own init frames, every other
    stage but the threshold chain is per frame, so all sum T frames go
    through one masked percentile, one compare and one top-n blob filter
    (one set of union-find launches instead of K), and the K chains run as
    ONE batched launch (:func:`thresh_chain_batch`).  The window or
    full-frame choice is made ONCE for the cohort, by one host read: if any
    box anywhere exceeds the 128² window, every video takes the full-frame
    pass.  Both passes are bit-identical, so the shared choice changes only
    the time."""
    p = params
    h, w = frames.shape[1:]
    dev = frames.device
    thresh0 = _ygvft_thresh0_batch(init_frames[:, -1].to(torch.float32),
                                   first_valid, first_box, p)
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
        thresh = thresh_chain_batch(thresh0, cur, n_px,
                                    torch.ones_like(valids), offsets, p.beta,
                                    use_plain)
        raw = (ffx < thresh[:, None, None]) & roix
        masks_x = top_n_blobs_batch(raw, p.max_glottal_components, use_plain)
        return masks_x.sum((1, 2)).to(torch.float32)

    win = 128
    fits = None
    if h >= win and w >= win:
        fits, oy, ox = roi_window_origin(boxes, h, w, win)
    if fits is None or not bool(fits):
        rows = torch.arange(h, device=dev)[None, :, None]
        cols = torch.arange(w, device=dev)[None, None, :]
        return tail(frames.to(torch.float32), roi_for(rows, cols))
    ar = torch.arange(win, device=dev)
    return tail(gather_windows(frames, oy, ox, win).to(torch.float32),
                roi_for(oy[:, None, None] + ar[None, :, None],
                        ox[:, None, None] + ar[None, None, :]))


def vft_parallel(init_frames, frames, active=None,
                 params: VFTParams = VFTParams(), use_plain: bool = False):
    """Frame-parallel VFT — same outputs as :func:`vft_scan` (the same
    kernels and rounding).  ``active`` may only disable a PREFIX (the init frames the
    caller overlays) and/or a contiguous tail: the motion-map and threshold
    recurrences treat inactive steps as identity, matching the scan.
    Both blob filters take the split route of
    ``ops/blobs.top_n_blobs_batch`` (single-region launches): same outputs as
    the dual route, fewer tensor ops at the small locked crop size.
    Returns (masks (T, H, W) bool, areas (T,) f32)."""
    p = params
    t = frames.shape[0]
    if active is None:
        active = torch.ones((t,), dtype=torch.bool, device=frames.device)
    prev0, lmap0, thresh0 = vft_initialize(init_frames, p, use_plain)

    ff = frames.to(torch.float32)
    # prev chain: the scan's carry keeps prev = last init frame until the
    # first active step, then follows frames; an inactive prefix maps to the
    # same chain as long as callers pass the frames the scan would see
    lmaps = motion_map(prev0, ff, lmap0, active, p.alpha, p.gaussian_ksize,
                       use_plain)

    rthr = _roi_threshold(lmaps, p.roi_threshold_ratio)
    roi = largest_blob_batch(lmaps > rthr[:, None, None], use_plain,
                             _split=True)

    cur, n_px = masked_percentile_u8_batch(ff, roi, p.glottal_percentile)
    thresh = _thresh_chain(thresh0, cur, n_px, active, p.beta, use_plain)

    raw = (ff < thresh[:, None, None]) & roi & active[:, None, None]
    masks = top_n_blobs_batch(raw, p.max_glottal_components, use_plain,
                              _split=True)
    return masks, masks.sum((1, 2)).to(torch.float32)


# ── sequential forms: one frame per step, explicit carry ────────────────────

def _ema_steps(carry, frame, roi_fn, p, use_plain: bool):
    """The part of a step both trackers share.  The two recurrences go
    through the same kernels as the frame-parallel forms, one step per launch
    (T = 1), so their rounding is the same; ``roi_fn(lmap)`` gives the ROI."""
    prev, lmap, thresh = carry
    ff = frame.to(torch.float32)
    one = torch.ones((1,), dtype=torch.bool, device=ff.device)
    lmap = motion_map(prev, ff[None], lmap, one, p.alpha, p.gaussian_ksize,
                      use_plain)[0]
    roi = roi_fn(lmap)
    # percentile(frame[roi]) if more than 10 px else the old threshold
    cur, n_px = percentile_from_hist(masked_histogram_u8(ff, roi),
                                     p.glottal_percentile)
    thresh = _thresh_chain(thresh, cur[None], n_px[None], one, p.beta,
                           use_plain)[0]
    raw = (ff < thresh) & roi
    mask = top_n_blobs(raw, p.max_glottal_components, use_plain)
    return (ff, lmap, thresh), mask


def vft_step(carry, frame, p: VFTParams, use_plain: bool = False):
    """One VFT frame.  frame: (H, W) integer-valued.  Returns (carry, mask)."""
    def roi_fn(lmap):
        return largest_blob(
            lmap > _roi_threshold(lmap, p.roi_threshold_ratio), use_plain)

    return _ema_steps(carry, frame, roi_fn, p, use_plain)


def ygvft_step(carry, frame, valid, box, p: YGVFTParams,
               use_plain: bool = False):
    """One YOLO-guided VFT frame; ``valid`` 0-d bool, ``box`` (4,) int."""
    h, w = frame.shape

    def roi_fn(lmap):
        return _bbox_mask(h, w, valid, box, device=frame.device)

    return _ema_steps(carry, frame, roi_fn, p, use_plain)


def _scan(step, carry, t: int, active, device):
    """Run ``step(carry, i)`` for i < t.  Inactive steps pass the carry
    through untouched and emit an empty mask; ``active`` stays on the device
    (no host read per frame)."""
    if active is None:
        active = torch.ones((t,), dtype=torch.bool, device=device)
    masks = []
    for i in range(t):
        c2, m = step(carry, i)
        a = active[i]
        carry = tuple(torch.where(a, new, old) for new, old in zip(c2, carry))
        masks.append(m & a)
    masks = torch.stack(masks)
    return carry, (masks, masks.sum((1, 2)).to(torch.float32))


def vft_scan_carry(carry, frames, active=None,
                   params: VFTParams = VFTParams(), use_plain: bool = False):
    """Segment-resumable VFT scan: run a segment from an explicit carry
    (prev, lmap, thresh) and return the updated carry.  Chained segment calls
    are bit-identical to one :func:`vft_scan` over the concatenation (the
    carry IS the full tracker state).
    Returns (carry, (masks (T, H, W) bool, areas (T,) f32))."""
    return _scan(lambda c, i: vft_step(c, frames[i], params, use_plain),
                 tuple(carry), frames.shape[0], active, frames.device)


def vft_scan(init_frames, frames, active=None,
             params: VFTParams = VFTParams(), use_plain: bool = False):
    """Full sequential VFT pass: initialize from init_frames, scan over
    frames.  Returns (masks (T, H, W) bool, areas (T,) f32)."""
    carry = vft_initialize(init_frames, params, use_plain)
    return vft_scan_carry(carry, frames, active, params, use_plain)[1]


def ygvft_scan_carry(carry, frames, valids, boxes, active=None,
                     params: YGVFTParams = YGVFTParams(),
                     use_plain: bool = False):
    """Segment-resumable YOLO-guided VFT scan from an explicit carry (prev,
    lmap, thresh); returns the updated carry.  (The motion map never reaches
    the guided tracker's output, but it is part of the carry and is kept up
    to date.)  Returns (carry, (masks (T, H, W) bool, areas (T,) f32))."""
    valids = valids.bool()
    return _scan(
        lambda c, i: ygvft_step(c, frames[i], valids[i], boxes[i], params,
                                use_plain),
        tuple(carry), frames.shape[0], active, frames.device)


def ygvft_scan(init_frames, first_valid, first_box, frames, valids, boxes,
               active=None, params: YGVFTParams = YGVFTParams(),
               use_plain: bool = False):
    """Full sequential YOLO-guided VFT pass.  init_frames: (N, H, W);
    frames: (T, H, W); valids: (T,) bool; boxes: (T, 4) int32 gated boxes.
    Returns (masks, areas)."""
    carry = ygvft_initialize(init_frames, first_valid, first_box, params,
                             use_plain)
    return ygvft_scan_carry(carry, frames, valids, boxes, active, params,
                            use_plain)[1]
