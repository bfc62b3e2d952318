"""Connected components and N-largest-blob filtering, for one mask and for
stacks of independent masks.

Counterpart of ``openglottal_tpu/ops/blobs.py``.  The connected-component
work is done by the min-propagation kernels of ``ops/blobs_cuda.py``: the
batch functions (``top_n_blobs_batch`` and its windowed form) follow the
reference's accelerator branch (label-propagation broadcasts, shifts and one
sort); the single-frame functions (``connected_components``, ``fill_holes``,
``top_n_blobs``, ``largest_blob``) use the reference's table form — gathers
and scatters through (H*W + 1)-entry tables indexed by component id — which
is the natural form on a GPU.  Counts are integers and every scatter is an
integer one, so results are exact and repeatable.

Semantics (cv2 ``findContours(RETR_EXTERNAL)`` + ``drawContours(FILLED)``,
reproduced topologically): blobs nested inside another blob's hole are
absorbed into the enclosing blob; enclosing blobs are ranked by foreground
pixel count (ties -> smaller label); the output is the FILLED region: holes
and nested content come out white, background pockets jointly enclosed by
several blobs stay black.

No padding to tile multiples: the CUDA kernels take any H, W >= 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from openglottal_tpu_torch.ops.blobs_cuda import (
    cc,
    cc_batch,
    dual_cc_batch,
    dual_min_prop_batch,
    min_prop_batch,
)


def _propagate(mask, connectivity: int, use_plain: bool = False):
    """CC labels of one (H, W) bool mask: component id = min flat index,
    pixels outside = H*W (int32).  One launch of the single-frame kernel."""
    return cc(mask.bool(), connectivity, use_plain=use_plain)


def _propagate_batch(masks, connectivity: int, use_plain: bool = False):
    """Per-frame CC labels of a (T, H, W) stack, one launch."""
    return cc_batch(masks.bool(), connectivity, use_plain=use_plain)


def connected_components(mask, connectivity: int = 8,
                         use_plain: bool = False):
    """Label the components of a boolean (H, W) mask.  Returns int32 labels:
    component id = min flat index in the component; background = H*W."""
    return _propagate(mask, connectivity, use_plain)


def _border_ids(lab):
    return torch.cat([lab[0, :], lab[-1, :], lab[:, 0], lab[:, -1]])


def fill_holes(mask, use_plain: bool = False):
    """Fill interior holes: background 4-components not touching the border."""
    mask = mask.bool()
    h, w = mask.shape
    bg = ~mask
    lab = _propagate(bg, 4, use_plain).long()
    reach = torch.zeros(h * w + 1, dtype=torch.bool, device=mask.device
                        ).index_fill_(0, _border_ids(lab), True)
    is_outside = reach[lab] & bg
    return mask | (bg & ~is_outside)


def _component_tree(mask, use_plain: bool = False):
    """Nesting analysis of foreground 8-components and background
    4-components; see :func:`_component_tree_from_labels`."""
    mask = mask.bool()
    labF = _propagate(mask, 8, use_plain)
    labB = _propagate(~mask, 4, use_plain)
    return _component_tree_from_labels(mask, labF, labB)


def _component_tree_from_labels(mask, labF, labB):
    """Gather/scatter part of :func:`_component_tree`, given the label maps.

    A component's id is the flat index of its topmost-leftmost pixel, and the
    pixel directly ABOVE that root pixel always belongs to the component's
    enclosing region (for a background comp: the enclosing foreground comp;
    for a foreground comp: the background comp it is embedded in).  That
    gives parent pointers without any contour tracing.

    Returns (labF, labB, rootF, hole): the labels as int64, ``rootF`` (HW+1,)
    the absorb-root per foreground comp id (nested comps resolve to their
    top-level enclosing comp, to nesting depth 4), ``hole`` (HW+1,) bool per
    background comp id — True iff a FILLED draw of its enclosing contour
    would paint it."""
    h, w = mask.shape
    hw = h * w
    dev = mask.device
    labF, labB = labF.long(), labB.long()
    flatF, flatB = labF.reshape(-1), labB.reshape(-1)

    ids = torch.arange(hw + 1, device=dev)
    up = torch.where(ids >= w, ids - w, hw)   # row-0 roots: no parent
    tail = torch.full((1,), hw, dtype=torch.long, device=dev)
    fg_parent = torch.cat([flatF, tail])[up]  # bg comp id -> enclosing fg comp
    bg_parent = torch.cat([flatB, tail])[up]  # fg comp id -> surrounding bg

    # bg comps touching the border are outside, never holes
    outside = torch.zeros(hw + 1, dtype=torch.bool, device=dev).index_fill_(
        0, torch.cat([_border_ids(labB), tail]), True)

    # bg comp H is NOT a hole if some 8-adjacent fg comp X is neither H's
    # enclosing comp nor nested inside H (bg_parent[X] != H)
    fgp_pix = fg_parent[flatB].view(h, w)
    bgpar_pix = bg_parent[flatF].view(h, w)
    padF = F.pad(labF, (1, 1, 1, 1), value=hw)
    padP = F.pad(bgpar_pix, (1, 1, 1, 1), value=hw)
    bad_any = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nbF = padF[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            nbP = padP[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            bad_any |= (nbF != hw) & (nbF != fgp_pix) & (nbP != labB)
    viol = torch.zeros(hw + 1, dtype=torch.int32, device=dev).index_add_(
        0, flatB, (bad_any & ~mask).reshape(-1).to(torch.int32)) > 0
    hole = ~outside & ~viol & (fg_parent != hw)

    rootF = ids
    for _ in range(4):   # absorb-root chase (depth <= 4 in real masks)
        b = bg_parent[rootF]
        rootF = torch.where(hole[b], fg_parent[b], rootF)
    return labF, labB, rootF, hole


def _select_top_n(mask, labF, labB, n: int):
    """Rank + paint given the label maps.  Components are ranked by integer
    foreground pixel count, ties towards the smaller label — written out as
    one int64 key, since ``torch.topk`` promises no order among equals."""
    h, w = mask.shape
    hw = h * w
    dev = mask.device
    labF, labB, rootF, hole = _component_tree_from_labels(mask, labF, labB)
    flatF, flatB = labF.reshape(-1), labB.reshape(-1)
    mflat = mask.reshape(-1)

    pix_rootF = rootF[flatF]                   # fg pixels -> top-level comp
    ids = torch.arange(hw + 1, device=dev)
    counts = torch.zeros(hw + 1, dtype=torch.long, device=dev).index_add_(
        0, pix_rootF, mflat.long())
    counts = torch.where(ids == hw, 0, counts)   # the "no component" slot
    top_idx = torch.topk(counts * (hw + 1) + (hw - ids), min(n, hw + 1)
                         ).indices
    keep = torch.zeros(hw + 1, dtype=torch.bool, device=dev)
    keep[top_idx] = counts[top_idx] > 0

    out_fg = keep[pix_rootF] & mflat
    # bg pixel painted iff its comp is a hole whose top-level owner is kept
    up = torch.where(ids >= w, ids - w, hw)
    tail = torch.full((1,), hw, dtype=torch.long, device=dev)
    owner = rootF[torch.cat([flatF, tail])[up]]   # bg comp id -> owner
    out_bg = hole[flatB] & keep[owner[flatB]] & ~mflat
    return (out_fg | out_bg).view(h, w)


def top_n_blobs(mask, n: int, use_plain: bool = False):
    """Keep the ``n`` largest blobs of ONE (H, W) mask with cv2
    findContours(RETR_EXTERNAL) + drawContours(FILLED) semantics (see the
    module docstring).  Two single-frame CC launches (mask 8-connected,
    background 4-connected), then tables.  Returns a bool mask."""
    mask = mask.bool()
    labF = _propagate(mask, 8, use_plain)
    labB = _propagate(~mask, 4, use_plain)
    return _select_top_n(mask, labF, labB, n)


def largest_blob(mask, use_plain: bool = False):
    """Largest connected component of one (H, W) mask."""
    return top_n_blobs(mask, 1, use_plain)


def _min_prop_batch(region, init, connectivity: int, use_plain: bool = False,
                    labels=None):
    """Component broadcast over a (T, H, W) bool region: every pixel of each
    component converges to the MIN of ``init`` (int32) over that component;
    pixels outside the region = H*W.

    Seeding one value at a component's single root pixel (H*W everywhere
    else) broadcasts that value over the component — distinct components are
    never adjacent within their own region mask, so values cannot leak."""
    return min_prop_batch(region, init.to(torch.int32), connectivity,
                          use_plain=use_plain, labels=labels)


def _shift_down_frame(x, fill):
    """Frame-local shift: value of the pixel ABOVE (row r-1); row 0 -> fill."""
    top = torch.full_like(x[:, :1, :], fill)
    return torch.cat([top, x[:, :-1, :]], dim=1)


def top_n_blobs_batch(masks: torch.Tensor, n: int, use_plain: bool = False,
                      _split: bool = False):
    """Keep the ``n`` largest blobs of every frame of a (T, H, W) stack.

      1. labF/labB: ONE dual-region CC launch (mask 8-connected, background
         4-connected; the regions are disjoint).
      2. Parent fields: at each component's root pixel (label == own index)
         the pixel directly above belongs to the enclosing region, so ONE
         dual-region broadcast of that value yields per-pixel enclosing
         component labels with no table lookups.
         (``_split=True`` takes the reference's other route through steps 1
         and 2 — two single-region CC launches and two single-region
         broadcasts — with the same result.  ``vft_parallel`` takes it:
         at its small size-locked crops it skips the tensor ops that build
         the code and take the dual result apart, and that outweighed the
         two extra launches on an H100; at the guided tracker's 128x128
         windows the dual route was the faster one.)
      3. FILLED-hole test: a background component is a hole unless it touches
         the border or 8-touches a foreground component that is neither its
         encloser nor nested inside it; the OR over the component is a
         min-propagation (4-connected) of the negated seed.
      4. Absorb chase: a nested family is one connected cluster of
         (mask | hole pixels) whose top-level root is the cluster's min flat
         index, so one 8-connected pass over that union — warm-started from
         labF — replaces any pointer chase, to arbitrary nesting depth.
      5. Rank: sort per-frame top-level owner labels of foreground pixels,
         run-length the sorted array, top-k on sizes, ties by n masked-min
         passes.  Paint = compare against the n kept labels.

    Returns a (T, H, W) bool mask.
    """
    masks = masks.bool()
    t, h, w = masks.shape
    hw = h * w
    dev = masks.device
    idx = torch.arange(hw, dtype=torch.int32, device=dev).view(1, h, w)
    bg = ~masks

    if _split:
        labF = _propagate_batch(masks, 8, use_plain)
        labB = _propagate_batch(bg, 4, use_plain)
    else:
        code = 2 - masks.to(torch.uint8)        # 1: mask, 2: background
        labFB = dual_cc_batch(code, use_plain=use_plain)
        labF = torch.where(masks, labFB, hw)
        labB = torch.where(bg, labFB, hw)

    # enclosing fg comp per bg pixel / surrounding bg comp per fg pixel
    fgp_seed = torch.where(bg & (labB == idx), _shift_down_frame(labF, hw), hw)
    bgp_seed = torch.where(masks & (labF == idx), _shift_down_frame(labB, hw),
                           hw)
    if _split:
        fgp = _min_prop_batch(bg, fgp_seed, 4, use_plain, labels=labB)
        bgp = _min_prop_batch(masks, bgp_seed, 8, use_plain, labels=labF)
    else:
        parent = dual_min_prop_batch(
            code, torch.where(masks, bgp_seed, fgp_seed), use_plain=use_plain)
        fgp = torch.where(bg, parent, hw)
        bgp = torch.where(masks, parent, hw)

    # hole violation: an 8-adjacent fg comp that is neither my enclosing comp
    # nor nested inside my comp
    bad = torch.zeros_like(masks)
    padF = F.pad(labF, (1, 1, 1, 1), value=hw)
    padP = F.pad(bgp, (1, 1, 1, 1), value=hw)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nbF = padF[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            nbP = padP[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            bad |= (nbF != hw) & (nbF != fgp) & (nbP != labB)
    border = torch.zeros((1, h, w), dtype=torch.bool, device=dev)
    border[:, 0, :] = True
    border[:, -1, :] = True
    border[:, :, 0] = True
    border[:, :, -1] = True
    seed_nh = (~(bg & (bad | border))).to(torch.int32)  # 0 = surely no hole
    nh = _min_prop_batch(bg, seed_nh, 4, use_plain, labels=labB)
    hole_pix = bg & (nh == 1) & (fgp != hw)

    union = masks | hole_pix
    # warm-started CC of the union: seeding mask pixels with their converged
    # labF makes the component minimum equal the cluster's min flat index
    # (every mask pixel's index >= its labF root)
    owner = _min_prop_batch(
        union, torch.where(masks, labF, torch.where(hole_pix, idx, hw)), 8,
        use_plain)

    # rank by fg pixel count (ties -> smaller label), keep n, paint the union
    om = torch.where(masks, owner, hw).view(t, hw)
    s = torch.sort(om, dim=1).values
    pos = torch.arange(hw, dtype=torch.int32, device=dev).view(1, hw)
    bnd = torch.cat([torch.ones((t, 1), dtype=torch.bool, device=dev),
                     s[:, 1:] != s[:, :-1]], dim=1)
    nxt = torch.cat([torch.where(bnd, pos, hw)[:, 1:],
                     torch.full((t, 1), hw, dtype=torch.int32, device=dev)],
                    dim=1)
    # next run boundary after i: reverse cumulative min
    nxt = torch.cummin(nxt.flip(1), dim=1).values.flip(1)
    size = nxt - pos
    # (size desc, label asc) top-n without a packed key (a packed int32 key
    # overflows once a blob exceeds half a 256x256 frame): top-k ranks sizes
    # exactly, ties resolve by n masked-min passes over the sorted labels
    size_key = torch.where(bnd & (s < hw), size, -1)
    topsz = torch.topk(size_key, n, dim=1).values          # (t, n) descending
    prev_sz = torch.full((t,), -2, dtype=torch.int32, device=dev)
    prev_lb = torch.full((t,), -1, dtype=torch.int32, device=dev)
    klabs = []
    for j in range(n):
        szj = topsz[:, j]
        cand = (size_key == szj[:, None]) & (
            (szj != prev_sz)[:, None] | (s > prev_lb[:, None]))
        lb = torch.where(cand, s, hw).min(1).values        # smallest unused
        klabs.append(torch.where(szj > 0, lb, hw))
        prev_sz, prev_lb = szj, lb
    keep = torch.zeros_like(masks)
    for kl in klabs:                                       # (t,) kept labels
        keep |= (owner == kl[:, None, None]) & (kl < hw)[:, None, None]
    return union & keep


def roi_window_origin(boxes: torch.Tensor, h: int, w: int, win: int):
    """Per-frame (win, win) window origins containing each box plus a 1-px
    in-frame background margin.  Returns (fits, oy, ox): ``fits`` is a 0-d
    bool tensor, True iff EVERY box is at most win-2 on both sides.

    Origin covers [x1+1-win, x1+1) clamped in-frame; given the box fits,
    this also covers x0-1 (x1+1-win <= x0-1  <=>  width <= win-2)."""
    boxes = boxes.to(torch.int32)
    x0, y0, x1, y1 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    fits = (((x1 - x0) <= win - 2) & ((y1 - y0) <= win - 2)).all()
    ox = torch.clamp(x1 + 1 - win, 0, w - win)
    oy = torch.clamp(y1 + 1 - win, 0, h - win)
    return fits, oy, ox


def gather_windows(x: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                   win: int):
    """(T, H, W) -> (T, win, win): frame t's window at (oy[t], ox[t])."""
    ar = torch.arange(win, device=x.device)
    rows = (oy.long()[:, None] + ar)[:, :, None]
    cols = (ox.long()[:, None] + ar)[:, None, :]
    return x[torch.arange(x.shape[0], device=x.device)[:, None, None],
             rows, cols]


def scatter_windows(sub: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                    h: int, w: int):
    """Inverse of :func:`gather_windows` into zero (T, h, w) frames."""
    t, win = sub.shape[0], sub.shape[1]
    ar = torch.arange(win, device=sub.device)
    rows = (oy.long()[:, None] + ar)[:, :, None]
    cols = (ox.long()[:, None] + ar)[:, None, :]
    out = torch.zeros((t, h, w), dtype=sub.dtype, device=sub.device)
    out[torch.arange(t, device=sub.device)[:, None, None], rows, cols] = sub
    return out


def top_n_blobs_batch_roi(masks: torch.Tensor, boxes: torch.Tensor, n: int,
                          win: int = 128, use_plain: bool = False):
    """:func:`top_n_blobs_batch` for masks CONFINED to per-frame boxes — the
    guided-VFT case.  Runs the identical machinery on a per-frame (win, win)
    window positioned to contain the box plus a 1-px in-frame background
    margin, then paints the result back into full frames; bit-identical to
    the full-frame pass (the argument is in the JAX package's docstring and
    pinned by the tests).

    Falls back to the full-frame pass when any box exceeds win-2 on a side.
    That choice is a host branch on one scalar (one small device-to-host
    read)."""
    t, hh, ww = masks.shape
    if hh < win or ww < win:
        return top_n_blobs_batch(masks, n, use_plain)
    fits, oy, ox = roi_window_origin(boxes, hh, ww, win)
    if not bool(fits):
        return top_n_blobs_batch(masks, n, use_plain)
    sub = gather_windows(masks.bool(), oy, ox, win)
    return scatter_windows(top_n_blobs_batch(sub, n, use_plain), oy, ox,
                           hh, ww)


def largest_blob_batch(masks: torch.Tensor, use_plain: bool = False,
                       _split: bool = False):
    """Largest component per frame of a (T, H, W) stack."""
    return top_n_blobs_batch(masks, 1, use_plain, _split)
