"""Inputs that are hard for the training kernels of ``csrc/train.cu``, made
from a seed with numpy alone, and plain-PyTorch models of the order in which
``og_unet_augment`` and ``og_bce_dice`` add their sums.

Augment families (``augment_case``), each one batch of 256² frames:

  ``b1``            B = 1, drawn parameters;
  ``b3_all_on``     B = 3, every flag on (flips, scale, noise, 5-tap blur,
                    brightness, contrast);
  ``b3_all_off``    B = 3, every flag off (scale 1): the gather alone;
  ``b16_extremes``  B = 16 (the trainers' batch): angles of ±30 (the draw's
                    limits), ±90, 180 and 45 degrees, scales of 0.85 and 1.15,
                    3- and 5-tap blurs at sigma 0.5 and 1.5, brightness and
                    contrast at 0.7 and 1.3, noise at sigma 0.05;
  ``b17_frames``    B = 17 (more samples than a wave of clusters): black,
                    saturated and constant frames beside random ones; full,
                    empty and edge masks; drawn parameters.

Loss families (``loss_cases``), each a list of (label, logits, targets,
valid):

  ``pm40``          (16, 1, 256, 256) logits N(0, 4) with ±40 among them;
  ``pm88``          logits of ±88 (exp(-88) is subnormal) and ±90 (exp(90)
                    overflows to inf) among N(0, 30);
  ``soft_targets``  targets uniform in [0, 1], not binary; targets all 0 and
                    all 1;
  ``masked``        the validation tail's padding: the last rows invalid, a
                    row in the middle invalid;
  ``all_invalid``   every row invalid (the count falls to 1);
  ``sizes``         other sizes of a row: 7x3, one element, 2x17x19.

Backward families (``bwd_cases``), beside the loss's, in the same form:

  ``per_row_odd``   rows of 1,961, 35 and 3 elements (not a multiple of 4:
                    16-byte groups straddle rows), masked and not;
  ``offset``        logits and targets one element past an allocation
                    (``stress_inputs`` offsets them on the device: the
                    kernel's unaligned path), masked and not;
  ``one_row``       a batch of one row, masked and not, and a row of 7;
  ``all_invalid``   masked calls whose every row is invalid.

TAL families (``tal_cases``), each at 256² (A = 1,344) and 64² (A = 84)
anchors, a list of (label, logits, predicted boxes, gts, gt validity):

  ``m1``, ``m4``, ``m8``  B = 16 with M = 1, 4 and 8 drawn gts, predicted
                    boxes drawn over the frame (many candidates);
  ``edges``         a gt covering the whole frame, gts at the frame's
                    right and bottom edges, invalid gts (an image with
                    none valid), zero-area and inverted gts, degenerate
                    predicted boxes;
  ``few``           gts with fewer than 10 positive candidates, with
                    none (no anchor centre inside; predicted boxes that
                    miss the gt);
  ``ties``          equal align values within a gt's top 10 (equal
                    logits and boxes) and across gts (a gt repeated; two
                    gts equally far from every predicted box): the lower
                    anchor and the first gt win;
  ``batches``       B = 1 and B = 17.

``tal_select_model`` is the assignment as ``og_tal_assign`` selects it:
packed keys (the align value's bits, then the lower anchor), candidates
dealt to 32 lanes, each lane's own top 10, rounds that take the warp's
largest value and, among the lanes that hold it, the lowest anchor, then
the resolve by the first gt with the largest value.  It equals
``tal_assign_plain`` bit for bit on the CPU, whatever order the candidates
come in; on the card the kernel is held bit-equal to it.

The order models: ``tile_mean`` is each image's mean as ``og_unet_augment``
adds it (per 16-row tile each column over its rows in order, the warps'
shuffle trees over 32 columns, the 8 warps in order, the 16 tiles in
order); ``augment_model`` is the plain augment with that mean.
``bce_dice_model`` is the loss as ``og_bce_dice`` adds it (element i to
thread i mod (blocks * 256), each thread in order of i, the warps' trees,
the 8 warps in order, the blocks' partials in double in the fixed order of
the finish), from per-element terms in the kernel's form (``bce_terms``).
On the card both are held bit-equal to their kernels; on the CPU within
``TRAIN_TOL`` of the plain versions.  ``stress_inputs`` gives every case of
every family as tensors on a device, and ``same_bits`` is the equality that
holds a kernel to a model, a repeat launch or another build.

    case = augment_case("b16_extremes", seed=0)
    rows = augment_params(case["draws"])          # (16, 16) float32
    for label, x, t, valid in loss_cases("masked", seed=0): ...
"""

from __future__ import annotations

import numpy as np
import torch

from openglottal_tpu_torch.ops import train_cuda

S = train_cuda.AUG_SIZE
TILE = train_cuda.AUG_TILE_ROWS
WARP = 32
THREADS = 256          # threads of an og_bce_dice block

# how far each training kernel may be from its plain version (the augment
# image differs only through each image's mean, summed in another order; the
# loss's sums are float32 in the kernel's blocks and pairwise in torch's,
# relative to the value's magnitude), as chip_smoke.py holds them
TRAIN_TOL = {"unet_augment": 1e-5, "bce_dice": 1e-4, "bce_dice_bwd": 1e-4,
             "tal_assign": 1e-5}

AUG_FAMILIES = ("b1", "b3_all_on", "b3_all_off", "b16_extremes",
                "b17_frames")
LOSS_FAMILIES = ("pm40", "pm88", "soft_targets", "masked", "all_invalid",
                 "sizes")
BWD_FAMILIES = ("per_row_odd", "offset", "one_row", "all_invalid")
TAL_FAMILIES = ("m1", "m4", "m8", "edges", "few", "ties", "batches")
TAL_SIZES = (256, 64)


# ── og_unet_augment ─────────────────────────────────────────────────────────

def _draws(b: int, rng, flags=None) -> dict:
    """Augmentation draws as the JAX package's ``_sample_params`` makes them
    (the scale already where ``do_scale``), numpy; ``flags`` True / False
    forces every flag."""
    def flag():
        return np.full(b, flags) if flags is not None else rng.random(b) > 0.5

    hflip, vflip = flag(), flag()
    angle = rng.uniform(-30, 30, b).astype(np.float32)
    scale = np.where(flag(), rng.uniform(0.85, 1.15, b), 1.0)
    do_noise = flag()
    sigma_n = rng.uniform(0.01, 0.05, b).astype(np.float32)
    do_blur, k5 = flag(), flag()
    sigma_b = rng.uniform(0.5, 1.5, b).astype(np.float32)
    bright = np.where(flag(), rng.uniform(0.7, 1.3, b), 1.0)
    contrast = np.where(flag(), rng.uniform(0.7, 1.3, b), 1.0)
    return {"hflip": hflip, "vflip": vflip, "angle": angle,
            "scale": scale.astype(np.float32), "do_noise": do_noise,
            "sigma_n": sigma_n, "do_blur": do_blur, "k5": k5,
            "sigma_b": sigma_b, "bright": bright.astype(np.float32),
            "contrast": contrast.astype(np.float32)}


def _frames(b: int, rng):
    imgs = rng.integers(0, 256, (b, S, S)).astype(np.uint8)
    msks = np.zeros((b, S, S), np.uint8)
    msks[:, 90:170, 100:160] = 1
    return imgs, msks


def augment_case(family: str, seed: int = 0) -> dict:
    """One augment family's batch: {"imgs", "msks": (B, 256, 256) uint8,
    "draws": the JAX package's draws (numpy), "noise": (B, 256, 256)
    float32}."""
    rng = np.random.default_rng(seed)
    if family == "b1":
        b, draws = 1, _draws(1, rng)
    elif family in ("b3_all_on", "b3_all_off"):
        on = family == "b3_all_on"
        b, draws = 3, _draws(3, rng, flags=on)
        if on:
            draws["scale"] = np.float32([0.85, 1.15, 0.93])
            draws["k5"] = np.array([True, False, True])
        else:
            draws["scale"] = np.ones(3, np.float32)
    elif family == "b16_extremes":
        b = 16
        draws = _draws(b, rng, flags=True)
        draws["angle"] = np.float32([30, -30, 90, -90, 180, 45, 0, -45,
                                     30, -30, 90, 180, 0, 45, -90, 15])
        draws["scale"] = np.float32([0.85, 1.15] * 8)
        draws["hflip"] = np.arange(b) % 3 == 0
        draws["vflip"] = np.arange(b) % 4 == 1
        draws["do_noise"] = np.arange(b) % 2 == 0
        draws["sigma_n"] = np.full(b, 0.05, np.float32)
        draws["do_blur"] = np.arange(b) % 4 != 3
        draws["k5"] = np.arange(b) % 2 == 1
        draws["sigma_b"] = np.float32([0.5, 1.5] * 8)[::-1].copy()
        draws["bright"] = np.float32([0.7, 1.3, 1.0, 0.7] * 4)
        draws["contrast"] = np.float32([1.3, 0.7, 0.7, 1.0] * 4)
    elif family == "b17_frames":
        b, draws = 17, _draws(17, rng)
    else:
        raise ValueError(f"unknown augment family {family!r}")
    imgs, msks = _frames(b, rng)
    if family == "b17_frames":
        imgs[0] = 0                  # black
        imgs[1] = 255                # saturated
        imgs[2] = 128                # constant
        imgs[3, :, :128] = 255       # half saturated, half black
        imgs[3, :, 128:] = 0
        msks[4] = 1                  # full mask
        msks[5] = 0                  # empty mask
        msks[6, :, :1] = 1           # the frame's edges
        msks[6, -1] = 1
    elif family == "b3_all_on":
        imgs[0] = 255
        msks[1] = 1
    noise = rng.standard_normal((b, S, S)).astype(np.float32)
    return {"imgs": imgs, "msks": msks, "draws": draws, "noise": noise}


def augment_params(draws: dict, device="cpu") -> torch.Tensor:
    """(B, 16) float32 parameter rows (``train_cuda.AUG_PARAMS``) of the
    draws, by the port's formulas (``data/augment.sample_params``)."""
    from openglottal_tpu_torch.data.augment import _DEG2RAD, blur_taps

    def t(k, dtype=torch.float32):
        return torch.as_tensor(np.asarray(draws[k]), device=device
                               ).to(dtype)

    th = t("angle") * _DEG2RAD.to(device)
    taps = blur_taps(t("k5", torch.bool), t("sigma_b"))
    rows = torch.zeros((th.shape[0], train_cuda.N_AUG_PARAMS),
                       dtype=torch.float32, device=device)
    rows[:, 0], rows[:, 1] = t("hflip"), t("vflip")
    rows[:, 2], rows[:, 3], rows[:, 4] = torch.cos(th), torch.sin(th), \
        t("scale")
    rows[:, 5], rows[:, 6], rows[:, 7] = t("do_noise"), t("sigma_n"), \
        t("do_blur")
    rows[:, 8:13] = taps
    rows[:, 13], rows[:, 14] = t("bright"), t("contrast")
    return rows


def _tree(v: torch.Tensor) -> torch.Tensor:
    """The last axis (32 lanes) added as a warp's __shfl_down tree (16, 8,
    4, 2, 1) leaves it in lane 0."""
    o = WARP // 2
    while o:
        v = v[..., :o] + v[..., o:2 * o]
        o //= 2
    return v[..., 0]


def _in_order(v: torch.Tensor) -> torch.Tensor:
    """The last axis added from 0 in order: ((0 + v0) + v1) + ..."""
    s = torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    for k in range(v.shape[-1]):
        s = s + v[..., k]
    return s


def tile_mean(img: torch.Tensor) -> torch.Tensor:
    """Each (256, 256) float32 image's mean (B, 1, 1) as ``og_unet_augment``
    adds it."""
    b = img.shape[0]
    tiles = img.reshape(b, S // TILE, TILE, S)
    cols = _in_order(tiles.transpose(2, 3))          # (B, 16, 256)
    warps = _tree(cols.reshape(b, S // TILE, S // WARP, WARP))
    parts = _in_order(warps)                         # (B, 16)
    return (_in_order(parts) / float(S * S)).reshape(b, 1, 1)


def augment_model(imgs_u8, msks_u8, params, noise):
    """``unet_augment_plain`` with the kernel's order of the mean: the
    kernel's images and masks, bit for bit on the card."""
    img, msk = train_cuda.augment_before_contrast(imgs_u8, msks_u8, params,
                                                  noise)
    return train_cuda.apply_contrast(img, params, tile_mean(img)), msk


# ── og_bce_dice ─────────────────────────────────────────────────────────────

def _loss_logits(shape, rng, sd):
    return rng.normal(0, sd, shape).astype(np.float32)


def _binary(shape, rng, p=0.3):
    return (rng.random(shape) < p).astype(np.float32)


def loss_cases(family: str, seed: int = 0) -> list:
    """One loss family: [(label, logits, targets, valid or None)], float32
    numpy arrays of shape (B, ...) and a (B,) bool mask."""
    rng = np.random.default_rng(seed)
    big = (16, 1, S, S)
    if family == "pm40":
        x = _loss_logits(big, rng, 4.0)
        flat = x.reshape(-1)
        pick = rng.choice(flat.size, 4096, replace=False)
        flat[pick] = np.where(np.arange(4096) % 2, 40.0, -40.0)
        flat[:4] = [40.0, -40.0, 0.0, -0.0]
        return [("pm40 16x1x256x256", x, _binary(big, rng), None)]
    if family == "pm88":
        shape = (5, 1, 64, 96)
        x = _loss_logits(shape, rng, 30.0)
        flat = x.reshape(-1)
        flat[::7] = 88.0
        flat[3::7] = -88.0
        flat[5::11] = 90.0
        flat[6::11] = -90.0
        return [("pm88 5x1x64x96", x, _binary(shape, rng, 0.5), None),
                ("pm88 masked", x, _binary(shape, rng, 0.5),
                 np.array([True, False, True, True, False]))]
    if family == "soft_targets":
        shape = (3, 1, 37, 53)
        x = _loss_logits(shape, rng, 3.0)
        return [("soft targets 3x1x37x53", x,
                 rng.random(shape).astype(np.float32), None),
                ("targets all 0", x, np.zeros(shape, np.float32), None),
                ("targets all 1 masked", x, np.ones(shape, np.float32),
                 np.array([True, False, True]))]
    if family == "masked":
        valid = np.arange(16) < 11
        mid = np.array([True, True, False, True, True])
        return [("masked tail 16x1x256x256", _loss_logits(big, rng, 4.0),
                 _binary(big, rng), valid),
                ("masked middle 5x1x64x96", _loss_logits((5, 1, 64, 96), rng,
                                                         4.0),
                 _binary((5, 1, 64, 96), rng), mid)]
    if family == "all_invalid":
        shape = (4, 1, 32, 32)
        return [("all invalid 4x1x32x32", _loss_logits(shape, rng, 4.0),
                 _binary(shape, rng), np.zeros(4, bool))]
    if family == "sizes":
        return [(f"size {'x'.join(map(str, sh))}", _loss_logits(sh, rng, 4.0),
                 _binary(sh, rng), v)
                for sh, v in (((1, 1, 7, 3), None), ((2, 1, 1, 1), None),
                              ((3, 2, 17, 19), np.array([True, False,
                                                         True])))]
    raise ValueError(f"unknown loss family {family!r}")


def bwd_cases(family: str, seed: int = 0) -> list:
    """One backward family: [(label, logits, targets, valid or None)] as
    ``loss_cases`` gives them."""
    rng = np.random.default_rng(seed)

    def case(label, shape, valid=None, p=0.3):
        return (label, _loss_logits(shape, rng, 4.0), _binary(shape, rng, p),
                valid)

    if family == "per_row_odd":
        return [case("per_row 1961 3x1x37x53", (3, 1, 37, 53)),
                case("per_row 35 masked 16x1x7x5", (16, 1, 7, 5),
                     np.arange(16) % 5 != 2),
                case("per_row 3 masked 5x1x1x3", (5, 1, 1, 3),
                     np.array([True, False, True, True, False]))]
    if family == "offset":
        return [case("offset 16x1x64x64", (16, 1, 64, 64)),
                case("offset masked 6x1x33x31", (6, 1, 33, 31),
                     np.array([True, True, False, True, False, True]))]
    if family == "one_row":
        return [case("one row 1x1x64x64", (1, 1, 64, 64)),
                case("one row masked 1x1x64x64", (1, 1, 64, 64),
                     np.array([True])),
                case("one row 1x1x1x7", (1, 1, 1, 7))]
    if family == "all_invalid":
        return [case("all invalid 16x1x32x32", (16, 1, 32, 32),
                     np.zeros(16, bool)),
                case("all invalid 3x1x5x7", (3, 1, 5, 7), np.zeros(3, bool))]
    raise ValueError(f"unknown backward family {family!r}")


def bce_terms(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(4, n) float32 per-element terms in ``og_bce_dice``'s form: BCE (the
    two log-sigmoids from one log1p(exp(-|x|))), sigma*t, sigma, t."""
    x, t = x.reshape(-1), t.reshape(-1)
    l1p = torch.log1p(torch.exp(-x.abs()))
    ls_pos = -(torch.clamp_min(-x, 0.0) + l1p)
    ls_neg = -(torch.clamp_min(x, 0.0) + l1p)
    bce = -(t * ls_pos) - (1 - t) * ls_neg
    p = torch.ones_like(x) / (1 + torch.exp(-x))
    return torch.stack([bce, p * t, p, t])


def bce_dice_model(x, t, valid=None, blocks: int = train_cuda.BCE_BLOCKS,
                   terms=None):
    """``og_bce_dice``'s outputs (sums (4,), count, loss), float32, from the
    per-element ``terms`` (``bce_terms(x, t)`` by default) added in the
    kernel's order."""
    dev = x.device
    rows = x.shape[0]
    n = x.numel()
    per_row = n // max(rows, 1)
    terms = bce_terms(x, t) if terms is None else terms
    keep = torch.ones(n, dtype=torch.bool, device=dev)
    if valid is not None:
        keep = valid.to(dev).repeat_interleave(per_row)
    # element i to thread i mod (blocks * 256), in order of i; a skipped
    # element adds nothing (+0 leaves a sum that is never -0 unchanged)
    nt = blocks * THREADS
    steps = -(-n // nt)
    pad = steps * nt - n
    f32 = torch.float32
    terms = torch.cat([terms.to(f32), torch.zeros((4, pad), dtype=f32,
                                                  device=dev)], 1)
    keep = torch.cat([keep, torch.zeros(pad, dtype=torch.bool, device=dev)])
    terms = torch.where(keep, terms, 0.0).reshape(4, steps, nt)
    per_thread = _in_order(terms.transpose(1, 2))                # (4, nt)
    warps = _tree(per_thread.reshape(4, blocks, THREADS // WARP, WARP))
    partial = _in_order(warps)                                   # (4, blocks)
    # the finish: thread k adds partials k, k + 256, ... in double, then a
    # tree over the 256 threads (halves added onto the first half)
    laps = -(-blocks // THREADS)
    d = torch.cat([partial.double(), torch.zeros(
        (4, laps * THREADS - blocks), dtype=torch.float64, device=dev)], 1)
    acc = _in_order(d.reshape(4, laps, THREADS).transpose(1, 2))  # (4, 256)
    h = THREADS // 2
    while h:
        acc = acc[:, :h] + acc[:, h:2 * h]
        h //= 2
    sums = acc[:, 0].to(f32)
    nvalid = rows if valid is None else int(valid.sum())
    cnt = torch.clamp_min(torch.tensor(float(nvalid), dtype=f32, device=dev)
                          * torch.tensor(float(per_row), dtype=f32,
                                         device=dev), 1.0)
    one, two, half = (torch.tensor(v, dtype=f32, device=dev)
                      for v in (1.0, 2.0, 0.5))
    eps = torch.tensor(train_cuda.DICE_EPS, dtype=f32, device=dev)
    bce = sums[0] / cnt
    dl = one - (two * sums[1] + eps) / ((sums[2] + sums[3]) + eps)
    return sums, cnt, half * bce + half * dl


def loss_tolerance_ok(got, want, tol: float) -> bool:
    """``got`` within ``tol`` of ``want`` relative to the largest magnitude
    of ``want`` (the measure of ``chip_smoke.hold_train`` for the loss)."""
    got, want = got.double(), want.double()
    scale = max(float(want.abs().max()), 1e-30)
    return float((got - want).abs().max()) / scale <= tol


# ── og_tal_assign ───────────────────────────────────────────────────────────

def tal_pts(size: int) -> np.ndarray:
    """(A, 2) float32 anchor centres of a size² frame (YOLOv8's strides)."""
    from openglottal_tpu_torch.models.yolo import anchors_for

    return anchors_for(size, size)[0].numpy()


def _tal_draw(b: int, m: int, size: int, rng):
    """Drawn gts (all valid) and predicted boxes scattered over the frame,
    logits N(0, 2): (logits, pred, gt, gv) float32 / bool numpy."""
    a = len(tal_pts(size))
    lo = rng.uniform(0, size * 0.7, (b, m, 2))
    hi = np.minimum(lo + rng.uniform(4, size * 0.6, (b, m, 2)), size)
    gt = np.concatenate([lo, hi], -1).astype(np.float32)
    centre = rng.uniform(0, size, (b, a, 2))
    wh = rng.uniform(4, size * 0.6, (b, a, 2))
    pred = np.concatenate([centre - wh / 2, centre + wh / 2], -1).astype(
        np.float32)
    cls = rng.normal(0, 2, (b, a)).astype(np.float32)
    return cls, pred, gt, np.ones((b, m), bool)


def tal_cases(family: str, size: int, seed: int = 0) -> list:
    """One TAL family at size² anchors: [(label, logits (B, A), pred
    (B, A, 4), gt (B, M, 4), gt valid (B, M))], float32 / bool numpy."""
    rng = np.random.default_rng(seed + size)
    tag = f"{family} {size}²"
    if family in ("m1", "m4", "m8"):
        return [(tag, *_tal_draw(16, int(family[1]), size, rng))]
    if family == "batches":
        return [(f"{tag} b=1", *_tal_draw(1, 4, size, rng)),
                (f"{tag} b=17", *_tal_draw(17, 4, size, rng))]
    cls, pred, gt, gv = _tal_draw(16, 4, size, rng)
    s = float(size)
    if family == "edges":
        gt[0, 0] = [0, 0, s, s]                       # the whole frame
        pred[0, :] = [0, 0, s, s]
        gt[1, 0] = [s - 9, 0, s, s]                   # the right edge
        gt[1, 1] = [0, s - 9, s, s]                   # the bottom edge
        gt[1, 2] = [0, 0, 9, s]                       # the left edge
        gv[2, 1] = False                              # invalid gts
        gv[3] = False                                 # none valid
        gt[4, 0] = [20, 20, 20, 20]                   # zero area
        gt[4, 1] = [10, 30, s - 10, 30]               # zero height
        gt[4, 2] = [s - 20, 20, 20, s - 20]           # inverted
        pred[5, ::3, 2:] = pred[5, ::3, :2]           # zero-area predictions
        pred[6, ::5, :2] = pred[6, ::5, 2:] + 1.0     # inverted predictions
        return [(tag, cls, pred, gt, gv)]
    if family == "few":
        h = 6.0 if size > 64 else 5.0
        for i in range(16):
            # small gts around an anchor centre: 1-4 candidates each
            c = rng.integers(1, size // 8 - 1, (4, 2)) * 8 + 4
            gt[i] = np.concatenate([c - h, c + h], -1)
        gt[0, 1] = [1, 1, 3, 3]                       # no centre inside
        gt[1] = [[1, 1, 3, 3]] * 4                    # no candidate at all
        pred[2] = np.concatenate([-s - 20 + 0 * pred[2, :, :2],
                                  -s - 10 + 0 * pred[2, :, :2]], -1)
        # predicted boxes around the gts: every inside anchor a candidate
        j = rng.integers(0, 4, pred.shape[1])
        for i in range(3, 16):
            pred[i] = gt[i, j] + rng.uniform(-3, 3, (pred.shape[1], 4))
        return [(tag, cls, pred, gt, gv)]
    if family == "ties":
        cls[0] = 0.0                                  # equal values in a gt
        gt[0, 0] = [0, 0, s / 2, s / 2]
        pred[0] = gt[0, 0]
        gt[1, 1] = gt[1, 0]                           # a gt repeated
        gt[2, 0] = [0, 0, s / 4, s / 4]               # two gts equally far
        gt[2, 1] = [s / 8, 0, s * 3 / 8, s / 4]       # from the boxes
        pred[2] = [s / 16, 0, s * 5 / 16, s / 4]
        cls[2] = 0.5
        cls[3] = 0.0                                  # equal scores and
        pred[3] = gt[3, 0]                            # boxes, drawn gts
        return [(tag, cls, pred, gt, gv)]
    raise ValueError(f"unknown TAL family {family!r}")


def tal_select_model(cls_logits, pred_boxes, gt_boxes, gt_valid, pts,
                     gen: torch.Generator | None = None):
    """``tal_assign``'s outputs (best_gt, assigned, t_score) as
    ``og_tal_assign`` selects: the align metric's bits as keys (0 where it
    is not > 0), each gt's candidates dealt to 32 lanes in list order (anchor
    order, or an order drawn from ``gen``: the kernel's list is its warps'
    regions one after another, and the selection does not depend on the
    order), each lane's top 10 by (value, lower anchor), ten rounds
    of the lanes' largest value and, among the lanes that hold it, the
    lowest anchor; the largest align is the first taken, the largest IoU
    the largest of the taken; an anchor goes to the first gt with the
    largest value among those that took it."""
    align, iou = train_cuda.tal_align(cls_logits, pred_boxes, gt_boxes,
                                      gt_valid, pts)
    b, m, a = align.shape
    dev = align.device
    topk = train_cuda.TAL_TOPK
    key = torch.where(align > 0, align, 0.0).view(torch.int32).long()
    cand = key > 0
    order = torch.arange(a, device=dev).expand(b, m, a)
    if gen is not None:
        order = torch.rand((b, m, a), generator=gen,
                           device=gen.device).argsort(-1).to(dev)
    # a candidate's place in its gt's list: its rank in ``order``
    rank = torch.where(cand, order, a).argsort(-1).argsort(-1)
    slots = -(-a // WARP)
    lanes_k = torch.zeros((b, m, WARP * slots), dtype=torch.int64,
                          device=dev)
    lanes_a = torch.full_like(lanes_k, a)
    bi, mi, ai = torch.nonzero(cand, as_tuple=True)
    place = rank[bi, mi, ai]
    lanes_k[bi, mi, place] = key[bi, mi, ai]
    lanes_a[bi, mi, place] = ai
    # place p to lane p mod 32, slot p // 32; each lane's ten in order of
    # the packed key (larger value, then lower anchor)
    lanes_k = lanes_k.view(b, m, slots, WARP).transpose(2, 3)
    lanes_a = lanes_a.view(b, m, slots, WARP).transpose(2, 3)
    packed = lanes_k * (a + 1) + (a - lanes_a)
    top = packed.topk(min(topk, slots), -1).values
    lk, la = top // (a + 1), a - top % (a + 1)
    if lk.shape[-1] < topk:
        pad = topk - lk.shape[-1]
        lk = torch.cat([lk, lk.new_zeros(lk.shape[:-1] + (pad,))], -1)
        la = torch.cat([la, la.new_full(la.shape[:-1] + (pad,), a)], -1)
    taken = torch.zeros((b, m, a), dtype=torch.bool, device=dev)
    first = torch.zeros((b, m), dtype=torch.int64, device=dev)
    for r in range(topk):
        v = lk[..., 0].amax(-1)                                  # (B, M)
        live = v > 0
        win = torch.where(lk[..., 0] == v[..., None], la[..., 0], a).amin(-1)
        if r == 0:
            first = v
        taken[live.nonzero(as_tuple=True) + (win[live],)] = True
        pop = (live[..., None] & (lk[..., 0] == v[..., None])
               & (la[..., 0] == win[..., None]))[..., None]
        lk = torch.where(pop, torch.cat([lk[..., 1:], lk[..., :1] * 0], -1),
                         lk)
        la = torch.where(pop, torch.cat([la[..., 1:], la[..., :1] * 0 + a],
                                        -1), la)
    max_align = first.to(torch.int32).view(torch.float32)[..., None]
    max_iou = torch.where(taken, iou.clamp_min(0), 0.0).amax(2, keepdim=True)
    claimed = torch.where(taken, align, -1.0)
    mx = claimed.amax(1)
    pos = torch.arange(m, device=dev)[None, :, None]
    best = torch.where(claimed == mx[:, None, :], pos, m).amin(1)
    assigned = taken.any(1)
    pick = best[:, None, :]
    t = (torch.gather(align, 1, pick) * torch.gather(
        max_iou.expand(b, m, a), 1, pick)) / (torch.gather(
            max_align.expand(b, m, a), 1, pick) + 1e-9)
    return (best.to(torch.int32), assigned,
            torch.where(assigned, t[:, 0], 0.0))


# ── every case on a device, and bit equality ───────────────────────────────

def bits(x: torch.Tensor) -> torch.Tensor:
    """A float32 tensor viewed as int32, others as they are."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def same_bits(got, want) -> bool:
    """Tuples of tensors equal member by member, floats by their bits."""
    return all(torch.equal(bits(g), bits(w)) for g, w in zip(got, want))


def stress_inputs(dev) -> list:
    """[(kind, label, inputs)] of every case of every family on ``dev``:
    ("augment", label, (imgs, msks, params, noise)), ("loss", label,
    (logits, targets, valid)), ("bwd", label, (logits, targets, valid)) and
    ("tal", label, (logits, pred, gt, gt valid, pts)); ``b3_all_on`` also
    with its frames and masks one byte past an allocation (frames the
    augment's bulk copies cannot take); the ``offset`` backward cases with
    logits and targets one element past one; ``m4 256²`` also with its
    predicted boxes one element past one (the TAL's scalar loads)."""
    def unaligned(x):
        return torch.empty(x.numel() + 1, dtype=x.dtype, device=dev
                           )[1:].view(x.shape).copy_(x)

    out = []
    for fam in AUG_FAMILIES:
        c = augment_case(fam)
        inputs = (torch.from_numpy(c["imgs"]).to(dev),
                  torch.from_numpy(c["msks"]).to(dev),
                  augment_params(c["draws"], dev),
                  torch.from_numpy(c["noise"]).to(dev))
        out.append(("augment", fam, inputs))
        if fam == "b3_all_on":
            out.append(("augment", f"{fam} unaligned",
                        (unaligned(inputs[0]), unaligned(inputs[1]),
                         *inputs[2:])))
    for fam in LOSS_FAMILIES:
        for label, x, t, v in loss_cases(fam):
            out.append(("loss", label, (
                torch.from_numpy(x).to(dev), torch.from_numpy(t).to(dev),
                None if v is None else torch.from_numpy(v).to(dev))))
    for fam in BWD_FAMILIES:
        for label, x, t, v in bwd_cases(fam):
            x, t = torch.from_numpy(x).to(dev), torch.from_numpy(t).to(dev)
            if fam == "offset":
                x, t = unaligned(x), unaligned(t)
            out.append(("bwd", label, (
                x, t, None if v is None else torch.from_numpy(v).to(dev))))
    for fam in TAL_FAMILIES:
        for size in TAL_SIZES:
            pts = torch.from_numpy(tal_pts(size)).to(dev)
            for label, *arrays in tal_cases(fam, size):
                cls, pred, gt, gv = (torch.from_numpy(v).to(dev)
                                     for v in arrays)
                out.append(("tal", label, (cls, pred, gt, gv, pts)))
                if label == "m4 256²":
                    out.append(("tal", f"{label} unaligned",
                                (cls, unaligned(pred), gt, gv, pts)))
    return out
