"""Training kernels: the hand-written CUDA kernels of ``csrc/train.cu``
(``og_unet_augment``, ``og_bce_dice`` forward and backward,
``og_tal_assign``), their wrappers and their plain PyTorch versions.

None replaces a Pallas kernel: the JAX package's training path has none,
and XLA fuses what these kernels do.

  ``unet_augment``  <- ``openglottal_tpu/data/augment.py:112`` (the
                       per-sample inverse-affine bilinear image gather and
                       nearest mask gather, zero fill; noise and clip; the
                       5-tap reflect-101 separable blur; brightness; contrast
                       against each image's mean), from uint8 frames scaled
                       by ``f32(1/255)`` as ``unet_train_step``'s jitted
                       ``/ 255`` is (XLA multiplies by the reciprocal)
  ``bce_dice``      <- ``openglottal_tpu/train/unet_trainer.py:49``
                       (``_loss_fn``: 0.5 mean BCE-with-logits + 0.5
                       soft-Dice) and ``:89`` (``unet_eval_loss_masked``), a
                       ``torch.autograd.Function`` whose backward is a kernel
  ``tal_assign``    <- ``openglottal_tpu/train/yolo_loss.py:98-133`` (the
                       task-aligned assignment: inside mask, IoU, align
                       metric, per-gt top-10, conflicts, soft targets)

The plain versions round as the JAX package's compiled CPU code does where
it matters for equality (found by comparing bits): the affine source
coordinates are ``fma(cos, x, -(sin*y)) + c`` and ``fma(sin, x, cos*y) +
c`` with ``x = (xx - c) / scale``; the bilinear sum is ``fma(w11, v11,
fma(w10, v10, fma(w00, v00, w01*v01)))``; the noise ``fma(noise, sigma,
x)``; each blur axis ``fma(k0, x0, k1*x1)`` then one fma a tap (the form of
``ops/blur.py``); the contrast ``fma(c, x, (1 - c)*mean)``.  The kernel
takes the same forms with ``__fmaf_rn``, so the masks are exactly equal to
the plain version's and the image differs only through the per-image mean
(a sum of 65,536 values taken in another order).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream without
synchronising and counts its launches in ``LAUNCHES``.  A CUDA tensor goes
to the kernel or the call raises; a CPU tensor goes to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from openglottal_tpu_torch.ops import _build
from openglottal_tpu_torch.ops.fma import fma32

LAUNCHES = {"unet_augment": 0, "bce_dice": 0, "bce_dice_bwd": 0,
            "tal_assign": 0}

# Measurement hook, as in ``blobs_cuda``: a list here receives
# (wrapper name, inputs, keyword arguments) of every launch.
RECORD: list | None = None

AUG_SIZE = 256
# per-sample augmentation parameters, one float32 row each
AUG_PARAMS = ("hflip", "vflip", "cos", "sin", "scale", "do_noise",
              "sigma_n", "do_blur", "k0", "k1", "k2", "k3", "k4", "bright",
              "contrast", "unused")
N_AUG_PARAMS = len(AUG_PARAMS)
# rows of a tile of the augment's per-image mean; (B, 256 / 16) float32 is
# the scratch ``og_unet_augment``'s C interface takes (this kernel keeps the
# tile partials in shared memory and does not use it)
AUG_TILE_ROWS = 16
DICE_EPS = 1e-6
# blocks of the loss's reduction (two on each of the H100's 132 SMs)
BCE_BLOCKS = 264
TAL_TOPK = 10
TAL_MAX_GT = 8
TAL_WARPS = 2 * TAL_MAX_GT         # og_tal_assign's block (its selection:
TAL_THREADS = 32 * TAL_WARPS       # a warp a gt)
TAL_SMEM_BYTES = 200 * 1024
INV255 = torch.tensor(1.0 / 255.0, dtype=torch.float32)

_configured = False
# og_bce_dice's scratch for each (device, stream): the blocks' partials, then
# the ticket of the last block's finish, zeroed once (every launch leaves it
# zero).  Launches on one stream run one after another and share it;
# launches on different streams, which may overlap, never share a ticket.
_BCE_SCRATCH: dict = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _record(name, inputs, kw) -> None:
    LAUNCHES[name] += 1
    if RECORD is not None:
        RECORD.append((name, inputs, kw))


def _lib() -> ctypes.CDLL:
    global _configured
    lib = _build.load("train")
    if not _configured:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.og_unet_augment.argtypes = [p] * 7 + [i, p]
        lib.og_bce_dice.argtypes = [p] * 5 + [i, i, i, p]
        lib.og_bce_dice_bwd.argtypes = [p] * 6 + [i, i, p]
        lib.og_tal_assign.argtypes = [p] * 8 + [i, i, i, p]
        for f in (lib.og_unet_augment, lib.og_bce_dice, lib.og_bce_dice_bwd,
                  lib.og_tal_assign):
            f.restype = ctypes.c_int
        _configured = True
    return lib


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(what: str, x, shape, dtype):
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if x.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {x.dtype}")


def _same_device(what: str, *xs):
    dev = xs[0].device
    for x in xs:
        if x is not None and x.device != dev:
            raise ValueError(f"{what}: inputs lie on different devices")
    return dev


def _contig(what: str, *xs):
    for x in xs:
        if x is not None and not x.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous")


# ── og_unet_augment ─────────────────────────────────────────────────────────

def affine_coords(params, size: int = AUG_SIZE):
    """Per-sample source coordinates (sy, sx), each (B, S, S) float32, of the
    composed flip∘rotate∘scale (``augment._affine_coords``) from the rows of
    ``params`` (cos and sin given, scale 1 where not drawn)."""
    dev = params.device
    c = (size - 1) / 2.0
    ar = torch.arange(size, dtype=torch.float32, device=dev) - c
    sc = params[:, 4, None, None]
    x = ar[None, None, :] / sc
    y = ar[None, :, None] / sc
    x, y = torch.broadcast_tensors(x, y)
    ct, st = params[:, 2, None, None], params[:, 3, None, None]
    sx = fma32(ct, x, -(st * y)) + c
    sy = fma32(st, x, ct * y) + c
    sx = torch.where(params[:, 0, None, None] != 0, (size - 1) - sx, sx)
    sy = torch.where(params[:, 1, None, None] != 0, (size - 1) - sy, sy)
    return sy, sx


def _at(img, yi, xi, size):
    """img[b, yi, xi] with zero fill outside the frame (float indices)."""
    inb = (yi >= 0) & (yi < size) & (xi >= 0) & (xi < size)
    yc = yi.clamp(0, size - 1).to(torch.int64)
    xc = xi.clamp(0, size - 1).to(torch.int64)
    b = torch.arange(img.shape[0], device=img.device)[:, None, None]
    return torch.where(inb, img[b, yc, xc], 0.0)


def gather_bilinear(img, sy, sx):
    """Bilinear samples of (B, S, S) float32 ``img`` at (sy, sx), zero
    outside (``augment._gather_bilinear``, its fused sum)."""
    size = img.shape[-1]
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy, wx = sy - y0, sx - x0
    v00, v01 = _at(img, y0, x0, size), _at(img, y0, x0 + 1, size)
    v10, v11 = _at(img, y0 + 1, x0, size), _at(img, y0 + 1, x0 + 1, size)
    acc = fma32((1 - wy) * (1 - wx), v00, ((1 - wy) * wx) * v01)
    acc = fma32(wy * (1 - wx), v10, acc)
    return fma32(wy * wx, v11, acc)


def gather_nearest(img, sy, sx):
    """Nearest samples (round half to even), zero outside
    (``augment._gather_nearest``)."""
    return _at(img, torch.round(sy), torch.round(sx), img.shape[-1])


def blur5(img, taps):
    """The 5-tap reflect-101 separable blur of (B, S, S) ``img`` with
    per-sample normalised taps (B, 5), rows first (``augment._blur5``)."""
    s = img.shape[-1]
    pad = torch.nn.functional.pad(img[:, None], (2, 2, 2, 2),
                                  mode="reflect")[:, 0]

    def axis(tap):
        k = [taps[:, d, None, None] for d in range(5)]
        acc = fma32(k[0], tap(0), k[1] * tap(1))
        for d in range(2, 5):
            acc = fma32(k[d], tap(d), acc)
        return acc

    rows = axis(lambda d: pad[:, d:d + s, :])
    return axis(lambda d: rows[:, :, d:d + s])


def augment_before_contrast(imgs_u8, msks_u8, params, noise):
    """The plain version's steps up to the contrast: (images after the
    brightness, masks), each (B, S, S) float32."""
    p = params
    x = imgs_u8.to(torch.float32) * INV255.to(imgs_u8.device)
    sy, sx = affine_coords(p, x.shape[-1])
    img = gather_bilinear(x, sy, sx)
    msk = gather_nearest(msks_u8.to(torch.float32), sy, sx)

    def col(j):
        return p[:, j, None, None]

    img = torch.where(col(5) != 0,
                      fma32(noise, col(6).expand_as(noise), img).clamp(0, 1),
                      img)
    img = torch.where(col(7) != 0, blur5(img, p[:, 8:13]), img)
    return (img * col(13)).clamp(0, 1), msk


def apply_contrast(img, params, mean):
    """clip(fma(c, img, (1 - c) * mean), 0, 1) with each sample's contrast c
    (``params[:, 14]``) and mean (B, 1, 1)."""
    c = params[:, 14, None, None]
    img = fma32(c.expand_as(img), img, ((1 - c) * mean).expand_as(img))
    return img.clamp(0, 1)


def unet_augment_plain(imgs_u8, msks_u8, params, noise):
    """The plain version of :func:`unet_augment`: eager tensor ops."""
    img, msk = augment_before_contrast(imgs_u8, msks_u8, params, noise)
    return apply_contrast(img, params, img.mean((1, 2), keepdim=True)), msk


def unet_augment(imgs_u8, msks_u8, params, noise):
    """Augment a batch: (B, 256, 256) uint8 frames and {0,1} uint8 masks,
    the per-sample parameter rows ``params`` (B, 16) float32 (columns
    ``AUG_PARAMS``: flags as 0/1, the angle's cos and sin, the scale, the
    noise sigma, the five normalised blur taps, brightness, contrast) and
    the Gaussian noise (B, 256, 256) float32 -> (images, masks), each (B,
    256, 256) float32.  On CUDA tensors one launch of ``og_unet_augment`` (a
    cluster of blocks a sample); on CPU tensors the plain version."""
    b = imgs_u8.shape[0]
    shape = (b, AUG_SIZE, AUG_SIZE)
    _check("unet_augment: imgs", imgs_u8, shape, torch.uint8)
    _check("unet_augment: msks", msks_u8, shape, torch.uint8)
    _check("unet_augment: params", params, (b, N_AUG_PARAMS), torch.float32)
    _check("unet_augment: noise", noise, shape, torch.float32)
    _same_device("unet_augment", imgs_u8, msks_u8, params, noise)
    if not imgs_u8.is_cuda:
        return unet_augment_plain(imgs_u8, msks_u8, params, noise)
    _contig("unet_augment", imgs_u8, msks_u8, params, noise)
    img = torch.empty(shape, dtype=torch.float32, device=imgs_u8.device)
    msk = torch.empty_like(img)
    partial = torch.empty((b, AUG_SIZE // AUG_TILE_ROWS), dtype=torch.float32,
                          device=imgs_u8.device)
    with torch.cuda.device(imgs_u8.device):
        err = _lib().og_unet_augment(
            imgs_u8.data_ptr(), msks_u8.data_ptr(), params.data_ptr(),
            noise.data_ptr(), img.data_ptr(), msk.data_ptr(),
            partial.data_ptr(), b, _stream())
    _build.check(err, "unet_augment")
    _record("unet_augment", (imgs_u8, msks_u8, params, noise), {})
    return img, msk


# ── og_bce_dice ─────────────────────────────────────────────────────────────

def _row_mask(logits, valid):
    """(B, 1...) float32 row weights: 1, or the ``valid`` mask."""
    if valid is None:
        return None
    return valid.to(torch.float32).reshape((-1,) + (1,) * (logits.dim() - 1))


def bce_dice_sums_plain(logits, targets, valid=None):
    """(4,) float32: ΣBCE, Σσ·t, Σσ, Σt over the valid rows, and the count
    of their elements (1 at least) -> (sums, n)."""
    x, t = logits.float(), targets.float()
    bce = -t * torch.nn.functional.logsigmoid(x) \
        - (1 - t) * torch.nn.functional.logsigmoid(-x)
    p = torch.sigmoid(x)
    v = _row_mask(x, valid)
    if v is not None:
        bce, p, t = bce * v, p * v, t * v
        n = valid.to(torch.float32).sum() * (x[0].numel())
    else:
        n = torch.tensor(float(x.numel()), device=x.device)
    sums = torch.stack([bce.sum(), (p * t).sum(), p.sum(), t.sum()])
    return sums, n.clamp_min(1.0)


def _loss_from_sums(sums, n):
    bce = sums[0] / n
    dl = 1.0 - (2.0 * sums[1] + DICE_EPS) / (sums[2] + sums[3] + DICE_EPS)
    return 0.5 * bce + 0.5 * dl


def bce_dice_grad_plain(logits, targets, valid, sums, n, g):
    """∂L/∂logits = g·(0.5·(σ − t)/n + 0.5·(I/D² − 2t/D)·σ(1 − σ)), I =
    2Σσt + eps, D = Σσ + Σt + eps; 0 on invalid rows."""
    x, t = logits.float(), targets.float()
    p = torch.sigmoid(x)
    i_ = 2.0 * sums[1] + DICE_EPS
    d = sums[2] + sums[3] + DICE_EPS
    grad = 0.5 * (p - t) / n + 0.5 * (i_ / (d * d) - 2.0 * t / d) * p * (1 - p)
    v = _row_mask(x, valid)
    if v is not None:
        grad = grad * v
    return grad * g


class _BceDice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, valid):
        if logits.is_cuda:
            sums, n, loss = _bce_dice_cuda(logits, targets, valid)
        else:
            sums, n = bce_dice_sums_plain(logits, targets, valid)
            loss = _loss_from_sums(sums, n)
        ctx.save_for_backward(logits, targets, sums, n,
                              *(() if valid is None else (valid,)))
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, targets, sums, n, *rest = ctx.saved_tensors
        valid = rest[0] if rest else None
        if logits.is_cuda:
            grad = _bce_dice_bwd_cuda(logits, targets, valid, sums, n, g)
        else:
            grad = bce_dice_grad_plain(logits, targets, valid, sums, n, g)
        return grad.to(logits.dtype), None, None


def _bce_dice_args(what, logits, targets, valid):
    if logits.shape != targets.shape:
        raise ValueError(f"{what}: logits {tuple(logits.shape)} and targets "
                         f"{tuple(targets.shape)} differ")
    if logits.dtype != torch.float32 or targets.dtype != torch.float32:
        raise ValueError(f"{what}: logits and targets must be float32")
    if valid is not None:
        _check(f"{what}: valid", valid, (logits.shape[0],), torch.bool)
    _same_device(what, logits, targets, valid)


def _bce_scratch(dev) -> torch.Tensor:
    """``_BCE_SCRATCH``'s buffer of the current stream of ``dev``
    (BCE_BLOCKS * 4 + 1 float32 words), made on that stream at its first
    use."""
    stream = torch.cuda.current_stream(dev)
    key = (stream.device_index, stream.cuda_stream)
    buf = _BCE_SCRATCH.get(key)
    if buf is None:
        buf = _BCE_SCRATCH[key] = torch.zeros(
            BCE_BLOCKS * 4 + 1, dtype=torch.float32, device=dev)
    return buf


def _bce_dice_cuda(logits, targets, valid):
    _contig("bce_dice", logits, targets, valid)
    dev = logits.device
    out = torch.empty((6,), dtype=torch.float32, device=dev)
    rows = logits.shape[0]
    with torch.cuda.device(dev):
        partial = _bce_scratch(dev)
        err = _lib().og_bce_dice(
            logits.data_ptr(), targets.data_ptr(),
            None if valid is None else valid.data_ptr(), partial.data_ptr(),
            out.data_ptr(), rows, logits.numel() // max(rows, 1), BCE_BLOCKS,
            _stream())
    _build.check(err, "bce_dice")
    _record("bce_dice", (logits.detach(), targets, valid), {})
    # out: ΣBCE, Σσt, Σσ, Σt, n, loss
    return out[:4], out[4], out[5]


def _bce_dice_bwd_cuda(logits, targets, valid, sums, n, g):
    dev = logits.device
    g = g.to(torch.float32).reshape(()).contiguous()
    sn = torch.cat([sums, n.reshape(1)]).contiguous()
    grad = torch.empty_like(logits)
    rows = logits.shape[0]
    with torch.cuda.device(dev):
        err = _lib().og_bce_dice_bwd(
            logits.data_ptr(), targets.data_ptr(),
            None if valid is None else valid.data_ptr(), sn.data_ptr(),
            g.data_ptr(), grad.data_ptr(), rows,
            logits.numel() // max(rows, 1), _stream())
    _build.check(err, "bce_dice_bwd")
    _record("bce_dice_bwd", (logits.detach(), targets, valid, sums, n, g), {})
    return grad


def bce_dice(logits, targets, valid=None):
    """0.5 · mean BCE-with-logits + 0.5 · soft-Dice of float32 ``logits``
    against float32 ``targets`` (same shape, leading axis the batch) ->
    0-d float32, differentiable in ``logits``.  ``valid`` (B,) bool: rows
    that count (the masked eval loss); the others count in neither the BCE
    mean nor the Dice sums.  On CUDA tensors the forward is one call of
    ``og_bce_dice`` (the blocks' sums, the last block's finish) and the
    backward one launch of ``og_bce_dice_bwd``; on CPU tensors the plain
    versions."""
    _bce_dice_args("bce_dice", logits, targets, valid)
    return _BceDice.apply(logits, targets, valid)


# ── og_tal_assign ───────────────────────────────────────────────────────────

def box_iou(gt, pred):
    """IoU of gt (B, M, 4) against pred (B, A, 4) xyxy -> (B, M, A), union
    + 1e-7 (``yolo_loss.pairwise_ciou``'s IoU)."""
    g = gt[:, :, None, :]
    p = pred[:, None, :, :]
    iw = (torch.minimum(g[..., 2], p[..., 2])
          - torch.maximum(g[..., 0], p[..., 0])).clamp_min(0)
    ih = (torch.minimum(g[..., 3], p[..., 3])
          - torch.maximum(g[..., 1], p[..., 1])).clamp_min(0)
    inter = iw * ih
    ag = (g[..., 2] - g[..., 0]).clamp_min(0) * (g[..., 3] - g[..., 1]
                                                 ).clamp_min(0)
    ap = (p[..., 2] - p[..., 0]).clamp_min(0) * (p[..., 3] - p[..., 1]
                                                 ).clamp_min(0)
    return inter / (ag + ap - inter + 1e-7)


def tal_align(cls_logits, pred_boxes, gt_boxes, gt_valid, pts):
    """(align, iou) (B, M, A): the align metric σ(cls)^0.5 · clip(IoU, 0)^6
    on anchors whose centre lies strictly inside a valid gt box (0
    elsewhere), and the IoU."""
    gx1, gy1, gx2, gy2 = [gt_boxes[..., i][:, :, None] for i in range(4)]
    px, py = pts[None, None, :, 0], pts[None, None, :, 1]
    inside = ((px > gx1) & (px < gx2) & (py > gy1) & (py < gy2)
              & gt_valid[:, :, None])
    iou = box_iou(gt_boxes, pred_boxes)
    c = iou.clamp_min(0)
    c2 = c * c
    c6 = c2 * c2 * c2           # XLA's integer_pow(x, 6): x²·x²·x²
    align = torch.sqrt(torch.sigmoid(cls_logits))[:, None, :] * c6
    return torch.where(inside, align, 0.0), iou


def tal_assign_plain(cls_logits, pred_boxes, gt_boxes, gt_valid, pts,
                     topk: int = TAL_TOPK):
    """The plain version of :func:`tal_assign`: eager tensor ops."""
    align, iou = tal_align(cls_logits, pred_boxes, gt_boxes, gt_valid, pts)
    topv, topi = _topk_lower_index(align, min(topk, pts.shape[0]))
    topk_mask = torch.zeros_like(align, dtype=torch.bool)
    topk_mask.scatter_(2, topi, topv > 0)
    claimed = torch.where(topk_mask, align, -1.0)
    mx = claimed.amax(1)
    best = _first_argmax(claimed, mx)               # first max over gts
    assigned = torch.gather(topk_mask, 1, best[:, None, :])[:, 0] & (mx > 0)
    max_align = torch.where(topk_mask, align, 0.0).amax(2, keepdim=True)
    max_iou = torch.where(topk_mask, iou.clamp_min(0), 0.0).amax(2,
                                                                 keepdim=True)
    norm = torch.gather(align * max_iou / (max_align + 1e-9), 1,
                        best[:, None, :])[:, 0]
    t_score = torch.where(assigned, norm, 0.0)
    return best.to(torch.int32), assigned, t_score


def _topk_lower_index(x, k: int):
    """top-k along the last axis, ties to the lower index (``lax.top_k``)."""
    # a stable descending sort keeps equal values in index order
    top = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(x, -1, top), top


def _first_argmax(x, mx):
    """The first index along axis 1 where x equals its max ``mx``."""
    m = x.shape[1]
    pos = torch.arange(m, device=x.device)[None, :, None]
    return torch.where(x == mx[:, None, :], pos, m).amin(1)


def tal_smem_bytes(a: int, m: int) -> int:
    """``og_tal_assign``'s dynamic shared memory for a anchors and m gts
    (``tal_smem`` in ``csrc/train.cu``): for each (gt, warp) a region of 6
    bytes (align bits, anchor) for each anchor the warp visits, then a
    claim byte an anchor, in 32-bit words."""
    region = 32 * -(-a // TAL_THREADS)
    return ((m * TAL_WARPS * region * 6 + 3) & ~3) + 4 * -(-a // 4)


def tal_assign(cls_logits, pred_boxes, gt_boxes, gt_valid, pts):
    """Task-aligned assignment of a batch (``yolo_loss``'s TAL, under
    ``stop_gradient`` there, so no backward): ``cls_logits`` (B, A) float32
    (the single class), ``pred_boxes`` (B, A, 4) float32 xyxy pixels
    (detached), ``gt_boxes`` (B, M, 4) float32, ``gt_valid`` (B, M) bool,
    ``pts`` (A, 2) float32 anchor centres -> (best_gt (B, A) int32,
    assigned (B, A) bool, t_score (B, A) float32).  On CUDA tensors one
    launch of ``og_tal_assign`` (a block an image, a warp a gt in the
    selection); on CPU tensors the plain version."""
    b, a = cls_logits.shape
    m = gt_boxes.shape[1]
    _check("tal_assign: cls_logits", cls_logits, (b, a), torch.float32)
    _check("tal_assign: pred_boxes", pred_boxes, (b, a, 4), torch.float32)
    _check("tal_assign: gt_boxes", gt_boxes, (b, m, 4), torch.float32)
    _check("tal_assign: gt_valid", gt_valid, (b, m), torch.bool)
    _check("tal_assign: pts", pts, (a, 2), torch.float32)
    _same_device("tal_assign", cls_logits, pred_boxes, gt_boxes, gt_valid,
                 pts)
    if not cls_logits.is_cuda:
        return tal_assign_plain(cls_logits, pred_boxes, gt_boxes, gt_valid,
                                pts)
    if m < 1 or m > TAL_MAX_GT or tal_smem_bytes(a, m) > TAL_SMEM_BYTES:
        raise ValueError(f"tal_assign: {m} gts x {a} anchors do not fit "
                         f"the kernel (1 <= M <= {TAL_MAX_GT}, "
                         f"{TAL_SMEM_BYTES} bytes of shared memory)")
    _contig("tal_assign", cls_logits, pred_boxes, gt_boxes, gt_valid, pts)
    dev = cls_logits.device
    best = torch.empty((b, a), dtype=torch.int32, device=dev)
    assigned = torch.empty((b, a), dtype=torch.bool, device=dev)
    t_score = torch.empty((b, a), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().og_tal_assign(
            cls_logits.data_ptr(), pred_boxes.data_ptr(), gt_boxes.data_ptr(),
            gt_valid.data_ptr(), pts.data_ptr(), best.data_ptr(),
            assigned.data_ptr(), t_score.data_ptr(), b, a, m, _stream())
    _build.check(err, "tal_assign")
    _record("tal_assign", (cls_logits, pred_boxes, gt_boxes, gt_valid, pts),
            {})
    return best, assigned, t_score
