"""Ultralytics-default train-time augmentation for the detector, batched.

Counterpart of ``openglottal_tpu/train/yolo_aug.py``.  The reference trains
its detector with the ultralytics v8 defaults (scripts/train_yolo.py:107-121;
the paper: "default YOLOv8 augmentation", main.tex:319):

  1. Mosaic4, p = 1: four images on a 2S x 2S gray (114) canvas around an
     integer centre ~ U(0.5S, 1.5S)².
  2. RandomPerspective with degrees = shear = perspective = 0, scale 0.5
     (gain ~ U(0.5, 1.5)), translate 0.1 (U(0.4, 0.6)·S), border -S/2: the
     canvas warps back to S x S, borders 114; boxes map through the affine,
     clip to [0, S] and pass ultralytics ``box_candidates`` (w, h > 2 px,
     aspect < 100, area ratio > 0.10).
  3. HSV jitter with gains 0.015 / 0.7 / 0.4 (r ~ U(-1, 1)·g + 1 a channel;
     hue multiplicative-mod).
  4. Horizontal flip, p = 0.5.

All of it runs as batched torch ops on the images' device, with the random
draws from an explicit ``torch.Generator`` (parity with the JAX package is
statistical; ``tests/test_torch_port_train_yolo.py``).
"""

from __future__ import annotations

import torch

GRAY = 114.0 / 255.0  # ultralytics border/canvas fill


def rgb_to_hsv(rgb):
    """(..., 3) float [0,1] -> HSV with H in [0,1) (fraction of the circle)."""
    r, g, b = rgb.unbind(-1)
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    safe = torch.where(d > 0, d, 1.0)
    h = torch.where(
        d <= 0, 0.0,
        torch.where(mx == r, torch.remainder((g - b) / safe, 6.0),
                    torch.where(mx == g, (b - r) / safe + 2.0,
                                (r - g) / safe + 4.0))) / 6.0
    s = torch.where(mx > 0, d / torch.where(mx > 0, mx, 1.0), 0.0)
    return torch.stack([h, s, mx], -1)


def hsv_to_rgb(hsv):
    """Inverse of :func:`rgb_to_hsv` (H in [0,1))."""
    h, s, v = hsv.unbind(-1)
    h6 = torch.remainder(h, 1.0) * 6.0
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int64), 6)
    table = torch.stack([torch.stack(c, -1) for c in (
        (v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q))], 0)
    return torch.gather(table, 0, i[None, ..., None].expand(
        1, *i.shape, 3))[0]


def _uniform(shape, lo, hi, gen, dev):
    return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo


def mosaic_affine_hsv(generator, imgs4_u8, boxes4, valid4,
                      translate: float = 0.1, scale: float = 0.5,
                      hgain: float = 0.015, sgain: float = 0.7,
                      vgain: float = 0.4, fliplr: float = 0.5):
    """Batched ultralytics-default augmentation.

    imgs4_u8: (B, 4, S, S, 3) uint8 RGB (tile 0 is the sample, 1-3 its
    mosaic partners); boxes4: (B, 4, 4) xyxy px (one gt per tile); valid4:
    (B, 4) bool.  Returns (imgs (B, S, S, 3) float32 [0,1], boxes (B, 4, 4),
    valid (B, 4)): up to four gt boxes per image for the multi-gt TAL loss.
    """
    b, four, s = imgs4_u8.shape[:3]
    assert four == 4
    dev = imgs4_u8.device
    gen = generator
    x = imgs4_u8.to(torch.float32) / 255.0
    centre = torch.floor(_uniform((b, 2), 0.5 * s, 1.5 * s, gen, dev))
    g = _uniform((b,), 1.0 - scale, 1.0 + scale, gen, dev)
    t = _uniform((b, 2), (0.5 - translate) * s, (0.5 + translate) * s, gen,
                 dev)
    r = _uniform((b, 3), -1.0, 1.0, gen, dev) * torch.tensor(
        [hgain, sgain, vgain], device=dev) + 1.0
    do_flip = torch.rand((b,), generator=gen, device=dev) < fliplr
    xc, yc = centre[:, 0, None, None], centre[:, 1, None, None]
    bi = torch.arange(b, device=dev)[:, None, None]

    # the 2S x 2S canvas: a canvas pixel maps into one tile (or the border)
    # by an integer shift per quadrant
    ii = torch.arange(2 * s, dtype=torch.float32, device=dev)
    xx, yy = ii[None, None, :], ii[None, :, None]
    left, top = xx < xc, yy < yc
    sx = torch.where(left, xx - xc + s, xx - xc)
    sy = torch.where(top, yy - yc + s, yy - yc)
    inside = (sx >= 0) & (sx < s) & (sy >= 0) & (sy < s)
    tile = (~top).to(torch.int64) * 2 + (~left).to(torch.int64)
    canvas = x[bi, tile, sy.clamp(0, s - 1).to(torch.int64),
               sx.clamp(0, s - 1).to(torch.int64)]
    canvas = torch.where(inside[..., None], canvas, GRAY)

    # boxes into canvas coords (tile pad = its quadrant's top-left corner)
    c0, c1 = centre[:, 0], centre[:, 1]
    padw = torch.stack([c0 - s, c0, c0 - s, c0], 1)
    padh = torch.stack([c1 - s, c1 - s, c1, c1], 1)
    b1 = (boxes4 + torch.stack([padw, padh, padw, padh], 2)).clamp(0.0,
                                                                   2.0 * s)

    # affine: dst = g·(src - S) + t, sampled bilinearly from the canvas
    oy = torch.arange(s, dtype=torch.float32, device=dev)
    src_x = (oy[None, None, :] - t[:, 0, None, None]) / g[:, None, None] + s
    src_y = (oy[None, :, None] - t[:, 1, None, None]) / g[:, None, None] + s
    src_x, src_y = torch.broadcast_tensors(src_x, src_y)
    x0 = torch.floor(src_x).to(torch.int64).clamp(0, 2 * s - 1)
    y0 = torch.floor(src_y).to(torch.int64).clamp(0, 2 * s - 1)
    x1 = (x0 + 1).clamp(0, 2 * s - 1)
    y1 = (y0 + 1).clamp(0, 2 * s - 1)
    wx = (src_x - x0).clamp(0.0, 1.0)[..., None]
    wy = (src_y - y0).clamp(0.0, 1.0)[..., None]
    inb = ((src_x >= 0) & (src_x <= 2 * s - 1) & (src_y >= 0)
           & (src_y <= 2 * s - 1))[..., None]
    img = ((1 - wy) * (1 - wx) * canvas[bi, y0, x0]
           + (1 - wy) * wx * canvas[bi, y0, x1]
           + wy * (1 - wx) * canvas[bi, y1, x0]
           + wy * wx * canvas[bi, y1, x1])
    img = torch.where(inb, img, GRAY)

    b2 = (g[:, None, None] * (b1 - s) + torch.cat([t, t], 1)[:, None, :]
          ).clamp(0.0, float(s))
    # ultralytics box_candidates(wh_thr=2, ar_thr=100, area_thr=0.10)
    w1, h1 = b1[..., 2] - b1[..., 0], b1[..., 3] - b1[..., 1]
    w2, h2 = b2[..., 2] - b2[..., 0], b2[..., 3] - b2[..., 1]
    ar = torch.maximum(w2 / (h2 + 1e-16), h2 / (w2 + 1e-16))
    valid = (valid4 & (w2 > 2) & (h2 > 2) & (ar < 100)
             & (w2 * h2 / (w1 * h1 + 1e-16) > 0.10))

    # HSV jitter (hue multiplicative-mod like cv2)
    hsv = rgb_to_hsv(img.clamp(0.0, 1.0))
    rr = r[:, None, None, :]
    hsv = torch.stack([torch.remainder(hsv[..., 0] * rr[..., 0], 1.0),
                       (hsv[..., 1] * rr[..., 1]).clamp(0.0, 1.0),
                       (hsv[..., 2] * rr[..., 2]).clamp(0.0, 1.0)], -1)
    img = hsv_to_rgb(hsv)

    # horizontal flip
    fl = do_flip[:, None, None, None]
    img = torch.where(fl, img.flip(2), img)
    flipped = torch.stack([s - b2[..., 2], b2[..., 1], s - b2[..., 0],
                           b2[..., 3]], -1)
    b2 = torch.where(do_flip[:, None, None], flipped, b2)
    return img, b2, valid
