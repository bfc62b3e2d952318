"""Synthetic HSV-like test videos: a pulsating dark ellipse ("glottis") on a
bright textured background.  The port's own copy of the JAX package's
generator (same numpy code, same random streams, so both packages see the
same frames for the same seed).

``realistic=True`` adds structure that is adversarial to intensity
thresholding inside the gated box (ventricular-band shadows at glottal
intensity, an axial glottal gradient, glottis-crossing specular streaks and
illumination drift).  Its low-frequency texture is upsampled by
:func:`resize_bicubic`, the port's own copy of OpenCV's ``INTER_CUBIC``
(the port imports no ``cv2``).
"""

from __future__ import annotations

import numpy as np


def _cubic_taps(n_in: int, n_out: int):
    """Source indices (n_out, 4) and weights (n_out, 4) of OpenCV's
    ``INTER_CUBIC`` along one axis: the half-pixel mapping
    fx = (d + 0.5) * n_in / n_out - 0.5, taps at floor(fx) - 1 .. + 2 with
    the border replicated, and Keys' kernel with a = -0.75 evaluated in
    float32, as OpenCV evaluates it (``interpolateCubic``)."""
    f32 = np.float32
    fx = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(f32)
    sx = np.floor(fx)
    x = (fx - sx).astype(f32)
    a, one = f32(-0.75), f32(1.0)
    c0 = ((a * (x + one) - f32(5) * a) * (x + one) + f32(8) * a) * (x + one) \
        - f32(4) * a
    c1 = ((a + f32(2)) * x - (a + f32(3))) * x * x + one
    y = one - x
    c2 = ((a + f32(2)) * y - (a + f32(3))) * y * y + one
    c3 = one - c0 - c1 - c2
    idx = np.clip(sx.astype(np.int64)[:, None] + np.arange(-1, 3), 0, n_in - 1)
    return idx, np.stack([c0, c1, c2, c3], -1).astype(np.float64)


def resize_bicubic(src: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``cv2.resize(src, (out_w, out_h), interpolation=cv2.INTER_CUBIC)`` of
    a 2-D float64 array, equal to it bit for bit: rows first (each output
    column a 4-tap sum over the source row), then columns, each sum in
    float64 from the left, as OpenCV's generic resize for float64 data."""
    iy, cy = _cubic_taps(src.shape[0], out_h)
    ix, cx = _cubic_taps(src.shape[1], out_w)
    rows = src.astype(np.float64)[:, ix]                  # (h, out_w, 4)
    hp = (rows[..., 0] * cx[:, 0] + rows[..., 1] * cx[:, 1]
          + rows[..., 2] * cx[:, 2] + rows[..., 3] * cx[:, 3])
    v = hp[iy]                                            # (out_h, 4, out_w)
    return (v[:, 0] * cy[:, 0, None] + v[:, 1] * cy[:, 1, None]
            + v[:, 2] * cy[:, 2, None] + v[:, 3] * cy[:, 3, None])


def synthetic_video(
    t: int = 64,
    size: int = 256,
    f0_cycles_per_frame: float = 0.05,
    center=(128.0, 128.0),
    drift_px: float = 0.2,
    seed: int = 0,
    realistic: bool = False,
):
    """Returns (frames_bgr (T, S, S, 3) uint8, gt_masks (T, S, S) bool).

    The ellipse's area pulses sinusoidally at ``f0_cycles_per_frame`` (the
    GAW ground truth), with a slow centre drift to exercise the gate's
    drift clamp.  ``realistic=True`` adds endoscopy-like structure that is
    adversarial to thresholding — see the module docstring.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size].astype(np.float32)
    base = (rng.normal(170, 12, (size, size)).clip(0, 255)).astype(np.float32)

    vignette = spec_cy = spec_cx = None
    if realistic:
        # low-frequency tissue texture + folds radiating from the glottis
        lowfreq = rng.normal(0, 1, (size // 16, size // 16))
        tex = resize_bicubic(lowfreq, size, size)
        ang = np.arctan2(yy - center[0], xx - center[1])
        folds = 10.0 * np.cos(6.0 * ang)
        base = (base + 18.0 * tex + folds).clip(0, 255)
        r2 = ((yy - size / 2) ** 2 + (xx - size / 2) ** 2) / (size / 2) ** 2
        vignette = 1.0 - 0.45 * r2.clip(0, 1)
        spec_cy, spec_cx = rng.uniform(0.2 * size, 0.8 * size, 2)
        # streak phase/orientation vary per video, not per frame
        streak_phase = rng.uniform(0, 2 * np.pi)
        band_gap = rng.uniform(4.0, 6.0)  # px between glottis edge and band

    frames = np.empty((t, size, size, 3), np.uint8)
    masks = np.empty((t, size, size), bool)
    cy, cx = center
    for i in range(t):
        phase = 2 * np.pi * f0_cycles_per_frame * i
        open_frac = 0.5 * (1 - np.cos(phase))  # 0 (closed) .. 1 (open)
        ry = 6 + 26 * open_frac
        rx = 3 + 9 * open_frac
        cy += rng.normal(0, drift_px)
        cx += rng.normal(0, drift_px)
        e = (((yy - cy) / max(ry, 1e-3)) ** 2 + ((xx - cx) / max(rx, 1e-3)) ** 2) < 1
        img = base.copy()
        if not realistic:
            img[e] = rng.normal(35, 8, e.sum()).clip(0, 255)
        else:
            # axial gradient: posterior (top) ~25 -> anterior (bottom) ~130
            axial = ((yy - (cy - ry)) / max(2 * ry, 1e-3)).clip(0, 1)
            glottal = 25.0 + 125.0 * axial + rng.normal(0, 6, (size, size))
            img = np.where(e, glottal.clip(0, 255), img)

            # ventricular-band shadows: elongated dark bands flanking the
            # glottis at glottal intensity, inside the dilated detector box,
            # pulsating/translating with the fold motion
            bw = 3.5 + 3.5 * open_frac  # band half-width px
            off = rx + band_gap + bw * 0.5
            bry = ry * 1.25 + 5.0
            for sgn in (-1.0, 1.0):
                bcx = cx + sgn * off
                band = ((((yy - cy) / max(bry, 1e-3)) ** 2
                         + (((xx - bcx) / max(bw, 1e-3)) ** 2)) < 1) & ~e
                img[band] = (28.0 + 14.0 * axial[band]
                             + rng.normal(0, 6, band.sum())).clip(0, 255)

            # specular streak sweeping across the glottal midline: a thin
            # bright ridge crossing the glottis, overwriting GT-dark pixels
            sweep = cy + 0.55 * ry * np.sin(
                2 * np.pi * 0.013 * i + streak_phase)
            slope = 0.18 * np.cos(streak_phase)
            d = yy - (sweep + slope * (xx - cx))
            streak = 215.0 * np.exp(-(d / 2.2) ** 2) \
                * np.exp(-(((xx - cx) / (3.0 * max(rx, 2.0))) ** 2))
            img = img + streak

        if realistic:
            spec_cy += rng.normal(0, 0.8)
            spec_cx += rng.normal(0, 0.8)
            spec = 70.0 * np.exp(-(((yy - spec_cy) / 22.0) ** 2
                                   + ((xx - spec_cx) / 22.0) ** 2))
            # illumination drift: slow global gain oscillation
            gain = 1.0 + 0.15 * np.sin(2 * np.pi * i / 97.0 + seed % 7)
            img = ((img * vignette + spec) * gain
                   + rng.normal(0, 4, (size, size))).clip(0, 255)
        g = img.astype(np.uint8)
        frames[i] = np.stack([g, g, g], -1)
        masks[i] = e
    return frames, masks


def synthetic_gt_boxes(masks: np.ndarray, dilate: int = 0):
    """Tight (x1, y1, x2, y2) boxes of GT masks; rows of -1 when empty."""
    t, h, w = masks.shape
    boxes = np.full((t, 4), -1, np.float32)
    for i in range(t):
        ys, xs = np.nonzero(masks[i])
        if len(ys):
            boxes[i] = [max(0, xs.min() - dilate), max(0, ys.min() - dilate),
                        min(w, xs.max() + 1 + dilate), min(h, ys.max() + 1 + dilate)]
    return boxes


def spiral_mask(h: int, w: int) -> np.ndarray:
    """Square spiral arms 4 px apart: a geodesically worst-case component."""
    m = np.zeros((h, w), bool)
    x0, y0, x1, y1 = 0, 0, w - 1, h - 1
    while x0 < x1 and y0 < y1:
        m[y0, x0:x1 + 1] = True
        m[y0:y1 + 1, x1] = True
        m[y1, x0:x1 + 1] = True
        m[y0 + 2:y1 + 1, x0] = True
        x0 += 4
        y0 += 4
        x1 -= 4
        y1 -= 4
    return m


def serpentine_mask(h: int, w: int) -> np.ndarray:
    """Full rows joined by 1-px links at alternating ends (one long channel)."""
    m = np.ones((h, w), bool)
    for r in range(1, h, 2):
        m[r, :] = False
        m[r, 0 if (r // 2) % 2 else w - 1] = True
    return m


def blob_stress_masks(h: int, w: int, seed: int = 13) -> np.ndarray:
    """(14, h, w) bool masks that stress connected-component code: blurred
    noise at thresholds 0.5/0.62/0.75, percolation noise at p = 0.4/0.55/0.7
    (thousands of tiny components up to giant spanning ones), a spiral, a
    serpentine, their complements, an all-zero and an all-one frame."""
    import torch

    from openglottal_tpu_torch.ops.blur import gaussian_blur

    rng = np.random.default_rng(seed)
    frames = []
    for thresh in (0.5, 0.62, 0.75):
        noise = torch.from_numpy(rng.random((h, w)).astype(np.float32))
        k = min(21, 2 * ((min(h, w) - 1) // 2) - 1)   # reflect pad < size
        blurred = gaussian_blur(noise, k, 5.0).numpy()
        # rescale to the unit interval so every threshold cuts real blobs
        blurred = (blurred - blurred.min()) / max(np.ptp(blurred), 1e-6)
        frames.append(blurred > thresh)
    for p in (0.4, 0.55, 0.7):
        frames.append(rng.random((h, w)) < p)
    sp, se = spiral_mask(h, w), serpentine_mask(h, w)
    frames += [sp, se, ~sp, ~se, rng.random((h, w)) < 0.5,
               rng.random((h, w)) < 0.62,
               np.zeros((h, w), bool), np.ones((h, w), bool)]
    return np.stack(frames)


def _centre_x(box) -> np.float32:
    """The gate's float32 centre x of a box: (x1 + x2) * 0.5, each step
    rounded."""
    return np.float32(np.float32(box[0] + box[2]) * np.float32(0.5))


def gate_stress_sequence(t: int, seed: int = 0, frame_h: int = 256,
                         frame_w: int = 256, max_shift: float = 30.0,
                         max_hold: int = 3):
    """(has (t,) bool, boxes (t, 4) float32, state0) that drive the gate FSM
    (``models/gate.py``, default ``GateParams``) through its rare branches:
    centre jumps of exactly ``max_shift`` (along an axis and along a 3-4-5
    diagonal) and one float32 ulp above and below it (``np.nextafter`` on a
    box corner until the float32 jump crosses), rejected jumps, holds of 1 to
    ``max_hold + 2`` missing frames (so expiry and re-acquisition), boxes far
    outside the frame and boxes larger than it (the clamp's lo > hi case).
    ``state0`` = (valid, cx, cy, w, h, miss) is a valid carried-in state whose
    centre the first box jumps from by exactly ``max_shift``."""
    f32 = np.float32
    rng = np.random.default_rng(seed)
    state0 = (True, f32(100.0), f32(120.0), 40, 36, 1)
    shift = f32(max_shift)
    prev = np.array([85.0, 102.0, 115.0, 138.0], np.float32)  # centre 100, 120
    has = np.ones(t, bool)
    boxes = np.zeros((t, 4), np.float32)

    def jump_by_ulps(box, above: bool):
        """box moved right by max_shift, its x2 bumped one ulp at a time
        until the float32 jump is above (or below) max_shift."""
        b = box + np.array([shift, 0, shift, 0], np.float32)
        target = np.inf if above else -np.inf
        while True:
            d = f32(_centre_x(b) - _centre_x(box))
            if (d > shift) if above else (d < shift):
                return b
            b[2] = np.nextafter(b[2], f32(target))

    kinds = ("walk", "axis", "diagonal", "above", "below", "reject", "gap",
             "outside", "oversized")
    weights = np.array([40, 8, 6, 8, 8, 8, 10, 6, 6], float)
    i = 0
    while i < t:
        kind = "axis" if i == 0 else kinds[rng.choice(len(kinds),
                                                      p=weights / weights.sum())]
        if kind == "gap":
            n = min(int(rng.integers(1, max_hold + 3)), t - i)
            has[i:i + n] = False
            boxes[i:i + n] = rng.uniform(-20, frame_w + 20, (n, 4))
            i += n
            continue
        if kind == "walk":
            b = prev + np.repeat(rng.normal(0, 4, 2), 2)[[0, 2, 1, 3]]
            b[2:] += rng.uniform(-3, 3, 2)
        elif kind == "axis":
            d = shift * rng.choice([-1, 1])
            b = prev + (np.array([d, 0, d, 0], np.float32) if rng.random() < .5
                        else np.array([0, d, 0, d], np.float32))
        elif kind == "diagonal":     # |(18, 24)| = 30 exactly in float32
            sx, sy = rng.choice([-1, 1], 2)
            b = prev + np.array([18 * sx, 24 * sy, 18 * sx, 24 * sy],
                                np.float32) * (shift / 30)
        elif kind in ("above", "below"):
            b = jump_by_ulps(prev, kind == "above")
        elif kind == "reject":
            b = prev + np.float32(max_shift + rng.uniform(1, 60))
        elif kind == "outside":
            x, y = rng.choice([-1, 1], 2) * rng.uniform(400, 5000, 2)
            b = np.array([x, y, x + 30, y + 20], np.float32)
        else:                        # oversized: wider and taller than the frame
            b = np.array([-rng.uniform(10, 90), -rng.uniform(10, 90),
                          frame_w + rng.uniform(10, 90),
                          frame_h + rng.uniform(10, 90)], np.float32)
        boxes[i] = b
        # keep the walk near the frame: restart from a central box when the
        # last box left it
        c = _centre_x(b)
        prev = (b.astype(np.float32) if -50 < c < frame_w + 50
                else np.array([85.0, 102.0, 115.0, 138.0], np.float32))
        i += 1
    return has, boxes, state0


def thresh_stress_sequence(t: int, seed: int = 0):
    """(thresh0, cur (t,), n_px (t,), active (t,) bool) for the tracker's
    threshold chain: ``n_px`` at the fallback edge (10, and one float32 ulp
    above it) among empty and full counts, integer and fractional
    percentiles, and an inactive tail of ``t // 8`` frames."""
    rng = np.random.default_rng(seed)
    cur = (rng.integers(0, 256, t) + rng.choice([0.0, 0.3, 0.5, 0.7], t)
           ).astype(np.float32)
    n_px = rng.choice(np.array([0.0, 5.0, 10.0, np.nextafter(np.float32(10),
                                                             np.float32(11)),
                                11.0, 900.0], np.float32), t)
    active = np.arange(t) < t - t // 8
    return np.float32(rng.uniform(20, 200)), cur, n_px.astype(np.float32), active
