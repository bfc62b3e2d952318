"""Lightweight 4-level U-Net for binary glottal segmentation.

Counterpart of ``openglottal_tpu/models/unet.py``: encoder widths (32, 64,
128, 256), DoubleConv = 2 x (Conv3x3 -> BN -> ReLU), 2x2 max-pool,
ConvTranspose2d(k=2, s=2) upsampling with skip concatenation (skip first), 1x1
logits head, float32 logits.  7.77M parameters.  Parameter names follow the
reference torch layout (``downs.{i}.net.{0,1,3,4}``, ``bottleneck``,
``ups.{2k}``, ``ups.{2k+1}``, ``head``) so a converted ``state_dict`` loads
strictly.

The forward pass is split as the JAX package splits it, so that pipeline 3
can run its two shallowest decoder levels on a window around the gate boxes
only (it counts mask pixels inside the box and nowhere else):

  :meth:`UNet.apply_to_d3` (encoder, bottleneck, the 32²- and 64²-level
  decoder blocks) -> :meth:`UNet.mid_full` (the 128²-level block) ->
  :meth:`UNet.tail_full` (the 256²-level block and the head);
  :meth:`UNet.forward` is their composition.

The windowed forms (:meth:`UNet.mid_window`, :meth:`UNet.tail_from_ymw`,
:meth:`UNet.tail_window_chunk`, :meth:`UNet.tail_window`) need folded
weights (the valid convolutions run as conv + bias + ReLU).  Halo'd valid
convolutions reproduce the full-frame 'same' convolutions at every window
pixel.  Window origins are Python ints or 0-d integer tensors on the
tensors' device; windows are cut by index tensors (a gather copy each), so
an origin on the device is never read by the host.  Tensors are NCHW
(``channels_last`` in memory on the serving path).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from openglottal_tpu_torch.models.yolo import BatchNorm

UNET_BN_EPS = 1e-5
UNET_BN_MOMENTUM = 0.9


class DoubleConv(nn.Module):
    """Two Conv3x3(no bias) -> BatchNorm -> ReLU blocks; ``fuse_bn`` runs the
    inference-folded form Conv3x3(+bias) -> ReLU.  Indices 0/3 are the convs
    and 1/4 the norms in both forms, so names do not move."""

    def __init__(self, in_ch: int, out_ch: int, fuse_bn: bool = False):
        super().__init__()

        def norm():
            return (nn.Identity() if fuse_bn
                    else BatchNorm(out_ch, UNET_BN_EPS, tracked=True,
                                   momentum=UNET_BN_MOMENTUM))

        self.net = nn.Sequential(
            nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=fuse_bn), norm(),
            nn.ReLU(),
            nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=fuse_bn), norm(),
            nn.ReLU())

    def forward(self, x):
        return self.net(x)


class UNet(nn.Module):
    """U-Net over (N, 1, H, W) frames; returns float32 logits (N, out, H, W)."""

    def __init__(self, out_ch: int = 1,
                 features: Sequence[int] = (32, 64, 128, 256),
                 fuse_bn: bool = False, in_ch: int = 1):
        super().__init__()
        self.downs = nn.ModuleList()
        c = in_ch
        for f in features:
            self.downs.append(DoubleConv(c, f, fuse_bn))
            c = f
        self.bottleneck = DoubleConv(c, 2 * c, fuse_bn)
        c = 2 * c
        ups = []
        for f in reversed(features):
            ups.append(nn.ConvTranspose2d(c, f, 2, stride=2))
            ups.append(DoubleConv(2 * f, f, fuse_bn))
            c = f
        self.ups = nn.ModuleList(ups)
        self.head = nn.Conv2d(c, out_ch, 1)

    # ── the split forward (JAX package: unet_apply_to_d3, unet_mid_full,
    # unet_tail_full, unet_apply_to_mid) ────────────────────────────────

    def _level(self, k: int, x, s):
        """Decoder level k: upsample, the bilinear size fix for odd sizes,
        skip-first concatenation, DoubleConv."""
        x = self.ups[2 * k](x)
        if x.shape[2:] != s.shape[2:]:   # odd sizes: bilinear size fix
            x = F.interpolate(x, size=s.shape[2:], mode="bilinear",
                              align_corners=False)
        return self.ups[2 * k + 1](torch.cat([s, x], dim=1))   # skip first

    def apply_to_d3(self, x):
        """Encoder, bottleneck and every decoder level but the last two ->
        (d3out (N, 4f0, H/4, W/4), skip2 (N, 2f0, H/2, W/2), skip1 (N, f0,
        H, W)), in the module's dtype."""
        x = x.to(self.head.weight.dtype)
        skips = []
        for down in self.downs:
            x = down(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = self.bottleneck(x)
        for k in range(len(self.downs) - 2):
            x = self._level(k, x, skips.pop())
        return x, skips[1], skips[0]

    def mid_full(self, d3out, skip2):
        """The full-frame second-to-last decoder level -> y_mid (N, 2f0,
        H/2, W/2)."""
        return self._level(len(self.downs) - 2, d3out, skip2)

    def apply_to_mid(self, x):
        """:meth:`apply_to_d3` then :meth:`mid_full` -> (y_mid, skip1)."""
        d3out, skip2, skip1 = self.apply_to_d3(x)
        return self.mid_full(d3out, skip2), skip1

    def tail_full(self, y_mid, skip1):
        """The full-frame last decoder level and the head -> logits (N, out,
        H, W) in the module's dtype (not cast: the pipelines threshold them
        as they are)."""
        return self.head(self._level(len(self.downs) - 1, y_mid, skip1))

    def logits(self, x):
        """The whole forward pass, logits in the module's dtype."""
        return self.tail_full(*self.apply_to_mid(x))

    def forward(self, x):
        return self.logits(x).float()

    # ── the windowed decoder (JAX package: unet_mid_window,
    # _tail_from_ymw, unet_tail_window_chunk, unet_tail_window) ──────────

    def mid_window(self, d3out, skip2, oy, ox, win: int = 160):
        """The second-to-last decoder level on the window the last level
        needs: for a frame-level origin (oy, ox) with o = 2 (mod 4), 6 <= o
        and o + win <= H - 6, DoubleConv's output on rows and columns
        [o/2 - 1, o/2 - 1 + win/2 + 2) of y_mid.  The concatenation is
        (win/2 + 6)² (a 3-px halo each side at half resolution, real in-frame
        data), so the valid convolutions give y_mid's values."""
        k = len(self.downs) - 2
        mw = win // 2 + 6
        m0y, m0x = oy // 2 - 3, ox // 2 - 3     # even by the origin lattice
        up = self.ups[2 * k](_cut(d3out, m0y // 2, m0x // 2, mw // 2, mw // 2))
        s2 = _cut(skip2, m0y, m0x, mw, mw)
        return _double_conv_valid(self.ups[2 * k + 1], torch.cat([s2, up], 1))

    def tail_from_ymw(self, ymw, skip1, oy, ox, win: int = 160):
        """The last decoder level and the head given y_mid's (win/2 + 2)²
        window at [o/2 - 1, ...) -> logits (N, out, win, win) of the frame
        window [oy, oy + win) x [ox, ox + win), in the module's dtype."""
        k = len(self.downs) - 1
        wh = win + 4                               # 2-px halo each side
        up = self.ups[2 * k](ymw)
        sw = _cut(skip1, oy - 2, ox - 2, wh, wh)
        return self.head(_double_conv_valid(self.ups[2 * k + 1],
                                            torch.cat([sw, up], 1)))

    def tail_window_chunk(self, y_mid, skip1, oy, ox, win: int = 160):
        """The last decoder level and the head on ONE (win, win) window
        shared by every frame, at an even origin with 2 <= o and o + win <=
        H - 2 (the halo reads real neighbours) -> logits (N, out, win,
        win)."""
        mh = (win + 4) // 2
        ymw = _cut(y_mid, (oy - 2) // 2, (ox - 2) // 2, mh, mh)
        return self.tail_from_ymw(ymw, skip1, oy, ox, win)

    def tail_window(self, y_mid, skip1, oy, ox, win: int = 128):
        """The last decoder level and the head on a (win, win) window per
        frame, at even origins oy, ox (N,) anywhere in the frame -> logits
        (N, out, win, win).  The halo is cut from zero-padded tensors, and
        positions outside the frame are zeroed after the upsample and after
        the first convolution: that is the zero padding the full-frame
        convolutions read at frame borders."""
        n = y_mid.shape[0]
        dev = y_mid.device
        oy = torch.as_tensor(oy, device=dev).reshape(-1).expand(n)
        ox = torch.as_tensor(ox, device=dev).reshape(-1).expand(n)
        k = len(self.downs) - 1
        halo = 2
        wh = win + 2 * halo
        up = self.ups[2 * k](_cut(F.pad(y_mid, (1, 1, 1, 1)), oy // 2,
                                  ox // 2, win // 2 + halo, win // 2 + halo))
        ar = torch.arange(wh, device=dev)
        rows = oy[:, None] - halo + ar
        cols = ox[:, None] - halo + ar
        hh, ww = skip1.shape[2:]
        inside = (((rows >= 0) & (rows < hh))[:, :, None]
                  & ((cols >= 0) & (cols < ww))[:, None, :])[:, None]
        up = up * inside.to(up.dtype)
        sw = _cut(F.pad(skip1, (halo,) * 4), oy, ox, wh, wh)
        dc = self.ups[2 * k + 1]
        x = F.relu(_conv_valid(torch.cat([sw, up], 1), dc.net[0]))
        x = x * inside[:, :, 1:-1, 1:-1].to(x.dtype)
        return self.head(F.relu(_conv_valid(x, dc.net[3])))


def _conv_valid(x, conv: nn.Conv2d):
    """``conv`` with no padding, its (folded) bias included, in the
    module's dtype: each output is k - 1 px smaller per axis."""
    return F.conv2d(x, conv.weight, conv.bias)


def _double_conv_valid(dc: DoubleConv, x):
    """A folded DoubleConv with no padding: conv + bias + ReLU twice."""
    return F.relu(_conv_valid(F.relu(_conv_valid(x, dc.net[0])), dc.net[3]))


def _cut(x, r0, c0, h: int, w: int):
    """The (h, w) window of (N, C, H, W) ``x`` at rows r0.., columns c0..

    Python int origins give a view.  Tensor origins (0-d for one window,
    (N,) for one per frame) give a copy made by one gather over the
    channels-last view of ``x``, so that the result is channels_last (what
    the convolutions take on the card) and the origin is never read by the
    host.  Where a pixel's channels lie together in whole 8-byte words (a
    channels_last ``x``), the gather moves those words, not single bf16 or
    f32 values: the same bytes, in 3x less time for bf16 on the H100."""
    if not isinstance(r0, torch.Tensor) and not isinstance(c0, torch.Tensor):
        return x[:, :, r0:r0 + h, c0:c0 + w]
    dev = x.device
    rows = (torch.as_tensor(r0, device=dev).reshape(-1, 1)
            + torch.arange(h, device=dev))
    cols = (torch.as_tensor(c0, device=dev).reshape(-1, 1)
            + torch.arange(w, device=dev))
    xs = x.permute(0, 2, 3, 1)
    wide = xs.stride(-1) == 1 and xs.shape[-1] * xs.element_size() % 8 == 0
    if wide:
        xs = xs.view(torch.int64)
    if rows.shape[0] == 1 and cols.shape[0] == 1:
        out = xs[:, rows[0, :, None], cols[0, None, :]]
    else:
        n = torch.arange(x.shape[0], device=dev)
        rows = rows.expand(x.shape[0], -1)
        cols = cols.expand(x.shape[0], -1)
        out = xs[n[:, None, None], rows[:, :, None], cols[:, None, :]]
    out = out.contiguous()
    return (out.view(x.dtype) if wide else out).permute(0, 3, 1, 2)


def window_origins(boxes, valid, h: int, w: int, win: int):
    """Even per-frame (win, win) window origins covering each valid frame's
    box -> (fits 0-d bool, oy (N,), ox (N,)), int64 on the boxes' device.
    Origins clamp in-frame and round down to even (the half-resolution grid
    of the upsample); invalid frames do not take part in ``fits``."""
    b = boxes.to(torch.int64)
    x0, y0, x1, y1 = b.unbind(1)
    ok = ((x1 - x0) <= win - 2) & ((y1 - y0) <= win - 2)
    fits = (ok | ~valid.to(torch.bool)).all()
    ox = (x1 + 1 - win).clamp(0, w - win) & ~1
    oy = (y1 + 1 - win).clamp(0, h - win) & ~1
    return fits, oy, ox


def chunk_window_origin(boxes, valid, h: int, w: int, win: int,
                        lattice: int = 2, margin: int = 2):
    """One (win, win) window for a chunk of frames, covering the union of
    its valid boxes, ``margin`` px inside the frame, its origin on the
    ``lattice`` grid (2: even; 4: o = 2 mod 4, which :meth:`UNet.mid_window`
    needs, with margin 6).  Returns (fits, oy, ox) as 0-d int64 / bool
    tensors on the boxes' device, computed there (no host read).  ``fits``
    is the direct containment test: False when the boxes move too far,
    touch the border or exceed the window, and the caller must then take
    the full-frame route."""
    big = 2 ** 31 - 1
    b = boxes.to(torch.int64)
    v = valid.to(torch.bool)
    lo = torch.where(v[:, None], b[:, :2], big).amin(0)      # (ux0, uy0)
    hi = torch.where(v[:, None], b[:, 2:], -big).amax(0)     # (ux1, uy1)
    any_valid = v.any()
    lo = torch.where(any_valid, lo, margin)
    hi = torch.where(any_valid, hi, margin + 2)
    off = 2 if lattice == 4 else 0   # lattice points: off, off + lattice, ..

    def snap(o, dim):
        o = o.clamp(margin, dim - win - margin)
        o = torch.div(o - off, lattice, rounding_mode="floor") * lattice + off
        return o.clamp_min(margin)   # snapping down may undershoot

    mid = torch.div(lo + hi, 2, rounding_mode="floor") - win // 2
    ox, oy = snap(mid[0], w), snap(mid[1], h)
    fits = ((ox <= lo[0]) & (hi[0] <= ox + win)
            & (oy <= lo[1]) & (hi[1] <= oy + win)
            & (ox + win + margin <= w) & (oy + win + margin <= h))
    return fits, oy, ox


def segment_frames(variables, frames_gray_u8, threshold: float = 0.5,
                   dtype=torch.float32, device=None):
    """Masks of (N, H, W) uint8 gray frames, batched, as the reference's
    per-frame ``unet_segment_frame`` makes them: each frame resized to 256²
    (bilinear), segmented, its probabilities resized back and compared with
    ``threshold`` -> (N, H, W) bool on the device.  This is
    ``GlottalPipelines.segment_video`` on a U-Net-only instance (the
    serving path's U-Net and resizes).

    ``variables``: the JAX package's U-Net tree (folded or not).
    ``device=None`` is the CUDA device (raises without one)."""
    from openglottal_tpu_torch.pipelines import GlottalPipelines

    pipe = GlottalPipelines(unet_variables=variables, dtype=dtype,
                            device=device)
    return pipe.segment_video(frames_gray_u8, threshold)
