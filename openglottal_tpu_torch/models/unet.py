"""Lightweight 4-level U-Net for binary glottal segmentation.

Counterpart of ``openglottal_tpu/models/unet.py`` (the plain forward; the
windowed decoder is not ported): encoder widths (32, 64, 128, 256), DoubleConv
= 2 x (Conv3x3 -> BN -> ReLU), 2x2 max-pool, ConvTranspose2d(k=2, s=2)
upsampling with skip concatenation (skip first), 1x1 logits head, float32
logits.  7.77M parameters.  Parameter names follow the reference torch
layout (``downs.{i}.net.{0,1,3,4}``, ``bottleneck``, ``ups.{2k}``,
``ups.{2k+1}``, ``head``) so a converted ``state_dict`` loads strictly.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from openglottal_tpu_torch.models.yolo import BatchNorm

UNET_BN_EPS = 1e-5


class DoubleConv(nn.Module):
    """Two Conv3x3(no bias) -> BatchNorm -> ReLU blocks; ``fuse_bn`` runs the
    inference-folded form Conv3x3(+bias) -> ReLU.  Indices 0/3 are the convs
    and 1/4 the norms in both forms, so names do not move."""

    def __init__(self, in_ch: int, out_ch: int, fuse_bn: bool = False):
        super().__init__()

        def norm():
            return (nn.Identity() if fuse_bn
                    else BatchNorm(out_ch, UNET_BN_EPS, tracked=True))

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

    def forward(self, x):
        x = x.to(self.head.weight.dtype)
        skips = []
        for down in self.downs:
            x = down(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = self.bottleneck(x)
        for k in range(0, len(self.ups), 2):
            x = self.ups[k](x)
            s = skips.pop()
            if x.shape[2:] != s.shape[2:]:   # odd sizes: bilinear size fix
                x = F.interpolate(x, size=s.shape[2:], mode="bilinear",
                                  align_corners=False)
            x = self.ups[k + 1](torch.cat([s, x], dim=1))   # skip first
        return self.head(x).float()
