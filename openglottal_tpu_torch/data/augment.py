"""Batched on-device training augmentation for the U-Net.

Counterpart of ``openglottal_tpu/data/augment.py``.  Reference augmentation
(openglottal/models/unet.py:150-191): h/v flip, ±30° rotation, 0.85–1.15
scale jitter, Gaussian noise σ ∈ [0.01, 0.05], Gaussian blur k ∈ {3, 5} σ ∈
[0.5, 1.5], brightness ×[0.7, 1.3], contrast [0.7, 1.3], each at p = 0.5
(rotation always).  The geometric ops compose into one inverse-affine
bilinear (image) / nearest (mask) resample per sample, and the whole
transform is one call of ``og_unet_augment`` (``ops/train_cuda.py``) on the
card.

Random draws come from an explicit ``torch.Generator``: 15 separate draws
per batch, one per decision (the apply-at-p = 0.5 flags and the factor draws
never share numbers, or the factor distribution would be conditioned on the
flag: the JAX package's round-1 bug), and the Gaussian noise as a 16th.
Parity with the JAX package is statistical; given the same parameters and
noise the transform is the JAX package's
(``tests/test_torch_port_augment.py``).
"""

from __future__ import annotations

import math

import torch

from openglottal_tpu_torch.ops import train_cuda
from openglottal_tpu_torch.ops.train_cuda import AUG_SIZE as SIZE

_DEG2RAD = torch.tensor(math.pi / 180.0, dtype=torch.float32)


def _uniform(b, lo, hi, gen, dev):
    return torch.rand(b, generator=gen, device=dev) * (hi - lo) + lo


def _flag(b, gen, dev):
    return torch.rand(b, generator=gen, device=dev) > 0.5


def blur_taps(k5, sigma):
    """Normalised 5-tap Gaussian taps (B, 5) float32; a 3-tap kernel is a
    5-tap one with zero outer weights (``augment._blur5``)."""
    x = torch.arange(5, dtype=torch.float32, device=sigma.device) - 2.0
    k = torch.exp(-(x ** 2) / (2 * sigma[:, None] ** 2))
    k = torch.where(k5[:, None] | (x.abs() <= 1), k, 0.0)
    return k / k.sum(1, keepdim=True)


def sample_params(b: int, generator: torch.Generator, device=None):
    """Draw one batch's augmentation -> (params (B, 16) float32 in the
    column order of ``train_cuda.AUG_PARAMS``, noise (B, 256, 256)
    float32), on ``device`` (the generator's)."""
    dev = torch.device(device) if device is not None else generator.device
    g = generator
    hflip, vflip = _flag(b, g, dev), _flag(b, g, dev)
    angle = _uniform(b, -30.0, 30.0, g, dev)
    do_scale = _flag(b, g, dev)
    scale = _uniform(b, 0.85, 1.15, g, dev)
    do_noise = _flag(b, g, dev)
    sigma_n = _uniform(b, 0.01, 0.05, g, dev)
    do_blur, k5 = _flag(b, g, dev), _flag(b, g, dev)
    sigma_b = _uniform(b, 0.5, 1.5, g, dev)
    bright = torch.where(_flag(b, g, dev), _uniform(b, 0.7, 1.3, g, dev), 1.0)
    contrast = torch.where(_flag(b, g, dev), _uniform(b, 0.7, 1.3, g, dev),
                           1.0)
    noise = torch.randn((b, SIZE, SIZE), generator=g, device=dev)
    th = angle * _DEG2RAD.to(dev)
    f = torch.float32
    params = torch.stack([
        hflip.to(f), vflip.to(f), torch.cos(th), torch.sin(th),
        torch.where(do_scale, scale, 1.0), do_noise.to(f), sigma_n,
        do_blur.to(f), *blur_taps(k5, sigma_b).unbind(1), bright, contrast,
        torch.zeros_like(angle)], 1)
    return params.contiguous(), noise


def augment_batch(imgs_u8, msks_u8, generator: torch.Generator):
    """(B, 256, 256) uint8 frames and {0,1} uint8 masks on the generator's
    device -> (images (B, 256, 256) float32 in [0, 1], masks (B, 256, 256)
    float32 in {0, 1}), augmented jointly."""
    params, noise = sample_params(imgs_u8.shape[0], generator, imgs_u8.device)
    return train_cuda.unet_augment(imgs_u8.contiguous(), msks_u8.contiguous(),
                                   params, noise)
