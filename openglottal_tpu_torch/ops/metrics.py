"""Segmentation metrics with the reference's conventions.

Counterpart of ``openglottal_tpu/ops/metrics.py``: ``dice`` and ``iou``
binarise with ``> 0``, reduce over the last two axes (any leading batch axes
stay) and give 1.0 when both masks are empty; ``dice_loss`` is the soft
Dice of ``sigmoid(logits)`` over the whole batch, differentiable through
autograd.  The sums of 0/1 values are exact in float32 below 2**24, so
``dice`` and ``iou`` are bit-equal to the reference's.
"""

from __future__ import annotations

import torch


def _binary(pred, gt):
    return (pred > 0).to(torch.float32), (gt > 0).to(torch.float32)


def dice(pred, gt):
    """Dice coefficient over the last two axes; empty and empty = 1.0."""
    p, g = _binary(pred, gt)
    inter = (p * g).sum((-2, -1))
    denom = p.sum((-2, -1)) + g.sum((-2, -1))
    return torch.where(denom > 0, 2.0 * inter / torch.clamp(denom, min=1.0),
                       1.0)


def iou(pred, gt):
    """Intersection over union over the last two axes; empty and empty =
    1.0."""
    p, g = _binary(pred, gt)
    inter = (p * g).sum((-2, -1))
    union = p.sum((-2, -1)) + g.sum((-2, -1)) - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1.0), 1.0)


def dice_loss(logits, target, eps: float = 1e-6):
    """Soft Dice loss of ``sigmoid(logits)`` against ``target`` over the
    whole batch (a 0-d float32 tensor)."""
    p = torch.sigmoid(logits.to(torch.float32))
    t = target.to(torch.float32)
    inter = (p * t).sum()
    return 1.0 - (2.0 * inter + eps) / (p.sum() + t.sum() + eps)
