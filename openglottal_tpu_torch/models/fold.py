"""Inference BatchNorm folding on ``state_dict``s:
Conv(no bias) -> BN -> act  ==>  Conv(+bias) -> act.

Counterpart of ``openglottal_tpu/models/fold.py``.  With running statistics,
BatchNorm is an affine map per channel:

    y = gamma * (x - mean) / sqrt(var + eps) + beta
      = scale * x + (beta - mean * scale),        scale = gamma / sqrt(var+eps)

so it folds exactly into the preceding convolution's weights and a bias.  A
folded ``state_dict`` loads into ``UNet(fuse_bn=True)`` / ``YOLOv8(fuse_bn=
True)``: conv names are unchanged, the BatchNorm entries disappear.  The
arithmetic is done in float32 in the reference's order; folded weights equal
the JAX package's folded weights to the last bit or two (XLA and PyTorch
round the 1/sqrt differently).
"""

from __future__ import annotations

import re

import torch

from openglottal_tpu_torch.models.unet import UNET_BN_EPS
from openglottal_tpu_torch.models.yolo import YOLO_BN_EPS

UNET_STEM = "downs.0.net.0.weight"
YOLO_STEM = "model.0.conv.weight"

# BN weight key -> (conv prefix, bn prefix)
_YOLO_BN = re.compile(r"^(?P<block>.*)\.bn\.weight$")
_UNET_BN = re.compile(r"^(?P<block>.*\.net)\.(?P<i>[14])\.weight$")


def _bn_pairs(sd: dict):
    """(conv_prefix, bn_prefix) for every BatchNorm in the state_dict."""
    pairs = []
    for key in sd:
        m = _YOLO_BN.match(key)
        if m and f"{m['block']}.bn.running_var" in sd:
            pairs.append((f"{m['block']}.conv", f"{m['block']}.bn"))
            continue
        m = _UNET_BN.match(key)
        if m and f"{m['block']}.{m['i']}.running_var" in sd:
            pairs.append((f"{m['block']}.{int(m['i']) - 1}",
                          f"{m['block']}.{m['i']}"))
    return pairs


def is_folded(sd: dict) -> bool:
    """True when no BatchNorm statistics remain and the block convs carry a
    bias."""
    if any(k.endswith("running_var") for k in sd):
        return False
    return any(k.endswith(".conv.bias") or re.search(r"\.net\.[03]\.bias$", k)
               for k in sd)


def fold_batchnorm(sd: dict, eps: float) -> dict:
    """Fold every Conv/BatchNorm pair of a ``state_dict`` (tensors).  A
    ``state_dict`` without BatchNorm statistics is returned unchanged."""
    pairs = _bn_pairs(sd)
    if not pairs:
        return sd
    out = dict(sd)
    for conv, bn in pairs:
        gamma = sd[f"{bn}.weight"].to(torch.float32)
        beta = sd[f"{bn}.bias"].to(torch.float32)
        mean = sd[f"{bn}.running_mean"].to(torch.float32)
        var = sd[f"{bn}.running_var"].to(torch.float32)
        # sqrt in float64 rounded once to float32 is the correctly rounded
        # float32 sqrt, which jnp.sqrt gives; torch.sqrt on the CPU is one
        # ulp off on some values
        scale = gamma / torch.sqrt((var + eps).double()).float()
        bias = beta - mean * scale
        if f"{conv}.bias" in sd:   # defensive; these convs are bias-free
            bias = bias + sd[f"{conv}.bias"] * scale
        out[f"{conv}.weight"] = sd[f"{conv}.weight"].to(torch.float32) \
            * scale[:, None, None, None]           # OIHW: O is first
        out[f"{conv}.bias"] = bias
        for name in ("weight", "bias", "running_mean", "running_var",
                     "num_batches_tracked"):
            out.pop(f"{bn}.{name}", None)
    return out


def fold_unet(sd: dict) -> dict:
    """Folded state_dict for ``UNet(fuse_bn=True)``."""
    return fold_batchnorm(sd, UNET_BN_EPS)


def fold_yolo(sd: dict) -> dict:
    """Folded state_dict for ``YOLOv8(fuse_bn=True)``."""
    return fold_batchnorm(sd, YOLO_BN_EPS)


def absorb_u8_scale(sd: dict, stem_key: str) -> dict:
    """Fold the /255 input normalisation into the stem conv kernel:
    ``conv(x/255, k) == conv(x, k/255)``, so the pipelines feed raw 0..255
    pixel values.  The multiply is done in float32; any cast to a narrower
    compute dtype comes after.  Only the kernel is scaled — a folded bias adds
    after the conv and is untouched."""
    out = dict(sd)
    out[stem_key] = sd[stem_key].to(torch.float32) * (1.0 / 255.0)
    return out
