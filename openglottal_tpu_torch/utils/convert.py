"""Weights across: the JAX package's ``{params, batch_stats}`` numpy trees ->
the port's ``state_dict``s.

Layouts: conv kernels HWIO -> OIHW (``transpose(3, 2, 0, 1)``); BatchNorm
scale/bias/mean/var -> weight/bias/running_mean/running_var; transposed-conv
kernels are mirrored spatially (``[::-1, ::-1]``) and then moved to torch's
(I, O, kH, kW) (``transpose(2, 3, 0, 1)``), which equates the reference's
correlation form with torch's scatter form.  An already-folded tree (no
``batch_stats``, convs with bias) converts to a folded ``state_dict``.
"""

from __future__ import annotations

import numpy as np
import torch

# ultralytics layer index -> flax module name
_CONV = {0: "ConvBNSiLU_0", 1: "ConvBNSiLU_1", 3: "ConvBNSiLU_2",
         5: "ConvBNSiLU_3", 7: "ConvBNSiLU_4", 16: "ConvBNSiLU_5",
         19: "ConvBNSiLU_6"}
_C2F = {2: "C2f_0", 4: "C2f_1", 6: "C2f_2", 8: "C2f_3", 12: "C2f_4",
        15: "C2f_5", 18: "C2f_6", 21: "C2f_7"}
_DETECT_LAYER = 22


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C", copy=True))


def _conv_w(kernel) -> torch.Tensor:
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def _put_conv_bn(sd, conv_key, bn_key, p, s, ci="Conv_0", bi="BatchNorm_0",
                 tracked=False):
    """One Conv (+ its BatchNorm, when the tree still has one)."""
    sd[f"{conv_key}.weight"] = _conv_w(p[ci]["kernel"])
    if "bias" in p[ci]:
        sd[f"{conv_key}.bias"] = _t(p[ci]["bias"])
    if bi in p:
        sd[f"{bn_key}.weight"] = _t(p[bi]["scale"])
        sd[f"{bn_key}.bias"] = _t(p[bi]["bias"])
        sd[f"{bn_key}.running_mean"] = _t(s[bi]["mean"])
        sd[f"{bn_key}.running_var"] = _t(s[bi]["var"])
        if tracked:
            sd[f"{bn_key}.num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long)


def yolo_state_dict_from_jax(tree: dict, prefix: str = "model.") -> dict:
    """JAX YOLOv8 variables (numpy tree) -> ``YOLOv8.state_dict()`` layout."""
    params = tree["params"]
    stats = tree.get("batch_stats") or {}
    sd: dict = {}

    def cbs(pfx, p, s):
        _put_conv_bn(sd, f"{pfx}.conv", f"{pfx}.bn", p, s or {})

    def sub(d, *names):
        for n in names:
            d = d.get(n, {}) if d else {}
        return d

    for layer, name in _CONV.items():
        cbs(f"{prefix}{layer}", params[name], sub(stats, name))
    for layer, name in _C2F.items():
        n = sum(1 for k in params[name] if k.startswith("Bottleneck_"))
        cbs(f"{prefix}{layer}.cv1", params[name]["ConvBNSiLU_0"],
            sub(stats, name, "ConvBNSiLU_0"))
        cbs(f"{prefix}{layer}.cv2", params[name]["ConvBNSiLU_1"],
            sub(stats, name, "ConvBNSiLU_1"))
        for i in range(n):
            for j in (0, 1):
                cbs(f"{prefix}{layer}.m.{i}.cv{j + 1}",
                    params[name][f"Bottleneck_{i}"][f"ConvBNSiLU_{j}"],
                    sub(stats, name, f"Bottleneck_{i}", f"ConvBNSiLU_{j}"))
    for j in (0, 1):
        cbs(f"{prefix}9.cv{j + 1}", params["SPPF_0"][f"ConvBNSiLU_{j}"],
            sub(stats, "SPPF_0", f"ConvBNSiLU_{j}"))
    hp, hs = params["DetectHead_0"], sub(stats, "DetectHead_0")
    for i in range(3):
        for branch, ours in (("cv2", "box"), ("cv3", "cls")):
            base = f"{prefix}{_DETECT_LAYER}.{branch}.{i}"
            cbs(f"{base}.0", hp[f"{ours}{i}_0"], sub(hs, f"{ours}{i}_0"))
            cbs(f"{base}.1", hp[f"{ours}{i}_1"], sub(hs, f"{ours}{i}_1"))
            sd[f"{base}.2.weight"] = _conv_w(hp[f"{ours}{i}_2"]["kernel"])
            sd[f"{base}.2.bias"] = _t(hp[f"{ours}{i}_2"]["bias"])
    # the fixed DFL projection the layout carries
    sd[f"{prefix}{_DETECT_LAYER}.dfl.conv.weight"] = torch.arange(
        16, dtype=torch.float32).view(1, 16, 1, 1)
    return sd


def unet_state_dict_from_jax(tree: dict) -> dict:
    """JAX U-Net variables (numpy tree) -> ``UNet.state_dict()`` layout."""
    params = tree["params"]
    stats = tree.get("batch_stats") or {}
    n_levels = sum(1 for k in params if k.startswith("ConvTranspose_"))
    sd: dict = {}

    def put_dc(prefix, p, s):
        for j, (ci, bi) in enumerate([(0, 1), (3, 4)]):
            _put_conv_bn(sd, f"{prefix}.net.{ci}", f"{prefix}.net.{bi}", p, s,
                         ci=f"Conv_{j}", bi=f"BatchNorm_{j}", tracked=True)

    for i in range(n_levels):
        put_dc(f"downs.{i}", params[f"DoubleConv_{i}"],
               stats.get(f"DoubleConv_{i}", {}))
    put_dc("bottleneck", params[f"DoubleConv_{n_levels}"],
           stats.get(f"DoubleConv_{n_levels}", {}))
    for k in range(n_levels):
        kern = np.asarray(params[f"ConvTranspose_{k}"]["kernel"])[::-1, ::-1]
        sd[f"ups.{2 * k}.weight"] = _t(np.transpose(kern, (2, 3, 0, 1)))
        sd[f"ups.{2 * k}.bias"] = _t(params[f"ConvTranspose_{k}"]["bias"])
        put_dc(f"ups.{2 * k + 1}", params[f"DoubleConv_{n_levels + 1 + k}"],
               stats.get(f"DoubleConv_{n_levels + 1 + k}", {}))
    sd["head.weight"] = _conv_w(params["Conv_0"]["kernel"])
    sd["head.bias"] = _t(params["Conv_0"]["bias"])
    return sd
