"""The reference's torch U-Net checkpoints <-> the JAX package's weight
trees, in numpy and torch only.

Counterpart of ``openglottal_tpu/utils/torch_import.py``.  The reference
distributes U-Net weights as torch ``state_dict`` ``.pt`` files; these
functions turn one into the ``{params, batch_stats}`` numpy tree that the
JAX package's ``.npz`` files hold (and :mod:`utils/convert` turns into the
port's ``state_dict``), and back.  Layout map:

  downs.{i}.net.{0,3}   -> DoubleConv_{i}.Conv_{0,1}        (OIHW -> HWIO)
  downs.{i}.net.{1,4}   -> DoubleConv_{i}.BatchNorm_{0,1}
  bottleneck.net.*      -> DoubleConv_4.*
  ups.{2k}              -> ConvTranspose_{k}                (IOHW -> HWIO,
                                                             mirrored)
  ups.{2k+1}.net.*      -> DoubleConv_{5+k}.*
  head                  -> Conv_0

The transposed-conv kernel is mirrored spatially: the tree's correlation form
then computes torch's scatter form.
"""

from __future__ import annotations

import numpy as np
import torch


def _conv_kernel(w) -> np.ndarray:
    # torch Conv2d (O, I, kH, kW) -> (kH, kW, I, O)
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _convT_kernel(w) -> np.ndarray:
    # torch ConvTranspose2d (I, O, kH, kW) -> (kH, kW, I, O), mirrored
    w = np.asarray(w)[:, :, ::-1, ::-1]
    return np.transpose(w, (2, 3, 0, 1))


def _double_conv(sd: dict, prefix: str):
    params, stats = {}, {}
    for j, (conv_idx, bn_idx) in enumerate([(0, 1), (3, 4)]):
        params[f"Conv_{j}"] = {
            "kernel": _conv_kernel(sd[f"{prefix}.net.{conv_idx}.weight"])}
        params[f"BatchNorm_{j}"] = {
            "scale": np.asarray(sd[f"{prefix}.net.{bn_idx}.weight"]),
            "bias": np.asarray(sd[f"{prefix}.net.{bn_idx}.bias"]),
        }
        stats[f"BatchNorm_{j}"] = {
            "mean": np.asarray(sd[f"{prefix}.net.{bn_idx}.running_mean"]),
            "var": np.asarray(sd[f"{prefix}.net.{bn_idx}.running_var"]),
        }
    return params, stats


def _read_state_dict(path) -> dict:
    """A U-Net ``state_dict`` from a ``.pt`` file (tensors only:
    ``weights_only=True``); ``{"state_dict": ...}`` and ``{"model": ...}``
    wrappers are accepted, as the reference's loader accepts them."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    elif (isinstance(sd, dict) and "model" in sd
          and hasattr(sd["model"], "items")):
        sd = sd["model"]
    return {k: v.numpy() for k, v in sd.items()}


def unet_from_torch(pt_path_or_state_dict, n_levels: int = 4) -> dict:
    """A reference U-Net checkpoint (a ``.pt`` path or a ``state_dict`` of
    tensors or arrays) -> the JAX-layout ``{params, batch_stats}`` tree."""
    if isinstance(pt_path_or_state_dict, (str, bytes)) or hasattr(
            pt_path_or_state_dict, "__fspath__"):
        sd = _read_state_dict(pt_path_or_state_dict)
    else:
        sd = {k: np.asarray(v) for k, v in pt_path_or_state_dict.items()}
    params: dict = {}
    stats: dict = {}
    for i in range(n_levels):
        params[f"DoubleConv_{i}"], stats[f"DoubleConv_{i}"] = _double_conv(
            sd, f"downs.{i}")
    params[f"DoubleConv_{n_levels}"], stats[f"DoubleConv_{n_levels}"] = \
        _double_conv(sd, "bottleneck")
    for k in range(n_levels):
        params[f"ConvTranspose_{k}"] = {
            "kernel": _convT_kernel(sd[f"ups.{2 * k}.weight"]),
            "bias": np.asarray(sd[f"ups.{2 * k}.bias"]),
        }
        dc, st = _double_conv(sd, f"ups.{2 * k + 1}")
        params[f"DoubleConv_{n_levels + 1 + k}"] = dc
        stats[f"DoubleConv_{n_levels + 1 + k}"] = st
    params["Conv_0"] = {
        "kernel": _conv_kernel(sd["head.weight"]),
        "bias": np.asarray(sd["head.bias"]),
    }
    return {"params": params, "batch_stats": stats}


def unet_to_torch_state_dict(variables) -> dict:
    """The inverse: a JAX-layout tree -> the reference's ``state_dict``
    (numpy arrays), for users going back to the reference toolchain."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {}

    def put_dc(prefix, p, s):
        for j, (ci, bi) in enumerate([(0, 1), (3, 4)]):
            sd[f"{prefix}.net.{ci}.weight"] = np.transpose(
                np.asarray(p[f"Conv_{j}"]["kernel"]), (3, 2, 0, 1))
            sd[f"{prefix}.net.{bi}.weight"] = np.asarray(
                p[f"BatchNorm_{j}"]["scale"])
            sd[f"{prefix}.net.{bi}.bias"] = np.asarray(
                p[f"BatchNorm_{j}"]["bias"])
            sd[f"{prefix}.net.{bi}.running_mean"] = np.asarray(
                s[f"BatchNorm_{j}"]["mean"])
            sd[f"{prefix}.net.{bi}.running_var"] = np.asarray(
                s[f"BatchNorm_{j}"]["var"])
            sd[f"{prefix}.net.{bi}.num_batches_tracked"] = np.asarray(0)

    for i in range(4):
        put_dc(f"downs.{i}", params[f"DoubleConv_{i}"],
               stats[f"DoubleConv_{i}"])
    put_dc("bottleneck", params["DoubleConv_4"], stats["DoubleConv_4"])
    for k in range(4):
        kern = np.asarray(params[f"ConvTranspose_{k}"]["kernel"])[::-1, ::-1]
        sd[f"ups.{2 * k}.weight"] = np.transpose(kern, (2, 3, 0, 1))
        sd[f"ups.{2 * k}.bias"] = np.asarray(
            params[f"ConvTranspose_{k}"]["bias"])
        put_dc(f"ups.{2 * k + 1}", params[f"DoubleConv_{5 + k}"],
               stats[f"DoubleConv_{5 + k}"])
    sd["head.weight"] = np.transpose(np.asarray(params["Conv_0"]["kernel"]),
                                     (3, 2, 0, 1))
    sd["head.bias"] = np.asarray(params["Conv_0"]["bias"])
    return sd
