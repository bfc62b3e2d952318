"""Weight path resolution, weight files and feature export.

Counterpart of ``openglottal_tpu/utils/io.py``.  The port reads and writes
the same framework-neutral ``.npz`` weight files (keys = '/'-joined tree
paths) and reads the reference's torch ``.pt`` checkpoints (a U-Net
``state_dict``; an ultralytics YOLOv8n checkpoint) into the same
JAX-layout ``{params, batch_stats}`` trees, so nothing downstream changes;
the trees are turned into ``state_dict``s by ``utils/convert.py``.
Checkpoint directories (orbax) are refused with a message.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from openglottal_tpu_torch.utils.torch_import import unet_from_torch
from openglottal_tpu_torch.utils.yolo_import import yolo_from_torch


def resolve_weights_path(path) -> Path:
    """Return path if it exists; else try weights/<basename>."""
    p = Path(path)
    if p.exists():
        return p
    legacy = Path("weights") / p.name
    if legacy.exists():
        return legacy
    return p


def load_weights_npz(path) -> dict:
    """'/'-joined keys of an ``.npz`` weight file -> nested dict of numpy
    arrays (``{"params": ..., "batch_stats": ...}``)."""
    p = resolve_weights_path(path)
    if not p.exists():
        raise FileNotFoundError(
            f"weights not found: {path} (also tried weights/{p.name})")
    tree: dict = {}
    with np.load(p) as z:
        for key in z.files:
            node = tree
            parts = key.split("/")
            for k in parts[:-1]:
                node = node.setdefault(k, {})
            node[parts[-1]] = z[key]
    return tree


def save_weights_npz(variables, path) -> None:
    """Save a ``{params, batch_stats}`` weight tree as one ``.npz`` file
    (keys = '/'-joined tree paths), the JAX package's layout: its
    ``load_weights_npz`` reads what this writes, and the other way round."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = np.asarray(node)

    walk("", variables)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **flat)


def _load_weights(path, what: str, from_pt) -> dict:
    """A weight tree from an ``.npz`` file, or from a torch ``.pt`` /
    ``.pth`` checkpoint through ``from_pt``; any other suffix is refused
    (nothing is unpickled on a guess)."""
    p = resolve_weights_path(path)
    if not p.exists():
        raise FileNotFoundError(
            f"{what} weights not found: {path} (also tried "
            f"weights/{p.name}); expected an .npz weight file or a torch "
            f".pt checkpoint")
    if p.is_dir():
        raise NotImplementedError(
            f"{what} weights {path}: a checkpoint directory (orbax) is not "
            f"read by the port; save it as .npz with the JAX package's "
            f"save_weights_npz, or give a torch .pt checkpoint")
    if p.suffix == ".npz":
        return load_weights_npz(p)
    if p.suffix in (".pt", ".pth"):
        return from_pt(p)
    raise ValueError(f"{what} weights {path}: unknown suffix {p.suffix!r}; "
                     f"expected .npz, .pt or .pth")


def load_unet_weights(path) -> dict:
    """U-Net (or crop U-Net) variables from an ``.npz`` weight file or a
    reference-style torch ``.pt`` ``state_dict`` (``{state_dict | model |
    raw}`` accepted) -> the JAX-layout tree."""
    return _load_weights(path, "U-Net", unet_from_torch)


def load_yolo_weights(path) -> dict:
    """YOLOv8 variables from an ``.npz`` weight file or an
    ultralytics-style YOLOv8n ``.pt`` (read without ultralytics,
    ``utils/yolo_import.py``) -> the JAX-layout tree."""
    return _load_weights(path, "YOLO", yolo_from_torch)


def save_features_json(feats: dict, out_path) -> None:
    """features.json with array-to-list conversion."""
    out_path = Path(out_path)
    os.makedirs(out_path.parent, exist_ok=True)
    save = {k: (v.tolist() if hasattr(v, "tolist") else v)
            for k, v in feats.items()}
    with open(out_path, "w") as f:
        json.dump(save, f, indent=2)
