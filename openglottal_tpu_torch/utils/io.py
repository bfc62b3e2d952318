"""Weight path resolution, ``.npz`` weight trees and feature export.

Counterpart of ``openglottal_tpu/utils/io.py``.  The port reads the same
framework-neutral ``.npz`` weight files (keys = '/'-joined tree paths); the
trees are turned into ``state_dict``s by ``utils/convert.py``.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np


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


def _load_npz_weights(path, what: str) -> dict:
    """A weight tree of an ``.npz`` file; checkpoint directories and torch
    ``.pt`` files wait for the training slice of the port."""
    p = resolve_weights_path(path)
    if not p.exists():
        raise FileNotFoundError(
            f"{what} weights not found: {path} (also tried "
            f"weights/{p.name}); expected an .npz weight file")
    if p.is_dir() or p.suffix != ".npz":
        raise NotImplementedError(
            f"{what} weights {path}: checkpoint directories and .pt files "
            f"are read once the training slice is ported; this port reads "
            f".npz weight files")
    return load_weights_npz(p)


def load_unet_weights(path) -> dict:
    """U-Net (or crop U-Net) variables from an ``.npz`` weight file."""
    return _load_npz_weights(path, "U-Net")


def load_yolo_weights(path) -> dict:
    """YOLOv8 variables from an ``.npz`` weight file."""
    return _load_npz_weights(path, "YOLO")


def save_features_json(feats: dict, out_path) -> None:
    """features.json with array-to-list conversion."""
    out_path = Path(out_path)
    os.makedirs(out_path.parent, exist_ok=True)
    save = {k: (v.tolist() if hasattr(v, "tolist") else v)
            for k, v in feats.items()}
    with open(out_path, "w") as f:
        json.dump(save, f, indent=2)
