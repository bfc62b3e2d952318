"""Kaggle dataset path resolution.

Counterpart of ``openglottal_tpu/data/kaggle_paths.py``: locate the BAGLS
dataset when running inside a Kaggle kernel (mounted under /kaggle/input);
the reference imports ``openglottal.kaggle_paths`` but never ships it
(reference data.py:16)."""

from __future__ import annotations

import os
from pathlib import Path

_BAGLS_HINTS = ("bagls", "benchmark-for-automatic-glottis-segmentation")
KAGGLE_INPUT = Path("/kaggle/input")


def is_kaggle() -> bool:
    return os.environ.get("KAGGLE_KERNEL_RUN_TYPE") is not None or \
        KAGGLE_INPUT.is_dir()


def get_kaggle_bagls_path(split: str) -> Path | None:
    """The directory holding BAGLS ``split`` ('training' | 'test') PNG pairs
    on Kaggle (under /kaggle/input), else None."""
    root = KAGGLE_INPUT
    if not root.is_dir():
        return None
    for ds in sorted(root.iterdir()):
        if not any(h in ds.name.lower() for h in _BAGLS_HINTS):
            continue
        for cand in (ds / split, ds / split.capitalize(), ds):
            if cand.is_dir() and any(cand.glob("*_seg.png")):
                return cand
    return None


def resolve_kaggle_data_paths(dataset: str, split: str):
    """(images_dir, labels_dir) for a Kaggle dataset, else None (reference
    data.py:171-195; BAGLS keeps images and masks together)."""
    if dataset.lower() != "bagls":
        return None
    path = get_kaggle_bagls_path(split)
    if path is None:
        return None
    return path, path
