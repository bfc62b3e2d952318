"""Dataset materialisation: PNG frames + masks -> packed uint8 arrays.

Counterpart of ``openglottal_tpu/data/dataset.py``.  Replaces the
reference's per-item cv2 loading (GlottisDataset,
openglottal/models/unet.py:91-148, and the HDF5 cache, data.py:200-329) with
one-shot host materialisation: images are letterboxed to 256² as the
reference does (INTER_NEAREST for 2-D arrays, masks with the same
geometry), then the whole epoch pipeline runs on the device
(``data/augment.py``).  PNGs are read by the port's own reader
(``data/png.py``, equal to ``cv2.imread``) and resized by
``ops/resize.resize_nearest_cv2`` (equal to cv2's INTER_NEAREST).
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

from openglottal_tpu_torch.data.png import imread_gray
from openglottal_tpu_torch.ops.resize import letterbox_info, resize_nearest_cv2

SIZE = 256


def letterbox_pair(img, msk, size: int = SIZE):
    """Letterbox a 2-D image and its mask to (size, size) with INTER_NEAREST
    (the reference's geometry); 256² pairs pass through."""
    h, w = img.shape[:2]
    if (h, w) == (size, size):
        return img, msk
    pt, pl, ch, cw = letterbox_info(h, w, size)
    out_i = np.zeros((size, size), img.dtype)
    out_m = np.zeros((size, size), msk.dtype)
    out_i[pt:pt + ch, pl:pl + cw] = resize_nearest_cv2(img, cw, ch)
    out_m[pt:pt + ch, pl:pl + cw] = resize_nearest_cv2(msk, cw, ch)
    return out_i, out_m


def label_name(fname: str, label_suffix: str = "") -> str:
    """The mask file of an image (``"_seg"`` for BAGLS, unet.py:107,134)."""
    return f"{Path(fname).stem}{label_suffix}.png" if label_suffix else fname


def cache_key(*parts) -> str:
    """sha256 of the JSON of ``parts``, 16 hex digits (as the JAX
    package keys its caches, train_unet_crop.py:54-70)."""
    return hashlib.sha256(json.dumps(list(parts)).encode()).hexdigest()[:16]


def materialize_split(fnames: list[str], img_dir, lbl_dir,
                      label_suffix: str = "", cache_dir=None):
    """Load (images (N,256,256) u8, masks (N,256,256) u8 in {0,1}).

    ``label_suffix`` mirrors the reference ("_seg" for BAGLS).  With
    ``cache_dir`` set, results are cached as ``glottis_<key>.npz`` keyed by
    the sha256 of the file list + dirs; the key is the JAX package's, so the
    two packages share a cache."""
    img_dir, lbl_dir = Path(img_dir), Path(lbl_dir)
    if cache_dir is not None:
        key = cache_key(sorted(fnames), str(img_dir), str(lbl_dir),
                        label_suffix)
        cache = Path(cache_dir) / f"glottis_{key}.npz"
        if cache.exists():
            z = np.load(cache)
            return z["images"], z["masks"]

    n = len(fnames)
    images = np.zeros((n, SIZE, SIZE), np.uint8)
    masks = np.zeros((n, SIZE, SIZE), np.uint8)
    for i, fname in enumerate(fnames):
        lbl = label_name(fname, label_suffix)
        img = imread_gray(img_dir / fname)
        msk = imread_gray(lbl_dir / lbl)
        if img is None or msk is None:
            raise FileNotFoundError(f"missing image or mask: {fname} / {lbl}")
        img, msk = letterbox_pair(img, msk)
        images[i] = img
        masks[i] = (msk > 0).astype(np.uint8)

    if cache_dir is not None:
        Path(cache_dir).mkdir(parents=True, exist_ok=True)
        np.savez_compressed(cache, images=images, masks=masks)
    return images, masks


def load_split_json(path) -> dict:
    """training.json with keys ``training`` / ``Val`` / optional ``test``
    (reference data.py:120-125)."""
    with open(path) as f:
        return json.load(f)


# ── HDF5 cache (reference data.py:200-329 format compatibility) ──────────────
# ``h5py`` is imported only here, when asked for (the card's machine has
# none; there these two functions raise ImportError).

def build_glottis_hdf5(fnames, img_dir, lbl_dir, output_path,
                       label_suffix: str = "", size: int = 256):
    """Write letterboxed images and {0,1} masks to HDF5 with the reference's
    layout (datasets ``images`` / ``masks`` / ``fnames``, data.py:200-259)."""
    import h5py

    images, masks = materialize_split(fnames, img_dir, lbl_dir, label_suffix)
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(output_path, "w") as f:
        f.create_dataset("images", data=images, dtype="u1",
                         chunks=(1, size, size))
        f.create_dataset("masks", data=masks, dtype="u1",
                         chunks=(1, size, size))
        ds = f.create_dataset("fnames", (len(fnames),),
                              dtype=h5py.special_dtype(vlen=str))
        for i, fname in enumerate(fnames):
            ds[i] = fname
    return output_path


def load_glottis_hdf5(h5_path) -> tuple[np.ndarray, np.ndarray]:
    """Load a reference-format HDF5 cache into packed arrays."""
    import h5py

    with h5py.File(h5_path, "r") as f:
        return f["images"][:], f["masks"][:]
