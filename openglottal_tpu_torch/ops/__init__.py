"""Tensor ops of the port, and the wrappers of its hand-written kernels
(``*_cuda.py``, built from ``csrc/`` by ``_build.py``).

The reference's names resolve here lazily (the ops modules import each
other, and the kernel wrappers, through this package): the resizes and
letterboxes, ``gaussian_blur``, the masked histograms and
``otsu_threshold``, ``dice`` / ``iou`` / ``dice_loss`` and
``connected_components`` / ``top_n_blobs``.
"""

from openglottal_tpu_torch import _lazy

_NAMES = {
    **{n: "openglottal_tpu_torch.ops.resize" for n in (
        "resize_bilinear", "resize_nearest", "crop_resize_bilinear",
        "letterbox", "letterbox_info", "apply_letterbox", "unletterbox")},
    "gaussian_blur": "openglottal_tpu_torch.ops.blur",
    **{n: "openglottal_tpu_torch.ops.histogram" for n in (
        "masked_histogram_u8", "masked_percentile_u8",
        "masked_percentile_u8_batch", "otsu_threshold")},
    **{n: "openglottal_tpu_torch.ops.metrics" for n in (
        "dice", "iou", "dice_loss")},
    **{n: "openglottal_tpu_torch.ops.blobs" for n in (
        "connected_components", "top_n_blobs")},
}


__getattr__ = _lazy(_NAMES)


__all__ = list(_NAMES)
