"""Networks (YOLOv8n, U-Net), BatchNorm folding, int8 quantization, the
temporal gate and the motion trackers.

The reference's names resolve here lazily: ``UNet``, ``DoubleConv``,
``TemporalGate``, ``gate_scan``, and the stateful ``compat`` classes
(``TemporalDetector``, ``VocalFoldTracker``, ``YOLOGuidedVFT``,
``GlottisDataset``).
"""

from openglottal_tpu_torch import _lazy

_NAMES = {
    "UNet": "openglottal_tpu_torch.models.unet",
    "DoubleConv": "openglottal_tpu_torch.models.unet",
    "TemporalGate": "openglottal_tpu_torch.models.gate",
    "gate_scan": "openglottal_tpu_torch.models.gate",
    **{n: "openglottal_tpu_torch.compat" for n in (
        "TemporalDetector", "VocalFoldTracker", "YOLOGuidedVFT",
        "GlottisDataset")},
}


__getattr__ = _lazy(_NAMES)


__all__ = list(_NAMES)
