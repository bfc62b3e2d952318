"""Glottal area waveform -> kinematic features.

Counterpart of ``openglottal_tpu/features.py``:
  * silent waveform (max == 0) -> None
  * open_quotient = fraction of frames with area > 0.1 * mean
  * f0 = rfft peak frequency in cycles/frame, DC excluded; peak at bin 1 means
    "no reliable f0" -> None (callers multiply by capture_fps for Hz)
  * periodicity = max normalised autocorrelation at lags 1..49
  * cv = std / (mean + 1e-8)

``kinematic_features_t`` is the tensor core (returns an f0_valid flag instead
of None); the host wrapper reproduces the reference's dict-or-None API.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_PERIODICITY_LAG = 50  # reference: ac[1:min(50, len(ac))]


def kinematic_features_t(area_wave: torch.Tensor) -> dict:
    """Feature core over a (T,) waveform; a dict of 0-d tensors.  ``silent``
    True means the reference would return None, ``f0_valid`` False means f0
    would be None."""
    area = area_wave.to(torch.float32)
    t = area.shape[0]
    mean_a = area.mean()
    std_a = area.std(unbiased=False)
    silent = area.max() == 0

    oq = (area > mean_a * 0.1).to(torch.float32).mean()

    centered = area - mean_a
    fft = torch.fft.rfft(centered).abs()
    freqs = torch.fft.rfftfreq(t, device=area.device)
    if fft.shape[0] > 1:
        peak_idx = torch.argmax(fft[1:]) + 1
    else:  # degenerate single-frame video
        peak_idx = torch.zeros((), dtype=torch.long, device=area.device)
    f0_valid = peak_idx != 1
    f0 = freqs[peak_idx]

    # autocorrelation at lags 1..min(49, T-1): direct dot products
    n_lags = min(MAX_PERIODICITY_LAG, t)
    ac0 = torch.dot(centered, centered) + 1e-8
    if n_lags > 1:
        acs = torch.stack([torch.dot(centered[:t - k], centered[k:])
                           for k in range(1, n_lags)])
        periodicity = acs.max() / ac0
    else:
        periodicity = torch.zeros((), dtype=torch.float32, device=area.device)

    return {
        "area_mean": mean_a,
        "area_std": std_a,
        "area_range": area.max() - area.min(),
        "open_quotient": oq,
        "f0": f0,
        "f0_valid": f0_valid,
        "periodicity": periodicity,
        "cv": std_a / (mean_a + 1e-8),
        "silent": silent,
    }


def kinematic_features(area_wave) -> dict | None:
    """Host API matching the reference ``_kinematic_features``: None for a
    silent waveform; f0 is None when the FFT peak lands on bin 1; includes the
    raw waveform under ``_area``.  The waveform is T scalars, so the feature
    math runs on the host copy."""
    if isinstance(area_wave, torch.Tensor):
        area_wave = area_wave.detach().cpu().numpy()
    area = np.asarray(area_wave, np.float64)
    if area.size == 0 or area.max() == 0:
        return None
    out = kinematic_features_t(torch.from_numpy(area.astype(np.float32)))
    return {
        "area_mean": float(out["area_mean"]),
        "area_std": float(out["area_std"]),
        "area_range": float(out["area_range"]),
        "open_quotient": float(out["open_quotient"]),
        "f0": float(out["f0"]) if bool(out["f0_valid"]) else None,
        "periodicity": float(out["periodicity"]),
        "cv": float(out["cv"]),
        "_area": area,
    }
