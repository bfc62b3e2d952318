"""ctypes binding of the frame-axis scan kernels (``csrc/scan.cu``).

``og_gate_scan`` runs the temporal gate FSM (``models/gate.py``),
``og_thresh_chain`` the tracker's scalar threshold recurrence and
``og_lmap_ema`` its per-pixel motion-map recurrence (``models/tracker.py``)
over a whole video in one launch each.  The wrappers
and the plain versions live beside the functions they serve; this module
holds the loaded library and the launch counts.
"""

from __future__ import annotations

import ctypes

import torch

from openglottal_tpu_torch.ops import _build

LAUNCHES = {"gate_scan": 0, "thresh_chain": 0, "lmap_ema": 0}

# Measurement hook, as in ``blobs_cuda``: a list here receives
# (wrapper name, inputs, keyword arguments) of every launch.
RECORD: list | None = None

_configured = False


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launched(name: str, inputs: tuple, **kwargs) -> None:
    LAUNCHES[name] += 1
    if RECORD is not None:
        RECORD.append((name, inputs, kwargs))


def lib() -> ctypes.CDLL:
    global _configured
    so = _build.load("scan")
    if not _configured:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        so.og_gate_scan.argtypes = [p, p, p, p, p, p, i, f, f, f, i, i, p]
        so.og_thresh_chain.argtypes = [p, p, p, p, p, i, f, f, p]
        so.og_lmap_ema.argtypes = [p, p, p, p, i, i, f, f, p]
        for fn in (so.og_gate_scan, so.og_thresh_chain, so.og_lmap_ema):
            fn.restype = ctypes.c_int
        _configured = True
    return so


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream
