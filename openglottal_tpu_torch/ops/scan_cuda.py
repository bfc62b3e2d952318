"""ctypes binding of the frame-axis scan kernels (``csrc/scan.cu``).

``og_gate_scan`` runs the temporal gate FSM (``models/gate.py``),
``og_thresh_chain`` the tracker's scalar threshold recurrence and
``og_motion_map`` its per-pixel motion map with the blurred absdiff that
feeds it (``models/tracker.py``) over a whole video in one launch each;
``og_gate_scan_batch`` and ``og_thresh_chain_batch`` run the first two over
the K videos of a cohort in one launch, one block per video.  The
wrappers and the plain versions live beside the functions they serve; this
module holds the loaded library and the launch counts.
"""

from __future__ import annotations

import ctypes

import torch

from openglottal_tpu_torch.ops import _build
from openglottal_tpu_torch.ops.blur import gaussian_kernel_1d

LAUNCHES = {"gate_scan": 0, "thresh_chain": 0, "motion_map": 0,
            "gate_scan_batch": 0, "thresh_chain_batch": 0}

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
        for name, args in (
                ("og_gate_scan", [p, p, p, p, p, p, i, f, f, f, i, i, p]),
                ("og_thresh_chain", [p, p, p, p, p, i, f, f, p]),
                ("og_gate_scan_batch", [p] * 6 + [i, f, f, f, i, i, p]),
                ("og_thresh_chain_batch", [p] * 6 + [i, f, f, p]),
                ("og_motion_map", [p] * 5 + [i, i, i, p, i, f, f, p])):
            # a library built from another checkout (chip_smoke.py
            # --against) may lack a later entry point
            fn = getattr(so, name, None)
            if fn is not None:
                fn.argtypes = args
                fn.restype = ctypes.c_int
        _configured = True
    return so


def taps(ksize: int):
    """The blur's float32 taps (``ops/blur.gaussian_kernel_1d``) as a C
    array for ``og_motion_map``, which copies them into its launch."""
    k = gaussian_kernel_1d(ksize)
    return (ctypes.c_float * len(k))(*k.tolist())


def check_offsets(offsets, total: int) -> list[int]:
    """K + 1 host ints, non-decreasing from 0 to ``total``: the sequences
    [offsets[i], offsets[i + 1]) of a flat stack."""
    off = [int(o) for o in offsets]
    if (not off or off[0] != 0 or off[-1] != total
            or any(b < a for a, b in zip(off, off[1:]))):
        raise ValueError(f"offsets {off} do not cut {total} frames into "
                         f"sequences")
    return off


def offsets_arg(offsets):
    """K + 1 sequence offsets (host ints, non-decreasing from 0) as the C
    array of long long the batched launches take by value."""
    return (ctypes.c_longlong * len(offsets))(*(int(o) for o in offsets))


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream
