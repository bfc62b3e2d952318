"""The in-box area count of pipeline 3: the hand-written CUDA kernel
(``csrc/areas.cu`` ``og_box_count``), its wrapper and its plain PyTorch
version.

Replaces the count of ``openglottal_tpu/pipelines.py``
``_unet_windowed_areas_chunk_fn`` (``logits > 0`` inside each frame's gate
box, on the decoder's window) and ``_box_area_sums`` (the same with the
window at the frame's origin):

    area[n] = valid[n] ? #{(i, j) : x[n, i, j] > thr,
                                    y0 <= oy + i < y1, x0 <= ox + j < x1} : 0

as float32.  The kernel reads the head's output as it is (bfloat16 or
float32) and only the rows and columns inside each box, and writes one float
per frame: the mask never reaches device memory.  The origin may be a 0-d
integer tensor on the device (the decoder's window origin), which the kernel
reads there, so the host never waits for it.

The wrapper checks device, dtype, shape and contiguity, allocates its output
with ``torch.empty``, launches on the current stream without synchronising
and counts its launches in ``LAUNCHES``.  A CUDA tensor goes to the kernel or
the call raises; a CPU tensor goes to the plain version (the eager compare,
AND and sum).  ``use_plain=True`` is a test hook that forces the plain
version on any device.
"""

from __future__ import annotations

import ctypes

import torch

from openglottal_tpu_torch.ops import _build

LAUNCHES = {"box_count": 0}

# Measurement hook, as in ``blobs_cuda``: a list here receives
# (wrapper name, inputs, keyword arguments) of every launch.
RECORD: list | None = None

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_configured = False


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _configured
    lib = _build.load("areas")
    if not _configured:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.og_box_count.argtypes = [p, i, f, p, p, p, p, i, i, p, i, i, i, p]
        lib.og_box_count.restype = ctypes.c_int
        _configured = True
    return lib


def box_count_plain(x, thr: float, valid, boxes, oy=0, ox=0):
    """The plain version: the eager compare, box masks, AND and sum."""
    n, h, w = x.shape
    dev = x.device
    rows = oy + torch.arange(h, device=dev)
    cols = ox + torch.arange(w, device=dev)
    b = boxes.to(torch.int64)
    rm = (rows[None] >= b[:, 1:2]) & (rows[None] < b[:, 3:4])
    cm = (cols[None] >= b[:, 0:1]) & (cols[None] < b[:, 2:3])
    # compared in float32, as the kernel compares (a bfloat16 comparison
    # would round ``thr`` to bfloat16)
    area = ((x.float() > thr) & rm[:, :, None] & cm[:, None, :]).sum((1, 2))
    return torch.where(valid.to(torch.bool), area.to(torch.float32), 0.0)


def _origin(o, dev):
    """(device pointer or None, host int) of an origin given as an int or a
    0-d integer tensor."""
    if not isinstance(o, torch.Tensor):
        return None, int(o)
    if o.numel() != 1 or o.device != dev:
        raise ValueError(f"box_count: an origin must be one integer on "
                         f"{dev}, got {tuple(o.shape)} on {o.device}")
    return o.to(torch.int64).reshape(()), 0


def box_count(x: torch.Tensor, thr: float, valid: torch.Tensor,
              boxes: torch.Tensor, oy=0, ox=0, use_plain: bool = False):
    """Per-frame count of ``x > thr`` inside each valid frame's box, with x
    the (N, H, W) window of the frame at (oy, ox) -> (N,) float32.

    x: bfloat16 or float32, contiguous; valid (N,) bool; boxes (N, 4)
    integer (x0, y0, x1, y1) in frame coordinates; oy / ox: ints or 0-d
    integer tensors on x's device."""
    if x.dim() != 3 or valid.shape != (x.shape[0],) or boxes.shape != (
            x.shape[0], 4):
        raise ValueError(f"box_count: x {tuple(x.shape)}, valid "
                         f"{tuple(valid.shape)}, boxes {tuple(boxes.shape)} "
                         f"are not (N, H, W), (N,) and (N, 4)")
    if use_plain or not x.is_cuda:
        return box_count_plain(x, thr, valid, boxes, oy, ox)
    dev = x.device
    if x.dtype not in _DTYPES:
        raise ValueError(f"box_count: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("box_count: x must be contiguous")
    if valid.device != dev or boxes.device != dev:
        raise ValueError("box_count: x, valid and boxes lie on different "
                         "devices")
    n, h, w = x.shape
    v = (valid if valid.dtype == torch.bool else valid != 0).contiguous()
    b = boxes.to(torch.int32).contiguous()
    (py, oy0), (px, ox0) = _origin(oy, dev), _origin(ox, dev)
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.og_box_count(
            x.data_ptr(), _DTYPES[x.dtype], float(thr), v.data_ptr(),
            b.data_ptr(), None if py is None else py.data_ptr(),
            None if px is None else px.data_ptr(), oy0, ox0, out.data_ptr(),
            n, h, w, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "box_count")
    LAUNCHES["box_count"] += 1
    if RECORD is not None:
        RECORD.append(("box_count", (x, valid, boxes),
                       {"thr": thr, "oy": oy, "ox": ox}))
    return out
