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

The kernel counts a table of chunks in one launch (``box_count_table``: a
cohort's chunk j of every video); ``box_count`` is a table of one.  The
wrapper checks device, dtype, shape and contiguity, allocates each chunk's
output with ``torch.empty`` unless the chunk brings its own, launches on the
current stream without synchronising and counts its launches in
``LAUNCHES``.  A CUDA tensor goes to the kernel or the call raises; a CPU
tensor goes to the plain version (the eager compare, AND and sum, looped
over the table).  ``use_plain=True`` is a test hook that forces the plain
version on any device.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

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


class _Chunk(ctypes.Structure):
    """One table entry as ``csrc/areas.cu`` lays it out (``Chunk``)."""

    _fields_ = [("x", ctypes.c_void_p), ("valid", ctypes.c_void_p),
                ("boxes", ctypes.c_void_p), ("oy", ctypes.c_void_p),
                ("ox", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("n", ctypes.c_int), ("first", ctypes.c_int),
                ("oy_arg", ctypes.c_int), ("ox_arg", ctypes.c_int)]


class CountChunk(NamedTuple):
    """One chunk of a count: x (N, H, W) bfloat16 or float32, contiguous;
    valid (N,) bool; boxes (N, 4) integer (x0, y0, x1, y1) in frame
    coordinates; oy / ox the window's origin (ints or 0-d integer tensors on
    x's device); out: None, or a contiguous (N,) float32 tensor on x's
    device to write the counts into."""

    x: torch.Tensor
    valid: torch.Tensor
    boxes: torch.Tensor
    oy: object = 0
    ox: object = 0
    out: torch.Tensor | None = None


def _lib() -> ctypes.CDLL:
    global _configured
    lib = _build.load("areas")
    if not _configured:
        lib.og_box_count_entry_bytes.restype = ctypes.c_int
        if lib.og_box_count_entry_bytes() != ctypes.sizeof(_Chunk):
            raise RuntimeError("box_count: the table entry's layout differs "
                               "between csrc/areas.cu and its binding")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.og_box_count.argtypes = [p, i, i, f, i, i, p]
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


def box_count_table_plain(chunks, thr: float):
    """The plain version of a table: :func:`box_count_plain` per chunk,
    written into the chunk's ``out`` where it brings one."""
    outs = []
    for c in chunks:
        a = box_count_plain(c.x, thr, c.valid, c.boxes, c.oy, c.ox)
        if c.out is not None:
            a = c.out.copy_(a)
        outs.append(a)
    return outs


def _origin(o, dev):
    """(device pointer or None, host int) of an origin given as an int or a
    0-d integer tensor."""
    if not isinstance(o, torch.Tensor):
        return None, int(o)
    if o.numel() != 1 or o.device != dev:
        raise ValueError(f"box_count: an origin must be one integer on "
                         f"{dev}, got {tuple(o.shape)} on {o.device}")
    o = o.to(torch.int64).reshape(())
    return o, o.data_ptr()


def _check_chunk(c: CountChunk) -> None:
    x, valid, boxes = c.x, c.valid, c.boxes
    if x.dim() != 3 or valid.shape != (x.shape[0],) or boxes.shape != (
            x.shape[0], 4):
        raise ValueError(f"box_count: x {tuple(x.shape)}, valid "
                         f"{tuple(valid.shape)}, boxes {tuple(boxes.shape)} "
                         f"are not (N, H, W), (N,) and (N, 4)")
    if c.out is not None and c.out.shape != (x.shape[0],):
        raise ValueError(f"box_count: out {tuple(c.out.shape)} is not "
                         f"({x.shape[0]},)")


def box_count_table(chunks, thr: float, use_plain: bool = False):
    """Per-frame counts of ``x > thr`` inside each valid frame's box for
    every :class:`CountChunk` of ``chunks`` -> a list of (N_i,) float32
    tensors (each chunk's ``out`` where it brings one).  On CUDA tensors ONE
    launch of ``og_box_count`` for the whole table (the chunks share dtype
    and (H, W)); on CPU tensors the plain version."""
    chunks = [c if isinstance(c, CountChunk) else CountChunk(*c)
              for c in chunks]
    for c in chunks:
        _check_chunk(c)
    if not chunks:
        return []
    if use_plain or not chunks[0].x.is_cuda:
        return box_count_table_plain(chunks, thr)
    x0 = chunks[0].x
    dev = x0.device
    if x0.dtype not in _DTYPES:
        raise ValueError(f"box_count: x must be float32 or bfloat16, got "
                         f"{x0.dtype}")
    h, w = x0.shape[1:]
    table = (_Chunk * len(chunks))()
    keep, outs = [], []
    for e, c in zip(table, chunks):
        x = c.x
        if x.dtype != x0.dtype or tuple(x.shape[1:]) != (h, w):
            raise ValueError("box_count: the chunks of a table must share "
                             "dtype and (H, W)")
        if not x.is_contiguous():
            raise ValueError("box_count: x must be contiguous")
        if (x.device != dev or c.valid.device != dev
                or c.boxes.device != dev):
            raise ValueError("box_count: the chunks' tensors lie on "
                             "different devices")
        v = (c.valid if c.valid.dtype == torch.bool
             else c.valid != 0).contiguous()
        b = c.boxes.to(torch.int32).contiguous()
        out = c.out
        if out is None:
            out = torch.empty((x.shape[0],), dtype=torch.float32, device=dev)
        elif (out.dtype != torch.float32 or out.device != dev
              or not out.is_contiguous()):
            raise ValueError("box_count: out must be contiguous float32 on "
                             "x's device")
        (ty, py), (tx, px) = _origin(c.oy, dev), _origin(c.ox, dev)
        e.x, e.valid, e.boxes, e.out = (x.data_ptr(), v.data_ptr(),
                                        b.data_ptr(), out.data_ptr())
        e.n = x.shape[0]
        if ty is None:
            e.oy, e.oy_arg = None, py
        else:
            e.oy, e.oy_arg = py, 0
        if tx is None:
            e.ox, e.ox_arg = None, px
        else:
            e.ox, e.ox_arg = px, 0
        keep += [v, b, ty, tx]
        outs.append(out)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.og_box_count(ctypes.byref(table), len(chunks),
                               _DTYPES[x0.dtype], float(thr), h, w,
                               torch.cuda.current_stream().cuda_stream)
    _build.check(err, "box_count")
    LAUNCHES["box_count"] += 1
    if RECORD is not None:
        RECORD.append(("box_count", tuple(chunks), {"thr": thr}))
    return outs


def box_count(x: torch.Tensor, thr: float, valid: torch.Tensor,
              boxes: torch.Tensor, oy=0, ox=0, use_plain: bool = False):
    """Per-frame count of ``x > thr`` inside each valid frame's box, with x
    the (N, H, W) window of the frame at (oy, ox) -> (N,) float32: a table
    of one chunk (:func:`box_count_table`).

    x: bfloat16 or float32, contiguous; valid (N,) bool; boxes (N, 4)
    integer (x0, y0, x1, y1) in frame coordinates; oy / ox: ints or 0-d
    integer tensors on x's device."""
    return box_count_table([CountChunk(x, valid, boxes, oy, ox)], thr,
                           use_plain)[0]
