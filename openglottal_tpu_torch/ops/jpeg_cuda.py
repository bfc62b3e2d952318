"""Baseline JPEG decode on the card: the wrappers of ``csrc/jpeg.cu``'s
``og_jpeg_entropy`` and ``og_jpeg_idct_bgr``, and the upload of a packed
chunk (``data/jpeg.pack``), the only thing of an MJPG clip that crosses.

Replace the host decode of ``openglottal_tpu/data/video.py:32-74``
(``cv2.VideoCapture``); the plain versions are ``data/jpeg.py``'s
``entropy_decode_plain`` and ``idct_bgr_plain``.

Each wrapper checks its inputs, allocates its outputs (and the entropy
decode's scratch, a record a subsequence of ``SUB_BITS`` bits) with
``torch.empty`` / ``torch.zeros``, launches on the current stream without
synchronising and counts its launches in ``LAUNCHES``.  A CUDA tensor goes
to the kernel or the call raises; a CPU tensor goes to the plain version.
:func:`decode` is the read path: upload, entropy decode, the error check
(one host sync: a corrupt or short frame raises ``ValueError`` naming it),
IDCT and colour.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from openglottal_tpu_torch.data import jpeg
from openglottal_tpu_torch.data.prefetch import PinnedUploader
from openglottal_tpu_torch.ops import _build

LAUNCHES = {"jpeg_entropy": 0, "jpeg_idct_bgr": 0}

# og_jpeg_entropy's subsequence length in bits (``csrc/jpeg.cu``: a thread
# synchronises and decodes one subsequence of a segment)
SUB_BITS = 1536

# Measurement hook, as in ``blobs_cuda``: a list here receives
# (wrapper name, inputs, outputs) of every launch.
RECORD: list | None = None

_FIELDS = ("data", "segs", "tables", "slots", "comp", "quant")
_configured = False


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    global _configured
    lib = _build.load("jpeg")
    if not _configured:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.og_jpeg_entropy.argtypes = ([p, p, i] + [p] * 6 + [i] * 9
                                        + [p, ll, ll, p])
        lib.og_jpeg_entropy_scratch_bytes.argtypes = [i, ll, i]
        lib.og_jpeg_idct_bgr.argtypes = [p, p, p] + [i] * 10 + [p]
        lib.og_jpeg_entropy.restype = ctypes.c_int
        lib.og_jpeg_entropy_scratch_bytes.restype = ll
        lib.og_jpeg_entropy_min_sub_bits.restype = ctypes.c_int
        lib.og_jpeg_idct_bgr.restype = ctypes.c_int
        _configured = True
    return lib


@dataclass
class DevicePacked:
    """A :class:`data.jpeg.Packed` with its arrays as tensors on one
    device."""
    data: torch.Tensor
    segs: torch.Tensor
    tables: torch.Tensor
    slots: torch.Tensor
    comp: torch.Tensor
    quant: torch.Tensor
    geo: jpeg.Geometry

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def t(self) -> int:
        return self.slots.shape[0]

    def host(self) -> jpeg.Packed:
        """The arrays back on the host, as the plain versions take them."""
        return jpeg.Packed(*(getattr(self, k).cpu().numpy() for k in _FIELDS),
                           self.geo)


def _validate(p: jpeg.Packed) -> None:
    """The packed arrays' bounds, on the host, before a kernel trusts them:
    every segment's words (at least one) inside ``data``, its frame and MCUs
    inside the chunk, the segments in frame order (the entropy kernel finds
    a frame's segments by bisection), every table slot and component slot
    inside its table."""
    geo, t = p.geo, p.slots.shape[0]
    segs = np.asarray(p.segs, np.int64).reshape(-1, jpeg.SEG_WORDS)
    off, nb, f, m0, nm = segs.T
    mcus = geo.mcus if geo.ncomp == 3 else geo.nblk
    ns = p.slots.shape[1]
    comp = np.asarray(p.comp)[:, :geo.ncomp]
    if (p.data.ndim != 1 or p.data.dtype != np.uint8
            or len(p.data) % 4 or p.quant.shape != (t, 3, 64)
            or comp.shape[0] != t or not 1 <= ns <= 6
            or (off % 4).any() or (off < 0).any() or (nb < 0).any()
            or (off + np.maximum(4, (nb + 3) // 4 * 4) > len(p.data)).any()
            or (f < 0).any() or (f >= t).any() or (np.diff(f) < 0).any()
            or (m0 < 0).any()
            or (nm < 1).any() or (m0 + nm > mcus).any()
            or (p.slots < -1).any() or (p.slots >= len(p.tables)).any()
            or (comp < 0).any() or (comp >= ns).any()
            or (np.take_along_axis(p.slots, comp.reshape(t, -1), 1)
                < 0).any()):
        raise ValueError("jpeg: packed chunk out of bounds")


def upload(p: jpeg.Packed, device,
           uploader: PinnedUploader | None = None) -> DevicePacked:
    """The packed chunk, checked (:func:`_validate`), on ``device``: for a
    CUDA device with an ``uploader``, copied through its pinned ring in one
    non-blocking upload that the current stream waits for; else a plain
    copy of each array."""
    _validate(p)
    device = torch.device(device)
    arrays = [torch.from_numpy(np.ascontiguousarray(getattr(p, k)))
              for k in _FIELDS]
    if device.type == "cuda" and uploader is not None:
        out, ev = uploader.upload(arrays)
        stream = torch.cuda.current_stream(device)
        stream.wait_event(ev)
        out[0].record_stream(stream)        # the one buffer of all six
    else:
        out = [a.to(device) for a in arrays]
    return DevicePacked(*out, geo=p.geo)


def _layout(geo: jpeg.Geometry):
    """(ncomp, mcux, mcuy, hs0, vs0) as the kernels take them: a gray frame
    is an MCU a block."""
    if geo.ncomp == 1:
        return 1, geo.bw[0], geo.bh[0], 1, 1
    return 3, geo.mcux, geo.mcuy, geo.hs[0], geo.vs[0]


def _check(dp: DevicePacked) -> None:
    for k in _FIELDS:
        x = getattr(dp, k)
        if x.device != dp.device or not x.is_contiguous():
            raise ValueError(f"jpeg: packed {k} must be contiguous on "
                             f"{dp.device}")
    if dp.data.dtype != torch.uint8 or any(
            getattr(dp, k).dtype != torch.int32 for k in _FIELDS[1:]):
        raise ValueError("jpeg: packed data must be uint8, the rest int32")
    t = dp.t
    if (dp.segs.dim() != 2 or dp.segs.shape[1] != jpeg.SEG_WORDS
            or dp.tables.dim() != 2
            or dp.tables.shape[1] != jpeg.TABLE_WORDS
            or tuple(dp.comp.shape) != (t, 3, 2)
            or tuple(dp.quant.shape) != (t, 3, 64)):
        raise ValueError("jpeg: packed arrays of the wrong shape")


def entropy_decode(dp: DevicePacked):
    """Huffman decode of a packed chunk -> (coefficients (T, nblk, 64) int16
    in natural order, the DC dequantised and predicted, the AC as levels;
    errors (T,) int32, non-zero for a corrupt or short frame).  On CUDA
    tensors one launch of ``og_jpeg_entropy``; on CPU tensors the plain
    version."""
    _check(dp)
    if not dp.data.is_cuda:
        coef, err = jpeg.entropy_decode_plain(dp.host())
        return (torch.from_numpy(coef).to(dp.device),
                torch.from_numpy(err).to(dp.device))
    return launch_entropy(dp, SUB_BITS)


def launch_entropy(dp: DevicePacked, sub_bits: int):
    """``og_jpeg_entropy`` on a chunk on the card with subsequences of
    ``sub_bits`` bits (the kernel's smallest is
    ``og_jpeg_entropy_min_sub_bits()``; :func:`entropy_decode` passes
    ``SUB_BITS``); its scratch from ``torch.empty``.  Counts one launch."""
    geo = dp.geo
    t, nslots = dp.t, dp.slots.shape[1]
    data = dp.data if dp.data.data_ptr() % 4 == 0 else dp.data.clone()
    lib = _lib()
    nseg = dp.segs.shape[0]
    nbytes = lib.og_jpeg_entropy_scratch_bytes(nseg, data.numel(), sub_bits)
    if nbytes < 0:
        raise ValueError(f"jpeg_entropy: subsequences of {sub_bits} bits are "
                         f"not supported")
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dp.device)
    coef = torch.empty((t, geo.nblk, 64), dtype=torch.int16,
                       device=dp.device)
    err = torch.zeros((t,), dtype=torch.int32, device=dp.device)
    ncomp, mcux, mcuy, hs0, vs0 = _layout(geo)
    with torch.cuda.device(dp.device):
        rc = lib.og_jpeg_entropy(
            data.data_ptr(), dp.segs.data_ptr(), nseg,
            dp.tables.data_ptr(), dp.slots.data_ptr(), dp.comp.data_ptr(),
            dp.quant.data_ptr(), coef.data_ptr(), err.data_ptr(), t, ncomp,
            mcux, mcux * mcuy, hs0, vs0, geo.nblk, nslots, sub_bits,
            scratch.data_ptr(), nbytes, data.numel(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "jpeg_entropy")
    LAUNCHES["jpeg_entropy"] += 1
    if RECORD is not None:
        RECORD.append(("jpeg_entropy", dp, (coef, err)))
    return coef, err


def idct_bgr(coef, dp: DevicePacked):
    """Dequantise, IDCT, colour and crop -> (T, H, W, 3) uint8 BGR, or (T,
    H, W) uint8 gray for one component, on the coefficients' device.  On
    CUDA tensors one launch of ``og_jpeg_idct_bgr``; on CPU tensors the
    plain version."""
    _check(dp)
    geo = dp.geo
    t = dp.t
    if tuple(coef.shape) != (t, geo.nblk, 64) or coef.dtype != torch.int16:
        raise ValueError(f"idct_bgr: expected ({t}, {geo.nblk}, 64) int16, "
                         f"got {tuple(coef.shape)} {coef.dtype}")
    if coef.device != dp.device:
        raise ValueError("idct_bgr: coefficients and tables on different "
                         "devices")
    if not coef.is_cuda:
        out = jpeg.idct_bgr_plain(coef.cpu().numpy(), dp.host())
        return torch.from_numpy(out).to(coef.device)
    coef = coef.contiguous()
    if coef.data_ptr() % 16:
        coef = coef.clone()         # the kernel reads 16-byte rows
    form = jpeg.colour_form(geo)
    shape = (t, geo.h, geo.w) if form == jpeg.FORM_GRAY else (
        t, geo.h, geo.w, 3)
    out = torch.empty(shape, dtype=torch.uint8, device=coef.device)
    ncomp, mcux, mcuy, hs0, vs0 = _layout(geo)
    with torch.cuda.device(coef.device):
        rc = _lib().og_jpeg_idct_bgr(
            coef.data_ptr(), dp.quant.data_ptr(), out.data_ptr(), t, geo.h,
            geo.w, ncomp, mcux, mcuy, hs0, vs0, geo.nblk, form,
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "jpeg_idct_bgr")
    LAUNCHES["jpeg_idct_bgr"] += 1
    if RECORD is not None:
        RECORD.append(("jpeg_idct_bgr", (coef, dp), out))
    return out


def raise_on_errors(err, first: int = 0) -> None:
    """``ValueError`` naming the first corrupt or short frame of a chunk
    whose first frame is number ``first``; ``err`` on the host."""
    bad = np.flatnonzero(np.asarray(err))
    if len(bad):
        raise ValueError(f"JPEG frame {first + int(bad[0])}: corrupt or "
                         f"short entropy-coded data ({len(bad)} frame(s) of "
                         f"the chunk)")


def decode(p: jpeg.Packed, device, first: int = 0,
           uploader: PinnedUploader | None = None):
    """A packed chunk -> its frames on ``device`` (``idct_bgr``'s output):
    the upload, the entropy decode, the error check and the IDCT, on the
    current stream.  One host sync (the error flags)."""
    dp = upload(p, device, uploader)
    coef, err = entropy_decode(dp)
    raise_on_errors(err.cpu().numpy(), first)
    return idct_bgr(coef, dp)
