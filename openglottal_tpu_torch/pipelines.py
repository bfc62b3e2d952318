"""Serving pipelines over whole videos: frames in, area waveform / kinematic
features out.

Counterpart of ``openglottal_tpu/pipelines.py``.  The five pipelines, for
(T, H, W) gray or (T, H, W, 3) BGR uint8 video of any frame size:

  1  ``vft``        — YOLOv8n -> temporal gate -> size-locked crops of the
                      gated boxes -> motion tracker
  2  ``guided-vft`` — YOLOv8n -> temporal gate -> YOLO-guided tracker
  3  ``unet``       — YOLOv8n + gate + U-Net, in-box pixel counts; on 256²
                      monochrome video with folded weights the U-Net's two
                      shallowest decoder levels run on a window around the
                      gate boxes only (the windowed decoder)
  4  ``crop-unet``  — YOLOv8n + gate -> each gated crop letterboxed to 256²
                      -> crop-trained U-Net -> mask pasted back
  5  ``unet-only``  — full-frame U-Net, no gate

Colour video crosses to the device whole and is converted to gray there
(``data/video.bgr_to_gray_u8``); video whose three channels are equal
crosses as one channel.  The detector sees 256² frames: other sizes are
letterboxed to 256² (bilinear, rounded to uint8) and its boxes mapped back;
the U-Net of ``unet`` / ``unet-only`` runs on frames resized to 256² and its
probabilities are resized back.  Both trackers run frame-parallel by default
and as a sequential per-frame loop with ``parallel_trackers=False`` (the
debug form).  Meshes raise ``NotImplementedError`` until a later slice
ports them.

int8 serving (``quant="int8"``: the U-Net post-training quantized, the
detector bfloat16; ``"int8-full"``: the detector too; ``models/quant.py``,
every interior convolution one launch of ``og_qconv``) takes the routes the
JAX package quantizes: ``unet`` on 256² video of which one channel crossed
(windowed with its ``ok`` redo, or full-frame), its cohorts and
``unet-only`` on 256² frames.  Other input, the other pipelines,
``run_pipeline_full`` and streams stay bfloat16, as in the JAX package.  The
calibration is made on the first video served (its first 64 frames) unless
:meth:`GlottalPipelines.calibrate` or :meth:`GlottalPipelines.load_qparams`
made it first.

Streaming (``stream_areas``, ``stream_features``) serves all five
pipelines from an iterable of 256² chunks in memory bounded by the chunk:
the networks run on the CHUNK-frame slices of the concatenated stream, the
gate and the trackers resume from their carries, and the waveform equals
the whole-video call's bit for bit (``unet``'s full-frame route, the
trackers' sequential forms).

Cohort serving (``yolo_unet_areas_gray_multi``,
``guided_vft_areas_gray_multi``, ``vft_areas_gray_multi``) serves K 256²
monochrome videos at once, each video's output bit-identical to the
per-video call on it.  The detector and the U-Net run over each video's own
``CHUNK``-frame slices, as the per-video call slices them; what reads
per-video state runs once for the sub-batch: one gate launch
(``gate_scan_batch``), one set of blob launches and one threshold-chain
launch (guided-vft), one in-box count per chunk index (``unet``), and one
host read per sub-batch.  The sub-batch size K comes from the card's free
memory (:func:`cohort_k`).

Model passes run over ``CHUNK``-frame slices in a Python loop (the last one
ragged; nothing is padded — PyTorch runs eagerly, so there are no static
shapes to bucket).

Device rule: ``device=None`` means ``torch.device("cuda")`` and raises when no
CUDA device is available; the CPU is used only when asked for by name.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from openglottal_tpu_torch.data.prefetch import prefetch_to_device
from openglottal_tpu_torch.data.video import bgr_to_gray_u8, is_monochrome
from openglottal_tpu_torch.features import kinematic_features
from openglottal_tpu_torch.models import quant as quant_mod
from openglottal_tpu_torch.models.fold import (
    UNET_STEM,
    YOLO_STEM,
    absorb_u8_scale,
    fold_unet,
    fold_yolo,
    is_folded,
)
from openglottal_tpu_torch.models.gate import (
    GateCarry,
    GateParams,
    gate_scan,
    gate_scan_batch,
    gate_single,
)
from openglottal_tpu_torch.models.tracker import (
    VFTParams,
    YGVFTParams,
    vft_initialize,
    vft_parallel,
    vft_scan,
    vft_scan_carry,
    ygvft_initialize,
    ygvft_parallel,
    ygvft_parallel_multi,
    ygvft_scan,
    ygvft_scan_carry,
)
from openglottal_tpu_torch.models.unet import UNet, chunk_window_origin
from openglottal_tpu_torch.models.yolo import YOLOv8, max_conf_detect
from openglottal_tpu_torch.ops.areas_cuda import CountChunk, box_count_table
from openglottal_tpu_torch.ops.resize import (
    crop_resize_bilinear,
    dyn_letterbox_geometry,
    dyn_letterbox_index_nearest,
    dyn_unletterbox_index_nearest,
    gather_rows_cols,
    letterbox,
    letterbox_info,
    resize_bilinear,
)
from openglottal_tpu_torch.utils.convert import (
    unet_state_dict_from_jax,
    yolo_state_dict_from_jax,
)
from openglottal_tpu_torch.utils.io import load_weights_npz

VFT_INIT = 2     # init crops of the motion tracker
YGVFT_INIT = 2   # init frames of the guided tracker
CHUNK = 128      # frame-chunk size for batched model passes
CALIB_FRAMES = 64   # frames of the int8 calibration
QUANT_MODES = (None, "int8", "int8-full")
SIZE = 256       # the networks' frame size
WIN = 160        # the windowed decoder's window side (frame pixels)
PIPELINES = ("vft", "guided-vft", "unet", "unet-only", "crop-unet")


# ── the cohort size K ───────────────────────────────────────────────────
#
# Device bytes one video of t 256² frames holds in a cohort sub-batch, on
# top of what a sub-batch holds whatever its K (one chunk's activations).
# ``e`` is the networks' element size (2 bfloat16, 4 float32).
#
#   unet:        t * 65,536 (its uploaded frames, kept for the redo)
#                + 128 * 256² * e (one chunk's logits, held until the chunk
#                index's in-box count: the full-frame route's, the larger)
#   guided-vft:  t * 65,536 * 2 (uploaded frames, the tracked frames' copy)
#                + t * 256² * TAIL_BYTES_PER_PX (the tracker tail over all of
#                the sub-batch's frames; counted at the full-frame pass,
#                which a run may take, not the 128² window)
#   vft:         t * 65,536 (uploaded frames; the trackers run one video at
#                a time, so their temporaries are not held K times)
#
# TAIL_BYTES_PER_PX counts the tensors alive together at the blob filter's
# peak (``ops/blobs.top_n_blobs_batch``): float frames 4, ROI 1, raw mask 1,
# code 1, dual labels 4 + the two split labels 8, the two parent seeds 8,
# the parents 4 + the two split parents 8, the two padded label planes
# 8 (+ 2 % of border), hole seed and result 8, owner 4, the sort's values
# 4 and int64 indices 8, run bounds 1, next-run 4 + cummin's values and
# indices 12, sizes 8, keep 1: ~100 B, rounded up to 112 for the
# allocator's blocks.  The fixed part (the detector's chunk, one U-Net
# chunk's activations: skip1 128*256²*32*e, skip2 half of it, d3out a
# quarter, and 1.5 times as much again while the deeper levels run) is
# taken off the free memory first.  (Against torch.cuda.max_memory_allocated
# on an H100, ``chip_smoke.py``'s cohort line: counting the activations
# only once more gave 4-11 % too little for ``unet``.)
TAIL_BYTES_PER_PX = 112
COHORT_MEM_SHARE = 0.8     # of the free memory a sub-batch may take
# The cohort tail's largest flat tensors are (sum T, 258, 258) int32 (the
# blob filter's padded label planes at the full-frame pass): the port's own
# kernels index them with 64-bit bases, but every tensor is kept under 2**31
# elements so that no 32-bit element index anywhere can overflow.
INT32_ELEMS = 2 ** 31 - 1


def cohort_video_bytes(pipeline: str, t: int, elem_bytes: int) -> int:
    """Device bytes one t-frame 256² video holds in a cohort sub-batch (the
    arithmetic above)."""
    frame = SIZE * SIZE
    if pipeline == "unet":
        return t * frame + CHUNK * frame * elem_bytes
    if pipeline == "guided-vft":
        return t * frame * 2 + t * frame * TAIL_BYTES_PER_PX
    if pipeline == "vft":
        return t * frame
    raise ValueError(f"no cohort form for pipeline {pipeline!r}")


def cohort_fixed_bytes(pipeline: str, max_t: int, elem_bytes: int) -> int:
    """Device bytes a sub-batch holds whatever its K: one U-Net chunk's
    encoder outputs 2.5 times over (``unet``), one detector chunk (a fifth
    of them), and for ``vft`` one video's tracker pass at the largest
    crop."""
    chunk_acts = CHUNK * SIZE * SIZE * 32 * elem_bytes * (1 + 0.5 + 0.25)
    fixed = 0.2 * chunk_acts
    if pipeline == "unet":
        fixed += 2.5 * chunk_acts
    if pipeline == "vft":
        fixed += max_t * SIZE * SIZE * TAIL_BYTES_PER_PX
    return int(fixed)


def cohort_k(pipeline: str, ts, free_bytes: int, elem_bytes: int = 2,
             max_k: int | None = None) -> int:
    """The sub-batch size K of a cohort of videos with lengths ``ts`` on a
    device with ``free_bytes`` free: as many videos of the longest length
    as fit COHORT_MEM_SHARE of the free memory after the fixed part
    (:func:`cohort_video_bytes`, :func:`cohort_fixed_bytes`), at most so
    many that guided-vft's tail keeps its (sum T, 258, 258) planes under
    2**31 elements, at least 1 and at most the cohort; ``max_k`` caps it."""
    ts = [int(t) for t in ts]
    if not ts:
        return 1
    max_t = max(max(ts), 1)
    budget = free_bytes * COHORT_MEM_SHARE - cohort_fixed_bytes(
        pipeline, max_t, elem_bytes)
    k = int(budget // cohort_video_bytes(pipeline, max_t, elem_bytes))
    if pipeline == "guided-vft":
        k = min(k, INT32_ELEMS // (max_t * (SIZE + 2) ** 2))
    if max_k is not None:
        k = min(k, int(max_k))
    return max(1, min(k, len(ts)))


def free_device_bytes(device: torch.device) -> int:
    """Free memory of the device: the card's (``torch.cuda.mem_get_info``,
    plus what PyTorch's caching allocator holds unused, which it hands out
    again), or the host's available memory for the CPU."""
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[0]
                   + torch.cuda.memory_reserved(device)
                   - torch.cuda.memory_allocated(device))
    import os

    return int(os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA device (raises without one); anything else is
    taken at its word."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "openglottal_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU on purpose")
        return torch.device("cuda")
    return torch.device(device)


@contextlib.contextmanager
def full_float32(dtype):
    """Within the block, float32 work on the card is float32: cuDNN
    convolutions and matmuls may not drop to TF32.  No-op for other dtypes.
    The previous settings are restored on exit."""
    if dtype != torch.float32:
        yield
        return
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def _require_256(gray):
    """Streaming takes 256² chunks, the networks' own size: the whole-video
    paths letterbox other sizes through 256², and a stream that ran the
    networks at another size would not equal them.  Returns (h, w)."""
    h, w = gray.shape[1:3]
    if (h, w) != (SIZE, SIZE):
        raise ValueError(
            f"streaming expects 256² chunks, got {(h, w)}: letterbox the "
            f"chunks first (ops/resize.letterbox), as the whole-video paths "
            f"do")
    return h, w


def _cut(piece, a: int, b: int):
    """Frames [a, b) of a stream piece (bgr | None, gray)."""
    bgr, gray = piece
    return (None if bgr is None else bgr[a:b]), gray[a:b]


def _join(a, b):
    """Two stream pieces (bgr | None, gray), one after the other; where one
    of them is colour, the other's gray frames join it as three equal
    channels."""
    def bgr(p):
        return p[0] if p[0] is not None else p[1][..., None].expand(
            -1, -1, -1, 3)
    colour = None
    if a[0] is not None or b[0] is not None:
        colour = torch.cat([bgr(a), bgr(b)])
    return colour, torch.cat([a[1], b[1]])


def _box_area_sums(masks, valids, boxes):
    """area[t] = sum(mask inside box) when valid else 0."""
    h, w = masks.shape[1:]
    rows = torch.arange(h, device=masks.device)[None, :]
    cols = torch.arange(w, device=masks.device)[None, :]
    rm = (rows >= boxes[:, 1, None]) & (rows < boxes[:, 3, None])
    cm = (cols >= boxes[:, 0, None]) & (cols < boxes[:, 2, None])
    inside = masks & rm[:, :, None] & cm[:, None, :]
    areas = inside.sum((1, 2)).to(torch.float32)
    return torch.where(valids, areas, torch.zeros_like(areas))


def _gather_crops(gray_u8, boxes, out_h: int, out_w: int):
    """Batched crop + INTER_LINEAR resize of each frame's box to the locked
    crop size, rounded (half to even) to uint8 values like a resize of uint8
    crops.  gray (N, H, W), boxes (N, 4) int -> (N, out_h, out_w) float32
    (integer windows of uint8 pixels: the resize's exact float64 sums)."""
    b = boxes
    c = crop_resize_bilinear(gray_u8, b[:, 1], b[:, 0], b[:, 3] - b[:, 1],
                             b[:, 2] - b[:, 0], out_h, out_w)
    return torch.round(c).clamp(0, 255)


def _to_u8(x):
    """Float pixel values rounded (half to even) and clipped to uint8."""
    return torch.round(x).clamp(0, 255).to(torch.uint8)


def _unet_features(sd) -> tuple:
    """The encoder widths of a U-Net ``state_dict`` (32, 64, 128, 256 for
    the served model; narrower trees load too)."""
    n = sum(1 for k in sd if k.startswith("downs.") and k.endswith(
        ".net.0.weight"))
    return tuple(int(sd[f"downs.{i}.net.0.weight"].shape[0]) for i in range(n))


def _as_tree(weights):
    """A weight tree given as such or as the path of an ``.npz`` file."""
    if weights is None or isinstance(weights, dict):
        return weights
    return load_weights_npz(weights)


class GlottalPipelines:
    """Holds the models and runs the serving pipelines.

    ``unet_variables`` / ``crop_unet_variables`` / ``yolo_variables``: the
    JAX package's ``{params, batch_stats}`` numpy trees (folded or not), or
    paths of ``.npz`` files holding them; the crop U-Net has the U-Net's
    architecture and its own weights.  ``dtype``: ``torch.bfloat16``
    (default) or ``torch.float32``; in float32 every model pass runs under
    :func:`full_float32`, so that f32 on the card is f32 and not TF32.
    ``fold_bn``: fold BatchNorm into the convs (inference default).
    ``parallel_trackers=False`` runs both trackers as sequential per-frame
    loops (the debug form).  ``window_decoder``: run pipeline 3's U-Net
    with its two shallowest decoder levels on one window per chunk around
    the gate boxes (256² monochrome video only; other input takes the
    full-frame route); ``None`` turns it on when the weights are folded and
    both models are given, as the JAX package does.  ``use_plain_kernels``
    is a test hook: it routes every hand-written kernel to its plain version
    on any device.  ``quant``: None, ``"int8"`` or ``"int8-full"`` (the int8
    serving mode, module docstring); it needs folded weights.
    """

    def __init__(self, unet_variables=None, crop_unet_variables=None,
                 yolo_variables=None, conf: float = 0.25,
                 gate_params: GateParams = GateParams(),
                 vft_params: VFTParams = VFTParams(),
                 ygvft_params: YGVFTParams = YGVFTParams(),
                 dtype=torch.bfloat16, mesh=None,
                 parallel_trackers: bool = True, fold_bn: bool = True,
                 quant: str | None = None,
                 window_decoder: bool | None = None, device=None,
                 use_plain_kernels: bool = False):
        if mesh is not None:
            raise NotImplementedError("mesh sharding is ported in a later slice")
        if quant not in QUANT_MODES:
            raise ValueError(
                f"quant must be None, 'int8' or 'int8-full', got {quant!r}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.conf = conf
        self.gate_params = gate_params
        self.vft_params = vft_params
        self.ygvft_params = ygvft_params
        self.parallel_trackers = parallel_trackers
        self.use_plain_kernels = use_plain_kernels

        sds = {}
        for name, tree, convert in (
                ("unet", unet_variables, unet_state_dict_from_jax),
                ("crop_unet", crop_unet_variables, unet_state_dict_from_jax),
                ("yolo", yolo_variables, yolo_state_dict_from_jax)):
            if tree is not None:
                sds[name] = convert(_as_tree(tree))
        # already-folded checkpoints drop straight in; otherwise fold when
        # asked (the inference default)
        if sds and all(is_folded(sd) for sd in sds.values()):
            self._fuse = True
        else:
            self._fuse = bool(fold_bn and sds)
            if self._fuse:
                sds = {k: (fold_yolo if k == "yolo" else fold_unet)(sd)
                       for k, sd in sds.items()}
        if quant is not None and not self._fuse:
            raise ValueError("quant needs BN-folded variables "
                             "(provide batch_stats or pre-folded weights)")
        self._quant = quant
        self._qparams = None
        # the folded float32 weights the int8 mode quantizes (the stems not
        # scaled by 1/255, as the JAX package's trees are)
        self._folded = {} if quant is None else {
            k: {n: t.to(self.device) for n, t in sds[k].items()}
            for k in ("unet", "yolo") if k in sds}
        self.unet = self.crop_unet = self.yolo = None
        for name in ("unet", "crop_unet"):
            if name in sds:
                setattr(self, name, self._build(
                    UNet(fuse_bn=self._fuse, features=_unet_features(
                        sds[name])),
                    absorb_u8_scale(sds[name], UNET_STEM)))
        if "yolo" in sds:
            self.yolo = self._build(
                YOLOv8(nc=1, fuse_bn=self._fuse),
                absorb_u8_scale(sds["yolo"], YOLO_STEM))
        # the windowed decoder runs its valid convolutions as conv + bias +
        # ReLU, so it needs folded weights
        if window_decoder is None:
            window_decoder = (self._fuse and self.unet is not None
                              and self.yolo is not None)
        if window_decoder and self.unet is not None and not self._fuse:
            raise ValueError("the windowed decoder needs folded weights "
                             "(fold_bn=True or folded checkpoints)")
        self.window_decoder = bool(window_decoder)

    def _build(self, model, sd):
        """Load (the /255 input scale already absorbed into the stem, in
        float32), then cast to the compute dtype and move to the device."""
        model.load_state_dict(sd, strict=True)
        model = model.eval().requires_grad_(False)
        return model.to(device=self.device, dtype=self.dtype,
                        memory_format=torch.channels_last)

    # ── int8 serving: calibration and its persistence ───────────────────

    @torch.no_grad()
    def calibrate(self, gray_u8):
        """Quantize the models for the int8 mode on the first CALIB_FRAMES
        frames of ``gray_u8`` ((N, 256, 256) uint8, host or device) as the
        activation-range calibration set: the U-Net always, the detector in
        ``"int8-full"``.  Called with the first video served when not called
        before."""
        if self._quant is None:
            raise ValueError("calibrate needs quant='int8' or 'int8-full'")
        g = gray_u8[:CALIB_FRAMES]
        g = (g if isinstance(g, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(np.asarray(g))))
        g = g.to(self.device)
        qp = {"unet": quant_mod.quantize_unet(self._folded["unet"], g)}
        if self._quant == "int8-full" and "yolo" in self._folded:
            cin = self._folded["yolo"][YOLO_STEM].shape[1]
            x = g.float()[..., None].expand(-1, -1, -1, cin)
            qp["yolo"] = quant_mod.quantize_yolo(self._folded["yolo"], x)
        self._qparams = qp
        return self

    def save_qparams(self, path):
        """Persist the int8 calibration in the JAX package's ``.npz`` layout
        (``models/quant.save_qparams``), so that serving does not depend on
        which video came first."""
        if self._qparams is None:
            raise ValueError("not calibrated yet: call calibrate() first")
        quant_mod.save_qparams(self._qparams, path)
        return self

    def load_qparams(self, path):
        """Restore a persisted calibration (this package's or the JAX
        package's ``.npz``); no lazy calibration follows."""
        if self._quant is None:
            raise ValueError("load_qparams needs quant='int8'/'int8-full'")
        self._qparams = quant_mod.load_qparams(path, self.device)
        return self

    def _q(self, gray):
        """The qparams of the int8 routes, calibrating on ``gray`` (the
        first video served) when there are none."""
        if self._qparams is None:
            self.calibrate(gray)
        return self._qparams

    def _int8_route(self, frames_dev, gray) -> bool:
        """Whether ``unet`` serves this video in int8: the int8 mode and 256²
        video of which one channel crossed (the JAX package's rule)."""
        return (self._quant is not None and frames_dev is None
                and tuple(gray.shape[1:3]) == (SIZE, SIZE))

    def _qdetect_chunk(self, qp, gray_chunk):
        """The int8 detector (``"int8-full"``) on a chunk of 256² gray
        frames: raw 0..255 values, the channel broadcast to the stem's
        three -> (has (N,), raw boxes (N, 4) f32)."""
        h, w = gray_chunk.shape[1:]
        cin = qp["stem_bf16"]["kernel"].shape[1]
        x = gray_chunk.float()[..., None].expand(-1, -1, -1, cin)
        outs = quant_mod.qyolo_forward(qp, x, self.use_plain_kernels)
        return max_conf_detect(outs, h, w, self.conf)[:2]

    # ── input ───────────────────────────────────────────────────────────

    @staticmethod
    def _host_frames(frames):
        """The host side of :meth:`_prepare`: the frames as the tensor that
        crosses (one channel of gray input or of (T, H, W, 3) input with
        equal channels, the whole of colour input).  Tensors are taken as
        they are (a 4-D one as BGR)."""
        if isinstance(frames, torch.Tensor):
            f = frames
        else:
            f = np.asarray(frames)
            if is_monochrome(f):
                f = f[..., 0]
            f = torch.from_numpy(np.ascontiguousarray(f))
        if f.dtype != torch.uint8 or not (
                f.dim() == 3 or (f.dim() == 4 and f.shape[-1] == 3)):
            raise ValueError(f"expected (T, H, W) or (T, H, W, 3) uint8 "
                             f"frames, got {tuple(f.shape)} {f.dtype}")
        return f

    @staticmethod
    def _split_gray(f):
        """The device side of :meth:`_prepare`: (frames_dev | None,
        gray_dev) of the frames that crossed."""
        if f.dim() == 3:
            return None, f
        return f, bgr_to_gray_u8(f)

    def _prepare(self, frames):
        """One host-to-device transfer per video -> (frames_dev | None,
        gray_dev).  Gray (T, H, W) input, and (T, H, W, 3) input with equal
        channels, cross as one channel and frames_dev is None; colour (T, H,
        W, 3) BGR input crosses whole and is converted to gray on the
        device."""
        return self._split_gray(self._host_frames(frames).to(self.device))

    def prepare(self, frames):
        """:meth:`_prepare`: (frames_dev | None, gray_dev)."""
        return self._prepare(frames)

    def prepare_prefetched(self, videos, size: int = 2):
        """:meth:`prepare` of each video of a stream, the uploads running up
        to ``size`` videos ahead of the consumer from pinned host memory on
        a side stream (``data/prefetch.prefetch_to_device``)."""
        for f in prefetch_to_device(videos, size=size, put=self._host_frames,
                                    device=self.device):
            yield self._split_gray(f)

    def _to_gray(self, frames) -> torch.Tensor:
        """Host or device frames -> (T, H, W) uint8 gray on the device."""
        return self._prepare(frames)[1]

    def _require(self, *names):
        for n in names:
            if getattr(self, n) is None:
                raise ValueError(f"this pipeline needs {n} weights")

    def _chunks(self, fn, *tensors):
        """fn over CHUNK-frame slices of the tensors, outputs concatenated
        (a tuple of outputs concatenated element by element)."""
        outs = []
        with full_float32(self.dtype):
            for i in range(0, tensors[0].shape[0], CHUNK):
                outs.append(fn(*(x[i:i + CHUNK] for x in tensors)))
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(c) for c in zip(*outs))
        return torch.cat(outs)

    # ── detector and gate ───────────────────────────────────────────────

    def _yolo_input(self, gray_chunk):
        """Raw-pixel detector input: the gray channel replicated to 3 on the
        device (the /255 lives in the stem kernel)."""
        x = gray_chunk[:, None].to(self.dtype).expand(-1, 3, -1, -1)
        return x.contiguous(memory_format=torch.channels_last)

    def _yolo_chunk(self, gray_chunk):
        h, w = gray_chunk.shape[1:]
        outs = self.yolo(self._yolo_input(gray_chunk))
        return max_conf_detect(outs, h, w, self.conf)

    def _yolo_chunk_bgr(self, bgr_chunk):
        """The detector on (N, H, W, 3) BGR frames: channels reversed to the
        RGB order the stem was trained on."""
        h, w = bgr_chunk.shape[1:3]
        x = bgr_chunk.flip(-1).permute(0, 3, 1, 2).to(self.dtype)
        outs = self.yolo(x.contiguous(memory_format=torch.channels_last))
        return max_conf_detect(outs, h, w, self.conf)

    @torch.no_grad()
    def detect_video(self, frames_bgr_u8):
        """(T, H, W, 3) BGR frames -> (has (T,), raw boxes (T, 4) f32, conf
        (T,)), in CHUNK-frame slices, at the frames' own size (256² is the
        detector's)."""
        self._require("yolo")
        f = frames_bgr_u8
        if not isinstance(f, torch.Tensor):
            f = torch.from_numpy(np.ascontiguousarray(f))
        return self._chunks(self._yolo_chunk_bgr, f.to(self.device))

    @torch.no_grad()
    def detect_video_gray(self, gray_u8):
        """(T, H, W) monochrome -> (has (T,), raw boxes (T, 4) f32, conf
        (T,)), in CHUNK-frame slices (channels replicated on the device)."""
        self._require("yolo")
        return self._chunks(self._yolo_chunk, self._to_gray(gray_u8))

    def _detector_input(self, src):
        """The frames the detector sees: ``src`` (the colour frames where
        there are any, else the gray ones), letterboxed to 256² when other
        than 256² (bilinear, each channel of colour input, rounded to
        uint8)."""
        if src.shape[1:3] == (SIZE, SIZE):
            return src
        x = src.to(torch.float32)
        if src.dim() == 4:
            return _to_u8(torch.stack([letterbox(x[..., c], SIZE, "linear")
                                       for c in range(3)], -1))
        return _to_u8(letterbox(x, SIZE, "linear"))

    def _detect_chunk(self, x):
        """(has (N,), raw boxes (N, 4) f32) of a chunk of BGR (N, H, W, 3)
        or gray (N, H, W) frames."""
        return (self._yolo_chunk_bgr if x.dim() == 4 else self._yolo_chunk)(
            x)[:2]

    @staticmethod
    def _frame_boxes(raw, h: int, w: int):
        """Raw boxes on :meth:`_detector_input`'s frames in (h, w) frame
        coordinates: letterboxed boxes are mapped back by (raw - pad) *
        max(h, w) / 256 and clipped to the frame."""
        if (h, w) == (SIZE, SIZE):
            return raw
        pt, pl, _, _ = letterbox_info(h, w, SIZE)
        scale = max(h, w) / float(SIZE)
        return torch.stack([((raw[:, 0] - pl) * scale).clamp(0, w),
                            ((raw[:, 1] - pt) * scale).clamp(0, h),
                            ((raw[:, 2] - pl) * scale).clamp(0, w),
                            ((raw[:, 3] - pt) * scale).clamp(0, h)], -1)

    def _gate_frames(self, has, raw, h: int, w: int, sequential: bool):
        """:meth:`_gate` of detections on :meth:`_detector_input`'s frames
        (boxes mapped back by :meth:`_frame_boxes`)."""
        return self._gate(has, self._frame_boxes(raw, h, w), h, w, sequential)

    @torch.no_grad()
    def _gated(self, frames_dev, gray_dev, sequential: bool = True):
        """Detector + gate -> (valid (T,) bool, boxes (T, 4) int32) in the
        frames' coordinates (:meth:`_detector_input`, :meth:`_gate_frames`).
        ``sequential=False`` gates every frame on its own
        (:func:`gate_single`)."""
        src = frames_dev if frames_dev is not None else gray_dev
        has, raw = self._chunks(self._detect_chunk, self._detector_input(src))
        return self._gate_frames(has, raw, *src.shape[1:3], sequential)

    def _gate(self, has, raw, h: int, w: int, sequential: bool):
        """The temporal gate over all frames, or (``sequential=False``) the
        per-frame gate."""
        if not sequential:
            return gate_single(has, raw, h, w, self.gate_params)
        return gate_scan(has, raw, h, w, self.gate_params,
                         use_plain=self.use_plain_kernels)

    @torch.no_grad()
    def gated_boxes(self, frames_u8, sequential: bool = True):
        """Detector + gate of a (T, H, W, 3) BGR or (T, H, W) gray uint8
        video, host or device -> (valid (T,) bool, boxes (T, 4) int32) on
        the device in the frames' coordinates; frames other than 256² go to
        the detector letterboxed (:meth:`_gated`).  ``sequential=False``
        gates every frame on its own."""
        self._require("yolo")
        f = frames_u8
        if not isinstance(f, torch.Tensor):
            f = torch.from_numpy(np.ascontiguousarray(f))
        f = f.to(self.device)
        return self._gated(f if f.dim() == 4 else None,
                           f if f.dim() == 3 else None, sequential)

    def _tracker(self, parallel_fn, scan_fn):
        """The tracker form this instance runs."""
        return parallel_fn if self.parallel_trackers else scan_fn

    # ── pipeline 1: VFT ─────────────────────────────────────────────────

    @staticmethod
    def _vft_plan(vb):
        """Host part of the VFT core, from the gate's outputs read back as
        ``vb`` ((t, 5) int: valid, box): (valid-frame indices, (h0, w0)),
        or (indices, None) when fewer than VFT_INIT + 1 frames have a box or
        the first box is empty.  The crop size is locked from the first
        gated box (a shape, so it must be read back)."""
        idx = np.nonzero(vb[:, 0])[0]
        if len(idx) < VFT_INIT + 1:
            return idx, None
        b0 = vb[idx[0], 1:]
        w0, h0 = int(b0[2] - b0[0]), int(b0[3] - b0[1])
        if w0 <= 0 or h0 <= 0:
            return idx, None
        return idx, (h0, w0)

    def _vft_track(self, gray, valid, boxes, n: int, h0: int, w0: int):
        """Device part of the VFT core: size-locked crops of the ``n``
        valid-box frames and ONE tracker pass over them (frame-parallel, or
        the sequential scan with ``parallel_trackers=False``); the first
        VFT_INIT of them seed it.  -> (crop masks, areas (n,)) on the
        device."""
        # the valid frames' indices, in order, made on the device
        sel = torch.argsort((~valid).to(torch.uint8), stable=True)[:n]
        crops = _gather_crops(gray[sel], boxes[sel], h0, w0)
        active = torch.arange(n, device=gray.device) >= VFT_INIT
        return self._tracker(vft_parallel, vft_scan)(
            crops[:VFT_INIT], crops, active, params=self.vft_params,
            use_plain=self.use_plain_kernels)

    @staticmethod
    def _gate_host(valid, boxes):
        """(valid, box) of every frame as one (t, 5) int32 device tensor,
        for one host read."""
        return torch.cat([valid[:, None].to(torch.int32),
                          boxes.to(torch.int32)], 1)

    @staticmethod
    def _vft_fill(t: int, idx, areas_v):
        """The (t,) waveform of a VFT pass: the tracked frames' areas at
        their indices, 0 at the init frames and the frames without a box."""
        areas = np.zeros(t, np.float32)
        if areas_v is not None:
            areas[idx] = areas_v
            areas[idx[:VFT_INIT]] = 0.0       # init frames contribute 0
        return areas

    def _vft_compute(self, gray, valid, boxes, t, want_masks: bool = False):
        """Shared VFT core: the gate outputs read back to the host (one
        device-to-host copy), the crop size locked (:meth:`_vft_plan`),
        ONE tracker pass over the valid-box frames (:meth:`_vft_track`).

        Returns (areas (t,) np.float32, crop_masks (n_valid, h0, w0) | None,
        idx valid-frame indices, (h0, w0))."""
        idx, hw0 = self._vft_plan(self._gate_host(valid, boxes).cpu().numpy())
        if hw0 is None:
            return self._vft_fill(t, idx, None), None, idx, (0, 0)
        cmasks, areas_v = self._vft_track(gray, valid, boxes, len(idx), *hw0)
        return (self._vft_fill(t, idx, areas_v.cpu().numpy()),
                cmasks.cpu().numpy() if want_masks else None, idx, hw0)

    @torch.no_grad()
    def vft_areas(self, frames_u8):
        """VFT waveform: detect + gate, then size-locked crops and one
        tracker pass.  Returns areas (T,) float32 on the host, or None for
        fewer than VFT_INIT + 5 frames.  All-zero when fewer than VFT_INIT + 1
        frames have a gated box or the first box is empty."""
        self._require("yolo")
        t = len(frames_u8)
        if t < VFT_INIT + 5:
            return None
        frames_dev, gray = self._prepare(frames_u8)
        valid, boxes = self._gated(frames_dev, gray)
        return self._vft_compute(gray, valid, boxes, t)[0]

    def vft_areas_gray(self, gray_u8):
        """:meth:`vft_areas` of monochrome (T, H, W) frames."""
        return self.vft_areas(gray_u8)

    # ── pipeline 2: guided VFT ──────────────────────────────────────────

    def _ygvft_track(self, gray, valid, boxes):
        """ONE guided-tracker pass (frame-parallel, or the sequential scan
        with ``parallel_trackers=False``) over the frames after the
        YGVFT_INIT seed frames -> (masks (t - YGVFT_INIT, h, w) bool, areas
        (t - YGVFT_INIT,) float32), on the device."""
        vin = valid[:YGVFT_INIT]
        # first valid init frame, picked on the device (no host read)
        fi = torch.argmax(vin.to(torch.uint8)).reshape(1)
        return self._tracker(ygvft_parallel, ygvft_scan)(
            gray[:YGVFT_INIT], vin.any(), boxes.index_select(0, fi)[0],
            gray[YGVFT_INIT:], valid[YGVFT_INIT:], boxes[YGVFT_INIT:],
            params=self.ygvft_params, use_plain=self.use_plain_kernels)

    def _ygvft_compute(self, gray, valid, boxes, t, want_masks: bool = False):
        """Shared guided-VFT core: ONE tracker pass (frame-parallel, or the
        sequential scan with ``parallel_trackers=False``) -> (areas (t,)
        np.float32, masks (t, h, w) bool tensor | None).  The first
        YGVFT_INIT frames seed the tracker and emit zero / empty outputs."""
        h, w = gray.shape[1:]
        masks_v, areas_v = self._ygvft_track(gray, valid, boxes)
        areas = np.zeros(t, np.float32)
        areas[YGVFT_INIT:] = areas_v.cpu().numpy()
        masks = None
        if want_masks:
            masks = torch.cat([torch.zeros((YGVFT_INIT, h, w),
                                           dtype=torch.bool,
                                           device=masks_v.device), masks_v])
        return areas, masks

    @torch.no_grad()
    def guided_vft_areas(self, frames_u8):
        """Guided-VFT waveform: detect + gate + one tracker pass.  Returns
        areas (T,) float32 on the host, or None for fewer than YGVFT_INIT + 2
        frames.  The first YGVFT_INIT frames seed the tracker and emit
        zero."""
        self._require("yolo")
        t = len(frames_u8)
        if t < YGVFT_INIT + 2:
            return None
        frames_dev, gray = self._prepare(frames_u8)
        valid, boxes = self._gated(frames_dev, gray)
        return self._ygvft_compute(gray, valid, boxes, t)[0]

    def guided_vft_areas_gray(self, gray_u8):
        """:meth:`guided_vft_areas` of monochrome (T, H, W) frames."""
        return self.guided_vft_areas(gray_u8)

    @torch.no_grad()
    def ygvft_eval_masks(self, gray, valid, boxes):
        """Guided-tracker masks of the non-init frames, (t - YGVFT_INIT, h,
        w) bool, given the gate's outputs (the init frames are excluded from
        evaluation metrics); the areas are not read back."""
        return self._ygvft_track(gray, valid, boxes)[0]

    # ── pipelines 3 and 5: the U-Net ────────────────────────────────────

    def _unet_input(self, x):
        """(N, H, W) raw pixel values -> the U-Net's (N, 1, H, W) input."""
        return x[:, None].to(self.dtype).contiguous(
            memory_format=torch.channels_last)

    def _unet_probs_chunk(self, x256):
        """U-Net probabilities of (N, 256, 256) float frames (pixel range
        0..255)."""
        return torch.sigmoid(self.unet(self._unet_input(x256))[:, 0])

    def _scores_chunk(self, gray_chunk, threshold: float = 0.5):
        """(scores (N, H, W), cut) of a chunk of gray frames, a pixel being
        in the mask where its score exceeds the cut (its probability
        exceeds ``threshold``): at 256² the logits as the head gives them,
        cut at logit(threshold) (0 for 0.5: ``logits > 0`` is ``p >
        0.5``); other sizes are resized to 256² (bilinear) and their
        probabilities resized back, cut at ``threshold``."""
        h, w = gray_chunk.shape[1:]
        if (h, w) == (SIZE, SIZE):
            return (self.unet.logits(self._unet_input(gray_chunk))[:, 0],
                    math.log(threshold / (1.0 - threshold)))
        x = resize_bilinear(gray_chunk.to(torch.float32), SIZE, SIZE)
        return resize_bilinear(self._unet_probs_chunk(x), h, w
                               ).contiguous(), threshold

    def _segment_chunk(self, gray_chunk, threshold: float = 0.5):
        """Boolean masks of a chunk of (N, H, W) gray frames."""
        scores, cut = self._scores_chunk(gray_chunk, threshold)
        return scores > cut

    @torch.no_grad()
    def segment_video(self, gray_u8, threshold: float = 0.5):
        """(T, H, W) gray -> (T, H, W) boolean masks of the full-frame
        U-Net, a pixel in the mask where its probability exceeds
        ``threshold`` (in (0, 1))."""
        self._require("unet")
        if not 0.0 < threshold < 1.0:
            raise ValueError(f"threshold must lie in (0, 1), got {threshold}")
        return self._chunks(lambda g: self._segment_chunk(g, threshold),
                            self._to_gray(gray_u8))

    @torch.no_grad()
    def unet_only_areas(self, gray_u8):
        """Pipeline 5: the U-Net's mask area of every frame, no gate ->
        (T,) float32 on the device (in the int8 mode, 256² frames through
        the int8 U-Net)."""
        self._require("unet")
        gray = self._to_gray(gray_u8)
        if self._quant is not None and tuple(gray.shape[1:]) == (SIZE, SIZE):
            qp = self._q(gray)["unet"]
            return self._chunks(
                lambda g: quant_mod.qunet_masks(
                    qp, g, self.use_plain_kernels).sum((1, 2)).to(
                        torch.float32), gray)
        return self._chunks(
            lambda g: self._segment_chunk(g).sum((1, 2)).to(torch.float32),
            gray)

    def _windowed(self, frames_dev, gray) -> bool:
        """Whether pipeline 3 takes the windowed decoder on this input: the
        constructor's choice, and 256² video of which one channel crossed
        (the JAX package's rule)."""
        return (self.window_decoder and frames_dev is None
                and tuple(gray.shape[1:]) == (SIZE, SIZE))

    def _window_areas(self, enc, valid, boxes, qp=None):
        """The windowed decoder on one chunk (JAX package:
        ``_unet_windowed_areas_chunk_fn``, ``tail="window"``, after
        ``unet_apply_to_d3``): one (WIN, WIN) window covering the union of
        the chunk's valid boxes (origin on the device, never read by the
        host) and the last two decoder levels on it -> (logits (N, WIN,
        WIN), fits 0-d bool, oy, ox), for the in-box count of ``logits >
        0``.  Where the boxes do not fit, the origin is still in the frame
        and the logits are computed, but only ``fits`` is to be trusted.
        With ``qp`` (the int8 U-Net's qparams), ``enc`` is
        ``models/quant.qunet_to_d3``'s output and the int8 tail runs."""
        if qp is not None:
            x8, skip1, skip2 = enc
            fits, oy, ox = chunk_window_origin(boxes, valid, *skip1.shape[1:3],
                                               WIN, lattice=4, margin=6)
            logits = quant_mod.qunet_tail_from_d3_window(
                qp, x8, skip1, skip2, oy, ox, WIN, self.use_plain_kernels)
            return logits, fits, oy, ox
        d3out, skip2, skip1 = enc
        h, w = skip1.shape[2:]
        fits, oy, ox = chunk_window_origin(boxes, valid, h, w, WIN,
                                           lattice=4, margin=6)
        ymw = self.unet.mid_window(d3out, skip2, oy, ox, WIN)
        logits = self.unet.tail_from_ymw(ymw, skip1, oy, ox, WIN)[:, 0]
        return logits, fits, oy, ox

    @torch.no_grad()
    def _unet_gated_multi(self, videos, window: bool,
                          want_masks: bool = False, quant: bool | None = None):
        """Pipeline 3 over K videos (``videos``: (frames_dev | None, gray)
        pairs, as :meth:`_prepare` gives them) in one loop over chunk
        indices: for chunk j, each video's U-Net, detector and temporal gate
        (its own carry, passed from chunk to chunk), then ONE in-box count
        of chunk j of every video (``ops/areas_cuda.box_count_table``).
        JAX package: ``_fused_yolo_unet_video_w`` / ``_fused_yolo_unet_multi
        _w`` (``tail="window"`` or ``"full"``), which run the detector over
        every chunk first; here each chunk's detector runs beside its U-Net.
        Each video's chunks are its own CHUNK-frame slices, as one video
        alone is sliced, so each video's values are its per-video call's.

        Full-frame route (``window=False``): the whole U-Net, then the
        detector, so that the host queues the detector while the card runs
        the U-Net; the count reads the logits (or the resized probabilities
        of other frame sizes).  Windowed route: the encoder and the deeper
        decoder levels first (they read no box), then the detector and the
        gate, then :meth:`_window_areas`.  A chunk's logits are held until
        the count of its chunk index (6.5 MB per bf16 windowed chunk), its
        encoder outputs are not.  The videos of one call share the count's
        (H, W) and threshold: several videos take one route at one frame
        size.

        Returns, per video, (areas (T,) float32, ok 0-d bool or None, valid
        (T,), boxes (T, 4) int32, masks (T, H, W) bool or None), on the
        device; ``ok`` (windowed route) is False when a chunk's boxes did
        not fit its window, and the areas are then to be redone on the
        full-frame route.  ``want_masks``: the full-frame route's masks
        too.

        ``quant`` (None: :meth:`_int8_route` of every video): the int8 U-Net
        (``models/quant``: ``qunet_to_d3`` and the windowed tail, or
        ``qunet_logits``), calibrated on the first video when not yet, and
        in ``"int8-full"`` the int8 detector.  JAX package:
        ``_fused_yolo_unet_video_qw`` / ``_q`` and their ``_multi`` forms."""
        if quant is None:
            quant = all(self._int8_route(f, g) for f, g in videos)
        qp = self._q(videos[0][1]) if quant else None
        qdet = quant and "yolo" in qp
        st = []
        for frames_dev, gray in videos:
            t, h, w = gray.shape
            st.append({
                "gray": gray, "hw": (h, w),
                "det_in": self._detector_input(
                    frames_dev if frames_dev is not None else gray),
                "gate": GateCarry(h, w, self.gate_params,
                                  use_plain=self.use_plain_kernels),
                "areas": torch.empty((t,), dtype=torch.float32,
                                     device=gray.device),
                "fits": [], "valid": [], "boxes": [], "masks": []})
        with full_float32(self.dtype):
            for i in range(0, max(v["gray"].shape[0] for v in st), CHUNK):
                table, thr = [], 0.0
                for v in st:
                    g = v["gray"][i:i + CHUNK]
                    if g.shape[0] == 0:
                        continue
                    up = self.use_plain_kernels
                    if window:
                        enc = (quant_mod.qunet_to_d3(qp["unet"], g, up)
                               if quant else
                               self.unet.apply_to_d3(self._unet_input(g)))
                    elif quant:
                        scores, thr = quant_mod.qunet_logits(qp["unet"], g,
                                                             up), 0.0
                    else:
                        scores, thr = self._scores_chunk(g)
                    det = v["det_in"][i:i + CHUNK]
                    has, raw = (self._qdetect_chunk(qp["yolo"], det) if qdet
                                else self._detect_chunk(det))
                    vv, bb = v["gate"](has, self._frame_boxes(raw, *v["hw"]))
                    out = v["areas"][i:i + CHUNK]
                    if window:
                        logits, fits, oy, ox = self._window_areas(
                            enc, vv, bb, qp["unet"] if quant else None)
                        del enc
                        v["fits"].append(fits)
                        table.append(CountChunk(logits, vv, bb, oy, ox, out))
                    else:
                        table.append(CountChunk(scores, vv, bb, out=out))
                        if want_masks:
                            v["masks"].append(scores > thr)
                    v["valid"].append(vv)
                    v["boxes"].append(bb)
                box_count_table(table, thr, use_plain=self.use_plain_kernels)
        return [(v["areas"],
                 torch.stack(v["fits"]).all() if window else None,
                 torch.cat(v["valid"]), torch.cat(v["boxes"]),
                 torch.cat(v["masks"]) if want_masks else None) for v in st]

    def _unet_gated(self, frames_dev, gray, window: bool,
                    want_masks: bool = False, quant: bool | None = None):
        """:meth:`_unet_gated_multi` of one video."""
        return self._unet_gated_multi([(frames_dev, gray)], window,
                                      want_masks, quant)[0]

    def yolo_unet_areas_deferred(self, frames_u8):
        """Pipeline 3 queued without any host read -> an opaque handle for
        :meth:`yolo_unet_areas_resolve`.  On the windowed route the areas
        are speculative: the handle carries the ``ok`` flag, which resolve
        reads together with the areas."""
        self._require("yolo", "unet")
        frames_dev, gray = self._prepare(frames_u8)
        window = self._windowed(frames_dev, gray)
        areas, ok = self._unet_gated(frames_dev, gray, window)[:2]
        return areas, ok, frames_dev, gray

    def yolo_unet_areas_gray_deferred(self, gray_u8):
        """:meth:`yolo_unet_areas_deferred` of (T, H, W) monochrome video."""
        return self.yolo_unet_areas_deferred(gray_u8)

    def yolo_unet_areas_resolve(self, pending):
        """Resolve a :meth:`yolo_unet_areas_deferred` handle -> areas (T,)
        float32 on the host, by ONE device-to-host read of the areas and the
        ``ok`` flag together; a video whose boxes did not fit the windows
        is redone on the full-frame route."""
        areas, ok, frames_dev, gray = pending
        if ok is None:
            return areas.cpu().numpy()
        host = torch.cat([areas, ok.to(torch.float32)[None]]).cpu().numpy()
        if host[-1]:
            return host[:-1]
        return self._unet_gated(frames_dev, gray, False)[0].cpu().numpy()

    def yolo_unet_areas(self, frames_u8):
        """Pipeline 3 on gray or BGR frames -> areas (T,) float32 on the
        device.  On the windowed route ``ok`` is read (one host read) and
        a video that did not fit is redone on the full-frame route."""
        areas, ok, frames_dev, gray = self.yolo_unet_areas_deferred(frames_u8)
        if ok is not None and not bool(ok):
            areas = self._unet_gated(frames_dev, gray, False)[0]
        return areas

    def yolo_unet_areas_gray(self, gray_u8):
        """:meth:`yolo_unet_areas` of (T, H, W) monochrome video."""
        return self.yolo_unet_areas(gray_u8)

    # ── cohort serving ──────────────────────────────────────────────────

    def _cohort_videos(self, grays) -> bool:
        """Whether a cohort takes the cohort form: every video (T, 256, 256)
        gray, or (T, 256, 256, 3) with equal channels (which crosses as
        one channel).  Other input is served by per-video calls, as the JAX
        package serves it (per-video letterboxes through 256²)."""
        for g in grays:
            shape = tuple(g.shape)
            if shape[1:3] != (SIZE, SIZE):
                return False
            if len(shape) == 4 and (isinstance(g, torch.Tensor)
                                    or not is_monochrome(np.asarray(g))):
                return False
            if len(shape) not in (3, 4):
                return False
        return True

    def sub_batch_k(self, pipeline: str, ts, max_k: int | None = None) -> int:
        """The cohort's sub-batch size on this instance's device
        (:func:`cohort_k` with the device's free memory)."""
        elem = 2 if self.dtype == torch.bfloat16 else 4
        return cohort_k(pipeline, ts, free_device_bytes(self.device), elem,
                        max_k)

    def _yolo_unet_multi_dispatch(self, grays):
        """Queue pipeline 3 for a sub-batch of videos without any host read
        -> (per-video (areas, ok) on the device, the prepared videos)."""
        vids = [self._prepare(g) for g in grays]
        window = self.window_decoder
        res = self._unet_gated_multi(vids, window)
        return [(r[0], r[1]) for r in res], vids

    @torch.no_grad()
    def yolo_unet_areas_gray_multi(self, grays, fetch: bool = True,
                                   max_k: int | None = None):
        """Pipeline 3 for a cohort of monochrome 256² videos -> a list of
        (T_i,) waveforms, each bit-identical to :meth:`yolo_unet_areas` on
        that video (np.float32 on the host; ``fetch=False``: float32 tensors
        on the device, with the same values).

        The cohort is cut into sub-batches of K videos (``max_k``, else
        :meth:`sub_batch_k`).  In a sub-batch, chunk j of every video runs
        as it runs alone (its own U-Net, detector and gate carry on its own
        CHUNK-frame slice), and the in-box counts of chunk j of all K videos
        are ONE launch.  Every sub-batch is queued before the first host
        read; each is then read ONCE, areas and the per-video windowed ``ok``
        flags together (``fetch=False``: the flags alone; the full-frame
        route and ``fetch=False``: no read).  A video whose boxes did not fit
        its windows is redone on the full-frame route in the read loop.
        ``[]`` -> ``[]``; other input than 256² monochrome video goes
        through per-video calls."""
        if not grays:
            return []
        self._require("yolo", "unet")
        if not self._cohort_videos(grays):
            outs = [self.yolo_unet_areas(g) for g in grays]
            return [o.cpu().numpy() for o in outs] if fetch else outs
        k = self.sub_batch_k("unet", [len(g) for g in grays], max_k)
        pending = [self._yolo_unet_multi_dispatch(grays[j:j + k])
                   for j in range(0, len(grays), k)]
        out = []
        for res, vids in pending:
            areas = [a for a, _ in res]
            oks = [ok for _, ok in res]
            window = oks[0] is not None
            ok_np = None
            if fetch:
                flat = torch.cat(areas + ([torch.stack(oks).to(torch.float32)]
                                          if window else []))
                host = flat.cpu().numpy()     # ONE read for the sub-batch
                cuts = np.cumsum([0] + [a.shape[0] for a in areas])
                areas = [host[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
                if window:
                    ok_np = host[cuts[-1]:] != 0
            elif window:
                ok_np = torch.stack(oks).cpu().numpy()
            for i, a in enumerate(areas):
                if ok_np is not None and not ok_np[i]:
                    a = self._unet_gated(*vids[i], False)[0]
                    if fetch:
                        a = a.cpu().numpy()
                out.append(a)
        return out

    def _detect_gate_multi(self, grays):
        """Detector + gate of K prepared 256² gray videos: each video's
        detector over its own CHUNK-frame slices (the per-video call's
        shapes), then ONE batched gate launch for all of them
        (:func:`gate_scan_batch`) -> (valid (sum T,), boxes (sum T, 4)
        int32, offsets: K + 1 host ints)."""
        has, raw = [], []
        with full_float32(self.dtype):
            for g in grays:
                for i in range(0, g.shape[0], CHUNK):
                    hh, rr = self._detect_chunk(g[i:i + CHUNK])
                    has.append(hh)
                    raw.append(rr)
        offsets = np.concatenate([[0], np.cumsum([g.shape[0] for g in grays])]
                                 ).tolist()
        valid, boxes = gate_scan_batch(
            torch.cat(has), torch.cat(raw), offsets, SIZE, SIZE,
            self.gate_params, use_plain=self.use_plain_kernels)
        return valid, boxes, offsets

    @torch.no_grad()
    def guided_vft_areas_gray_multi(self, grays, max_k: int | None = None):
        """Guided-VFT waveforms for a cohort of monochrome 256² videos ->
        a list of (T_i,) np.float32 waveforms, each bit-identical to
        :meth:`guided_vft_areas` on that video; a video shorter than
        YGVFT_INIT + 2 frames gives None.  Per sub-batch (K videos,
        ``max_k`` or :meth:`sub_batch_k`): the detector per video, ONE
        batched gate, then :func:`ygvft_parallel_multi` over all the
        sub-batch's tracked frames (one set of union-find launches, one
        threshold-chain launch, one host read for the window choice); every
        sub-batch is queued before the waveforms are read, one read per
        sub-batch.  Other input than 256² monochrome video, and
        ``parallel_trackers=False``, go through per-video calls."""
        if not grays:
            return []
        self._require("yolo")
        if not self.parallel_trackers or not self._cohort_videos(grays):
            return [self.guided_vft_areas(g) for g in grays]
        ts = [len(g) for g in grays]
        run = [i for i, t in enumerate(ts) if t >= YGVFT_INIT + 2]
        out = [None] * len(grays)
        k = self.sub_batch_k("guided-vft", [ts[i] for i in run], max_k)
        pending = []
        for j in range(0, len(run), k):
            sub = run[j:j + k]
            gr = [self._to_gray(grays[i]) for i in sub]
            valid, boxes, off = self._detect_gate_multi(gr)
            starts = off[:-1]
            # each video's init frames, and its tracked frames flattened
            vin = torch.stack([valid[a:a + YGVFT_INIT] for a in starts])
            fi = torch.argmax(vin.to(torch.uint8), 1)
            first_box = torch.stack([boxes[a:a + YGVFT_INIT] for a in starts]
                                    ).gather(1, fi[:, None, None].expand(
                                        -1, 1, 4))[:, 0]
            tracked = [(a + YGVFT_INIT, b) for a, b in zip(off[:-1], off[1:])]
            areas = ygvft_parallel_multi(
                torch.stack([g[:YGVFT_INIT] for g in gr]), vin.any(1),
                first_box, torch.cat([g[YGVFT_INIT:] for g in gr]),
                torch.cat([valid[a:b] for a, b in tracked]),
                torch.cat([boxes[a:b] for a, b in tracked]),
                np.concatenate([[0], np.cumsum([b - a for a, b in tracked])]
                               ).tolist(),
                params=self.ygvft_params, use_plain=self.use_plain_kernels)
            pending.append((sub, areas))
        for sub, areas in pending:
            host = areas.cpu().numpy()        # ONE read for the sub-batch
            pos = 0
            for i in sub:
                n = ts[i] - YGVFT_INIT
                a = np.zeros(ts[i], np.float32)
                a[YGVFT_INIT:] = host[pos:pos + n]
                pos += n
                out[i] = a
        return out

    @torch.no_grad()
    def vft_areas_gray_multi(self, grays, max_k: int | None = None):
        """VFT waveforms for a cohort of monochrome 256² videos -> a list of
        (T_i,) np.float32 waveforms, each bit-identical to :meth:`vft_areas`
        on that video; a video shorter than VFT_INIT + 5 frames gives None.
        Per sub-batch (K videos, ``max_k`` or :meth:`sub_batch_k`): the
        detector per video, ONE batched gate, ONE host read of the
        sub-batch's (valid, boxes) to lock each video's crop size (a host
        shape), then the K per-video tracker passes queued and their areas
        read once.  Other input than 256² monochrome video goes through
        per-video calls."""
        if not grays:
            return []
        self._require("yolo")
        if not self._cohort_videos(grays):
            return [self.vft_areas(g) for g in grays]
        ts = [len(g) for g in grays]
        run = [i for i, t in enumerate(ts) if t >= VFT_INIT + 5]
        out = [None] * len(grays)
        k = self.sub_batch_k("vft", [ts[i] for i in run], max_k)
        for j in range(0, len(run), k):
            sub = run[j:j + k]
            gr = [self._to_gray(grays[i]) for i in sub]
            valid, boxes, off = self._detect_gate_multi(gr)
            vb = self._gate_host(valid, boxes).cpu().numpy()   # ONE read
            plans, tracked = [], []
            for g, a, b in zip(gr, off[:-1], off[1:]):
                idx, hw0 = self._vft_plan(vb[a:b])
                plans.append((idx, hw0))
                if hw0 is not None:
                    tracked.append(self._vft_track(
                        g, valid[a:b], boxes[a:b], len(idx), *hw0)[1])
            host = (torch.cat(tracked).cpu().numpy() if tracked
                    else np.zeros(0, np.float32))    # ONE read
            pos = 0
            for i, (idx, hw0) in zip(sub, plans):
                a_v = None
                if hw0 is not None:
                    a_v = host[pos:pos + len(idx)]
                    pos += len(idx)
                out[i] = self._vft_fill(ts[i], idx, a_v)
        return out

    # ── pipeline 4: crop U-Net ──────────────────────────────────────────

    def _crop_unet_chunk(self, gray_u8, valids, boxes):
        """The crop pipeline on a chunk: each gated box's crop letterboxed
        to 256² (nearest, as the reference letterboxes 2-D arrays), the crop
        U-Net, and its mask projected back into the full frame.  The two
        nearest resamplings are per-frame index maps applied by gathers.
        gray (C, H, W) uint8, valids (C,), boxes (C, 4) int -> (C, H, W)
        bool; frames without a box (and so an empty crop) get empty masks."""
        h, w = gray_u8.shape[1:]
        boxes = boxes.to(torch.int32)
        x1, y1 = boxes[:, 0], boxes[:, 1]
        ch = boxes[:, 3] - boxes[:, 1]
        cw = boxes[:, 2] - boxes[:, 0]
        pad_t, pad_l, c_h, c_w = dyn_letterbox_geometry(ch, cw, SIZE)
        rows, row_in = dyn_letterbox_index_nearest(h, SIZE, y1, ch, pad_t, c_h)
        cols, col_in = dyn_letterbox_index_nearest(w, SIZE, x1, cw, pad_l, c_w)
        boxed = gather_rows_cols(gray_u8, rows, row_in, cols, col_in)
        m256 = self.crop_unet(self._unet_input(boxed))[:, 0] > 0  # p > 0.5
        rows, row_ok = dyn_unletterbox_index_nearest(h, SIZE, y1, ch, pad_t,
                                                     c_h)
        cols, col_ok = dyn_unletterbox_index_nearest(w, SIZE, x1, cw, pad_l,
                                                     c_w)
        full = gather_rows_cols(m256, rows, row_ok, cols, col_ok)
        return full & valids.bool()[:, None, None]

    @torch.no_grad()
    def crop_unet_masks(self, frames_u8, gray_u8=None, valid=None,
                        boxes=None):
        """Pipeline 4's full-frame masks -> (masks (T, H, W) bool, valid,
        boxes).  ``gray_u8`` given: ``frames_u8`` is the device's BGR video
        or None; ``valid`` / ``boxes`` given: the gate is not run again."""
        self._require("crop_unet")
        if gray_u8 is not None:
            frames_dev, gray = frames_u8, self._to_gray(gray_u8)
        else:
            frames_dev, gray = self._prepare(frames_u8)
        if valid is None:
            self._require("yolo")
            valid, boxes = self._gated(frames_dev, gray)
        masks = self._chunks(self._crop_unet_chunk, gray, valid, boxes)
        return masks, valid, boxes

    # ── streaming ───────────────────────────────────────────────────────

    def _stream_segments(self, chunks, prefetch: int):
        """The stream's frames re-cut into the CHUNK-frame slices of the
        concatenated stream, the slices the whole-video call runs its
        networks on (cuDNN picks its algorithms per shape, so only the same
        slices give the same values).  Yields, for each non-empty chunk, the
        list of (bgr | None, gray) slices it completes (perhaps none), then
        the ragged rest as a last list.  At most CHUNK - 1 frames wait on
        the device for the next chunk.  Chunks cross as :meth:`prepare`
        lets them (one channel of monochrome ones), ``prefetch`` > 0 of
        them ahead from pinned memory, else one at a time as they come."""
        if prefetch > 0:
            segs = prefetch_to_device(chunks, size=prefetch,
                                      put=self._host_frames,
                                      device=self.device)
        else:
            segs = (self._host_frames(c).to(self.device) for c in chunks)
        held = None
        for f in segs:
            seg = self._split_gray(f)
            if seg[1].shape[0] == 0:
                continue
            _require_256(seg[1])
            cur = seg if held is None else _join(held, seg)
            t = cur[1].shape[0]
            full = t - t % CHUNK
            yield [_cut(cur, i, i + CHUNK) for i in range(0, full, CHUNK)]
            held = _cut(cur, full, t) if full < t else None
        if held is not None:
            yield [held]

    def _stream_gate(self, gate, bgr, gray):
        """Detector on one slice (on its BGR frames where it has them, as
        :meth:`detect_video`) and the gate from its carry -> (valid,
        boxes)."""
        with full_float32(self.dtype):
            has, raw = self._detect_chunk(bgr if bgr is not None else gray)
        return gate(has, raw)

    def _stream_u_slice(self, pipeline: str, gate, bgr, gray):
        """Areas of one slice of a U-Net pipeline, on the device, as the
        whole-video call computes them on that slice: ``unet`` on its
        full-frame route (logits, detector, gate, in-box count),
        ``unet-only`` the masks' pixel counts, ``crop-unet`` the crop
        U-Net's masks in the gate boxes."""
        if pipeline == "unet-only":
            with full_float32(self.dtype):
                return self._segment_chunk(gray).sum((1, 2)).to(
                    torch.float32)
        if pipeline == "unet":
            with full_float32(self.dtype):
                scores, thr = self._scores_chunk(gray)
        valid, boxes = self._stream_gate(gate, bgr, gray)
        if pipeline == "crop-unet":
            masks = self.crop_unet_masks(None, gray_u8=gray, valid=valid,
                                         boxes=boxes)[0]
            return _box_area_sums(masks, valid, boxes)
        out = torch.empty((gray.shape[0],), dtype=torch.float32,
                          device=gray.device)
        box_count_table([CountChunk(scores, valid, boxes, out=out)], thr,
                        use_plain=self.use_plain_kernels)
        return out

    @torch.no_grad()
    def stream_areas(self, chunks, pipeline: str = "unet",
                     prefetch: int = 2) -> np.ndarray:
        """Area waveform of a stream of frame chunks, in memory bounded by
        the chunk and not by the video.  JAX package:
        ``GlottalPipelines.stream_areas``.

        ``chunks``: an iterable of (n, 256, 256) gray or (n, 256, 256, 3)
        BGR uint8 arrays (e.g. ``data/video.iter_frames_bgr``), uploaded
        ``prefetch`` chunks ahead of the compute from pinned memory
        (``prefetch=0``: each as it comes).  The gate's state crosses
        chunks in its kernel's buffer (``GateCarry``), the trackers' in
        their carries; the waveform stays on the device and is read once at
        the end (``vft`` also reads the gate once per chunk, to lock its
        crop size and place its crops).  The result is bit-identical to the
        whole-video call: ``unet`` to its full-frame route
        (``window_decoder=False``; it streams on that route), the trackers
        to their sequential forms (``parallel_trackers=False``).  Colour
        chunks detect on their BGR frames and segment on gray, as the
        whole-video calls do; chunks of other sizes than 256² raise
        ``ValueError``.  An empty stream gives an empty waveform.  In the
        int8 mode streams stay bfloat16, as the JAX package's do."""
        if pipeline in ("vft", "guided-vft"):
            self._require("yolo")
            return self._stream_tracker_areas(chunks, pipeline, prefetch)
        if pipeline not in ("unet", "unet-only", "crop-unet"):
            raise ValueError(
                f"unknown streaming pipeline {pipeline!r} (supported: "
                f"{', '.join(PIPELINES)})")
        self._require(*{"unet": ("yolo", "unet"), "unet-only": ("unet",),
                        "crop-unet": ("yolo", "crop_unet")}[pipeline])
        gate = GateCarry(SIZE, SIZE, self.gate_params,
                         use_plain=self.use_plain_kernels)
        areas = [self._stream_u_slice(pipeline, gate, bgr, gray)
                 for slices in self._stream_segments(chunks, prefetch)
                 for bgr, gray in slices]
        if not areas:
            return np.zeros((0,), np.float32)
        return torch.cat(areas).cpu().numpy()      # the one read

    def _stream_tracker_areas(self, chunks, pipeline: str,
                              prefetch: int) -> np.ndarray:
        """The trackers' streams, resuming the sequential forms from their
        carries (``vft_scan_carry``, ``ygvft_scan_carry``).  JAX package:
        ``GlottalPipelines._stream_tracker_areas``.

        vft: the crop size locks at the first gated box of the stream
        (``"dead"``, all zero, for an empty one); the first VFT_INIT gated
        crops seed the tracker and read zero, as do frames without a box.
        guided-vft: the first YGVFT_INIT frames seed the tracker and read
        zero.  Seeds may straddle chunks."""
        gate = GateCarry(SIZE, SIZE, self.gate_params,
                         use_plain=self.use_plain_kernels)
        state = {"carry": None, "lock": None, "init": []}
        areas = []
        for slices in self._stream_segments(chunks, prefetch):
            gated = [(gray, *self._stream_gate(gate, bgr, gray))
                     for bgr, gray in slices]
            if pipeline == "vft":
                if gated:
                    areas.append(self._stream_vft(state, *(
                        torch.cat(x) for x in zip(*gated))))
            else:
                areas += [self._stream_ygvft(state, *g) for g in gated]
        if not areas:
            return np.zeros((0,), np.float32)
        return torch.cat(areas).cpu().numpy()      # the one read of areas

    def _stream_vft(self, state, gray, valid, boxes):
        """vft over a chunk's slices -> their areas on the device, after
        ONE host read of their gate outputs (the crop lock and the number of
        crops are host values)."""
        out = torch.zeros((gray.shape[0],), dtype=torch.float32,
                          device=gray.device)
        vb = self._gate_host(valid, boxes).cpu().numpy()
        idx = np.nonzero(vb[:, 0])[0]
        if state["lock"] is None and idx.size:
            b0 = vb[idx[0], 1:]
            w0, h0 = int(b0[2] - b0[0]), int(b0[3] - b0[1])
            state["lock"] = (h0, w0) if (w0 > 0 and h0 > 0) else "dead"
        if idx.size == 0 or state["lock"] == "dead":
            return out
        n = len(idx)
        # the gated frames' indices, in order, made on the device
        sel = torch.argsort((~valid).to(torch.uint8), stable=True)[:n]
        crops = _gather_crops(gray[sel], boxes[sel], *state["lock"])
        k = 0
        if state["carry"] is None:
            have = sum(c.shape[0] for c in state["init"])
            k = min(VFT_INIT - have, n)
            state["init"].append(crops[:k])
            if have + k == VFT_INIT:
                state["carry"] = vft_initialize(
                    torch.cat(state["init"]), self.vft_params,
                    self.use_plain_kernels)
                state["init"] = []
        if state["carry"] is not None and k < n:
            state["carry"], (_, a) = vft_scan_carry(
                state["carry"], crops[k:], params=self.vft_params,
                use_plain=self.use_plain_kernels)
            out.index_copy_(0, sel[k:], a)
        return out

    def _stream_ygvft(self, state, gray, valid, boxes):
        """guided-vft over one slice -> its areas on the device (no host
        read: the seed's first valid box is picked on the device)."""
        t = gray.shape[0]
        start = 0
        if state["carry"] is None:
            have = sum(x[0].shape[0] for x in state["init"])
            start = min(YGVFT_INIT - have, t)
            state["init"].append((gray[:start], valid[:start],
                                  boxes[:start]))
            if have + start == YGVFT_INIT:
                ff, vin, bin_ = (torch.cat(x) for x in zip(*state["init"]))
                fi = torch.argmax(vin.to(torch.uint8)).reshape(1)
                state["carry"] = ygvft_initialize(
                    ff, vin.any(), bin_.index_select(0, fi)[0],
                    self.ygvft_params, self.use_plain_kernels)
                state["init"] = []
        zeros = torch.zeros((start if state["carry"] is not None else t,),
                            dtype=torch.float32, device=gray.device)
        if state["carry"] is None or start == t:
            return zeros
        state["carry"], (_, a) = ygvft_scan_carry(
            state["carry"], gray[start:], valid[start:], boxes[start:],
            params=self.ygvft_params, use_plain=self.use_plain_kernels)
        return torch.cat([zeros, a]) if start else a

    def stream_features(self, chunks, pipeline: str = "unet"):
        """Kinematic features of a chunk stream (:meth:`stream_areas`);
        None for an empty stream or a silent waveform."""
        areas = self.stream_areas(chunks, pipeline)
        if areas.size == 0:
            return None
        return kinematic_features(areas)

    # ── outputs ─────────────────────────────────────────────────────────

    @torch.no_grad()
    def run_pipeline_full(self, frames_u8, pipeline: str):
        """Masks, boxes and areas of every frame, for overlays -> (masks
        (T, H, W) bool | None, valid (T,) bool | None, boxes (T, 4) int32 |
        None, areas (T,) float32), tensors on the device.  ``unet-only`` has
        no gate; ``unet`` shows a frame's mask only where the gate holds a
        box; ``vft`` pastes each tracked crop mask at the frame's box,
        cut where the box is smaller than the locked crop."""
        if pipeline not in PIPELINES:
            raise ValueError(f"unknown pipeline {pipeline!r}")
        frames_dev, gray = self._prepare(frames_u8)
        t, h, w = gray.shape
        if pipeline == "unet-only":
            masks = self.segment_video(gray)
            return masks, None, None, masks.sum((1, 2)).to(torch.float32)
        self._require("yolo")
        if pipeline == "unet":
            self._require("unet")
            # bfloat16 in the int8 mode too, as the JAX package's
            areas, _, valid, boxes, masks = self._unet_gated(
                frames_dev, gray, False, want_masks=True, quant=False)
            return masks & valid[:, None, None], valid, boxes, areas
        valid, boxes = self._gated(frames_dev, gray)
        if pipeline == "crop-unet":
            masks, valid, boxes = self.crop_unet_masks(
                frames_dev, gray_u8=gray, valid=valid, boxes=boxes)
            return masks, valid, boxes, masks.sum((1, 2)).to(torch.float32)
        if pipeline == "guided-vft":
            areas, masks = self._ygvft_compute(gray, valid, boxes, t,
                                               want_masks=True)
            return masks, valid, boxes, torch.from_numpy(areas).to(gray.device)
        areas, cmasks, idx, (h0, w0) = self._vft_compute(
            gray, valid, boxes, t, want_masks=True)
        masks = np.zeros((t, h, w), bool)
        if cmasks is not None:
            boxes_np = boxes.cpu().numpy()
            for k, fi in enumerate(idx[VFT_INIT:], VFT_INIT):
                x1, y1, x2, y2 = boxes_np[fi]
                mh, mw = min(h0, y2 - y1), min(w0, x2 - x1)
                if mh > 0 and mw > 0:
                    masks[fi, y1:y1 + mh, x1:x1 + mw] = cmasks[k][:mh, :mw]
        return (torch.from_numpy(masks).to(gray.device), valid, boxes,
                torch.from_numpy(areas).to(gray.device))

    def extract_features(self, frames_u8, pipeline: str = "unet"):
        """Frames in, kinematic features out (dict, or None for an empty
        video, too few frames, or a silent waveform)."""
        if len(frames_u8) == 0:
            return None
        if pipeline not in PIPELINES:
            raise ValueError(f"unknown pipeline {pipeline!r}")
        if pipeline == "vft":
            areas = self.vft_areas(frames_u8)
        elif pipeline == "guided-vft":
            areas = self.guided_vft_areas(frames_u8)
        elif pipeline == "unet":
            areas = self.yolo_unet_areas_resolve(
                self.yolo_unet_areas_deferred(frames_u8))
        elif pipeline == "unet-only":
            areas = self.unet_only_areas(frames_u8).cpu().numpy()
        else:
            masks, valid, boxes = self.crop_unet_masks(frames_u8)
            areas = _box_area_sums(masks, valid, boxes).cpu().numpy()
        if areas is None:
            return None
        return kinematic_features(areas)
