"""Serving pipelines over whole videos: frames in, area waveform / kinematic
features out.

Counterpart of ``openglottal_tpu/pipelines.py``.  Ported so far, for
monochrome 256x256 video ((T, H, W) uint8, or (T, H, W, 3) with equal
channels):

  1  ``vft``        — YOLOv8n -> temporal gate -> size-locked crops of the
                      gated boxes -> motion tracker
  2  ``guided-vft`` — YOLOv8n -> temporal gate -> YOLO-guided tracker
  3  ``unet``       — YOLOv8n + gate + full-frame U-Net, in-box pixel counts

Both trackers run frame-parallel by default and as a sequential per-frame
loop with ``parallel_trackers=False`` (the debug form).  Everything else
(colour input, other frame sizes, the ``crop-unet`` / ``unet-only``
pipelines, meshes, int8, the windowed decoder) raises ``NotImplementedError``
until a later slice ports it.

Model passes run over ``CHUNK``-frame slices in a Python loop (the last one
ragged; nothing is padded — PyTorch runs eagerly, so there are no static
shapes to bucket).

Device rule: ``device=None`` means ``torch.device("cuda")`` and raises when no
CUDA device is available; the CPU is used only when asked for by name.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from openglottal_tpu_torch.features import kinematic_features
from openglottal_tpu_torch.models.fold import (
    UNET_STEM,
    YOLO_STEM,
    absorb_u8_scale,
    fold_unet,
    fold_yolo,
    is_folded,
)
from openglottal_tpu_torch.models.gate import GateParams, gate_scan
from openglottal_tpu_torch.models.tracker import (
    VFTParams,
    YGVFTParams,
    vft_parallel,
    vft_scan,
    ygvft_parallel,
    ygvft_scan,
)
from openglottal_tpu_torch.models.unet import UNet
from openglottal_tpu_torch.models.yolo import YOLOv8, max_conf_detect
from openglottal_tpu_torch.ops.resize import crop_resize_bilinear
from openglottal_tpu_torch.utils.convert import (
    unet_state_dict_from_jax,
    yolo_state_dict_from_jax,
)
from openglottal_tpu_torch.utils.io import load_weights_npz

VFT_INIT = 2     # init crops of the motion tracker
YGVFT_INIT = 2   # init frames of the guided tracker
CHUNK = 128      # frame-chunk size for batched model passes
PIPELINES = ("vft", "guided-vft", "unet", "unet-only", "crop-unet")


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


def is_monochrome(frames_np) -> bool:
    """Host-side check whether a (T, H, W, 3) uint8 video has equal channels
    (checked on first/middle/last frames)."""
    if not isinstance(frames_np, np.ndarray) or frames_np.ndim != 4:
        return False
    t = frames_np.shape[0]
    f = frames_np[[0, t // 2, t - 1]]
    return bool((f[..., 0] == f[..., 1]).all()
                and (f[..., 1] == f[..., 2]).all())


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
    crops.  gray (N, H, W), boxes (N, 4) int -> (N, out_h, out_w) float32."""
    b = boxes.to(torch.float32)
    c = crop_resize_bilinear(gray_u8.to(torch.float32), b[:, 1], b[:, 0],
                             b[:, 3] - b[:, 1], b[:, 2] - b[:, 0],
                             out_h, out_w)
    return torch.round(c).clamp(0, 255)


def _as_tree(weights):
    """A weight tree given as such or as the path of an ``.npz`` file."""
    if weights is None or isinstance(weights, dict):
        return weights
    return load_weights_npz(weights)


class GlottalPipelines:
    """Holds the models and runs the serving pipelines.

    ``unet_variables`` / ``yolo_variables``: the JAX package's ``{params,
    batch_stats}`` numpy trees (folded or not), or paths of ``.npz`` files
    holding them.  ``dtype``: ``torch.bfloat16`` (default) or
    ``torch.float32``; in float32 every model pass runs under
    :func:`full_float32`, so that f32 on the card is f32 and not TF32.
    ``fold_bn``: fold BatchNorm into the convs (inference default).
    ``parallel_trackers=False`` runs both trackers as sequential per-frame
    loops (same outputs up to the blur's rounding; the debug form).
    ``use_plain_kernels`` is a test hook: it routes every hand-written kernel
    to its plain version on any device.
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
        if crop_unet_variables is not None:
            raise NotImplementedError(
                "crop-unet weights: the crop pipeline is ported in a later "
                "slice")
        if mesh is not None:
            raise NotImplementedError("mesh sharding is ported in a later slice")
        if quant is not None:
            raise NotImplementedError("int8 serving is ported in a later slice")
        if window_decoder:
            raise NotImplementedError(
                "the windowed decoder is ported in a later slice")
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
        if unet_variables is not None:
            sds["unet"] = unet_state_dict_from_jax(_as_tree(unet_variables))
        if yolo_variables is not None:
            sds["yolo"] = yolo_state_dict_from_jax(_as_tree(yolo_variables))
        # already-folded checkpoints drop straight in; otherwise fold when
        # asked (the inference default)
        if sds and all(is_folded(sd) for sd in sds.values()):
            self._fuse = True
        else:
            self._fuse = bool(fold_bn and sds)
            if self._fuse:
                if "unet" in sds:
                    sds["unet"] = fold_unet(sds["unet"])
                if "yolo" in sds:
                    sds["yolo"] = fold_yolo(sds["yolo"])
        self.unet = self.yolo = None
        if "unet" in sds:
            self.unet = self._build(
                UNet(fuse_bn=self._fuse),
                absorb_u8_scale(sds["unet"], UNET_STEM))
        if "yolo" in sds:
            self.yolo = self._build(
                YOLOv8(nc=1, fuse_bn=self._fuse),
                absorb_u8_scale(sds["yolo"], YOLO_STEM))

    def _build(self, model, sd):
        """Load (the /255 input scale already absorbed into the stem, in
        float32), then cast to the compute dtype and move to the device."""
        model.load_state_dict(sd, strict=True)
        model = model.eval().requires_grad_(False)
        return model.to(device=self.device, dtype=self.dtype,
                        memory_format=torch.channels_last)

    # ── shared pieces ───────────────────────────────────────────────────

    def _to_gray(self, frames) -> torch.Tensor:
        """Host or device frames -> (T, H, W) uint8 on the device; one
        transfer of a single channel."""
        if isinstance(frames, torch.Tensor):
            g = frames
        else:
            g = np.asarray(frames)
            if g.ndim == 4:
                if not is_monochrome(g):
                    raise NotImplementedError(
                        "colour (BGR) input is ported in a later slice; "
                        "this slice serves monochrome video")
                g = g[..., 0]
            g = torch.from_numpy(np.ascontiguousarray(g))
        if g.dim() != 3 or g.dtype != torch.uint8:
            raise ValueError(f"expected (T, H, W) uint8 frames, got "
                             f"{tuple(g.shape)} {g.dtype}")
        if tuple(g.shape[1:]) != (256, 256):
            raise NotImplementedError(
                "frames other than 256x256 (letterboxing) are ported in a "
                "later slice")
        return g.to(self.device)

    def _yolo_input(self, gray_chunk):
        """Raw-pixel detector input: the gray channel replicated to 3 on the
        device (the /255 lives in the stem kernel)."""
        x = gray_chunk[:, None].to(self.dtype).expand(-1, 3, -1, -1)
        return x.contiguous(memory_format=torch.channels_last)

    def _yolo_chunk(self, gray_chunk):
        h, w = gray_chunk.shape[1:]
        outs = self.yolo(self._yolo_input(gray_chunk))
        return max_conf_detect(outs, h, w, self.conf)

    def _require(self, *names):
        for n in names:
            if getattr(self, n) is None:
                raise ValueError(f"this pipeline needs {n} weights")

    @torch.no_grad()
    def detect_video_gray(self, gray_u8):
        """(T, 256, 256) monochrome -> (has (T,), raw boxes (T, 4) f32,
        conf (T,)), in CHUNK-frame slices."""
        self._require("yolo")
        gray = self._to_gray(gray_u8)
        outs = []
        with full_float32(self.dtype):
            for i in range(0, gray.shape[0], CHUNK):
                outs.append(self._yolo_chunk(gray[i:i + CHUNK]))
        return tuple(torch.cat(c) for c in zip(*outs))

    def _detect_gate(self, gray):
        """Detector over all chunks + the causal gate scan ->
        (valid (T,) bool, boxes (T, 4) int32)."""
        has, raw, _ = self.detect_video_gray(gray)
        h, w = gray.shape[1:]
        return gate_scan(has, raw, h, w, self.gate_params,
                         use_plain=self.use_plain_kernels)

    def _tracker(self, parallel_fn, scan_fn):
        """The tracker form this instance runs."""
        return parallel_fn if self.parallel_trackers else scan_fn

    # ── pipeline 1: VFT ─────────────────────────────────────────────────

    def _vft_compute(self, gray, valid, boxes, t, want_masks: bool = False):
        """Shared VFT core: gather size-locked crops of the valid-box frames
        and run ONE tracker pass over them (frame-parallel, or the sequential
        scan with ``parallel_trackers=False``).  The crop size is locked from
        the first gated box — a shape, so the gate outputs are read back to
        the host here (one device-to-host copy).  The tracker consumes only
        the valid-box frames, in order; the first VFT_INIT of them seed it.

        Returns (areas (t,) np.float32, crop_masks (n_valid, h0, w0) | None,
        idx valid-frame indices, (h0, w0))."""
        vb = torch.cat([valid[:, None].to(torch.int32),
                        boxes.to(torch.int32)], 1).cpu().numpy()
        idx = np.nonzero(vb[:, 0])[0]
        areas = np.zeros(t, np.float32)
        if len(idx) < VFT_INIT + 1:
            return areas, None, idx, (0, 0)
        b0 = vb[idx[0], 1:]
        w0, h0 = int(b0[2] - b0[0]), int(b0[3] - b0[1])
        if w0 <= 0 or h0 <= 0:
            return areas, None, idx, (0, 0)
        n = len(idx)
        # the valid frames' indices, in order, made on the device
        sel = torch.argsort((~valid).to(torch.uint8), stable=True)[:n]
        crops = _gather_crops(gray[sel], boxes[sel], h0, w0)
        active = torch.arange(n, device=gray.device) >= VFT_INIT
        cmasks, areas_v = self._tracker(vft_parallel, vft_scan)(
            crops[:VFT_INIT], crops, active, params=self.vft_params,
            use_plain=self.use_plain_kernels)
        areas[idx] = areas_v.cpu().numpy()
        areas[idx[:VFT_INIT]] = 0.0       # init frames contribute 0
        return (areas, cmasks.cpu().numpy() if want_masks else None, idx,
                (h0, w0))

    @torch.no_grad()
    def vft_areas_gray(self, gray_u8):
        """VFT waveform for monochrome video: detect + gate, then size-locked
        crops and one tracker pass.  Returns areas (t,) float32 on the host,
        or None for fewer than VFT_INIT + 5 frames.  All-zero when fewer than
        VFT_INIT + 1 frames have a gated box or the first box is empty."""
        self._require("yolo")
        t = len(gray_u8)
        if t < VFT_INIT + 5:
            return None
        gray = self._to_gray(gray_u8)
        valid, boxes = self._detect_gate(gray)
        return self._vft_compute(gray, valid, boxes, t)[0]

    def vft_areas(self, frames_u8):
        """:meth:`vft_areas_gray` for (T, H, W, 3) frames with equal
        channels (colour input is ported in a later slice)."""
        return self.vft_areas_gray(frames_u8)

    # ── pipeline 2: guided VFT ──────────────────────────────────────────

    def _ygvft_compute(self, gray, valid, boxes, t, want_masks: bool = False):
        """Shared guided-VFT core: ONE tracker pass (frame-parallel, or the
        sequential scan with ``parallel_trackers=False``) -> (areas (t,)
        np.float32, masks (t, h, w) bool tensor | None).  The first
        YGVFT_INIT frames seed the tracker and emit zero / empty outputs."""
        h, w = gray.shape[1:]
        vin = valid[:YGVFT_INIT]
        # first valid init frame, picked on the device (no host read)
        fi = torch.argmax(vin.to(torch.uint8)).reshape(1)
        masks_v, areas_v = self._tracker(ygvft_parallel, ygvft_scan)(
            gray[:YGVFT_INIT], vin.any(), boxes.index_select(0, fi)[0],
            gray[YGVFT_INIT:], valid[YGVFT_INIT:], boxes[YGVFT_INIT:],
            params=self.ygvft_params, use_plain=self.use_plain_kernels)
        areas = np.zeros(t, np.float32)
        areas[YGVFT_INIT:] = areas_v.cpu().numpy()
        masks = None
        if want_masks:
            masks = torch.cat([torch.zeros((YGVFT_INIT, h, w),
                                           dtype=torch.bool,
                                           device=masks_v.device), masks_v])
        return areas, masks

    @torch.no_grad()
    def guided_vft_areas_gray(self, gray_u8):
        """Guided-VFT waveform for monochrome video: detect + gate + one
        tracker pass.  Returns areas (T,) float32 on the host, or None for
        fewer than YGVFT_INIT + 2 frames.  The first YGVFT_INIT frames seed
        the tracker and emit zero."""
        self._require("yolo")
        t = len(gray_u8)
        if t < YGVFT_INIT + 2:
            return None
        gray = self._to_gray(gray_u8)
        valid, boxes = self._detect_gate(gray)
        return self._ygvft_compute(gray, valid, boxes, t)[0]

    @torch.no_grad()
    def ygvft_eval_masks(self, gray, valid, boxes):
        """Guided-tracker masks of the non-init frames, (t - YGVFT_INIT, h,
        w) bool, given the gate's outputs (the init frames are excluded from
        evaluation metrics)."""
        t = gray.shape[0]
        _, masks = self._ygvft_compute(gray, valid, boxes, t,
                                       want_masks=True)
        return masks[YGVFT_INIT:]

    # ── pipeline 3: YOLO + U-Net ────────────────────────────────────────

    @torch.no_grad()
    def yolo_unet_areas_gray(self, gray_u8):
        """YOLO+UNet waveform for monochrome video (one-loop form): every
        chunk goes through the U-Net (``logits > 0``) and the detector, the
        gate runs over all frames, then in-box pixels are counted.  The gate
        needs every frame's detection before any box is known, so the bool
        masks of all chunks are kept until then (T x 64 KB).  Returns areas
        (T,) float32 on the device."""
        self._require("yolo", "unet")
        gray = self._to_gray(gray_u8)
        h, w = gray.shape[1:]
        masks, has, raw = [], [], []
        with full_float32(self.dtype):
            for i in range(0, gray.shape[0], CHUNK):
                g = gray[i:i + CHUNK]
                x = g[:, None].to(self.dtype).contiguous(
                    memory_format=torch.channels_last)
                masks.append(self.unet(x)[:, 0] > 0)      # sigmoid > 0.5
                hs, bx, _ = self._yolo_chunk(g)
                has.append(hs)
                raw.append(bx)
        valid, boxes = gate_scan(torch.cat(has), torch.cat(raw), h, w,
                                 self.gate_params,
                                 use_plain=self.use_plain_kernels)
        return _box_area_sums(torch.cat(masks), valid, boxes)

    # ── entry point ─────────────────────────────────────────────────────

    def extract_features(self, frames_u8, pipeline: str = "unet"):
        """Frames in, kinematic features out (dict, or None for an empty
        video, too few frames, or a silent waveform)."""
        if len(frames_u8) == 0:
            return None
        if pipeline not in PIPELINES:
            raise ValueError(f"unknown pipeline {pipeline!r}")
        if pipeline in ("unet-only", "crop-unet"):
            raise NotImplementedError(
                f"pipeline {pipeline!r} is ported in a later slice")
        if pipeline == "vft":
            areas = self.vft_areas(frames_u8)
        elif pipeline == "guided-vft":
            areas = self.guided_vft_areas_gray(frames_u8)
        else:
            areas = self.yolo_unet_areas_gray(frames_u8).cpu().numpy()
        if areas is None:
            return None
        return kinematic_features(areas)
