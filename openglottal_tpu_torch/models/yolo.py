"""YOLOv8n in PyTorch: CSP backbone, C2f blocks, SPPF, anchor-free decoupled
head with DFL box regression.

Counterpart of ``openglottal_tpu/models/yolo.py``.  Scale "n": per-stage
channels (16, 32, 64, 128, 256), C2f repeats (1, 2, 2, 1), ~3.0M parameters
for nc=1.  Parameter names follow the ultralytics layout (``model.0.conv``,
``model.2.m.0.cv1`` ... ``model.22.cv2.0.2``) so a converted ``state_dict``
(``utils/convert.py``) loads with ``strict=True``.

Networks run NCHW inside (``channels_last`` memory format is the caller's
choice); the level outputs are returned NHWC-shaped, as the JAX package
returns them, so that tests compare like with like.

Postprocessing: only the argmax-confidence box of a single class is kept, so
full NMS is unnecessary — decode all anchors, take the max-sigmoid-conf box.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

REG_MAX = 16
STRIDES = (8, 16, 32)
YOLO_BN_EPS = 1e-3
YOLO_BN_MOMENTUM = 0.97
DETECT_LAYER = 22


class BatchNorm(nn.Module):
    """BatchNorm over NCHW with flax's semantics, computed in float32 as the
    reference does.  State: weight, bias, running_mean, running_var (+
    num_batches_tracked when ``tracked``, for layouts that carry it).

    In eval mode it normalises by the running statistics and returns the
    input's dtype.  In training mode (``module.train()``) it normalises by
    the batch mean and the *biased* batch variance in one fused pass (the
    call ``F.batch_norm`` makes, which takes cuDNN's kernels on the card,
    given no running statistics), returns
    float32 (flax's ``dtype=float32``) and updates the running statistics
    as flax does, ``ra = m·ra + (1−m)·batch``, from the mean and inverse
    std that pass returns (the biased variance is invstd⁻² − eps; flax takes
    it as E[x²] − E[x]², the same value up to rounding).  ``F.batch_norm``
    handed the running statistics would update them with the unbiased
    variance and weight the batch by ``momentum`` rather than 1 − m."""

    def __init__(self, ch: int, eps: float, tracked: bool = False,
                 momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))
        if tracked:
            self.register_buffer("num_batches_tracked",
                                 torch.zeros((), dtype=torch.long))

    def forward(self, x):
        if not self.training:
            y = F.batch_norm(x.float(), self.running_mean.float(),
                             self.running_var.float(), self.weight.float(),
                             self.bias.float(), False, 0.0, self.eps)
            return y.to(x.dtype)
        # one fused pass (and its fused backward) normalises by the batch's
        # biased variance; no running statistics are handed to it.  This is
        # F.batch_norm's own call, which also returns the batch mean and
        # inverse std it computed (cuDNN's or the native kernel's)
        y, mean, invstd, _, _ = torch._batch_norm_impl_index(
            x.float(), self.weight.float(), self.bias.float(), None, None,
            True, 0.0, self.eps, torch.backends.cudnn.enabled)
        with torch.no_grad():
            var = invstd.pow(-2).sub_(self.eps).clamp_min_(0.0)
            m = self.momentum
            self.running_mean.mul_(m).add_((1 - m) * mean)
            self.running_var.mul_(m).add_((1 - m) * var)
        return y


@torch.no_grad()
def init_flax_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise ``model`` as flax initialises the JAX package's networks
    (not to its bits: to its distributions): every conv and transposed-conv
    kernel from ``lecun_normal`` (a normal truncated at ±2 std, std =
    sqrt(1 / fan_in) / 0.8796..., fan_in = kh·kw·C_in), biases 0, BatchNorm
    scale 1 and shift 0, running mean 0 and variance 1.  The fixed DFL
    projection is left alone.  Draws come from ``generator``, in module
    order."""
    for mod in model.modules():
        if isinstance(mod, _DFL):
            continue
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            if mod.weight.requires_grad is False:
                continue
            w = mod.weight
            c_in = w.shape[0] if isinstance(mod, nn.ConvTranspose2d) \
                else w.shape[1]
            std = (1.0 / (c_in * w.shape[2] * w.shape[3])) ** 0.5 \
                / .87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
    return model


class ConvBNSiLU(nn.Module):
    """Conv(no bias) -> BN -> SiLU; ``fuse_bn`` runs the inference-folded
    form Conv(+bias) -> SiLU (``models/fold.py``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, fuse_bn: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride,
                              padding=kernel // 2, bias=fuse_bn)
        if not fuse_bn:
            self.bn = BatchNorm(out_ch, YOLO_BN_EPS,
                                momentum=YOLO_BN_MOMENTUM)
        self.fuse_bn = fuse_bn

    def forward(self, x):
        x = self.conv(x)
        if not self.fuse_bn:
            x = self.bn(x)
        return F.silu(x)


class Bottleneck(nn.Module):
    def __init__(self, ch: int, shortcut: bool = True, fuse_bn: bool = False):
        super().__init__()
        self.cv1 = ConvBNSiLU(ch, ch, 3, fuse_bn=fuse_bn)
        self.cv2 = ConvBNSiLU(ch, ch, 3, fuse_bn=fuse_bn)
        self.shortcut = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C2f(nn.Module):
    """Cross-stage partial bottleneck with 2 convolutions (v8 C2f)."""

    def __init__(self, in_ch: int, out_ch: int, n: int = 1,
                 shortcut: bool = False, fuse_bn: bool = False):
        super().__init__()
        self.c = out_ch // 2
        self.cv1 = ConvBNSiLU(in_ch, out_ch, 1, fuse_bn=fuse_bn)
        self.cv2 = ConvBNSiLU((2 + n) * self.c, out_ch, 1, fuse_bn=fuse_bn)
        self.m = nn.ModuleList(Bottleneck(self.c, shortcut, fuse_bn)
                               for _ in range(n))

    def forward(self, x):
        y = self.cv1(x)
        parts = [y[:, :self.c], y[:, self.c:]]
        for m in self.m:
            parts.append(m(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    """Three chained 5x5 stride-1 max-pools, concatenated."""

    def __init__(self, in_ch: int, out_ch: int, pool_k: int = 5,
                 fuse_bn: bool = False):
        super().__init__()
        c = out_ch // 2
        self.cv1 = ConvBNSiLU(in_ch, c, 1, fuse_bn=fuse_bn)
        self.cv2 = ConvBNSiLU(4 * c, out_ch, 1, fuse_bn=fuse_bn)
        self.pool_k = pool_k

    def forward(self, x):
        x = self.cv1(x)
        pools = [x]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], self.pool_k, 1,
                                      self.pool_k // 2))
        return self.cv2(torch.cat(pools, dim=1))


class _DFL(nn.Module):
    """The fixed DFL projection (arange over the 16 bins) that the
    ultralytics layout carries as a frozen 1x1 conv weight."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(REG_MAX, 1, 1, bias=False)
        self.conv.weight.requires_grad_(False)
        with torch.no_grad():
            self.conv.weight.copy_(
                torch.arange(REG_MAX, dtype=torch.float32).view(1, -1, 1, 1))


class DetectHead(nn.Module):
    """Decoupled anchor-free head: per-level box (4*REG_MAX) + cls (nc)
    logits.  ``cv2`` is the box branch, ``cv3`` the class branch."""

    def __init__(self, nc: int = 1, ch: Sequence[int] = (64, 128, 256),
                 fuse_bn: bool = False):
        super().__init__()
        c2 = max(16, ch[0] // 4, REG_MAX * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(nn.Sequential(
            ConvBNSiLU(c, c2, 3, fuse_bn=fuse_bn),
            ConvBNSiLU(c2, c2, 3, fuse_bn=fuse_bn),
            nn.Conv2d(c2, 4 * REG_MAX, 1)) for c in ch)
        self.cv3 = nn.ModuleList(nn.Sequential(
            ConvBNSiLU(c, c3, 3, fuse_bn=fuse_bn),
            ConvBNSiLU(c3, c3, 3, fuse_bn=fuse_bn),
            nn.Conv2d(c3, nc, 1)) for c in ch)
        self.dfl = _DFL()

    def forward(self, feats):
        outs = []
        for i, x in enumerate(feats):
            b = self.cv2[i](x).float().permute(0, 2, 3, 1)
            c = self.cv3[i](x).float().permute(0, 2, 3, 1)
            outs.append((b, c))
        return outs


def _upsample2x(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class YOLOv8(nn.Module):
    """YOLOv8 detection model over (N, 3, H, W) input; returns per-level
    (box_logits (N, h, w, 64), cls_logits (N, h, w, nc)) in float32."""

    def __init__(self, nc: int = 1,
                 width: Sequence[int] = (16, 32, 64, 128, 256),
                 depth: Sequence[int] = (1, 2, 2, 1), fuse_bn: bool = False):
        super().__init__()
        w, d, fb = width, depth, fuse_bn
        self.model = nn.ModuleDict({
            "0": ConvBNSiLU(3, w[0], 3, 2, fb),                    # P1/2
            "1": ConvBNSiLU(w[0], w[1], 3, 2, fb),                 # P2/4
            "2": C2f(w[1], w[1], d[0], True, fb),
            "3": ConvBNSiLU(w[1], w[2], 3, 2, fb),                 # P3/8
            "4": C2f(w[2], w[2], d[1], True, fb),
            "5": ConvBNSiLU(w[2], w[3], 3, 2, fb),                 # P4/16
            "6": C2f(w[3], w[3], d[2], True, fb),
            "7": ConvBNSiLU(w[3], w[4], 3, 2, fb),                 # P5/32
            "8": C2f(w[4], w[4], d[3], True, fb),
            "9": SPPF(w[4], w[4], 5, fb),
            "12": C2f(w[4] + w[3], w[3], d[3], False, fb),
            "15": C2f(w[3] + w[2], w[2], d[3], False, fb),
            "16": ConvBNSiLU(w[2], w[2], 3, 2, fb),
            "18": C2f(w[2] + w[3], w[3], d[3], False, fb),
            "19": ConvBNSiLU(w[3], w[3], 3, 2, fb),
            "21": C2f(w[3] + w[4], w[4], d[3], False, fb),
            str(DETECT_LAYER): DetectHead(nc, (w[2], w[3], w[4]), fb),
        })

    def forward(self, x):
        m = self.model
        x = x.to(m["0"].conv.weight.dtype)
        x = m["1"](m["0"](x))
        x = m["2"](x)
        x4 = m["4"](m["3"](x))
        x6 = m["6"](m["5"](x4))
        x9 = m["9"](m["8"](m["7"](x6)))

        x12 = m["12"](torch.cat([_upsample2x(x9), x6], dim=1))
        p3 = m["15"](torch.cat([_upsample2x(x12), x4], dim=1))
        p4 = m["18"](torch.cat([m["16"](p3), x12], dim=1))
        p5 = m["21"](torch.cat([m["19"](p4), x9], dim=1))
        return m[str(DETECT_LAYER)]([p3, p4, p5])


def anchors_for(size_h: int, size_w: int, device=None):
    """Anchor centres (in pixels) and strides for all levels, concatenated."""
    pts, strides = [], []
    for s in STRIDES:
        h, w = size_h // s, size_w // s
        cy = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * s
        cx = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * s
        gy, gx = torch.meshgrid(cy, cx, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        strides.append(torch.full((h * w,), float(s), dtype=torch.float32,
                                  device=device))
    return torch.cat(pts, 0), torch.cat(strides, 0)


def decode_boxes(level_outputs, size_h: int, size_w: int):
    """DFL-decode all anchors -> (boxes_xyxy (N, A, 4), conf (N, A, nc))."""
    boxes, confs = [], []
    dev = level_outputs[0][0].device
    bins = torch.arange(REG_MAX, dtype=torch.float32, device=dev)
    for b, c in level_outputs:
        n, h, w, _ = b.shape
        dist = torch.softmax(b.reshape(n, h * w, 4, REG_MAX), dim=-1)
        boxes.append((dist * bins).sum(-1))   # (N, hw, 4) ltrb, stride units
        confs.append(torch.sigmoid(c.reshape(n, h * w, -1)))
    pts, strides = anchors_for(size_h, size_w, dev)
    dist = torch.cat(boxes, 1)
    conf = torch.cat(confs, 1)
    x1y1 = pts[None] - dist[..., :2] * strides[None, :, None]
    x2y2 = pts[None] + dist[..., 2:] * strides[None, :, None]
    return torch.cat([x1y1, x2y2], -1), conf


def max_conf_detect(level_outputs, size_h: int, size_w: int,
                    conf_thresh: float = 0.25):
    """Keep only the max-confidence box; among equal confidences the first
    anchor wins.  Returns (has (N,) bool, best_box (N, 4) f32 xyxy,
    best_conf (N,))."""
    boxes, conf = decode_boxes(level_outputs, size_h, size_w)
    conf = conf.max(-1).values
    best_conf = conf.max(1).values
    a = conf.shape[1]
    pos = torch.arange(a, device=conf.device)
    idx = torch.where(conf == best_conf[:, None], pos, a).min(1).values
    idx = idx.clamp(max=a - 1)                  # all-NaN row: keep in range
    best_box = boxes.gather(1, idx[:, None, None].expand(-1, 1, 4))[:, 0]
    return best_conf > conf_thresh, best_box, best_conf


class YoloDetector:
    """Batched detector: BGR uint8 frames -> each frame's max-confidence box.

    Counterpart of the JAX package's ``YoloDetector`` (the reference's
    ``TemporalDetector`` configuration surface: the confidence threshold);
    the temporal gate lives in ``models/gate.py`` and reads this output.
    It is ``GlottalPipelines.detect_video`` on a detector-only instance (the
    serving path's detector, one class).  ``variables``: the JAX package's
    YOLOv8 tree (folded or not).  ``device=None`` is the CUDA device (raises
    without one)."""

    def __init__(self, variables, conf: float = 0.25, dtype=torch.float32,
                 device=None):
        from openglottal_tpu_torch.pipelines import GlottalPipelines

        self.pipe = GlottalPipelines(yolo_variables=variables, conf=conf,
                                     dtype=dtype, device=device)

    def detect_frames(self, frames_bgr_u8):
        """(N, H, W, 3) uint8 BGR, host or device -> (has (N,) bool, box
        (N, 4) float32 xyxy, conf (N,)) at the frames' own size.  256² is
        the detector's size; other sizes are letterboxed upstream, as every
        evaluation path of the reference does (``GlottalPipelines.
        gated_boxes`` does it itself)."""
        return self.pipe.detect_video(frames_bgr_u8)
