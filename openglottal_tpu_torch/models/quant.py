"""Post-training int8 quantization of the U-Net and of YOLOv8n (the opt-in
int8 serving mode).

Counterpart of ``openglottal_tpu/models/quant.py``, same scheme:

  * weights: per-output-channel symmetric int8, sw[c] = max|w[..., c]| / 127
    (:func:`quantize_weights`, from the folded float32 weights);
  * activations: per-tensor symmetric int8, the scale calibrated as the
    ``pct`` percentile of |x| (pct = 100: the max) at every tap of the
    folded bfloat16 model run on calibration frames;
  * every interior convolution runs s8 x s8 -> s32 with its epilogue in one
    launch of ``og_qconv`` (``ops/qconv_cuda.py``): y = acc * (sx * sw) + b,
    ReLU or SiLU (+ the C2f residual), requantised to the next tap's scale;
    the detect head's last 1x1 convolutions give float32 logits;
  * the decoder concat's skip and upsample share one calibrated scale, so the
    concat conv is one int8 convolution over two K sources (the concat is not
    written); YOLO's concat groups are pinned likewise;
  * max-pools pool int8 directly (-128 identity); the stems (raw 0..255
    input), the U-Net's 2x2 transposed-conv upsamplers and its 1x1 head stay
    bfloat16 / float32 library convolutions, their outputs requantised.

Tensors are NHWC (int8 activations, as the JAX package lays them out);
weights in qparams are laid out for the port: ``w8`` (C_out, kh, kw, C_in)
(the kernel's K-contiguous layout), the bfloat16 stem and the float32 head
OIHW, the upsamplers as ``nn.ConvTranspose2d`` weights (I, O, 2, 2).
:func:`qparams_from_jax` takes the JAX package's qparams tree (HWIO), and
:func:`save_qparams` / :func:`load_qparams` read and write the JAX package's
``.npz`` layout ('/'-joined keys, a ``::bf16`` marker, act_scales as Python
floats), so a calibration persisted by either package serves in the other.

Requantisation is ``clip(rint(x * f32(1 / s)), -127, 127)``: the JAX
package's compiled code multiplies by the float32 reciprocal of the constant
scale (found by comparing bits), and so does the port on every device.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from openglottal_tpu_torch.models.fold import is_folded
from openglottal_tpu_torch.ops.qconv_cuda import qconv, reciprocal32

# ── weights, requantisation, names ───────────────────────────────────────


def quantize_weights(kernel: np.ndarray):
    """Per-output-channel symmetric int8 of an HWIO kernel: returns (w8,
    sw) with w8[..., c] = round(w[..., c] / sw[c]), sw[c] = max|w[..., c]| /
    127 (an all-zero channel gets sw = 1)."""
    k = np.asarray(kernel, np.float32)
    sw = np.abs(k).reshape(-1, k.shape[-1]).max(0) / 127.0
    sw = np.where(sw == 0, 1.0, sw).astype(np.float32)
    w8 = np.clip(np.round(k / sw), -127, 127).astype(np.int8)
    return w8, sw


def _q(x, scale: float):
    """float32 -> int8 at per-tensor ``scale`` (times its float32
    reciprocal, rounded half to even, clipped to +-127), contiguous."""
    y = torch.round(x * reciprocal32(scale)).clamp(-127.0, 127.0)
    return y.to(torch.int8).contiguous()


def _bf16(v: float) -> float:
    """``v`` rounded to bfloat16, as a Python float: a bfloat16 tensor
    times it rounds its exact float32 product once, as a product of two
    bfloat16 values does, and no scalar tensor crosses to the device (a
    pageable host-to-device copy synchronises)."""
    return float(torch.tensor(v, dtype=torch.bfloat16))


def _names():
    """(encoder DoubleConvs, bottleneck, decoder DoubleConvs, upsamplers)."""
    enc = [f"DoubleConv_{i}" for i in range(4)]
    dec = [f"DoubleConv_{i}" for i in range(5, 9)]
    ups = [f"ConvTranspose_{i}" for i in range(4)]
    return enc, "DoubleConv_4", dec, ups


def _tap_names():
    """Activation taps needing a calibrated scale: the int8 input of every
    quantized conv."""
    names = []
    for i in range(4):
        names += [f"enc{i}_mid", f"enc{i}_out"]
    names += ["bneck_mid", "bneck_out"]
    for i in range(4):
        names += [f"up{i}", f"dec{i}_mid", f"dec{i}_out"]
    return names


def _unet_keys():
    """JAX module name -> the port's U-Net ``state_dict`` prefix."""
    enc, bneck, dec, ups = _names()
    keys = {name: f"downs.{i}" for i, name in enumerate(enc)}
    keys[bneck] = "bottleneck"
    for k, (name, up) in enumerate(zip(dec, ups)):
        keys[name] = f"ups.{2 * k + 1}"
        keys[up] = f"ups.{2 * k}"
    keys["Conv_0"] = "head"
    return keys


_DC_CONV = {"Conv_0": "net.0", "Conv_1": "net.3"}


def _percentile_abs(a, pct: float):
    """The ``pct`` percentile of |a| over all elements (linear
    interpolation, as ``jnp.percentile``), a 0-d float32 tensor on a's
    device.  pct = 100 is the max; otherwise two ``kthvalue`` selections
    (``torch.quantile`` refuses inputs over 2**24 elements)."""
    v = a.float().abs().reshape(-1)
    if pct >= 100.0:
        return v.amax()
    pos = pct / 100.0 * (v.numel() - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, v.numel() - 1)
    v_lo = v.kthvalue(lo + 1).values
    v_hi = v.kthvalue(hi + 1).values
    return v_lo + (v_hi - v_lo) * float(pos - lo)


def _nchw(x):
    """An NHWC tensor as the NCHW (channels_last) view convolutions take."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _conv_bf16(x, k, b, stride: int = 1, pad: int = 1):
    """bfloat16 conv of an NHWC tensor, its bias added after the conv's own
    rounding (as the JAX package adds it) -> NHWC bfloat16."""
    y = F.conv2d(_nchw(x), k, None, stride=stride, padding=pad)
    return _nhwc(y) + b


def _pool2(x8):
    """2x2 stride-2 max-pool of NHWC int8 (max-pool commutes with the
    monotone quantisation)."""
    n, h, w, c = x8.shape
    return x8.reshape(n, h // 2, 2, w // 2, 2, c).amax((2, 4))


def _cut(x, r0, c0, h: int, w: int):
    """The (h, w) window of NHWC ``x`` at rows r0.., columns c0..: a view
    for int origins; for 0-d integer tensors on x's device a copy made by
    one gather (8-byte words where the channels allow), so the origin is
    never read by the host."""
    if not isinstance(r0, torch.Tensor) and not isinstance(c0, torch.Tensor):
        return x[:, r0:r0 + h, c0:c0 + w]
    dev = x.device
    rows = torch.as_tensor(r0, device=dev).reshape(()) + torch.arange(
        h, device=dev)
    cols = torch.as_tensor(c0, device=dev).reshape(()) + torch.arange(
        w, device=dev)
    xs = x.contiguous()
    wide = xs.shape[-1] * xs.element_size() % 8 == 0
    if wide:
        xs = xs.view(torch.int64)
    out = xs[:, rows[:, None], cols[None, :]]
    return out.view(x.dtype) if wide else out


# ── U-Net ────────────────────────────────────────────────────────────────


def quantize_unet(sd: dict, calib_gray_u8, pct: float = 100.0) -> dict:
    """Post-training quantization of a FOLDED U-Net ``state_dict`` (float32,
    the stem not scaled by 1/255; ``models/fold.fold_unet``).
    calib_gray_u8: (N, 256, 256) uint8 calibration frames (a tensor on the
    weights' device, or numpy), run through the bfloat16 model to record
    per-activation ranges.  Returns the port's qparams tree."""
    if not is_folded(sd):
        raise ValueError("quantize_unet expects fold_unet-folded weights")
    dev = sd["head.weight"].device
    g = torch.as_tensor(np.asarray(calib_gray_u8) if not isinstance(
        calib_gray_u8, torch.Tensor) else calib_gray_u8).to(dev)
    acts = _bf16_taps(sd, g, pct)
    scales = {name: acts[name] / 127.0 for name in _tap_names()}
    scales = {k: (v if v > 0 else 1.0) for k, v in scales.items()}
    # each skip and its upsample share one scale, so the decoder's concat
    # conv is one int8 conv over both
    for i in range(4):
        sc = max(scales[f"enc{3 - i}_out"], scales[f"up{i}"])
        scales[f"enc{3 - i}_out"] = sc
        scales[f"up{i}"] = sc
    keys = _unet_keys()
    enc, bneck, dec, ups = _names()
    q: dict[str, Any] = {"act_scales": scales}
    for name in enc + [bneck] + dec:
        q[name] = {conv: _qlayer(sd, f"{keys[name]}.{sub}")
                   for conv, sub in _DC_CONV.items()}
    for name in ups:
        q[name] = {"kernel": sd[f"{keys[name]}.weight"].to(torch.bfloat16),
                   "bias": sd[f"{keys[name]}.bias"].to(torch.bfloat16)}
    q["stem_bf16"] = {"kernel": sd["downs.0.net.0.weight"].to(torch.bfloat16),
                      "bias": sd["downs.0.net.0.bias"].to(torch.bfloat16)}
    q["head"] = {"kernel": sd["head.weight"].float(),
                 "bias": sd["head.bias"].float()}
    return q


def _qlayer(sd: dict, prefix: str) -> dict:
    """{w8 (C_out, kh, kw, C_in) int8, sw, b} of one folded conv."""
    w = sd[f"{prefix}.weight"]
    hwio = w.detach().float().permute(2, 3, 1, 0).cpu().numpy()
    w8, sw = quantize_weights(hwio)
    dev = w.device
    return {"w8": torch.from_numpy(np.ascontiguousarray(
                w8.transpose(3, 0, 1, 2))).to(dev),
            "sw": torch.from_numpy(sw).to(dev),
            "b": sd[f"{prefix}.bias"].float().contiguous()}


@torch.no_grad()
def _bf16_taps(sd: dict, gray_u8, pct: float = 100.0) -> dict:
    """The folded bfloat16 U-Net on calibration frames -> {tap: the
    ``pct`` percentile of |activation|} (floats; one host read)."""
    keys = _unet_keys()
    enc, bneck, dec, ups = _names()
    bf = torch.bfloat16
    # x / 255 as the JAX package's compiled code takes it (times the float32
    # reciprocal), then bfloat16
    x = (gray_u8.float() * reciprocal32(255.0)).to(bf)[..., None]
    taps = {}

    def dc(name, x, tag):
        for j, conv in enumerate(("Conv_0", "Conv_1")):
            p = f"{keys[name]}.{_DC_CONV[conv]}"
            x = torch.relu(_conv_bf16(x, sd[f"{p}.weight"].to(bf),
                                      sd[f"{p}.bias"].to(bf)))
            taps[f"{tag}_{'mid' if j == 0 else 'out'}"] = _percentile_abs(
                x, pct)
        return x

    skips = []
    for i, name in enumerate(enc):
        x = dc(name, x, f"enc{i}")
        skips.append(x)
        x = _nhwc(F.max_pool2d(_nchw(x), 2, 2))
    x = dc(bneck, x, "bneck")
    for i, (name, up) in enumerate(zip(dec, ups)):
        p = keys[up]
        x = _nhwc(F.conv_transpose2d(_nchw(x), sd[f"{p}.weight"].to(bf),
                                     None, stride=2)) + sd[f"{p}.bias"].to(bf)
        taps[f"up{i}"] = _percentile_abs(x, pct)
        x = dc(name, torch.cat([skips.pop(), x], -1), f"dec{i}")
    vals = torch.stack([taps[k] for k in taps]).cpu().numpy()
    return dict(zip(taps, (float(v) for v in vals)))


def _qc(x8, layer, sx: float, s_next: float, pad: int = 1,
        use_plain: bool = False):
    """conv (s8 x s8 -> s32) -> dequant + bias -> ReLU -> requant: one
    ``og_qconv`` launch."""
    return qconv(x8, layer["w8"], layer["sw"], layer["b"], sx, pad=pad,
                 epilogue="relu_q", s_next=s_next, use_plain=use_plain)


def _stem(qparams, gray_u8):
    """The bfloat16 stem on raw pixels (its kernel times bf16(1/255) in
    bfloat16, as the JAX package scales it), ReLU, quantised -> (N, H, W, 32)
    int8."""
    st = qparams["stem_bf16"]
    k = st["kernel"] * _bf16(1.0 / 255.0)
    x = gray_u8.to(torch.bfloat16)[..., None]
    y = torch.relu(_conv_bf16(x, k, st["bias"]))
    return _q(y.float(), qparams["act_scales"]["enc0_mid"])


def _qup(qparams, x8, sx_in: float, i: int):
    """bfloat16 dequant -> 2x2 stride-2 transposed conv (+ bias after its
    rounding) -> requant (decoder level i)."""
    s = qparams["act_scales"]
    up = qparams[_names()[3][i]]
    xb = x8.to(torch.bfloat16) * _bf16(sx_in)
    u = _nhwc(F.conv_transpose2d(_nchw(xb), up["kernel"], None, stride=2))
    return _q((u + up["bias"]).float(), s[f"up{i}"])


def _head(qparams, x8, sx: float):
    """The float32 1x1 logits head over the dequantised activation ->
    (N, H, W) float32 logits (a float32 matmul: no TF32)."""
    head = qparams["head"]
    xf = x8.float() * sx
    k = head["kernel"].reshape(head["kernel"].shape[0], -1).t()
    return (torch.matmul(xf, k) + head["bias"])[..., 0].contiguous()


@torch.no_grad()
def qunet_to_d3(qparams, gray_u8, use_plain: bool = False):
    """The int8 U-Net's shared prefix through the 64²-level decoder block ->
    (x8_d3 (N, H/4, W/4, 128), skip1 (N, H, W, 32), skip2 (N, H/2, W/2, 64)),
    int8 NHWC.  gray_u8: (N, H, W) uint8 raw frames."""
    s = qparams["act_scales"]
    enc, bneck, dec, ups = _names()
    x8 = _stem(qparams, gray_u8)
    skips = []
    sx = s["enc0_mid"]
    for i, name in enumerate(enc):
        if i > 0:
            x8 = _qc(x8, qparams[name]["Conv_0"], sx, s[f"enc{i}_mid"],
                     use_plain=use_plain)
            sx = s[f"enc{i}_mid"]
        x8 = _qc(x8, qparams[name]["Conv_1"], sx, s[f"enc{i}_out"],
                 use_plain=use_plain)
        sx = s[f"enc{i}_out"]
        skips.append(x8)
        x8 = _pool2(x8)
    x8 = _qc(x8, qparams[bneck]["Conv_0"], sx, s["bneck_mid"],
             use_plain=use_plain)
    x8 = _qc(x8, qparams[bneck]["Conv_1"], s["bneck_mid"], s["bneck_out"],
             use_plain=use_plain)
    sx = s["bneck_out"]
    for i in range(2):   # decoder levels at H/8 and H/4
        u8 = _qup(qparams, x8, sx, i)
        # skip first, as the concat: two K sources of one conv
        x8 = _qc((skips.pop(), u8), qparams[dec[i]]["Conv_0"], s[f"up{i}"],
                 s[f"dec{i}_mid"], use_plain=use_plain)
        x8 = _qc(x8, qparams[dec[i]]["Conv_1"], s[f"dec{i}_mid"],
                 s[f"dec{i}_out"], use_plain=use_plain)
        sx = s[f"dec{i}_out"]
    return x8, skips[0], skips[1]


@torch.no_grad()
def qunet_tail_from_d3_full(qparams, x8_d3, skip1, skip2,
                            use_plain: bool = False):
    """Full-frame decoder levels 2-3 and the head from the d3 split point
    -> logits (N, H, W) float32; (qunet_to_d3 then this) is
    :func:`qunet_logits`."""
    s = qparams["act_scales"]
    dec = _names()[2]
    x8, sx = x8_d3, s["dec1_out"]
    for i, s8 in ((2, skip2), (3, skip1)):
        u8 = _qup(qparams, x8, sx, i)
        x8 = _qc((s8, u8), qparams[dec[i]]["Conv_0"], s[f"up{i}"],
                 s[f"dec{i}_mid"], use_plain=use_plain)
        x8 = _qc(x8, qparams[dec[i]]["Conv_1"], s[f"dec{i}_mid"],
                 s[f"dec{i}_out"], use_plain=use_plain)
        sx = s[f"dec{i}_out"]
    return _head(qparams, x8, sx)


@torch.no_grad()
def qunet_tail_from_d3_window(qparams, x8_d3, skip1, skip2, oy, ox,
                              win: int = 160, use_plain: bool = False):
    """Windowed decoder levels 2-3 and the head -> logits (N, win, win) of
    the frame window at even origin (oy, ox), oy = 2 (mod 4), 6-px interior
    margins (``models/unet.chunk_window_origin`` lattice 4, margin 6); the
    origin as ints or 0-d integer tensors on the device.  The valid int8
    convolutions on real-halo windows give the full-frame pass's values
    (s32 sums are exact in any order)."""
    s = qparams["act_scales"]
    dec = _names()[2]
    mw = win // 2 + 6
    m0y, m0x = oy // 2 - 3, ox // 2 - 3       # even by the origin lattice
    d3w = _cut(x8_d3, m0y // 2, m0x // 2, mw // 2, mw // 2)
    u8 = _qup(qparams, d3w, s["dec1_out"], 2)                  # (N, mw, mw)
    s2w = _cut(skip2, m0y, m0x, mw, mw)
    x8 = _qc((s2w, u8), qparams[dec[2]]["Conv_0"], s["up2"], s["dec2_mid"],
             pad=0, use_plain=use_plain)                       # mw - 2
    x8 = _qc(x8, qparams[dec[2]]["Conv_1"], s["dec2_mid"], s["dec2_out"],
             pad=0, use_plain=use_plain)                       # win/2 + 2
    wh = win + 4
    u8 = _qup(qparams, x8, s["dec2_out"], 3)                   # (N, wh, wh)
    s1w = _cut(skip1, oy - 2, ox - 2, wh, wh)
    x8 = _qc((s1w, u8), qparams[dec[3]]["Conv_0"], s["up3"], s["dec3_mid"],
             pad=0, use_plain=use_plain)                       # win + 2
    x8 = _qc(x8, qparams[dec[3]]["Conv_1"], s["dec3_mid"], s["dec3_out"],
             pad=0, use_plain=use_plain)                       # win
    return _head(qparams, x8, s["dec3_out"])


def qunet_logits(qparams, gray_u8, use_plain: bool = False):
    """The int8 U-Net on (N, H, W) uint8 frames -> (N, H, W) float32
    logits."""
    return qunet_tail_from_d3_full(
        qparams, *qunet_to_d3(qparams, gray_u8, use_plain),
        use_plain=use_plain)


def qunet_masks(qparams, gray_u8, use_plain: bool = False):
    """Boolean masks of the int8 U-Net (``logits > 0``, sigmoid > 0.5)."""
    return qunet_logits(qparams, gray_u8, use_plain) > 0


# ── YOLOv8n ──────────────────────────────────────────────────────────────
#
# One walker runs both the bfloat16 calibration pass (recording per-tap |x|
# percentiles) and the int8 forward, as the JAX package's does.  Concat
# operands share a scale: inside each C2f, cv1's halves and every bottleneck
# output; the FPN groups {sppf, x6, cbs6} and {x12, x4, cbs5}.

_YOLO_CONV = {"ConvBNSiLU_0": 0, "ConvBNSiLU_1": 1, "ConvBNSiLU_2": 3,
              "ConvBNSiLU_3": 5, "ConvBNSiLU_4": 7, "ConvBNSiLU_5": 16,
              "ConvBNSiLU_6": 19}
_YOLO_C2F = {f"C2f_{j}": layer for j, layer in
             enumerate((2, 4, 6, 8, 12, 15, 18, 21))}
YOLO_STEM = "ConvBNSiLU_0/Conv_0"
_FPN_GROUPS = (("sppf_out", "C2f_2_out", "cbs6"),
               ("C2f_4_out", "C2f_1_out", "cbs5"))


def yolo_sd_prefix(path: str) -> str:
    """A JAX YOLOv8 conv path (``C2f_0/Bottleneck_0/ConvBNSiLU_1/Conv_0``,
    ``DetectHead_0/cls2_2``) -> the port's ``state_dict`` prefix."""
    parts = path.split("/")
    top = parts[0]
    if top in _YOLO_CONV:
        return f"model.{_YOLO_CONV[top]}.conv"
    if top in _YOLO_C2F:
        base = f"model.{_YOLO_C2F[top]}"
        if parts[1].startswith("Bottleneck_"):
            b = parts[1].split("_")[1]
            return f"{base}.m.{b}.cv{int(parts[2][-1]) + 1}.conv"
        return f"{base}.cv{int(parts[1][-1]) + 1}.conv"
    if top == "SPPF_0":
        return f"model.9.cv{int(parts[1][-1]) + 1}.conv"
    if top == "DetectHead_0":
        name = parts[1]                       # box{i}_{j} / cls{i}_{j}
        branch = "cv2" if name.startswith("box") else "cv3"
        i, j = name[3:].split("_")
        return f"model.22.{branch}.{i}.{j}" + (".conv" if j != "2" else "")
    raise KeyError(f"not a YOLOv8 conv path: {path!r}")


def yolo_conv_paths(sd: dict) -> list:
    """Every conv path of the folded YOLOv8n ``state_dict`` but the stem."""
    paths = [f"ConvBNSiLU_{i}/Conv_0" for i in range(1, 7)]
    for name, layer in _YOLO_C2F.items():
        n = len({k.split(".")[3] for k in sd
                 if k.startswith(f"model.{layer}.m.")})
        paths += [f"{name}/ConvBNSiLU_0/Conv_0", f"{name}/ConvBNSiLU_1/Conv_0"]
        paths += [f"{name}/Bottleneck_{b}/ConvBNSiLU_{j}/Conv_0"
                  for b in range(n) for j in (0, 1)]
    paths += ["SPPF_0/ConvBNSiLU_0/Conv_0", "SPPF_0/ConvBNSiLU_1/Conv_0"]
    for i in range(3):
        for br in ("box", "cls"):
            paths += [f"DetectHead_0/{br}{i}_0/Conv_0",
                      f"DetectHead_0/{br}{i}_1/Conv_0",
                      f"DetectHead_0/{br}{i}_2"]
    return paths


def _maxpool5_i8(x8):
    """5x5 stride-1 max-pool of NHWC int8, padding 2 with -128 (the JAX
    package's identity), separably."""
    h, w = x8.shape[1:3]
    p = F.pad(x8, (0, 0, 2, 2, 2, 2), value=-128)
    r = p[:, 0:h]
    for d in range(1, 5):
        r = torch.maximum(r, p[:, d:d + h])
    c = r[:, :, 0:w]
    for d in range(1, 5):
        c = torch.maximum(c, r[:, :, d:d + w])
    return c.contiguous()


def _up2(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class _YoloWalk:
    """Structural walker over the folded YOLOv8n.

    mode="calib": ``source`` is the folded float32 ``state_dict`` (stem not
    scaled); activations are NHWC bfloat16 tensors; records taps[name] = the
    pct percentile of |x|.  mode="int8": ``source`` is the yolo qparams;
    activations are (int8 NHWC tensor, or a pair of them concatenated along
    channels, scale name) and every interior conv is one ``og_qconv``."""

    def __init__(self, source, mode: str, pct: float = 100.0,
                 use_plain: bool = False):
        self.src = source
        self.mode = mode
        self.pct = pct
        self.use_plain = use_plain
        self.taps = {}

    def _tap(self, name, x):
        v = _percentile_abs(x, self.pct)
        prev = self.taps.get(name)
        self.taps[name] = v if prev is None else torch.maximum(prev, v)

    def _scale(self, name):
        return self.src["act_scales"][name]

    def _kb(self, path):
        p = yolo_sd_prefix(path)
        return (self.src[f"{p}.weight"].to(torch.bfloat16),
                self.src[f"{p}.bias"].to(torch.bfloat16))

    def cbs(self, name, x, out_name, stride=1, residual=None):
        """ConvBNSiLU: conv -> SiLU (-> residual add) -> requantise / tap."""
        if self.mode == "calib":
            k, b = self._kb(name)
            y = F.silu(_conv_bf16(x, k, b, stride, k.shape[-1] // 2))
            if residual is not None:
                y = y + residual
            self._tap(out_name, y)
            return y
        layer = self.src[name]
        kw = dict(residual=None, s_res=None)
        if residual is not None:
            kw = dict(residual=residual[0], s_res=self._scale(residual[1]))
        y8 = qconv(x[0], layer["w8"], layer["sw"], layer["b"],
                   self._scale(x[1]), stride=stride,
                   pad=layer["w8"].shape[1] // 2, epilogue="silu_q",
                   s_next=self._scale(out_name), use_plain=self.use_plain,
                   **kw)
        return y8, out_name

    def head_conv(self, name, x):
        """The head's final 1x1 conv -> float32 logits."""
        if self.mode == "calib":
            k, b = self._kb(name)
            return _conv_bf16(x, k, b, 1, 0)
        layer = self.src[name]
        return qconv(x[0], layer["w8"], layer["sw"], layer["b"],
                     self._scale(x[1]), pad=0, epilogue="f32",
                     use_plain=self.use_plain)

    def concat(self, xs, out_name):
        """Same-scale activations along channels (calibration pins the
        group); two int8 operands stay a pair (the conv reads both)."""
        if self.mode == "calib":
            return torch.cat(xs, -1)
        parts = []
        for x in xs:
            parts += list(x[0]) if isinstance(x[0], tuple) else [x[0]]
        return (tuple(parts) if len(parts) == 2 else torch.cat(parts, -1),
                out_name)

    def split2(self, x, c):
        if self.mode == "calib":
            return x[..., :c], x[..., c:]
        return (x[0][..., :c], x[1]), (x[0][..., c:], x[1])

    def maxpool(self, x):
        if self.mode == "calib":
            return _nhwc(F.max_pool2d(_nchw(x), 5, 1, 2))
        return _maxpool5_i8(x[0]), x[1]

    def upsample(self, x):
        if self.mode == "calib":
            return _up2(x)
        return _up2(x[0]), x[1]

    def _c_out(self, path):
        if self.mode == "calib":
            return self.src[f"{yolo_sd_prefix(path)}.weight"].shape[0]
        return self.src[path]["w8"].shape[0]

    def c2f(self, name, x, n: int, shortcut: bool):
        c = self._c_out(f"{name}/ConvBNSiLU_1/Conv_0") // 2
        y = self.cbs(f"{name}/ConvBNSiLU_0/Conv_0", x, f"{name}_cv1")
        p0, p1 = self.split2(y, c)
        parts = [p0, p1]
        for j in range(n):
            b = parts[-1]
            mid = self.cbs(f"{name}/Bottleneck_{j}/ConvBNSiLU_0/Conv_0", b,
                           f"{name}_b{j}m")
            res = b if shortcut else None
            parts.append(self.cbs(
                f"{name}/Bottleneck_{j}/ConvBNSiLU_1/Conv_0", mid,
                f"{name}_cv1", residual=res))
        # p0 | p1 is cv1's output itself: concatenate that
        cat = self.concat([y] + parts[2:], f"{name}_cv1")
        return self.cbs(f"{name}/ConvBNSiLU_1/Conv_0", cat, f"{name}_out")

    def sppf(self, name, x):
        y = self.cbs(f"{name}/ConvBNSiLU_0/Conv_0", x, f"{name}_cv1")
        pools = [y]
        for _ in range(3):
            pools.append(self.maxpool(pools[-1]))
        cat = self.concat(pools, f"{name}_cv1")
        return self.cbs(f"{name}/ConvBNSiLU_1/Conv_0", cat, "sppf_out")

    def forward(self, x_raw, depth=(1, 2, 2, 1)):
        """YOLOv8n on raw 0..255 float frames (N, H, W, cin) -> per-level
        (box (N, h, w, 64), cls (N, h, w, 1)) float32 logits; the /255 lives
        in the bfloat16 stem kernel."""
        d = depth
        if self.mode == "calib":
            k, b = self._kb(YOLO_STEM)
        else:
            k, b = self.src["stem_bf16"]["kernel"], self.src["stem_bf16"]["bias"]
        k = k * _bf16(1.0 / 255.0)
        y = F.silu(_conv_bf16(x_raw.to(torch.bfloat16), k, b, 2, 1))  # P1/2
        if self.mode == "calib":
            self._tap("p1", y)
            x = y
        else:
            x = (_q(y.float(), self._scale("p1")), "p1")

        x = self.cbs("ConvBNSiLU_1/Conv_0", x, "cbs1", stride=2)   # P2/4
        x = self.c2f("C2f_0", x, d[0], True)
        x = self.cbs("ConvBNSiLU_2/Conv_0", x, "cbs2", stride=2)   # P3/8
        x4 = self.c2f("C2f_1", x, d[1], True)
        x = self.cbs("ConvBNSiLU_3/Conv_0", x4, "cbs3", stride=2)  # P4/16
        x6 = self.c2f("C2f_2", x, d[2], True)
        x = self.cbs("ConvBNSiLU_4/Conv_0", x6, "cbs4", stride=2)  # P5/32
        x = self.c2f("C2f_3", x, d[3], True)
        x9 = self.sppf("SPPF_0", x)

        x = self.concat([self.upsample(x9), x6], "sppf_out")
        x12 = self.c2f("C2f_4", x, d[3], False)
        x = self.concat([self.upsample(x12), x4], "C2f_4_out")
        p3 = self.c2f("C2f_5", x, d[3], False)
        x = self.cbs("ConvBNSiLU_5/Conv_0", p3, "cbs5", stride=2)
        x = self.concat([x, x12], "C2f_4_out")
        p4 = self.c2f("C2f_6", x, d[3], False)
        x = self.cbs("ConvBNSiLU_6/Conv_0", p4, "cbs6", stride=2)
        x = self.concat([x, x9], "sppf_out")
        p5 = self.c2f("C2f_7", x, d[3], False)

        outs = []
        for i, f in enumerate((p3, p4, p5)):
            b = self.cbs(f"DetectHead_0/box{i}_0/Conv_0", f, f"box{i}a")
            b = self.cbs(f"DetectHead_0/box{i}_1/Conv_0", b, f"box{i}b")
            b = self.head_conv(f"DetectHead_0/box{i}_2", b)
            c = self.cbs(f"DetectHead_0/cls{i}_0/Conv_0", f, f"cls{i}a")
            c = self.cbs(f"DetectHead_0/cls{i}_1/Conv_0", c, f"cls{i}b")
            c = self.head_conv(f"DetectHead_0/cls{i}_2", c)
            outs.append((b.float(), c.float()))
        return outs


@torch.no_grad()
def quantize_yolo(sd: dict, calib_x_raw, pct: float = 100.0) -> dict:
    """Post-training quantization of a FOLDED YOLOv8n ``state_dict``
    (float32, stem not scaled; ``models/fold.fold_yolo``).  calib_x_raw:
    (N, H, W, cin) raw 0..255 float frames with the stem's channel count.
    Returns the port's yolo qparams (conv paths as keys, as the JAX
    package's)."""
    if not is_folded(sd):
        raise ValueError("quantize_yolo expects fold_yolo-folded weights")
    dev = sd[f"{yolo_sd_prefix(YOLO_STEM)}.weight"].device
    x = torch.as_tensor(calib_x_raw if isinstance(calib_x_raw, torch.Tensor)
                        else np.asarray(calib_x_raw), dtype=torch.float32)
    w = _YoloWalk(sd, "calib", pct=pct)
    w.forward(x.to(dev))
    vals = torch.stack([w.taps[k] for k in w.taps]).cpu().numpy()
    scales = {k: max(float(v) / 127.0, 1e-12) for k, v in zip(w.taps, vals)}
    for group in _FPN_GROUPS:
        sc = max(scales[n] for n in group)
        for n in group:
            scales[n] = sc
    q: dict[str, Any] = {"act_scales": scales}
    stem = yolo_sd_prefix(YOLO_STEM)
    q["stem_bf16"] = {"kernel": sd[f"{stem}.weight"].to(torch.bfloat16),
                      "bias": sd[f"{stem}.bias"].to(torch.bfloat16)}
    for path in yolo_conv_paths(sd):
        q[path] = _qlayer(sd, yolo_sd_prefix(path))
    return q


def qyolo_forward(qparams, x_raw, use_plain: bool = False):
    """int8 YOLOv8n on raw 0..255 float NHWC frames -> per-level (box, cls)
    float32 logits, NHWC (as ``models/yolo.YOLOv8`` returns them)."""
    with torch.no_grad():
        return _YoloWalk(qparams, "int8", use_plain=use_plain).forward(x_raw)


# ── the JAX package's qparams layout, and its .npz ──────────────────────


def _leaf(v, dtype=None, device="cpu"):
    """A numpy (or ml_dtypes bfloat16) / torch leaf as a torch tensor."""
    if isinstance(v, torch.Tensor):
        t = v
    else:
        a = np.asarray(v)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device).contiguous()


def _flat_convs(node, prefix=""):
    """{path: layer} of every dict holding ``w8`` under ``node`` (the
    yolo tree, whose paths are flat keys or, as the JAX package's
    ``load_qparams`` restores them, nested dicts)."""
    out = {}
    for k, v in node.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) and "w8" in v:
            out[path] = v
        elif isinstance(v, dict):
            out.update(_flat_convs(v, path))
    return out


def _conv_from_jax(layer, device):
    w8 = np.asarray(layer["w8"]) if not isinstance(layer["w8"], torch.Tensor) \
        else layer["w8"].cpu().numpy()
    return {"w8": _leaf(np.ascontiguousarray(w8.transpose(3, 0, 1, 2)),
                        device=device),
            "sw": _leaf(layer["sw"], torch.float32, device),
            "b": _leaf(layer["b"], torch.float32, device)}


def _hwio_to_oihw(k):
    a = k.float().cpu().numpy() if isinstance(k, torch.Tensor) else \
        np.asarray(k).astype(np.float32)
    return np.ascontiguousarray(a.transpose(3, 2, 0, 1))


def qparams_from_jax(tree: dict, device="cpu") -> dict:
    """A JAX package qparams tree ({"unet": ..., optional "yolo": ...}, or a
    bare single-model tree; numpy leaves, as
    ``openglottal_tpu.models.quant.load_qparams`` returns it) -> the port's:
    ``w8`` HWIO -> (C_out, kh, kw, C_in), the bfloat16 stem and the float32
    head HWIO -> OIHW, the upsamplers mirrored into ``nn.ConvTranspose2d``'s
    (I, O, 2, 2); bfloat16 leaves stay bfloat16, act_scales floats."""
    if "unet" in tree or "yolo" in tree:
        return {k: qparams_from_jax(v, device) for k, v in tree.items()}
    out: dict[str, Any] = {"act_scales": {k: float(v) for k, v in
                                          tree["act_scales"].items()}}
    bf = torch.bfloat16
    st = tree["stem_bf16"]
    out["stem_bf16"] = {
        "kernel": torch.from_numpy(_hwio_to_oihw(st["kernel"])).to(bf).to(
            device),
        "bias": _leaf(st["bias"], bf, device)}
    if "head" in tree:                                   # the U-Net
        for name, node in tree.items():
            if name.startswith("DoubleConv_"):
                out[name] = {c: _conv_from_jax(l, device)
                             for c, l in node.items()}
            elif name.startswith("ConvTranspose_"):
                k = node["kernel"]
                k = (k.float().cpu().numpy() if isinstance(k, torch.Tensor)
                     else np.asarray(k).astype(np.float32))
                k = np.ascontiguousarray(k[::-1, ::-1].transpose(2, 3, 0, 1))
                out[name] = {"kernel": torch.from_numpy(k).to(bf).to(device),
                             "bias": _leaf(node["bias"], bf, device)}
        out["head"] = {
            "kernel": torch.from_numpy(_hwio_to_oihw(tree["head"]["kernel"])
                                       ).to(device),
            "bias": _leaf(tree["head"]["bias"], torch.float32, device)}
    else:                                                 # YOLOv8n
        rest = {k: v for k, v in tree.items()
                if k not in ("act_scales", "stem_bf16")}
        for path, layer in _flat_convs(rest).items():
            out[path] = _conv_from_jax(layer, device)
    return out


def _to_jax_flat(qp: dict, prefix: str, flat: dict) -> None:
    """The port's qparams -> the JAX package's flat .npz entries."""
    def put(key, t):
        a = t.detach().cpu()
        if a.dtype == torch.bfloat16:
            flat[f"{key}::bf16"] = a.float().numpy()
        else:
            flat[key] = a.numpy()

    for k, v in qp["act_scales"].items():
        flat[f"{prefix}act_scales/{k}"] = np.asarray(float(v))
    hwio = lambda t: t.permute(2, 3, 1, 0)        # OIHW / OHWI -> HWIO
    st = qp["stem_bf16"]
    put(f"{prefix}stem_bf16/kernel", hwio(st["kernel"]).contiguous())
    put(f"{prefix}stem_bf16/bias", st["bias"])
    for name, node in qp.items():
        if name in ("act_scales", "stem_bf16"):
            continue
        if name == "head":
            put(f"{prefix}head/kernel", hwio(node["kernel"]).contiguous())
            put(f"{prefix}head/bias", node["bias"])
        elif name.startswith("ConvTranspose_"):
            k = node["kernel"].permute(2, 3, 0, 1).flip(0, 1).contiguous()
            put(f"{prefix}{name}/kernel", k)
            put(f"{prefix}{name}/bias", node["bias"])
        else:
            layers = node if "w8" not in node else {"": node}
            for sub, layer in layers.items():
                base = f"{prefix}{name}/{sub}/" if sub else f"{prefix}{name}/"
                put(f"{base}w8", layer["w8"].permute(1, 2, 3, 0).contiguous())
                put(f"{base}sw", layer["sw"])
                put(f"{base}b", layer["b"])


def save_qparams(qparams: dict, path) -> None:
    """Persist a qparams tree ({"unet": ..., optional "yolo": ...} or a bare
    single-model tree) to one ``.npz`` in the JAX package's layout:
    '/'-joined keys, bfloat16 leaves as float32 under a ``::bf16`` marker,
    HWIO kernels."""
    flat: dict = {}
    if "unet" in qparams or "yolo" in qparams:
        for model, qp in qparams.items():
            _to_jax_flat(qp, f"{model}/", flat)
    else:
        _to_jax_flat(qparams, "", flat)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **flat)


def load_jax_tree(path) -> dict:
    """An ``.npz`` of the JAX package's layout -> its qparams tree (numpy
    leaves, bfloat16 leaves as torch bfloat16 tensors, act_scales floats)."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            k, bf16 = ((key[:-6], True) if key.endswith("::bf16")
                       else (key, False))
            node = tree
            parts = k.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            v = z[key]
            if bf16:
                v = torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
            elif "act_scales" in parts:
                v = float(v)
            node[parts[-1]] = v
    return tree


def load_qparams(path, device="cpu") -> dict:
    """Inverse of :func:`save_qparams` (also reads the JAX package's files)
    -> the port's qparams on ``device``."""
    return qparams_from_jax(load_jax_tree(path), device)
