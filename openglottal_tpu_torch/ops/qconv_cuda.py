"""The int8 convolution of the int8 serving mode: the hand-written CUDA kernel
(``csrc/qconv.cu`` ``og_qconv``), its wrapper and its plain PyTorch version.

Computes the int8 convolutions of ``openglottal_tpu/models/quant.py``
(``_qconv``, ``_qconv_relu_q``, ``_YoloWalk.cbs`` and ``head_conv``): an s8 x
s8 -> s32 convolution of NHWC int8 activations with per-output-channel int8
weights, and one of three epilogues on the s32 sums,

    y      = fma(f32(acc), f32(sx) * sw[o], b[o])
    relu_q : q(max(y, 0))
    silu_q : q(y * (1 / (1 + exp(-y))))  [fma(f32(r8), s_r, .) with a residual;
             exp as XLA's CPU code computes it]
    f32    : y
    q(v)   = clip(rint(v * f32(1 / s_next)), -127, 127) as int8,

the rounding the JAX package's compiled code takes (XLA fuses ``acc * m + b``
into an fma and multiplies by the float32 reciprocal of a constant scale).
The kernel (wgmma s8 x s8 -> s32 over rings of stages fed by TMA and
cp.async, tiles of output pixels by the whole of C_out up to 256, in one of
two forms by shape: see the source's note, and :func:`halo_stages`) keeps
the s32 sums in registers; PyTorch has no int8 convolution on CUDA
(``F.conv2d`` on int8 tensors wraps around on the CPU).

The activations are one (N, H, W, C) int8 tensor or two whose channels are
concatenated along K (the decoder's skip and upsample: the concatenation is
never written); each may be a strided view (a channel slice, a window) as
long as its channels are contiguous and its pixels start on 16-byte
boundaries.  C_in must be a multiple of 16.  Weights are (C_out, kh, kw,
C_in) int8, contiguous (K contiguous, the kernel's layout).

The wrapper checks device, dtypes, shapes and alignment, allocates the
output with ``torch.empty``, launches on the current stream without
synchronising and counts its launches in ``LAUNCHES``.  A CUDA tensor goes to
the kernel or the call raises; a CPU tensor goes to the plain version.
``use_plain=True`` is a test hook that forces the plain version on any
device.

The plain version sums exactly: a float64 convolution of the int8 values is
exact (|products| <= 127², sums <= 9 * 512 * 127² < 2**53; rounded to the
integer in case a library algorithm on the card is not), never ``F.conv2d``
on int8 tensors.  It then takes the kernel's operations one by one: the
fma by ``ops/fma.fma32`` (correctly rounded), products by a float32 value,
the SiLU's exp as XLA's CPU code takes it (:func:`exp_xla`, the kernel's
``exp_xla``), so the plain version gives the same bits on the CPU and on
the card, and they are the JAX package's.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from openglottal_tpu_torch.ops import _build
from openglottal_tpu_torch.ops.fma import fma32

LAUNCHES = {"qconv": 0}

# Measurement hook, as in ``blobs_cuda``: a list here receives
# (wrapper name, inputs, keyword arguments) of every launch.
RECORD: list | None = None

EPILOGUES = {"relu_q": 0, "silu_q": 1, "f32": 2}
_configured = False


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class _Args(ctypes.Structure):
    """One launch's arguments as ``csrc/qconv.cu`` lays them out (``Args``)."""

    _fields_ = [("x0", ctypes.c_void_p), ("x1", ctypes.c_void_p),
                ("w", ctypes.c_void_p), ("sw", ctypes.c_void_p),
                ("b", ctypes.c_void_p), ("res", ctypes.c_void_p),
                ("out", ctypes.c_void_p),
                *[(f"{s}_{d}", ctypes.c_longlong)
                  for s in ("x0", "x1", "res") for d in ("img", "row", "pix")],
                *[(n, ctypes.c_int) for n in (
                    "c0", "c1", "n", "h", "w_in", "ho", "wo", "cout", "kh",
                    "kw", "stride", "pad", "epi")],
                ("sx", ctypes.c_float), ("rcp", ctypes.c_float),
                ("sres", ctypes.c_float)]


def _lib() -> ctypes.CDLL:
    global _configured
    lib = _build.load("qconv")
    if not _configured:
        lib.og_qconv_args_bytes.restype = ctypes.c_int
        if lib.og_qconv_args_bytes() != ctypes.sizeof(_Args):
            raise RuntimeError("qconv: the argument block's layout differs "
                               "between csrc/qconv.cu and its binding")
        lib.og_qconv.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.og_qconv.restype = ctypes.c_int
        _configured = True
    return lib


def tile_n(cout: int) -> int:
    """The kernel's tile width for C_out (``og_qconv_tile_n``): the whole
    of C_out up to 256 in one tile (16, 32, 64, 128 or 256 columns), so
    each im2col row is gathered once; C_out 512 takes two tiles of 256."""
    for bn in (16, 32, 64, 128):
        if cout <= bn:
            return bn
    return 256


SMEM_MAX = 232448        # a block's dynamic shared memory on the H100


def halo_stages(ho: int, wo: int, c0: int, c1: int, cout: int, kh: int,
                kw: int, stride: int) -> int:
    """Ring stages of the kernel's halo form for a layer, 0 where the layer
    takes the gathering form (``halo_plan`` in ``csrc/qconv.cu``, rule for
    rule): stride 1, C_in a multiple of 32, C_out <= 128, and the layer's
    weights with two stages or more (an even count, at most 8) of a tile's
    input window beside them in shared memory.  The kernel's shapes, tried
    in order (blocks of 64 output pixels a tile, thread blocks an SM, each
    of the two with half the shared memory): C_out <= 16: 4 and 2, then 4
    and 1; <= 32: 2 and 2, then 2 and 1; <= 64: 1 and 2, then 2 and 1;
    <= 128: 1 and 1.  A tile's rows are min(128, its pixels) wide (64
    where the output is 64 pixels wide or less); its window is its rows +
    kh - 1 input rows of its row's pixels + kw - 1."""
    cin = c0 + c1
    if stride != 1 or cin % 32 or cout > 128:
        return 0
    bn = tile_n(cout)
    shapes = {16: ((4, 2), (4, 1)), 32: ((2, 2), (2, 1)),
              64: ((1, 2), (2, 1)), 128: ((1, 1),)}[bn]
    for mb, per_sm in shapes:
        tw = min(128, mb * 64) if wo > 64 else 64
        hr, hw = mb * 64 // tw + kh - 1, tw + kw - 1
        if hw > 256:
            return 0
        weights = -(-kh * kw * cin // 128) * bn * 128
        stage = hr * (cin // 16) * (-(-hw * 16 // 128) * 128)
        budget = (SMEM_MAX - 2048) // 2 if per_sm == 2 else SMEM_MAX
        free = budget - 1024 - weights - 2 * 64 * bn - 8 * 17
        stages = min(free // stage, 8) & ~1
        if stages >= 2:
            return stages
    return 0


def f32(v: float) -> float:
    """``v`` rounded to float32 (a Python float holding a float32 value)."""
    return float(np.float32(v))


def reciprocal32(s: float) -> float:
    """f32(1 / f32(s)), the multiplier XLA puts in place of ``/ s``."""
    return float(np.float32(1.0) / np.float32(s))


def out_size(h: int, k: int, stride: int, pad: int) -> int:
    return (h + 2 * pad - k) // stride + 1


def _sources(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


# The float32 exp that XLA's CPU code emits (a Cephes polynomial after a
# two-constant reduction by ln 2, every multiply-add fused); csrc/qconv.cu's
# exp_xla takes the same steps with __fmaf_rn.
EXP_LO, EXP_HI = -87.8, 88.8
TINY32 = 2.0 ** -126                 # the least normal float32
EXP_LOG2E = 1.44269504088896341
EXP_C1, EXP_C2 = 0.693359375, -2.12194440e-4
EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
         1.6666665459e-1, 5.0000001201e-1)


def exp_xla(x):
    """exp of a float32 tensor as XLA's CPU code computes it, bit for bit:
    n = clamp(floor(fma(x, log2 e, 0.5)), -127, 127), a = x - n ln 2 in two
    fmas, a degree-5 polynomial in fmas, times 2**n (0 for n = -127), a
    subnormal result flushed to 0."""
    x = x.float().clamp(f32(EXP_LO), f32(EXP_HI))
    c = lambda v: torch.full_like(x, f32(v))                 # noqa: E731
    n = torch.floor(fma32(f32(EXP_LOG2E), x, c(0.5))).clamp(-127.0, 127.0)
    a = fma32(-f32(EXP_C1), n, x)
    a = fma32(-f32(EXP_C2), n, a)
    z = fma32(f32(EXP_P[0]), a, c(EXP_P[1]))
    for p in EXP_P[2:]:
        z = fma32(z, a, c(p))
    z = fma32(z, a * a, a) + 1.0
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return flush32(z * pow2)


def flush32(v):
    """A float32 tensor with its subnormal values flushed to zero, as XLA's
    CPU code runs (exp and 1 / (1 + exp) are never negative)."""
    return torch.where(v < TINY32, torch.zeros_like(v), v)


def qconv_plain(x, w8, sw, b, sx: float, stride: int = 1, pad: int = 1,
                epilogue: str = "relu_q", s_next: float | None = None,
                residual=None, s_res: float | None = None):
    """The plain version of :func:`qconv` (same arguments): an exact sum,
    then the kernel's epilogue operation by operation."""
    xs = torch.cat([s.to(torch.float64) for s in _sources(x)], -1)
    wd = w8.to(torch.float64).permute(0, 3, 1, 2)            # OIHW
    acc = F.conv2d(xs.permute(0, 3, 1, 2), wd, stride=stride, padding=pad)
    acc = acc.round().permute(0, 2, 3, 1).float()            # exact integers
    m = sw.float() * f32(sx)
    y = fma32(m, acc, b.float().expand_as(acc))
    if epilogue == "f32":
        return y.contiguous()
    if epilogue == "relu_q":
        v = y.clamp_min(0.0)
    elif epilogue == "silu_q":
        v = y * flush32(1.0 / (exp_xla(-y) + 1.0))
        if residual is not None:
            v = fma32(f32(s_res), residual.float(), v)
    else:
        raise ValueError(f"qconv: unknown epilogue {epilogue!r}")
    q = torch.round(v * reciprocal32(s_next)).clamp(-127.0, 127.0)
    return q.to(torch.int8).contiguous()


def _strides(t, name):
    """(img, row, pixel) strides of an NHWC int8 view with contiguous
    channels whose pixels start on 16-byte boundaries."""
    if t.dim() != 4 or t.dtype != torch.int8:
        raise ValueError(f"qconv: {name} must be (N, H, W, C) int8, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"qconv: {name}'s channels must be contiguous")
    st = t.stride()[:3]
    if t.data_ptr() % 16 or any(s % 16 for s in st):
        raise ValueError(f"qconv: {name} must start on a 16-byte boundary "
                         f"with 16-byte pixel strides (strides {t.stride()})")
    return st


def qconv(x, w8, sw, b, sx: float, stride: int = 1, pad: int = 1,
          epilogue: str = "relu_q", s_next: float | None = None,
          residual=None, s_res: float | None = None,
          use_plain: bool = False):
    """One int8 convolution layer -> (N, Ho, Wo, C_out) int8 (``relu_q``,
    ``silu_q``) or float32 (``f32``), contiguous.

    x: (N, H, W, C) int8, or a pair of such tensors (same N, H, W) whose
    channels are concatenated along K; w8 (C_out, kh, kw, C_in) int8; sw, b
    (C_out,) float32; sx the input's scale (a float); s_next the output's
    scale (the requantising epilogues); residual (N, Ho, Wo, C_out) int8 and
    its scale s_res (``silu_q`` only)."""
    xs = _sources(x)
    if epilogue not in EPILOGUES:
        raise ValueError(f"qconv: unknown epilogue {epilogue!r}")
    if epilogue != "f32" and s_next is None:
        raise ValueError("qconv: a requantising epilogue needs s_next")
    if residual is not None and epilogue != "silu_q":
        raise ValueError("qconv: a residual is added by silu_q only")
    if not 1 <= len(xs) <= 2:
        raise ValueError("qconv: x is one tensor or a pair")
    n, h, w = xs[0].shape[:3]
    if any(tuple(s.shape[:3]) != (n, h, w) for s in xs):
        raise ValueError("qconv: the K sources differ in (N, H, W)")
    cout, kh, kw, cin = w8.shape
    if sum(s.shape[-1] for s in xs) != cin:
        raise ValueError(f"qconv: x has {sum(s.shape[-1] for s in xs)} "
                         f"channels, the weights {cin}")
    ho, wo = out_size(h, kh, stride, pad), out_size(w, kw, stride, pad)
    if residual is not None and tuple(residual.shape) != (n, ho, wo, cout):
        raise ValueError(f"qconv: residual {tuple(residual.shape)} is not "
                         f"{(n, ho, wo, cout)}")
    kw_args = dict(sx=sx, stride=stride, pad=pad, epilogue=epilogue,
                   s_next=s_next, s_res=s_res)
    if use_plain or not xs[0].is_cuda:
        return qconv_plain(x, w8, sw, b, **kw_args, residual=residual)

    dev = xs[0].device
    if any(s.shape[-1] % 16 for s in xs):
        raise ValueError("qconv: each source's channels must be a multiple "
                         "of 16")
    tensors = (*xs, w8, sw, b) + ((residual,) if residual is not None else ())
    if any(t.device != dev for t in tensors):
        raise ValueError("qconv: the tensors lie on different devices")
    if w8.dtype != torch.int8 or not w8.is_contiguous():
        raise ValueError("qconv: w8 must be contiguous int8 (C_out, kh, kw, "
                         "C_in)")
    for name, t in (("sw", sw), ("b", b)):
        if t.dtype != torch.float32 or t.shape != (cout,) or \
                not t.is_contiguous():
            raise ValueError(f"qconv: {name} must be contiguous float32 "
                             f"({cout},)")
    if ho <= 0 or wo <= 0:
        raise ValueError(f"qconv: no output for {(h, w)} and a {kh}x{kw} "
                         f"kernel with pad {pad}")
    a = _Args()
    for i, s in enumerate(xs):
        st = _strides(s, f"x[{i}]")
        setattr(a, f"x{i}", s.data_ptr())
        setattr(a, f"c{i}", s.shape[-1])
        for d, v in zip(("img", "row", "pix"), st):
            setattr(a, f"x{i}_{d}", v)
    if residual is not None:
        if residual.dtype != torch.int8 or (cout > 1 and residual.stride(-1)
                                            != 1):
            raise ValueError("qconv: residual must be int8 with contiguous "
                             "channels")
        a.res = residual.data_ptr()
        a.res_img, a.res_row, a.res_pix = residual.stride()[:3]
        a.sres = f32(s_res)
    out = torch.empty((n, ho, wo, cout), device=dev,
                      dtype=torch.float32 if epilogue == "f32" else torch.int8)
    a.w, a.sw, a.b, a.out = (w8.data_ptr(), sw.data_ptr(), b.data_ptr(),
                             out.data_ptr())
    a.n, a.h, a.w_in, a.ho, a.wo, a.cout = n, h, w, ho, wo, cout
    a.kh, a.kw, a.stride, a.pad = kh, kw, stride, pad
    a.epi = EPILOGUES[epilogue]
    a.sx = f32(sx)
    a.rcp = reciprocal32(s_next) if s_next is not None else 0.0
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.og_qconv(ctypes.byref(a),
                           torch.cuda.current_stream().cuda_stream)
    _build.check(err, "qconv")
    LAUNCHES["qconv"] += 1
    if RECORD is not None:
        RECORD.append(("qconv", (xs, w8, sw, b, residual), kw_args))
    return out
