"""Roundings the port writes out instead of leaving to a library, held bit
for bit against the reference on the CPU: the float32 exp of XLA's CPU code
(``ops/qconv_cuda.exp_xla``, the SiLU of og_qconv's ``silu_q`` and of its
plain version), cv2's INTER_LINEAR (``ops/resize.resize_linear_cv2``, for
the compat trackers and the host-side letterbox), and the int8 kernel's
tile widths and forms as the wrapper states them (``ops/qconv_cuda.tile_n``,
``halo_stages``; ``chip_smoke.py`` holds the built kernel to the same)."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglottal_tpu_torch.ops.qconv_cuda import (
    exp_xla,
    flush32,
    halo_stages,
    tile_n,
)
from openglottal_tpu_torch.ops.resize import resize_linear_cv2


def test_exp_xla_bit_equal_to_jitted_jax_exp():
    """exp and the SiLU over normal draws, a dense sweep of [-100, 100]
    (both clamps, the subnormal flush, n = -127) and the special points."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        (rng.standard_normal(200_000) * 8).astype(np.float32),
        np.linspace(-100, 100, 40_001, dtype=np.float32),
        np.float32([0.0, -0.0, -87.8, 88.8, -87.79, 88.79, 1e-30, -1e-30])])
    want = np.asarray(jax.jit(jnp.exp)(x))
    got = exp_xla(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    t = torch.from_numpy(x)
    silu = (t * flush32(1.0 / (exp_xla(-t) + 1.0))).numpy()
    want = np.asarray(jax.jit(jax.nn.silu)(x))
    np.testing.assert_array_equal(silu.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("channels", [0, 3])
def test_resize_linear_cv2_uint8_any_shape(channels):
    """uint8 through the 11-bit fixed point: equal to cv2 on random sizes
    up and down, single rows and columns, exact halvings."""
    rng = np.random.default_rng(channels)
    sizes = [(1, 7, 5, 9), (9, 1, 4, 6), (64, 64, 32, 32), (100, 90, 50, 45)]
    sizes += [tuple(int(v) for v in rng.integers(1, 120, 4))
              for _ in range(12)]
    for h, w, oh, ow in sizes:
        shape = (h, w, channels) if channels else (h, w)
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        np.testing.assert_array_equal(
            resize_linear_cv2(img, ow, oh),
            cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR),
            err_msg=str((h, w, oh, ow)))


def test_resize_linear_cv2_float32_frames():
    """float32 frames of two rows or more: one fma a pass, equal to cv2."""
    rng = np.random.default_rng(5)
    for _ in range(10):
        h, w = (int(v) for v in rng.integers(2, 120, 2))
        oh, ow = (int(v) for v in rng.integers(1, 120, 2))
        img = (rng.random((h, w)) * 300 - 20).astype(np.float32)
        np.testing.assert_array_equal(
            resize_linear_cv2(img, ow, oh).view(np.int32),
            cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR
                       ).view(np.int32), err_msg=str((h, w, oh, ow)))


@pytest.mark.parametrize("cout,width", [
    (1, 16), (16, 16), (17, 32), (32, 32), (33, 64), (64, 64), (80, 128),
    (128, 128), (129, 256), (256, 256), (512, 256)])
def test_qconv_tile_width(cout, width):
    """The whole of C_out up to 256 in one tile; 512 as two tiles of 256."""
    assert tile_n(cout) == width
    assert -(-cout // width) == (2 if cout == 512 else 1)


# (output rows, columns, c0, c1, C_out, k, stride) -> the halo form's ring
# stages (0: the gathering form) on the U-Net's layers at 256² and the
# cases that fall off the halo form's rules
HALO_CASES = [
    ("enc0.1: two blocks an SM", (256, 256, 32, 0, 32, 3, 1), 6),
    ("enc1.1: two blocks an SM", (128, 128, 64, 0, 64, 3, 1), 4),
    ("enc2.0", (64, 64, 64, 0, 128, 3, 1), 8),
    ("enc2.1", (64, 64, 128, 0, 128, 3, 1), 2),
    ("dec1.0 weights too large", (64, 64, 128, 128, 128, 3, 1), 0),
    ("enc3.0 C_out 256", (32, 32, 128, 0, 256, 3, 1), 0),
    ("dec2.0: large weights, one block an SM", (128, 128, 64, 64, 64, 3, 1),
     2),
    ("dec3.0 two sources", (256, 256, 32, 32, 32, 3, 1), 2),
    ("window 162 wide: a partial tile", (162, 162, 32, 0, 32, 3, 1), 6),
    ("dec2.0 window", (84, 84, 64, 64, 64, 3, 1), 2),
    ("odd count of 64-pixel rows", (63, 64, 32, 0, 32, 3, 1), 8),
    ("rows of 30 pixels", (3, 30, 32, 0, 128, 3, 1), 8),
    ("stride 2", (64, 64, 32, 0, 64, 3, 2), 0),
    ("C_in 48", (64, 64, 48, 0, 32, 3, 1), 0),
    ("C_out 512", (64, 64, 32, 0, 512, 1, 1), 0),
    ("1x1", (32, 128, 64, 0, 64, 1, 1), 8),
]


@pytest.mark.parametrize("shape,stages", [c[1:] for c in HALO_CASES],
                         ids=[c[0] for c in HALO_CASES])
def test_qconv_halo_form(shape, stages):
    """Which layers take the halo form (weights resident, the input window
    by TMA, taps read in place), and how deep its ring is."""
    ho, wo, c0, c1, cout, k, stride = shape
    assert halo_stages(ho, wo, c0, c1, cout, k, k, stride) == stages
