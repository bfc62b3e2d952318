"""U-Net augmentation, port vs JAX package on the CPU (``data/augment.py``
and the plain version of ``ops/train_cuda.unet_augment``).

Given the same per-sample parameters (the flags, the angle's cos and sin,
the scale, the blur taps as the JAX package computes them) and the same
noise, the plain version equals the JAX package's jitted transform
(``_affine_coords``, ``_gather_bilinear``, ``_gather_nearest``, noise,
``_blur5``, brightness, contrast): the source coordinates, the bilinear and
nearest gathers and the blur bit for bit, the mask exactly, and the image
within 1e-6 (it may differ only through each image's mean, a float32 sum of
65,536 values; 0 measured).  The draws are held by their statistics, as
tests/test_augment.py holds the JAX package's (the parity there is
statistical: the reference's RNG is unseeded).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglottal_tpu.data import augment as jaug
from openglottal_tpu_torch.data import augment
from openglottal_tpu_torch.ops import train_cuda

S = 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draws(b, seed, all_on=None):
    rng = np.random.default_rng(seed)

    def flag():
        if all_on is not None:
            return np.full(b, all_on)
        return rng.random(b) > 0.5

    p = {"hflip": flag(), "vflip": flag(),
         "angle": rng.uniform(-30, 30, b).astype(np.float32),
         "scale": rng.uniform(0.85, 1.15, b).astype(np.float32),
         "do_noise": flag(),
         "sigma_n": rng.uniform(0.01, 0.05, b).astype(np.float32),
         "do_blur": flag(), "k5": flag(),
         "sigma_b": rng.uniform(0.5, 1.5, b).astype(np.float32),
         "bright": np.where(flag(), rng.uniform(0.7, 1.3, b), 1).astype(
             np.float32),
         "contrast": np.where(flag(), rng.uniform(0.7, 1.3, b), 1).astype(
             np.float32)}
    p["angle"][:2] = [90.0, -30.0]           # odd angles
    return p, rng.standard_normal((b, S, S)).astype(np.float32)


@jax.jit
def _jax_augment(imgs, msks, p, noise):
    """augment_batch's body (data/augment.py:112-140) with the draws given."""
    imgs = imgs.astype(jnp.float32) / 255.0
    msks = msks.astype(jnp.float32)

    def geo(img, msk, hf, vf, ang, sc):
        sy, sx = jaug._affine_coords(hf, vf, ang, sc)
        return (jaug._gather_bilinear(img, sy, sx),
                jaug._gather_nearest(msk, sy, sx), sy, sx)

    i1, m, sy, sx = jax.vmap(geo)(imgs, msks, p["hflip"], p["vflip"],
                                  p["angle"], p["scale"])
    i2 = jnp.where(p["do_noise"][:, None, None],
                   jnp.clip(i1 + noise * p["sigma_n"][:, None, None], 0, 1),
                   i1)
    i3 = jnp.where(p["do_blur"][:, None, None],
                   jax.vmap(jaug._blur5)(i2, p["k5"], p["sigma_b"]), i2)
    i4 = jnp.clip(i3 * p["bright"][:, None, None], 0, 1)
    mean = i4.mean(axis=(1, 2), keepdims=True)
    c = p["contrast"][:, None, None]
    return (jnp.clip(c * i4 + (1 - c) * mean, 0, 1), m,
            {"sy": sy, "sx": sx, "i1": i1, "i2": i2, "i3": i3})


@jax.jit
def _jax_params(p):
    th = jnp.deg2rad(p["angle"])
    x = jnp.arange(5, dtype=jnp.float32) - 2.0

    def taps(k5, s):
        k = jnp.exp(-(x ** 2) / (2 * s ** 2))
        k = jnp.where(k5, k, jnp.where(jnp.abs(x) <= 1, k, 0.0))
        return k / k.sum()

    return jnp.cos(th), jnp.sin(th), jax.vmap(taps)(p["k5"], p["sigma_b"])


def _param_rows(p):
    ct, st, k = (np.asarray(t) for t in _jax_params(p))
    rows = np.zeros((len(ct), train_cuda.N_AUG_PARAMS), np.float32)
    rows[:, 0], rows[:, 1] = p["hflip"], p["vflip"]
    rows[:, 2], rows[:, 3], rows[:, 4] = ct, st, p["scale"]
    rows[:, 5], rows[:, 6], rows[:, 7] = p["do_noise"], p["sigma_n"], \
        p["do_blur"]
    rows[:, 8:13] = k
    rows[:, 13], rows[:, 14] = p["bright"], p["contrast"]
    return torch.from_numpy(rows)


def _frames(b, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, S, S)).astype(np.uint8)
    imgs[0] = 255                                 # saturated frame
    msks = np.zeros((b, S, S), np.uint8)
    msks[:, 90:170, 100:160] = 1
    msks[1] = 1                                   # full mask
    msks[2] = 0                                   # empty mask
    msks[3, :, :1] = 1                            # the frame's edge
    return imgs, msks


@pytest.mark.parametrize("flags", [None, True, False])
def test_plain_augment_matches_jax_given_the_draws(flags):
    b = 6
    imgs, msks = _frames(b)
    p, noise = _draws(b, seed=1 if flags is None else 2, all_on=flags)
    want_img, want_msk, mid = (jax.tree.map(np.asarray, t) for t in
                               _jax_augment(imgs, msks, p, noise))
    rows = _param_rows(p)
    img, msk = train_cuda.unet_augment(torch.from_numpy(imgs),
                                       torch.from_numpy(msks), rows,
                                       torch.from_numpy(noise))
    assert img.dtype == msk.dtype == torch.float32
    np.testing.assert_array_equal(msk.numpy(), want_msk)
    np.testing.assert_allclose(img.numpy(), want_img, rtol=0, atol=1e-6)
    # the pieces, bit for bit
    sy, sx = train_cuda.affine_coords(rows)
    np.testing.assert_array_equal(sy.numpy(), mid["sy"])
    np.testing.assert_array_equal(sx.numpy(), mid["sx"])
    x = torch.from_numpy(imgs).float() * train_cuda.INV255
    np.testing.assert_array_equal(
        train_cuda.gather_bilinear(x, sy, sx).numpy(), mid["i1"])
    np.testing.assert_array_equal(
        train_cuda.gather_nearest(torch.from_numpy(msks).float(), sy,
                                  sx).numpy(), want_msk)
    blurred = train_cuda.blur5(torch.from_numpy(mid["i2"]), rows[:, 8:13])
    on = p["do_blur"]
    np.testing.assert_array_equal(blurred.numpy()[on], mid["i3"][on])


def test_scale_by_reciprocal_is_the_jitted_division():
    """``/ 255`` under jit is ``* f32(1/255)`` (XLA's rewrite), which the
    port takes; eager division would differ."""
    x = np.arange(256, dtype=np.uint8)
    jitted = np.asarray(jax.jit(lambda v: v.astype(jnp.float32) / 255.0)(x))
    ours = (torch.from_numpy(x).float() * train_cuda.INV255).numpy()
    np.testing.assert_array_equal(ours, jitted)
    assert not np.array_equal(x.astype(np.float32) / np.float32(255), jitted)


def test_blur_taps_match_jax():
    p, _ = _draws(64, seed=3)
    _, _, k = _jax_params(p)
    ours = augment.blur_taps(torch.from_numpy(p["k5"]),
                             torch.from_numpy(p["sigma_b"]))
    np.testing.assert_allclose(ours.numpy(), np.asarray(k), rtol=1e-6)
    assert torch.all(ours[~torch.from_numpy(p["k5"])][:, [0, 4]] == 0)


def _draw_table(n, seed=7):
    params, noise = augment.sample_params(n, torch.Generator().manual_seed(
        seed))
    return params.numpy(), noise


def test_photometric_factor_distributions():
    """Brightness / contrast at p ~ 0.5 with factors ~ U[0.7, 1.3] on both
    sides of 1 (the JAX package's round-1 bug conditioned the factor on the
    flag); the draws are pairwise independent."""
    n = 4096
    rows, noise = _draw_table(n)
    for j in (13, 14):
        f = rows[:, j]
        applied = f[f != 1.0]
        assert 0.45 < len(applied) / n < 0.55
        assert applied.min() >= 0.7 and applied.max() <= 1.3
        assert abs(applied.mean() - 1.0) < 0.02
        assert 0.45 < (applied < 1.0).mean() < 0.55
        hist, _ = np.histogram(applied, bins=6, range=(0.7, 1.3))
        assert (hist > len(applied) / 6 * 0.66).all(), hist
    assert abs(np.corrcoef(rows[:, 13], rows[:, 14])[0, 1]) < 0.1
    assert abs(np.corrcoef(rows[:, 6], noise[:, 0, 0].numpy())[0, 1]) < 0.1


def test_geometric_draw_distributions():
    n = 4096
    rows, noise = _draw_table(n, seed=8)
    for j in (0, 1, 5, 7):
        assert 0.45 < rows[:, j].mean() < 0.55, j
    ang = np.degrees(np.arctan2(rows[:, 3], rows[:, 2]))
    assert ang.min() >= -30.0001 and ang.max() <= 30.0001
    assert abs(ang.mean()) < 1.0 and ang.std() > 15
    np.testing.assert_allclose(rows[:, 2] ** 2 + rows[:, 3] ** 2, 1.0,
                               atol=1e-6)
    scaled = rows[:, 4][rows[:, 4] != 1.0]
    assert 0.45 < len(scaled) / n < 0.55
    assert scaled.min() >= 0.85 and scaled.max() <= 1.15
    assert 0.01 <= rows[:, 6].min() and rows[:, 6].max() <= 0.05
    k3 = rows[:, 8] == 0
    assert 0.45 < k3.mean() < 0.55
    np.testing.assert_allclose(rows[:, 8:13].sum(1), 1.0, atol=1e-6)
    assert abs(float(noise.mean())) < 0.01 and abs(float(noise.std()) - 1) \
        < 0.01


def _patch_batch(b):
    imgs = np.zeros((b, S, S), np.uint8)
    msks = np.zeros((b, S, S), np.uint8)
    imgs[:, 100:160, 110:150] = 255
    msks[:, 100:160, 110:150] = 1
    return torch.from_numpy(imgs), torch.from_numpy(msks)


def test_augment_batch_range_geometry_and_area():
    """Outputs in [0, 1], masks binary; a bright patch on the mask stays on
    the transformed mask; the mask area stays within the scale's bounds;
    another seed gives another batch."""
    imgs, msks = _patch_batch(24)
    ai, am = augment.augment_batch(imgs, msks,
                                   torch.Generator().manual_seed(1))
    assert ai.min() >= 0 and ai.max() <= 1
    assert set(torch.unique(am).tolist()) <= {0.0, 1.0}
    for i in range(len(ai)):
        sel = am[i] > 0.5
        if sel.sum() < 50:
            continue
        assert ai[i][sel].mean() > ai[i][~sel].mean() + 0.2, i
    area0 = float(msks.sum())
    area1 = float(am.sum())
    assert 0.6 * area0 < area1 < 1.5 * area0
    ai2, _ = augment.augment_batch(imgs, msks,
                                   torch.Generator().manual_seed(2))
    assert not torch.allclose(ai, ai2)


def test_unet_augment_refuses_bad_inputs():
    imgs, msks = _patch_batch(2)
    rows = torch.zeros((2, train_cuda.N_AUG_PARAMS))
    noise = torch.zeros((2, S, S))
    with pytest.raises(ValueError):
        train_cuda.unet_augment(imgs[:, :128], msks, rows, noise)
    with pytest.raises(ValueError):
        train_cuda.unet_augment(imgs, msks.float(), rows, noise)
    with pytest.raises(ValueError):
        train_cuda.unet_augment(imgs, msks, rows[:, :8], noise)
