"""Port vs JAX package on the CPU: blur, masked percentiles, the threshold
chain and the kinematic features.  Inputs are made with numpy from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglottal_tpu import features as jfeat
from openglottal_tpu.models import tracker as jtracker
from openglottal_tpu.ops import blur as jblur
from openglottal_tpu.ops import histogram as jhist
from openglottal_tpu_torch import features as tfeat
from openglottal_tpu_torch.data.synthetic import thresh_stress_sequence
from openglottal_tpu_torch.models import tracker as ttracker
from openglottal_tpu_torch.ops import blur as tblur
from openglottal_tpu_torch.ops import histogram as thist


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes side by side; PyTorch's
    intra-op thread pool in each of them oversubscribes the cores and makes
    the many small tensor ops here an order of magnitude slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("ksize,sigma", [(13, 0.0), (5, 0.0), (21, 5.0),
                                         (1, 0.0), (31, 0.0)])
def test_gaussian_blur(ksize, sigma):
    """Bit-equal: the same taps in the same order, rounded as the compiled
    reference rounds them (tap 0 fused over the rounded product of tap 1,
    then one fma per tap), on random floats and on integer-valued absdiffs
    (what the trackers blur)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 255, (3, 48, 40)).astype(np.float32)
    d = rng.integers(0, 256, (2, 48, 40)).astype(np.float32)
    np.testing.assert_array_equal(tblur.gaussian_kernel_1d(ksize, sigma),
                                  jblur.gaussian_kernel_1d(ksize, sigma))
    for v in (x, d):
        got = tblur.gaussian_blur(torch.from_numpy(v), ksize, sigma).numpy()
        want = np.asarray(jblur.gaussian_blur(jnp.asarray(v), ksize,
                                              sigma=sigma))
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def _pct_case(seed, t=9, hw=(24, 32)):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 256, (t, *hw)).astype(np.float32)
    m = rng.random((t, *hw)) < rng.uniform(0.02, 0.9, (t, 1, 1))
    m[0] = False                       # empty mask
    m[1] = False
    m[1].reshape(-1)[:7] = True        # n <= 10
    m[2] = True                        # everything
    v[3] = 17.0                        # constant frame
    return v, m


@pytest.mark.parametrize("q", [30.0, 5.0, 50.0, 100.0, 0.0])
def test_masked_percentile_u8_batch_exact(q):
    v, m = _pct_case(int(q))
    gv, gn = thist.masked_percentile_u8_batch(torch.from_numpy(v),
                                              torch.from_numpy(m), q)
    wv, wn = jhist.masked_percentile_u8_batch(jnp.asarray(v), jnp.asarray(m), q)
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    keep = np.asarray(wn) > 0           # value is garbage where n == 0
    np.testing.assert_array_equal(gv.numpy()[keep], np.asarray(wv)[keep])


@pytest.mark.parametrize("q", [30.0, 5.0, 99.0])
def test_percentile_from_hist_exact(q):
    v, m = _pct_case(3)
    for i in range(v.shape[0]):
        gh = thist.masked_histogram_u8(torch.from_numpy(v[i]),
                                       torch.from_numpy(m[i]))
        wh = jhist.masked_histogram_u8(jnp.asarray(v[i]), jnp.asarray(m[i]))
        np.testing.assert_array_equal(gh.numpy(), np.asarray(wh))
        gv, gn = thist.percentile_from_hist(gh, q)
        wv, wn = jhist.percentile_from_hist(wh, q)
        assert float(gn) == float(wn)
        if float(wn) > 0:
            assert float(gv) == float(wv), (i, q)
        got = thist.masked_percentile_u8(torch.from_numpy(v[i]),
                                         torch.from_numpy(m[i]), q, 127.0)
        want = jhist.masked_percentile_u8(jnp.asarray(v[i]), jnp.asarray(m[i]),
                                          q, 127.0)
        assert float(got) == float(want)


def _thresh_both(th0, cur, n_px, active, beta):
    got = ttracker._thresh_chain(torch.tensor(th0), torch.from_numpy(cur),
                                 torch.from_numpy(n_px),
                                 torch.from_numpy(active), beta).numpy()
    want = np.asarray(jtracker._thresh_chain(
        jnp.asarray(th0), jnp.asarray(cur), jnp.asarray(n_px),
        jnp.asarray(active), beta))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed,beta", [(0, 0.7), (1, 0.7), (2, 0.9), (3, 0.35)])
def test_thresh_chain_bit_equal(seed, beta):
    """T sequential float32 steps: identical bits, including the fallback
    steps (n <= 10) and an inactive tail."""
    rng = np.random.default_rng(seed)
    t = 300
    cur = (rng.integers(0, 256, t) + rng.choice([0.0, 0.3, 0.7], t)
           ).astype(np.float32)
    n_px = rng.choice([0.0, 5.0, 10.0, 11.0, 400.0], t).astype(np.float32)
    active = np.arange(t) < 280
    th0 = np.float32(rng.uniform(20, 200))
    _thresh_both(th0, cur, n_px, active, beta)


# the sequences the card's check holds the CUDA kernel to: n_px at 10 and one
# float32 ulp above it, an inactive tail; T = 1 is the sequential trackers'
# launch
@pytest.mark.parametrize("t", [1, 600])
def test_thresh_chain_stress_sequence_bit_equal(t):
    _thresh_both(*thresh_stress_sequence(t, seed=t), 0.7)


def _wave(kind, t=160):
    rng = np.random.default_rng(4)
    i = np.arange(t)
    if kind == "sine":
        return (500 * (1 - np.cos(2 * np.pi * 0.05 * i))
                + rng.normal(0, 5, t)).clip(0).astype(np.float32)
    if kind == "ramp":                 # FFT peak at bin 1 -> f0 None
        return (10.0 * i).astype(np.float32)
    if kind == "short":
        return np.array([3.0, 9.0, 4.0, 8.0, 2.0], np.float32)
    return np.zeros(t, np.float32)     # silent


@pytest.mark.parametrize("kind", ["sine", "ramp", "short", "silent"])
def test_kinematic_features(kind):
    """rtol 1e-4: float32 reductions and an FFT in two libraries."""
    a = _wave(kind)
    got, want = tfeat.kinematic_features(a), jfeat.kinematic_features(a)
    if kind == "silent":
        assert got is None and want is None
        return
    assert set(got) == set(want)
    assert got["f0"] == want["f0"] or (
        got["f0"] is not None and want["f0"] is not None
        and abs(got["f0"] - want["f0"]) < 1e-7)
    if kind == "ramp":
        assert got["f0"] is None
    for k in ("area_mean", "area_std", "area_range", "open_quotient",
              "periodicity", "cv"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    np.testing.assert_array_equal(got["_area"], want["_area"])


def test_kinematic_features_empty_is_none():
    assert tfeat.kinematic_features(np.zeros(0, np.float32)) is None
