"""Port vs JAX package on the CPU: the temporal gate FSM, bit-equal.

The port's ``gate_scan`` on CPU tensors runs its plain version (the host
loop that the one-thread CUDA kernel is held against on the card); the JAX
side runs the ``lax.scan``.  Outputs are bool / int32 and must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglottal_tpu.models import gate as jgate
from openglottal_tpu_torch.data.synthetic import gate_stress_sequence
from openglottal_tpu_torch.models import gate as tgate


ALT_PARAMS = (1e6, 3, 1)   # max_shift_px, padding, max_hold_frames


def _random_sequence(seed, t=200, H=256, W=256, p_miss=0.25, step=18.0):
    rng = np.random.default_rng(seed)
    has = rng.random(t) > p_miss
    cx = np.cumsum(rng.normal(0, step, t)) % W
    cy = np.cumsum(rng.normal(0, step, t)) % H
    w = rng.uniform(8, 60, t)
    h = rng.uniform(8, 60, t)
    x1 = np.clip(cx - w / 2, 0, W - 1)
    y1 = np.clip(cy - h / 2, 0, H - 1)
    boxes = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
    return has, boxes


def _both(has, boxes, H=256, W=256, params=(30.0, 8, 3)):
    jv, jb = jgate.gate_scan(has, boxes, H, W,
                             params=jgate.GateParams(*params))
    tv, tb = tgate.gate_scan(torch.from_numpy(has), torch.from_numpy(boxes),
                             H, W, tgate.GateParams(*params))
    assert tv.dtype == torch.bool and tb.dtype == torch.int32
    return (np.asarray(jv), np.asarray(jb)), (tv.numpy(), tb.numpy())


# hold / expiry / drift-clamp / re-acquisition all occur in these walks:
# (seed, miss probability, walk step in px)
@pytest.mark.parametrize("seed,p_miss,step", [
    (0, 0.25, 18.0), (1, 0.25, 18.0), (2, 0.5, 18.0), (3, 0.1, 30.0),
    (4, 0.7, 5.0), (5, 0.25, 45.0)])
def test_gate_scan_random_walks_bit_equal(seed, p_miss, step):
    has, boxes = _random_sequence(seed, p_miss=p_miss, step=step)
    (jv, jb), (tv, tb) = _both(has, boxes)
    assert 0 < jv.sum() < len(jv) or p_miss < 0.2
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tb, jb)


def test_gate_hold_then_zero_then_fresh():
    has = np.array([True] + [False] * 6 + [True])
    boxes = np.tile(np.array([100.0, 100.0, 140.0, 150.0], np.float32), (8, 1))
    boxes[7] = [200.0, 200.0, 230.0, 230.0]     # far away: fresh, no clamp
    (jv, jb), (tv, tb) = _both(has, boxes)
    assert list(tv) == [True] * 4 + [False] * 3 + [True]
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tb, jb)


def test_gate_drift_clamp_holds_previous():
    has = np.array([True, True, True])
    boxes = np.array([[100, 100, 120, 120], [180, 180, 200, 200],
                      [118, 100, 138, 120]], np.float32)   # jump 113, then 18
    (jv, jb), (tv, tb) = _both(has, boxes)
    assert tuple(tb[1]) == tuple(tb[0]) and tuple(tb[2]) != tuple(tb[0])
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tb, jb)


def test_gate_jump_exactly_at_limit_is_accepted():
    has = np.array([True, True])
    boxes = np.array([[100, 100, 120, 120], [130, 100, 150, 120]], np.float32)
    (jv, jb), (tv, tb) = _both(has, boxes)
    assert tuple(tb[1]) != tuple(tb[0])
    np.testing.assert_array_equal(tb, jb)


@pytest.mark.parametrize("H,W", [(256, 256), (64, 48)])
def test_gate_border_clamp_and_oversized_box(H, W):
    """Boxes at the border are shifted inside; a box wider than the frame
    makes lo > hi in the clip, which must give hi; fractional sizes are
    truncated toward zero."""
    has = np.ones(6, bool)
    boxes = np.array([[0.2, 0.7, 30.9, 20.4],
                      [W - 20.5, H - 9.5, W - 0.5, H - 0.25],
                      [W - 25.0, H - 12.0, W + 5.0, H + 3.0],
                      [-10.0, -8.0, 12.5, 11.5],
                      [1.0, 1.0, W + 40.0, 30.0],
                      [3.0, 2.0, 20.0, H + 90.0]], np.float32)
    (jv, jb), (tv, tb) = _both(has, boxes, H, W, params=ALT_PARAMS)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tb, jb)


@pytest.mark.parametrize("seed,p_miss", [(9, 0.25), (10, 0.6), (11, 0.8)])
def test_gate_other_params_bit_equal(seed, p_miss):
    """Odd padding, one held frame, no drift clamp (each distinct parameter
    set costs the JAX side a compile, so the tests share one)."""
    has, boxes = _random_sequence(seed, t=120, p_miss=p_miss)
    (jv, jb), (tv, tb) = _both(has, boxes, params=ALT_PARAMS)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tb, jb)


def test_gate_scan_carry_chunks_equal_whole():
    has, boxes = _random_sequence(21, t=90)
    h_t, b_t = torch.from_numpy(has), torch.from_numpy(boxes)
    wv, wb = tgate.gate_scan(h_t, b_t, 256, 256)
    st = tgate.gate_init()
    vs, bs = [], []
    for i in range(0, 90, 32):
        st, (v, b) = tgate.gate_scan_carry(st, h_t[i:i + 32], b_t[i:i + 32],
                                           256, 256)
        vs.append(v)
        bs.append(b)
    assert torch.equal(torch.cat(vs), wv) and torch.equal(torch.cat(bs), wb)


def test_gate_rejects_bad_shapes():
    with pytest.raises(ValueError):
        tgate.gate_scan(torch.ones(4, dtype=torch.bool), torch.zeros((3, 4)),
                        256, 256)


def _carry_bits(st):
    """A carry of either package as 6 ints (floats by their bits)."""
    v = [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
         for x in st]
    f = np.array([v[1], v[2]], np.float32).view(np.int32)
    return [int(bool(v[0])), int(f[0]), int(f[1]), int(v[3]), int(v[4]),
            int(v[5])]


def _stress_both(t, carried, cuts=()):
    """The stress sequence of length t through the JAX package's
    gate_scan_carry in one call and through the port in segments cut at
    ``cuts``, from gate_init (what gate_scan runs) or from the sequence's
    carried-in valid state.  Returns (jax, port) as ((valid, boxes), carry)."""
    has, boxes, s0 = gate_stress_sequence(t, seed=t)
    if carried:
        jst = jgate.GateState(jnp.bool_(s0[0]), jnp.float32(s0[1]),
                              jnp.float32(s0[2]), jnp.int32(s0[3]),
                              jnp.int32(s0[4]), jnp.int32(s0[5]))
        tst = tgate.GateState(*s0)
    else:
        jst, tst = jgate.gate_init(), tgate.gate_init()
    jnew, (jv, jb) = jgate.gate_scan_carry(jst, has, boxes, 256, 256)
    vs, bs = [], []
    for a, b in zip((0, *cuts), (*cuts, t)):
        tst, (v, bx) = tgate.gate_scan_carry(tst, torch.from_numpy(has[a:b]),
                                             torch.from_numpy(boxes[a:b]),
                                             256, 256)
        vs.append(v)
        bs.append(bx)
    return (((np.asarray(jv), np.asarray(jb)), _carry_bits(jnew)),
            ((torch.cat(vs).numpy(), torch.cat(bs).numpy()),
             _carry_bits(tst)))


# the sequences the card's check holds the CUDA kernel to: jumps of exactly
# max_shift and one float32 ulp either side, rejections, holds, expiry,
# re-acquisition, boxes outside and larger than the frame; 4097 frames cross
# the kernel's 4096-frame tile
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("t", [33, 4097])
def test_gate_stress_sequence_bit_equal(t, carried):
    ((jv, jb), jc), ((tv, tb), tc) = _stress_both(t, carried)
    assert 0 < jv.sum() < t
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tb, jb)
    assert tc == jc


def test_gate_stress_carry_chunks_cut_at_4096():
    """Segments cut inside a tile and at the tile boundary, the carry passed
    on: equal to the JAX package's one call."""
    ((jv, jb), jc), ((tv, tb), tc) = _stress_both(4097, True, (1000, 4096))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tb, jb)
    assert tc == jc
