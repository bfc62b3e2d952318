"""The training kernels' plain versions and order models on inputs that are
hard for them (``tools/train_stress.py``), on the CPU.

Augment families (batches of 1, 3, 16 and 17; every flag on and off; angles
of ±30, ±90, 180 and 45 degrees, scales of 0.85 and 1.15, 3- and 5-tap
blurs, brightness and contrast at their limits; black, saturated and
constant frames): ``unet_augment_plain`` against the JAX package's
transform (``openglottal_tpu/data/augment.py:112``, jitted, given the same
draws and noise, cos / sin / taps from its own formulas) with the mask
exact and the image within 1e-6 (it may differ only through each image's
mean, a float32 sum of 65,536 values taken in another order).

Loss families (logits of ±40, ±88 and ±90, soft targets, targets all 0 and
all 1, masked rows, every row invalid, other sizes): ``bce_dice_sums_plain`` / ``_loss_from_sums``
against the JAX package's loss (``openglottal_tpu/train/unet_trainer.py``
``_loss_fn`` at :47-50, and the masked loss of ``unet_eval_loss_masked`` at
:89-109 written out as there), both jitted: the loss and each of the four
sums within 1e-5 of the largest (float32 sums of up to 2**20 terms in
XLA's order and torch's; 1.8e-6 and 2.2e-6 measured at 2**20 terms).

The order models (``augment_model``: the plain augment with the kernel's
per-tile mean; ``bce_dice_model``: the kernel's grid-stride sums, warp
trees and double finish) within ``TRAIN_TOL`` of the plain versions (the
augment's mask exact, its image within 1e-5; the loss and its sums within
1e-4 of their largest, the count equal): on the card they are held
bit-equal to ``og_unet_augment`` and ``og_bce_dice`` (``chip_smoke.py
--train``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openglottal_tpu.data import augment as jaug
from openglottal_tpu.train import unet_trainer as jtr
from openglottal_tpu_torch.ops import train_cuda
from openglottal_tpu_torch.tools import train_stress as ts

TRAIN_TOL = ts.TRAIN_TOL
_PLAIN = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the cores: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ── og_unet_augment ─────────────────────────────────────────────────────────

@jax.jit
def _jax_augment(imgs, msks, p, noise):
    """augment_batch's body (data/augment.py:112-140) with the draws given."""
    imgs = imgs.astype(jnp.float32) / 255.0
    msks = msks.astype(jnp.float32)

    def geo(img, msk, hf, vf, ang, sc):
        sy, sx = jaug._affine_coords(hf, vf, ang, sc)
        return (jaug._gather_bilinear(img, sy, sx),
                jaug._gather_nearest(msk, sy, sx))

    i1, m = jax.vmap(geo)(imgs, msks, p["hflip"], p["vflip"], p["angle"],
                          p["scale"])
    i2 = jnp.where(p["do_noise"][:, None, None],
                   jnp.clip(i1 + noise * p["sigma_n"][:, None, None], 0, 1),
                   i1)
    i3 = jnp.where(p["do_blur"][:, None, None],
                   jax.vmap(jaug._blur5)(i2, p["k5"], p["sigma_b"]), i2)
    i4 = jnp.clip(i3 * p["bright"][:, None, None], 0, 1)
    mean = i4.mean(axis=(1, 2), keepdims=True)
    c = p["contrast"][:, None, None]
    return jnp.clip(c * i4 + (1 - c) * mean, 0, 1), m


@jax.jit
def _jax_params(p):
    th = jnp.deg2rad(p["angle"])
    x = jnp.arange(5, dtype=jnp.float32) - 2.0

    def taps(k5, s):
        k = jnp.exp(-(x ** 2) / (2 * s ** 2))
        k = jnp.where(k5, k, jnp.where(jnp.abs(x) <= 1, k, 0.0))
        return k / k.sum()

    return jnp.cos(th), jnp.sin(th), jax.vmap(taps)(p["k5"], p["sigma_b"])


def _jax_rows(d):
    """The kernel's parameter rows from the JAX package's cos, sin, taps."""
    ct, st, k = (np.asarray(t) for t in _jax_params(d))
    rows = np.zeros((len(ct), train_cuda.N_AUG_PARAMS), np.float32)
    rows[:, 0], rows[:, 1] = d["hflip"], d["vflip"]
    rows[:, 2], rows[:, 3], rows[:, 4] = ct, st, d["scale"]
    rows[:, 5], rows[:, 6], rows[:, 7] = d["do_noise"], d["sigma_n"], \
        d["do_blur"]
    rows[:, 8:13] = k
    rows[:, 13], rows[:, 14] = d["bright"], d["contrast"]
    return torch.from_numpy(rows)


def _augment(family):
    """(case, torch inputs, plain output) of a family, made once."""
    if family not in _PLAIN:
        case = ts.augment_case(family)
        inputs = (torch.from_numpy(case["imgs"]),
                  torch.from_numpy(case["msks"]), _jax_rows(case["draws"]),
                  torch.from_numpy(case["noise"]))
        _PLAIN[family] = case, inputs, train_cuda.unet_augment_plain(*inputs)
    return _PLAIN[family]


@pytest.mark.parametrize("family", ts.AUG_FAMILIES)
def test_plain_augment_matches_jax_on_each_family(family):
    case, _, (img, msk) = _augment(family)
    want_img, want_msk = (np.asarray(t) for t in _jax_augment(
        case["imgs"], case["msks"], case["draws"], case["noise"]))
    assert img.shape == (len(case["imgs"]), 256, 256)
    np.testing.assert_array_equal(msk.numpy(), want_msk)
    np.testing.assert_allclose(img.numpy(), want_img, rtol=0, atol=1e-6)


@pytest.mark.parametrize("family", ts.AUG_FAMILIES)
def test_augment_order_model_within_tol_of_plain(family):
    _, inputs, (img, msk) = _augment(family)
    m_img, m_msk = ts.augment_model(*inputs)
    assert torch.equal(m_msk, msk)
    assert float((m_img - img).abs().max()) <= TRAIN_TOL["unet_augment"]


def test_tile_mean_adds_in_the_kernels_order():
    """One tile's column sums, its warps' trees and the tiles' order, held
    against a scalar walk of the same additions."""
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.random((1, 256, 256)).astype(np.float32))
    v = img[0].numpy()
    f = np.float32
    parts = []
    for t in range(16):
        cols = [f(0)] * 256
        for x in range(256):
            for r in range(16):
                cols[x] = f(cols[x] + v[t * 16 + r, x])
        warps = []
        for w in range(8):
            lane = cols[w * 32:(w + 1) * 32]
            o = 16
            while o:
                lane = [f(lane[i] + lane[i + o]) for i in range(o)]
                o //= 2
            warps.append(lane[0])
        s = f(0)
        for w in warps:
            s = f(s + w)
        parts.append(s)
    s = f(0)
    for p in parts:
        s = f(s + p)
    mean = ts.tile_mean(img)
    assert mean.shape == (1, 1, 1)
    assert mean.view(torch.int32).item() == \
        torch.tensor(f(s / f(65536))).view(torch.int32).item()


# ── og_bce_dice ─────────────────────────────────────────────────────────────

@jax.jit
def _jax_sums_loss(x, t, v):
    """The four sums and the loss of the masked eval loss
    (unet_trainer.py:101-109, v the row weights)."""
    per_row = x[0].size
    w = v.reshape((-1,) + (1,) * (x.ndim - 1))
    bce = (optax.sigmoid_binary_cross_entropy(x, t) * w).sum()
    p = jax.nn.sigmoid(x) * w
    tt = t * w
    n_px = w.sum() * per_row
    dl = 1.0 - (2.0 * (p * tt).sum() + 1e-6) / (p.sum() + tt.sum() + 1e-6)
    return (jnp.stack([bce, (p * tt).sum(), p.sum(), tt.sum()]),
            0.5 * (bce / jnp.maximum(n_px, 1.0)) + 0.5 * dl)


_jax_loss_fn = jax.jit(jtr._loss_fn)


def _loss_cases():
    return [(fam, *case) for fam in ts.LOSS_FAMILIES
            for case in ts.loss_cases(fam)]


@pytest.mark.parametrize("family", ts.LOSS_FAMILIES)
def test_plain_loss_matches_jax_on_each_family(family):
    for label, x, t, valid in ts.loss_cases(family):
        v = np.ones(len(x), np.float32) if valid is None else \
            valid.astype(np.float32)
        want_sums, want_loss = (np.asarray(a) for a in _jax_sums_loss(x, t,
                                                                       v))
        if valid is None:     # the training loss itself
            np.testing.assert_allclose(float(_jax_loss_fn(x, t)), want_loss,
                                       rtol=1e-6, err_msg=label)
        sums, n = train_cuda.bce_dice_sums_plain(
            torch.from_numpy(x), torch.from_numpy(t),
            None if valid is None else torch.from_numpy(valid))
        loss = train_cuda._loss_from_sums(sums, n)
        np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5,
                                   atol=1e-12, err_msg=label)
        np.testing.assert_allclose(sums.numpy(), want_sums, rtol=0,
                                   atol=1e-5 * max(np.abs(want_sums).max(),
                                                   1e-30), err_msg=label)


@pytest.mark.parametrize("family", ts.LOSS_FAMILIES)
def test_loss_order_model_within_tol_of_plain(family):
    for label, x, t, valid in ts.loss_cases(family):
        x, t = torch.from_numpy(x), torch.from_numpy(t)
        valid = None if valid is None else torch.from_numpy(valid)
        sums, n = train_cuda.bce_dice_sums_plain(x, t, valid)
        loss = train_cuda._loss_from_sums(sums, n)
        m_sums, m_n, m_loss = ts.bce_dice_model(x, t, valid)
        assert m_sums.dtype == m_n.dtype == m_loss.dtype == torch.float32
        assert float(m_n) == float(n), label
        tol = TRAIN_TOL["bce_dice"]
        assert ts.loss_tolerance_ok(m_sums, sums, tol), label
        assert ts.loss_tolerance_ok(m_loss.reshape(1), loss.reshape(1),
                                    tol), label


def test_bce_dice_model_adds_in_the_kernels_order():
    """A small grid (3 blocks of 256 threads) against a scalar walk of the
    kernel's additions: each thread its elements i, i + 768, ... in order,
    the warps' trees, the 8 warps in order, the blocks' partials in double
    (thread k of the finish from 0, then halves onto the first)."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 3, (5, 1, 19, 23)).astype(np.float32)
    t = (rng.random(x.shape) > 0.5).astype(np.float32)
    valid = np.array([True, True, False, True, True])
    terms = ts.bce_terms(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    n, per_row, blocks = x.size, x[0].size, 3
    f = np.float32
    nt = blocks * 256
    sums = np.zeros((4, nt), f)
    for th in range(nt):
        for i in range(th, n, nt):
            if valid[i // per_row]:
                for j in range(4):
                    sums[j, th] = f(sums[j, th] + terms[j, i])
    partial = np.zeros((4, blocks), f)
    for blk in range(blocks):
        for j in range(4):
            warps = []
            for w in range(8):
                at = blk * 256 + w * 32
                lane = list(sums[j, at:at + 32])
                o = 16
                while o:
                    lane = [f(lane[k] + lane[k + o]) for k in range(o)]
                    o //= 2
                warps.append(lane[0])
            s = f(0)
            for w in warps:
                s = f(s + w)
            partial[j, blk] = s
    acc = np.zeros((4, 256))
    for k in range(256):
        for q in range(k, blocks, 256):
            acc[:, k] = acc[:, k] + partial[:, q].astype(np.float64)
    h = 128
    while h:
        acc[:, :h] = acc[:, :h] + acc[:, h:2 * h]
        h //= 2
    m_sums, m_n, _ = ts.bce_dice_model(torch.from_numpy(x),
                                       torch.from_numpy(t),
                                       torch.from_numpy(valid), blocks=blocks)
    np.testing.assert_array_equal(m_sums.numpy().view(np.int32),
                                  acc[:, 0].astype(f).view(np.int32))
    assert float(m_n) == 4 * per_row


def test_families_are_seeded_and_shaped():
    a, b = ts.augment_case("b17_frames", 5), ts.augment_case("b17_frames", 5)
    assert all(np.array_equal(a[k], b[k]) for k in ("imgs", "msks", "noise"))
    assert [len(ts.augment_case(f)["imgs"]) for f in ts.AUG_FAMILIES] == \
        [1, 3, 3, 16, 17]
    rows = ts.augment_params(a["draws"])
    assert rows.shape == (17, train_cuda.N_AUG_PARAMS)
    assert rows.dtype == torch.float32
    cases = _loss_cases()
    assert {c[0] for c in cases} == set(ts.LOSS_FAMILIES)
    assert any(v is not None and not v.any() for *_, v in cases)
    assert any((np.abs(x) == 88.0).any() for _, _, x, _, _ in cases)
    with pytest.raises(ValueError, match="unknown"):
        ts.augment_case("nope")
    with pytest.raises(ValueError, match="unknown"):
        ts.loss_cases("nope")


def test_stress_inputs_hold_every_case_and_bits_tell_signed_zeros_apart():
    """``stress_inputs`` (what ``chip_smoke.py --train`` launches) gives every
    family's cases, the unaligned augment case one byte past an allocation;
    ``same_bits`` is equality of the bits (-0.0 is not 0.0)."""
    items = ts.stress_inputs(torch.device("cpu"))
    aug = [(label, x) for kind, label, x in items if kind == "augment"]
    loss = [label for kind, label, _ in items if kind == "loss"]
    assert [label for label, _ in aug] == [
        *ts.AUG_FAMILIES[:2], "b3_all_on unaligned", *ts.AUG_FAMILIES[2:]]
    assert loss == [c[0] for f in ts.LOSS_FAMILIES for c in ts.loss_cases(f)]
    on, unaligned = aug[1][1], aug[2][1]
    assert unaligned[0].data_ptr() % 16 != 0
    assert ts.same_bits(on, unaligned)
    assert not ts.same_bits((torch.tensor([0.0]),), (torch.tensor([-0.0]),))
    assert torch.equal(torch.tensor([0.0]), torch.tensor([-0.0]))


def test_train_cycles_marks_every_barrier_of_a_copy_and_csrc_keeps_none():
    """``tools/train_cycles.py`` instruments a copy of ``csrc/train.cu``: a
    mark where each kernel starts, after each barrier of the two redesigned
    kernels (``__syncthreads``, ``cluster_wait``, ``mbar_wait``) and at each
    end; the shipped source holds no clock reads."""
    import re

    from openglottal_tpu_torch.ops import _build
    from openglottal_tpu_torch.tools import blob_cycles, train_cycles

    src = (_build.CSRC_DIR / "train.cu").read_text()
    code = re.sub(r"//[^\n]*", "", src)
    assert "clock64" not in code and "og_train_occupancy" not in code
    text = blob_cycles.instrument(src, train_cycles._BARRIER,
                                  train_cycles._OCCUPANCY)
    for kernel in ("augment_kernel", "bce_dice_kernel"):
        start = re.search(rf"\b{kernel}\(", src).end()
        body = src[src.index("{", start):]
        body = body[:blob_cycles._body_end(body, 0) + 1]
        barriers = len(train_cycles._BARRIER.findall(body))
        assert barriers >= 4
        start = re.search(rf"\b{kernel}\(", text).end()
        got = text[text.index("{", start):]
        got = got[:blob_cycles._body_end(got, 0) + 1]
        assert got.count("og_mark(og_k);") == barriers + 1
        assert got.count("og_end(og_k);") == 1 + body.count("return;")
    for entry in ("og_read_pass_clock", "og_clear_pass_clock",
                  "og_train_occupancy", "og_unet_augment", "og_bce_dice"):
        assert f"int {entry}(" in text
