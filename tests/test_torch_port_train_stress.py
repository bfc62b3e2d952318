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

Backward families (rows not a multiple of 4, offset logits, one row,
all-invalid masked calls): ``bce_dice_grad_plain`` against ``jax.grad`` of
the JAX package's loss (``_loss_fn`` at :49-52, the masked loss of :89
written out) within ``TRAIN_TOL``.  TAL families (M = 1, 4, 8; invalid,
whole-frame, edge and zero-area gts; fewer than 10 candidates and none;
ties within and across gts; batches of 1 and 17; at 256² and 64²):
``tal_assign_plain`` against the JAX package's assignment
(``openglottal_tpu/train/yolo_loss.py:98-133``, jitted) with ``assigned``
and ``best_gt`` on assigned anchors exact and ``t_score`` within 1e-5, and
``tal_select_model`` (``og_tal_assign``'s selection, held bit-equal to the
kernel on the card) bit-equal to ``tal_assign_plain``, with the candidates
in anchor order and in a drawn order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openglottal_tpu.data import augment as jaug
from openglottal_tpu.train import unet_trainer as jtr
from openglottal_tpu.train import yolo_loss as jyl
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


def _jax_masked_loss(x, t, v):
    return _jax_sums_loss.__wrapped__(x, t, v)[1]


_jax_grad_loss = jax.jit(jax.grad(jtr._loss_fn))
_jax_grad_masked = jax.jit(jax.grad(_jax_masked_loss))


@pytest.mark.parametrize("family", ts.BWD_FAMILIES)
def test_plain_bwd_matches_jax_grad_on_each_family(family):
    """bce_dice_grad_plain (from the plain sums, g = 1) against jax.grad of
    the JAX package's loss, within TRAIN_TOL of the largest gradient."""
    for label, x, t, valid in ts.bwd_cases(family):
        if valid is None:
            want = np.asarray(_jax_grad_loss(x, t))
        else:
            want = np.asarray(_jax_grad_masked(x, t, valid.astype(np.float32)))
        xt, tt = torch.from_numpy(x), torch.from_numpy(t)
        vt = None if valid is None else torch.from_numpy(valid)
        sums, n = train_cuda.bce_dice_sums_plain(xt, tt, vt)
        got = train_cuda.bce_dice_grad_plain(xt, tt, vt, sums, n,
                                             torch.tensor(1.0)).numpy()
        assert got.shape == x.shape, label
        diff = float(np.abs(got - want).max())
        assert diff <= TRAIN_TOL["bce_dice_bwd"] * max(
            float(np.abs(want).max()), 1e-30), (label, diff)
        if valid is not None:
            assert not got[~valid].any(), label


# ── og_tal_assign ───────────────────────────────────────────────────────────

@jax.jit
def _jax_assign(cls_logits, pred_boxes, gt_boxes, gt_valid, pts):
    """yolo_loss.py:98-133 of the JAX package, as it computes the TAL
    assignment."""
    b, m = gt_boxes.shape[:2]
    cls_prob = jax.nn.sigmoid(cls_logits)
    gx1, gy1, gx2, gy2 = [gt_boxes[..., i][:, :, None] for i in range(4)]
    px, py = pts[None, None, :, 0], pts[None, None, :, 1]
    inside = (px > gx1) & (px < gx2) & (py > gy1) & (py < gy2)
    inside = inside & gt_valid[:, :, None]
    _, iou = jyl.pairwise_ciou(gt_boxes[:, :, None, :],
                               pred_boxes[:, None, :, :])
    align = (cls_prob[:, None, :] ** jyl.TAL_ALPHA) * (
        jnp.clip(iou, 0) ** jyl.TAL_BETA)
    align = jnp.where(inside, align, 0.0)
    topv, topi = jax.lax.top_k(align, jyl.TAL_TOPK)
    topk_mask = jnp.zeros_like(align, bool).at[
        jnp.arange(b)[:, None, None], jnp.arange(m)[None, :, None],
        topi].set(topv > 0)
    claimed = jnp.where(topk_mask, align, -1.0)
    best_gt = jnp.argmax(claimed, axis=1)
    assigned = jnp.take_along_axis(topk_mask, best_gt[:, None, :], 1)[:, 0]
    assigned = assigned & (jnp.max(claimed, 1) > 0)
    max_align = jnp.max(jnp.where(topk_mask, align, 0), axis=2, keepdims=True)
    max_iou = jnp.max(jnp.where(topk_mask, jnp.clip(iou, 0), 0), 2,
                      keepdims=True)
    norm = jnp.take_along_axis(align * max_iou / (max_align + 1e-9),
                               best_gt[:, None, :], 1)[:, 0]
    return best_gt, assigned, jnp.where(assigned, norm, 0.0)


def _tal_family(family):
    """[(label, numpy inputs, torch inputs with pts)] of a family at both
    sizes."""
    out = []
    for size in ts.TAL_SIZES:
        pts = ts.tal_pts(size)
        for label, *arrays in ts.tal_cases(family, size):
            out.append((label, (*arrays, pts),
                        tuple(torch.from_numpy(v) for v in (*arrays, pts))))
    return out


@pytest.mark.parametrize("family", ts.TAL_FAMILIES)
def test_plain_tal_matches_jax_on_each_family(family):
    for label, arrays, inputs in _tal_family(family):
        jb, ja, jt = (np.asarray(v) for v in _jax_assign(*arrays))
        tb, ta, tt = train_cuda.tal_assign_plain(*inputs)
        np.testing.assert_array_equal(ta.numpy(), ja, err_msg=label)
        np.testing.assert_array_equal(tb.numpy()[ja], jb[ja], err_msg=label)
        np.testing.assert_allclose(tt.numpy(), jt, rtol=0,
                                   atol=TRAIN_TOL["tal_assign"],
                                   err_msg=label)


@pytest.mark.parametrize("family", ts.TAL_FAMILIES)
def test_tal_select_model_equals_plain_on_each_family(family):
    """The kernel's selection (packed keys, lanes' own top 10, rounds, the
    first-largest resolve) gives tal_assign_plain's outputs bit for bit,
    whatever order the candidates are appended in."""
    gen = torch.Generator().manual_seed(11)
    for label, _, inputs in _tal_family(family):
        want = train_cuda.tal_assign_plain(*inputs)
        assert ts.same_bits(ts.tal_select_model(*inputs), want), label
        assert ts.same_bits(ts.tal_select_model(*inputs, gen=gen), want), \
            label


def test_tal_families_cover_their_cases():
    """The TAL families hold what their names say: M = 1, 4 and 8, B = 1
    and 17, a gt of fewer than 10 candidates and one of none, a gt whose
    candidates are every anchor, invalid gts, and equal values within a
    gt's top 10 and across gts."""
    def align(family, size, k=0):
        _, *arrays = ts.tal_cases(family, size)[k]
        pts = ts.tal_pts(size)
        return train_cuda.tal_align(*(torch.from_numpy(v)
                                      for v in (*arrays, pts)))[0], arrays

    for size in ts.TAL_SIZES:
        a = len(ts.tal_pts(size))
        assert [ts.tal_cases(f, size)[0][3].shape[1]
                for f in ("m1", "m4", "m8")] == [1, 4, 8]
        assert [c[1].shape[0] for c in ts.tal_cases("batches", size)] == \
            [1, 17]
        al, arrays = align("few", size)
        pos = (al > 0).sum(-1)
        assert (pos < 10).all() and (pos == 0).any() and (pos > 0).any()
        al, arrays = align("edges", size)
        assert int((al[0, 0] > 0).sum()) == a
        assert not arrays[3][3].any() and not arrays[3][2, 1]
        al, _ = align("ties", size)
        top = al[0, 0].sort(descending=True).values[:11]
        assert bool((top == top[0]).all()) and top[0] > 0
        assert torch.equal(al[1, 0], al[1, 1])
        both = (al[2, 0] > 0) & (al[2, 1] > 0)
        assert both.any() and torch.equal(al[2, 0][both], al[2, 1][both])


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
    family's cases, the unaligned augment case one byte past an allocation,
    the offset backward cases and an unaligned TAL case one element past
    one; ``same_bits`` is equality of the bits (-0.0 is not 0.0)."""
    items = ts.stress_inputs(torch.device("cpu"))
    aug = [(label, x) for kind, label, x in items if kind == "augment"]
    loss = [label for kind, label, _ in items if kind == "loss"]
    assert [label for label, _ in aug] == [
        *ts.AUG_FAMILIES[:2], "b3_all_on unaligned", *ts.AUG_FAMILIES[2:]]
    assert loss == [c[0] for f in ts.LOSS_FAMILIES for c in ts.loss_cases(f)]
    on, unaligned = aug[1][1], aug[2][1]
    assert unaligned[0].data_ptr() % 16 != 0
    assert ts.same_bits(on, unaligned)
    bwd = [(label, x) for kind, label, x in items if kind == "bwd"]
    assert [label for label, _ in bwd] == [
        c[0] for f in ts.BWD_FAMILIES for c in ts.bwd_cases(f)]
    for label, (x, t, _) in bwd:
        assert (x.data_ptr() % 16 != 0) == label.startswith("offset"), label
        assert (t.data_ptr() % 16 != 0) == label.startswith("offset"), label
    tal = {label: x for kind, label, x in items if kind == "tal"}
    assert len(tal) == 1 + sum(len(ts.tal_cases(f, z))
                               for f in ts.TAL_FAMILIES for z in ts.TAL_SIZES)
    assert {x[4].shape[0] for x in tal.values()} == {1344, 84}
    assert tal["m4 256² unaligned"][1].data_ptr() % 16 != 0
    assert ts.same_bits(tal["m4 256² unaligned"], tal["m4 256²"])
    assert not ts.same_bits((torch.tensor([0.0]),), (torch.tensor([-0.0]),))
    assert torch.equal(torch.tensor([0.0]), torch.tensor([-0.0]))


def test_train_cycles_marks_every_barrier_of_a_copy_and_csrc_keeps_none():
    """``tools/train_cycles.py`` instruments a copy of ``csrc/train.cu``: a
    mark where each kernel starts, after each barrier of the four kernels
    (``__syncthreads``, ``cluster_wait``, ``mbar_wait``; the backward has
    none) and at each end, and in ``og_tal_assign`` one where each gt's
    selection ends; the copy adds the occupancy, the gt clocks' reader and
    the TAL's launch floor (an empty kernel of its grid); the shipped source
    holds no clock reads."""
    import re

    from openglottal_tpu_torch.ops import _build
    from openglottal_tpu_torch.tools import blob_cycles, train_cycles

    src = (_build.CSRC_DIR / "train.cu").read_text()
    code = re.sub(r"//[^\n]*", "", src)
    assert "clock64" not in code and "og_train_occupancy" not in code
    assert "og_gt_mark" not in code and "og_tal_floor" not in code
    text = train_cycles.instrumented_source(src)
    for kernel, least in (("augment_kernel", 4), ("bce_dice_kernel", 4),
                          ("tal_assign_kernel", 2), ("bce_dice_bwd", 0)):
        start = re.search(rf"\b{kernel}\(", src).end()
        body = src[src.index("{", start):]
        body = body[:blob_cycles._body_end(body, 0) + 1]
        barriers = len(train_cycles._BARRIER.findall(body))
        assert barriers >= least
        start = re.search(rf"\b{kernel}\(", text).end()
        got = text[text.index("{", start):]
        got = got[:blob_cycles._body_end(got, 0) + 1]
        assert got.count("og_mark(og_k);") == barriers + 1
        assert got.count("og_end(og_k);") == 1 + body.count("return;")
        assert got.count("og_gt_mark(w);") == (kernel == "tal_assign_kernel")
    assert text.count("og_gt_mark(w);") == 1
    assert "__global__ void og_tal_floor_kernel() {}" in text
    for entry in ("og_read_pass_clock", "og_clear_pass_clock",
                  "og_train_occupancy", "og_unet_augment", "og_bce_dice",
                  "og_bce_dice_bwd", "og_tal_assign", "og_read_gt_clock",
                  "og_tal_floor"):
        assert f"int {entry}(" in text
    with pytest.raises(ValueError, match="take_n"):
        train_cycles.instrumented_source(src.replace("take_n[w] = r;", ""))
