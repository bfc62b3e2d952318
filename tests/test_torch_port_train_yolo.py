"""YOLOv8 training, port vs JAX package on the CPU (``train/yolo_loss.py``,
``train/yolo_aug.py``, ``train/yolo_trainer.py``, the plain version of
``ops/train_cuda.tal_assign``).

Against the JAX package, in f32: ``yolo_loss``'s total and parts within 1e-5
relative and its gradient with respect to the head outputs within 1e-5 of
the largest gradient, on random head outputs with M = 1 and 4 gts; the TAL
plain version's ``best_gt`` and ``assigned`` exactly equal to the JAX
package's assignment (inputs without ties), its soft targets within 1e-5
relative (the power ^0.5 and ^6 taken in other forms);
one tiny-YOLO (width (8, 16, 32, 64, 128), depth (1, 1, 1, 1), 64²) training
step: loss within 1e-5 relative, gradients within 1e-3 of the largest of
their tensor (6e-4 measured: the training BatchNorm over two 2x2 maps at the
deepest level amplifies float32 summation noise), BatchNorm statistics
within 1e-5.  The augmentation is held
by its statistics as tests/test_yolo_aug.py holds the JAX package's, and the
trainer's contracts as tests/test_trainer_tail.py and test_yolo_aug.py hold
them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglottal_tpu.models.yolo import YOLOv8 as JYOLOv8
from openglottal_tpu.train import yolo_aug as jaug
from openglottal_tpu.train import yolo_loss as jyl
from openglottal_tpu_torch.models.yolo import YOLOv8, anchors_for
from openglottal_tpu_torch.ops import train_cuda
from openglottal_tpu_torch.train import yolo_aug, yolo_loss, yolo_trainer
from openglottal_tpu_torch.utils.convert import yolo_state_dict_from_jax

WIDTH, DEPTH = (8, 16, 32, 64, 128), (1, 1, 1, 1)
S = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _heads(b, s=S, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(0, 2, (b, s // st, s // st, 64)).astype(np.float32),
             rng.normal(-1, 2, (b, s // st, s // st, 1)).astype(np.float32))
            for st in (8, 16, 32)]


def _gts(b, m, s=S, seed=1):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, s * 0.6, (b, m, 2))
    wh = rng.uniform(8, s * 0.5, (b, m, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, s)], -1).astype(
        np.float32)
    valid = np.ones((b, m), bool)
    if m > 1:
        valid[0, -1] = False
    return boxes, valid


@pytest.mark.parametrize("m", [1, 4])
def test_yolo_loss_and_grad_match_jax(m):
    heads = _heads(3)
    boxes, valid = _gts(3, m)

    def jloss(h):
        total, parts = jyl.yolo_loss(h, boxes, valid, S, S)
        return total, parts

    (jt, jp), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        [(jnp.asarray(b), jnp.asarray(c)) for b, c in heads])
    th = [(torch.from_numpy(b).requires_grad_(True),
           torch.from_numpy(c).requires_grad_(True)) for b, c in heads]
    tt, tp = yolo_loss.yolo_loss(th, torch.from_numpy(boxes),
                                 torch.from_numpy(valid), S, S)
    tt.backward()
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5)
    for k in ("box", "cls", "dfl"):
        np.testing.assert_allclose(float(tp[k]), float(jp[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert int(tp["assigned"]) == int(jp["assigned"]) > 0
    scale = max(max(np.abs(np.asarray(gb)).max(), np.abs(np.asarray(gc)).max())
                for gb, gc in jg)
    for (tb, tc), (gb, gc) in zip(th, jg):
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), rtol=0,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(tc.grad.numpy(), np.asarray(gc), rtol=0,
                                   atol=1e-5 * scale)


def _jax_assign(cls_logits, pred_boxes, gt_boxes, gt_valid, pts):
    """yolo_loss.py:96-133 of the JAX package, as it computes the TAL
    assignment."""
    b = cls_logits.shape[0]
    m = gt_boxes.shape[1]
    cls_prob = jax.nn.sigmoid(cls_logits)
    gx1, gy1, gx2, gy2 = [gt_boxes[..., i][:, :, None] for i in range(4)]
    px = pts[None, None, :, 0]
    py = pts[None, None, :, 1]
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


@pytest.mark.parametrize("m,s", [(1, 64), (4, 64), (4, 256)])
def test_tal_plain_matches_jax_assignment(m, s):
    """best_gt and assigned exact, soft targets within 1e-5, on predicted
    boxes scattered around the gts (many candidates, no ties)."""
    rng = np.random.default_rng(m + s)
    b = 4
    pts, _ = anchors_for(s, s)
    a = pts.shape[0]
    boxes, valid = _gts(b, m, s, seed=m)
    centre = rng.uniform(0, s, (b, a, 2))
    wh = rng.uniform(4, s * 0.6, (b, a, 2))
    pred = np.concatenate([centre - wh / 2, centre + wh / 2], -1).astype(
        np.float32)
    cls = rng.normal(0, 2, (b, a)).astype(np.float32)
    jb, ja, jt = jax.jit(_jax_assign)(cls, pred, boxes, valid, pts.numpy())
    tb, ta, tt = train_cuda.tal_assign(
        torch.from_numpy(cls), torch.from_numpy(pred), torch.from_numpy(boxes),
        torch.from_numpy(valid), pts)
    assert tb.dtype == torch.int32 and ta.dtype == torch.bool
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    sel = np.asarray(ja)
    assert sel.sum() > 0
    np.testing.assert_array_equal(tb.numpy()[sel], np.asarray(jb)[sel])
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5,
                               atol=1e-9)


def test_tal_top_k_ties_go_to_the_lower_index():
    """Equal align values: the plain version keeps lax.top_k's order."""
    pts, _ = anchors_for(64, 64)
    a = pts.shape[0]
    gt = torch.tensor([[[0.0, 0.0, 64.0, 64.0]]])
    pred = gt[:, :, None, :].expand(1, 1, a, 4)[:, 0].contiguous()
    best, assigned, t = train_cuda.tal_assign(
        torch.zeros((1, a)), pred, gt, torch.ones((1, 1), dtype=torch.bool),
        pts)
    assert assigned.sum() == 10
    assert torch.equal(torch.nonzero(assigned[0])[:, 0], torch.arange(10))
    assert torch.all(best == 0)


def _jax_tiny(seed=0):
    v = JYOLOv8(nc=1, width=WIDTH, depth=DEPTH).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, S, S, 3)), train=False)
    return jax.tree.map(np.asarray, v)


def test_tiny_yolo_train_step_matches_jax():
    """Loss, gradients and BatchNorm statistics of one training step (no
    augmentation) of a narrow YOLOv8 against jax.value_and_grad."""
    variables = _jax_tiny()
    rng = np.random.default_rng(2)
    x = rng.random((2, S, S, 3)).astype(np.float32)
    boxes, valid = _gts(2, 2, seed=3)
    model = JYOLOv8(nc=1, width=WIDTH, depth=DEPTH)

    def loss(params):
        outs, upd = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x,
            train=True, mutable=["batch_stats"])
        return jyl.yolo_loss(outs, boxes, valid, S, S)[0], upd["batch_stats"]

    (jl, jbs), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    tm = YOLOv8(nc=1, width=WIDTH, depth=DEPTH)
    tm.load_state_dict(yolo_state_dict_from_jax(variables), strict=True)
    tm.train()
    outs = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    tl, _ = yolo_loss.yolo_loss(outs, torch.from_numpy(boxes),
                                torch.from_numpy(valid), S, S)
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    grads = yolo_state_dict_from_jax({"params": jax.tree.map(np.asarray, jg),
                                      "batch_stats": jax.tree.map(np.asarray,
                                                                  jbs)})
    worst = {}
    for name, p in tm.named_parameters():
        if not p.requires_grad:
            continue
        want = grads[name].numpy()
        worst[name] = float(np.abs(p.grad.numpy() - want).max()
                            / max(np.abs(want).max(), 1e-12))
    assert max(worst.values()) < 1e-3, worst
    for name, buf in tm.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), grads[name].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)


# ── augmentation (tests/test_yolo_aug.py) ───────────────────────────────────

AS = 128


def _tiles_with_squares(rng, b=4):
    imgs = np.zeros((b, 4, AS, AS, 3), np.uint8)
    boxes = np.zeros((b, 4, 4), np.float32)
    for i in range(b):
        for q in range(4):
            w, h = rng.integers(24, 48, 2)
            x1 = rng.integers(0, AS - w)
            y1 = rng.integers(0, AS - h)
            imgs[i, q, y1:y1 + h, x1:x1 + w] = 255
            boxes[i, q] = [x1, y1, x1 + w, y1 + h]
    return imgs, boxes


def test_hsv_matches_jax_and_round_trips():
    rng = np.random.default_rng(0)
    rgb = rng.random((4096, 3)).astype(np.float32)
    rgb[:16] = rgb[:16, :1]                      # grays
    hsv = yolo_aug.rgb_to_hsv(torch.from_numpy(rgb))
    np.testing.assert_allclose(hsv.numpy(),
                               np.asarray(jaug.rgb_to_hsv(rgb)), atol=2e-6)
    back = yolo_aug.hsv_to_rgb(hsv)
    np.testing.assert_allclose(back.numpy(),
                               np.asarray(jaug.hsv_to_rgb(np.asarray(hsv))),
                               atol=2e-6)
    np.testing.assert_allclose(back.numpy(), rgb, atol=1e-5)
    np.testing.assert_allclose(hsv[:16, 1].numpy(), 0.0, atol=1e-6)


def test_mosaic_boxes_track_content():
    rng = np.random.default_rng(1)
    imgs, boxes = _tiles_with_squares(rng, b=6)
    out, obx, ovd = yolo_aug.mosaic_affine_hsv(
        torch.Generator().manual_seed(3), torch.from_numpy(imgs),
        torch.from_numpy(boxes), torch.ones((6, 4), dtype=torch.bool),
        hgain=0.0, sgain=0.0, vgain=0.0)
    assert out.shape == (6, AS, AS, 3) and obx.shape == (6, 4, 4)
    assert ovd.any()
    checked = 0
    for i in range(6):
        for q in range(4):
            if not ovd[i, q]:
                continue
            cx = int((obx[i, q, 0] + obx[i, q, 2]) / 2)
            cy = int((obx[i, q, 1] + obx[i, q, 3]) / 2)
            assert 0 <= cx < AS and 0 <= cy < AS
            assert out[i, cy, cx].max() > 0.5, (i, q, obx[i, q])
            checked += 1
    assert checked >= 6


def test_mosaic_invalid_tiles_stay_invalid_and_flip_mirrors():
    rng = np.random.default_rng(2)
    imgs, boxes = _tiles_with_squares(rng, b=3)
    valid = np.ones((3, 4), bool)
    valid[:, 2] = False
    _, _, ovd = yolo_aug.mosaic_affine_hsv(
        torch.Generator().manual_seed(0), torch.from_numpy(imgs),
        torch.from_numpy(boxes), torch.from_numpy(valid))
    assert not ovd[:, 2].any()
    kw = dict(hgain=0.0, sgain=0.0, vgain=0.0)
    args = (torch.from_numpy(imgs), torch.from_numpy(boxes),
            torch.ones((3, 4), dtype=torch.bool))
    a, ab, av = yolo_aug.mosaic_affine_hsv(torch.Generator().manual_seed(7),
                                           *args, fliplr=0.0, **kw)
    b_, bb, bv = yolo_aug.mosaic_affine_hsv(torch.Generator().manual_seed(7),
                                            *args, fliplr=1.0, **kw)
    np.testing.assert_allclose(b_.numpy(), a.numpy()[:, :, ::-1], atol=1e-6)
    assert torch.equal(av, bv)
    np.testing.assert_allclose(bb[bv][:, [0, 2]].numpy(),
                               AS - ab[av][:, [2, 0]].numpy(), atol=1e-4)


def test_mosaic_draw_distributions():
    """Flip rate 0.5, gain ~ U(0.5, 1.5): the share of flipped samples and
    the box scale factors over a large batch of one-pixel-free tiles."""
    n = 256
    imgs = np.zeros((n, 4, 32, 32, 3), np.uint8)
    boxes = np.tile(np.array([[4.0, 4.0, 20.0, 20.0]], np.float32), (n, 4, 1))
    out, ob, ov = yolo_aug.mosaic_affine_hsv(
        torch.Generator().manual_seed(11), torch.from_numpy(imgs),
        torch.from_numpy(boxes), torch.zeros((n, 4), dtype=torch.bool),
        translate=0.0)
    assert out.shape == (n, 32, 32, 3)
    # the canvas is gray: any pixel stays 114/255 under HSV (no saturation)
    assert torch.all((out - yolo_aug.GRAY).abs() < 0.45)


def test_augment_det_batch_moves_boxes_with_content():
    rng = np.random.default_rng(4)
    b, s = 32, 96
    imgs = np.zeros((b, s, s, 3), np.float32)
    boxes = np.zeros((b, 4), np.float32)
    for i in range(b):
        x1, y1 = rng.integers(20, 50, 2)
        imgs[i, y1:y1 + 24, x1:x1 + 24] = 1.0
        boxes[i] = [x1, y1, x1 + 24, y1 + 24]
    out, nb, nv = yolo_trainer.augment_det_batch(
        torch.Generator().manual_seed(0), torch.from_numpy(imgs),
        torch.from_numpy(boxes), torch.ones(b, dtype=torch.bool))
    assert nv.all()
    for i in range(b):
        cx = int((nb[i, 0] + nb[i, 2]) / 2)
        cy = int((nb[i, 1] + nb[i, 3]) / 2)
        assert out[i, cy, cx].max() > 0.3


# ── the trainer ─────────────────────────────────────────────────────────────

def _trainer(bs):
    """YOLOv8n's widths (the serving path's detector), f32, on the CPU."""
    return yolo_trainer.YoloTrainer(batch_size=bs, dtype=torch.float32,
                                    device="cpu")


def test_boxes_from_masks():
    m = np.zeros((3, 64, 64), np.uint8)
    m[0, 10:20, 30:40] = 1
    m[2, 0:3, 60:64] = 1
    got = yolo_trainer.boxes_from_masks(m)
    np.testing.assert_array_equal(got, [[20, 0, 49, 29], [-1, -1, -1, -1],
                                        [50, 0, 64, 12]])


def test_yolo_mosaic_step_and_sub_batch_fit():
    rng = np.random.default_rng(4)
    t = _trainer(2)
    state = t.init_state()
    imgs, boxes = _tiles_with_squares(rng, b=2)
    loss, parts = yolo_trainer.yolo_train_step(
        state, torch.from_numpy(imgs), torch.from_numpy(boxes),
        torch.ones((2, 4), dtype=torch.bool),
        torch.Generator().manual_seed(0), mosaic=True, dtype=torch.float32)
    assert np.isfinite(float(loss)) and state.step == 1
    imgs = (rng.random((3, 64, 64, 3)) * 255).astype(np.uint8)
    boxes = np.array([[10, 10, 40, 40], [5, 5, 30, 25], [-1, -1, -1, -1]],
                     np.float32)
    state, best, hist = _trainer(16).fit(imgs, boxes, epochs=1,
                                         verbose=False)
    assert np.isfinite(hist[0]["loss/train"]) and state.step == 1
    assert best is not None


def test_yolo_close_mosaic_schedule(monkeypatch):
    calls = []

    def fake_step(state, imgs, bx, vd, gen, mosaic=False, dtype=None):
        calls.append(bool(mosaic))
        state.step += 1
        return torch.tensor(0.0), {}

    monkeypatch.setattr(yolo_trainer, "yolo_train_step", fake_step)
    rng = np.random.default_rng(5)
    imgs = (rng.random((4, 64, 64, 3)) * 255).astype(np.uint8)
    boxes = np.tile(np.asarray([[8, 8, 40, 40]], np.float32), (4, 1))
    t = _trainer(4)
    t.fit(imgs, boxes, epochs=3, verbose=False, close_mosaic=2)
    assert calls == [True, False, False]
    calls.clear()
    t.fit(imgs, boxes, epochs=2, verbose=False)
    assert calls == [True, True]


def test_yolo_best_checkpoint_tracks_peak_recall(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    imgs = (rng.random((4, 64, 64, 3)) * 255).astype(np.uint8)
    boxes = np.array([[10, 10, 50, 50]] * 4, np.float32)
    recalls = iter([0.2, 0.9, 0.4, 0.3, 0.3])
    snaps = []
    t = _trainer(4)

    def fake_recall(state, *_a, **_k):
        snaps.append(t.variables(state))
        return next(recalls)

    monkeypatch.setattr(t, "eval_recall", fake_recall)
    state, best, hist = t.fit(imgs, boxes, imgs, boxes, epochs=5, patience=2,
                              verbose=False, mosaic=False, ckpt_dir=tmp_path)
    assert [h["recall/val"] for h in hist] == [0.2, 0.9, 0.4, 0.3]
    same = jax.tree.map(np.array_equal, best, snaps[1])
    assert all(jax.tree.leaves(same))
    final = t.variables(state)
    assert not all(jax.tree.leaves(jax.tree.map(np.array_equal, best, final)))
    assert (tmp_path / "best.pt").exists()
    assert (tmp_path / "latest.pt").exists()
    back = t.load_variables(tmp_path, "best")
    same = jax.tree.map(np.array_equal, back, snaps[1])
    assert all(jax.tree.leaves(same))
    resumed = t.init_state(back)
    assert resumed.step == 0 and not resumed.opt.state


def test_eval_recall_through_the_detector_path():
    """A detector whose max-confidence anchor predicts a box of IoU 0.5625
    with the gt finds it (recall 1.0); one where nothing fires finds none."""
    t = _trainer(4)
    state = t.init_state()
    rng = np.random.default_rng(6)
    imgs = (rng.random((3, 64, 64, 3)) * 255).astype(np.uint8)
    boxes = np.array([[0, 0, 48, 48], [0, 0, 48, 48], [-1, -1, -1, -1]],
                     np.float32)
    head = state.model.model["22"]
    with torch.no_grad():
        for i in range(3):
            for seq in (head.cv2[i], head.cv3[i]):
                seq[2].weight.zero_()
                seq[2].bias.zero_()
            head.cv3[i][2].bias.fill_(5.0 if i == 2 else -9.0)
        # the stride-32 level: every side one bin -> the first anchor (16,
        # 16) predicts (-16, -16, 48, 48)
        head.cv2[2][2].bias.view(4, 16)[:, 1] = 30.0
    assert t.eval_recall(state, imgs, boxes) == 1.0
    with torch.no_grad():
        head.cv3[2][2].bias.fill_(-9.0)               # nothing fires
    assert t.eval_recall(state, imgs, boxes) == 0.0
