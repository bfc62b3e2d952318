"""U-Net training, port vs JAX package on the CPU (``train/unet_trainer.py``,
the BatchNorm training mode of ``models/yolo.BatchNorm``, the plain versions
of ``ops/train_cuda.bce_dice``).

One f32 training step of a U-Net of features (8, 16, 32, 64) at 64², from the
same weights (carried by ``utils/convert.py``) on the same batch, against
``jax.value_and_grad`` of ``_loss_fn ∘ model.apply(train=True)``: the loss
within 1e-6 relative, every gradient within 1e-4 of the largest of its
tensor (float32 convolutions summed in another order), the BatchNorm running
statistics within 1e-6, and one AdamW step from the JAX package's
gradients against optax ``inject_hyperparams(adamw)`` within 3e-7 relative
(torch decays the parameter before the Adam step, optax adds both to one
update).
``cosine_lr`` is equal; the eval losses (masked and not) within 2e-5
relative (eval-mode forwards of another summation order), the loss and its
gradient on given logits within 1e-6 / 1e-5 relative.  The
initialisation holds flax's distributions (not its bits).  The trainer's
contracts mirror tests/test_trainer_tail.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openglottal_tpu.models.unet import UNet as JUNet
from openglottal_tpu.train import unet_trainer as jtr
from openglottal_tpu_torch.models.unet import UNet
from openglottal_tpu_torch.models.yolo import BatchNorm, init_flax_
from openglottal_tpu_torch.ops import train_cuda
from openglottal_tpu_torch.pipelines import GlottalPipelines
from openglottal_tpu_torch.train import unet_trainer as tr
from openglottal_tpu_torch.utils.convert import unet_state_dict_from_jax
from openglottal_tpu_torch.utils.io import load_unet_weights

FEATURES = (8, 16, 32, 64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(b=2, s=64, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, s, s)).astype(np.uint8)
    msks = np.zeros((b, s, s), np.uint8)
    msks[:, s // 4:s // 2, s // 3:2 * s // 3] = 1
    msks[1:, :3] = 1
    return imgs, msks


def _jax_variables(seed=0):
    v = JUNet(features=FEATURES).init(jax.random.PRNGKey(seed),
                                      jnp.zeros((1, 64, 64, 1)), train=False)
    return jax.tree.map(np.asarray, v)


def _state(variables, lr=1e-3):
    t = tr.UNetTrainer(features=FEATURES, lr=lr, dtype=torch.float32,
                       device="cpu")
    return t.init_state(variables)


def _as_sd(params, stats):
    return unet_state_dict_from_jax({"params": params, "batch_stats": stats})


def test_unet_train_step_matches_jax():
    """Loss, gradients, BatchNorm running statistics and one AdamW step of
    the port against the JAX package (f32, no augmentation)."""
    variables = _jax_variables()
    imgs, msks = _batch()
    model = JUNet(features=FEATURES)
    x = jax.jit(lambda a: a.astype(jnp.float32) / 255.0)(imgs)[..., None]
    y = jnp.asarray(msks, jnp.float32)[..., None]

    def loss(params):
        logits, upd = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x,
            train=True, mutable=["batch_stats"])
        return jtr._loss_fn(logits, y), upd["batch_stats"]

    (jl, jbs), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    tx = optax.inject_hyperparams(optax.adamw)(learning_rate=1e-3,
                                               weight_decay=0.01)
    upd, _ = tx.update(jg, tx.init(variables["params"]), variables["params"])
    jnew = optax.apply_updates(variables["params"], upd)

    state = _state(variables)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    loss_t = tr.unet_step(state, torch.from_numpy(imgs).float()
                          * train_cuda.INV255,
                          torch.from_numpy(msks).float(), torch.float32)
    np.testing.assert_allclose(float(loss_t), float(jl), rtol=1e-6)
    assert state.step == 1

    # gradients: the JAX tree's through the same layout map
    grads = _as_sd(jax.tree.map(np.asarray, jg), jax.tree.map(
        np.asarray, jbs))
    named = dict(state.model.named_parameters())
    assert set(named) <= set(grads)
    # (the optimizer step has run: recompute this step's gradients)
    probe = _state(variables)
    probe.model.train()
    logits = probe.model(torch.from_numpy(imgs).float()[:, None]
                         * train_cuda.INV255)
    train_cuda.bce_dice(logits, torch.from_numpy(msks).float()[:, None]
                        ).backward()
    for name, p in probe.model.named_parameters():
        g, want = p.grad.numpy(), grads[name].numpy()
        scale = max(np.abs(want).max(), 1e-12)
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)

    # BatchNorm running statistics after the training forward
    new_stats = _as_sd(variables["params"], jax.tree.map(np.asarray, jbs))
    n_bn = 0
    for name, buf in state.model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), new_stats[name].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
            assert not torch.equal(buf, before[name]), name
            n_bn += 1
    assert n_bn == 2 * 2 * (2 * len(FEATURES) + 1)

    # one AdamW step, given the JAX package's gradients
    fresh = _state(variables)
    for name, p in fresh.model.named_parameters():
        p.grad = grads[name].clone()
    fresh.opt.step()
    new = _as_sd(jax.tree.map(np.asarray, jnew), jax.tree.map(np.asarray,
                                                              jbs))
    for name, p in fresh.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), new[name].numpy(),
                                   rtol=3e-7, atol=1e-9, err_msg=name)


def test_batchnorm_training_semantics():
    """Batch mean and biased variance normalise; running statistics move
    by (1 - m) toward them (flax: m 0.9 U-Net, 0.97 YOLO), not as
    F.batch_norm(training=True) moves them."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(2.0, 3.0, (4, 5, 6, 7)).astype(
        np.float32))
    for m, eps in ((0.9, 1e-5), (0.97, 1e-3)):
        bn = BatchNorm(5, eps, momentum=m).train()
        with torch.no_grad():
            bn.weight.copy_(torch.arange(5.0) + 1)
            bn.bias.copy_(torch.arange(5.0) - 2)
        y = bn(x)
        mean = x.double().mean((0, 2, 3))
        var = x.double().var((0, 2, 3), unbiased=False)
        want = ((x.double() - mean[None, :, None, None])
                / torch.sqrt(var + eps)[None, :, None, None]
                * (torch.arange(5.0).double() + 1)[None, :, None, None]
                + (torch.arange(5.0).double() - 2)[None, :, None, None])
        assert y.dtype == torch.float32
        np.testing.assert_allclose(y.detach().numpy(), want.numpy(), atol=2e-5)
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   ((1 - m) * mean).numpy(), rtol=1e-5)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   (m + (1 - m) * var).numpy(), rtol=1e-5)
        bn.eval()
        with torch.no_grad():
            ye = bn(x.to(torch.bfloat16))
        assert ye.dtype == torch.bfloat16


def test_init_matches_flax_distributions():
    """lecun_normal kernels (truncated normal, fan-in std), zero biases, BN
    scale 1 and shift 0: the port's init against flax's, by statistics."""
    torch_model = init_flax_(UNet(features=(32, 64, 128, 256)),
                             torch.Generator().manual_seed(0))
    jv = JUNet().init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)),
                      train=False)
    jsd = unet_state_dict_from_jax(jax.tree.map(np.asarray, jv))
    sd = torch_model.state_dict()
    assert sorted(sd) == sorted(jsd)
    for k, v in sd.items():
        assert v.shape == jsd[k].shape, k
        w = v.double()
        if k.endswith("bias") or "running_mean" in k:
            assert torch.all(w == 0), k
            continue
        if "running_var" in k or (k.endswith(".weight") and v.dim() == 1):
            assert torch.all(w == 1), k
            continue
        if v.dim() != 4 or v.numel() < 500:
            continue
        fan_in = (v.shape[0] if k.startswith("ups.") and k.split(".")[1]
                  in ("0", "2", "4", "6") else v.shape[1]) * v.shape[2] \
            * v.shape[3]
        std = (1.0 / fan_in) ** 0.5
        jw = jsd[k].double()
        for t in (w, jw):
            assert abs(float(t.std()) / std - 1) < 0.1, k
            assert float(t.abs().max()) <= 2 * std / .87962566 + 1e-6, k
            assert abs(float(t.mean())) < 0.1 * std, k


def test_cosine_lr_equals_jax():
    for epochs in (1, 2, 7, 50):
        for e in range(epochs):
            assert tr.cosine_lr(e, epochs, 1e-3) == jtr.cosine_lr(e, epochs,
                                                                  1e-3)


def test_masked_eval_loss_matches_jax():
    """Padded rows count in neither the BCE mean nor the Dice sums; all-True
    equals the plain eval loss (f32, eval-mode BN)."""
    variables = _jax_variables(1)
    imgs, msks = _batch(3, seed=4)
    imgs[2] = 0
    msks[2] = 0
    valid = np.array([True, True, False])
    jv = jax.tree.map(jnp.asarray, variables)
    model = JUNet(features=FEATURES)
    jm = jtr.unet_eval_loss_masked(model, jv["params"], jv["batch_stats"],
                                   imgs, msks, valid)
    ja = jtr.unet_eval_loss(model, jv["params"], jv["batch_stats"], imgs,
                            msks)
    state = _state(variables)
    tm = tr.unet_eval_loss_masked(state, torch.from_numpy(imgs),
                                  torch.from_numpy(msks),
                                  torch.from_numpy(valid), torch.float32)
    ta = tr.unet_eval_loss(state, torch.from_numpy(imgs),
                           torch.from_numpy(msks), torch.float32)
    np.testing.assert_allclose(float(tm), float(jm), rtol=2e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=2e-5)
    tv = tr.unet_eval_loss_masked(state, torch.from_numpy(imgs),
                                  torch.from_numpy(msks),
                                  torch.ones(3, dtype=torch.bool),
                                  torch.float32)
    np.testing.assert_allclose(float(tv), float(ta), rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_bce_dice_value_and_grad_match_jax(masked):
    """The loss's plain forward and its backward (the kernel's formula)
    against jax.value_and_grad of _loss_fn / the masked eval loss, on logits
    of ±40 as well."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 4, (3, 1, 32, 32)).astype(np.float32)
    x[0, 0, 0, :4] = [40.0, -40.0, 0.0, 17.0]
    t = (rng.random((3, 1, 32, 32)) > 0.7).astype(np.float32)
    valid = np.array([True, False, True]) if masked else None

    def jloss(lg):
        if valid is None:
            return jtr._loss_fn(lg, t)
        v = jnp.asarray(valid, jnp.float32)[:, None, None, None]
        n = v.sum() * 32 * 32
        bce = (optax.sigmoid_binary_cross_entropy(lg, t) * v).sum() / n
        p = jax.nn.sigmoid(lg) * v
        tt = t * v
        return 0.5 * bce + 0.5 * (1 - (2 * (p * tt).sum() + 1e-6)
                                  / (p.sum() + tt.sum() + 1e-6))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(x)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = train_cuda.bce_dice(xt, torch.from_numpy(t), None if valid is None
                               else torch.from_numpy(valid))
    (loss * 2.0).backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), 2.0 * np.asarray(jg),
                               rtol=1e-5, atol=1e-9)


# ── the trainer's contracts (tests/test_trainer_tail.py) ────────────────────

def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    imgs = (rng.random((n, 256, 256)) * 255).astype(np.uint8)
    msks = (rng.random((n, 256, 256)) > 0.8).astype(np.uint8)
    return imgs, msks


def _trainer(bs):
    return tr.UNetTrainer(features=FEATURES, batch_size=bs,
                          dtype=torch.float32, device="cpu")


def test_unet_trains_on_sub_batch_dataset():
    imgs, msks = _data(3)
    state, best, hist = _trainer(16).fit(imgs, msks, imgs[:2], msks[:2],
                                         epochs=1, verbose=False)
    assert np.isfinite(hist[0]["loss/train"])
    assert np.isfinite(hist[0]["loss/val"])
    assert state.step == 1


def test_unet_tail_batch_trains():
    imgs, msks = _data(5)
    state, best, hist = _trainer(4).fit(imgs, msks, imgs[:2], msks[:2],
                                        epochs=1, verbose=False)
    assert state.step == 2          # one full batch of 4 + the tail of 1
    assert np.isfinite(hist[0]["loss/train"])


def test_unet_no_val_still_checkpoints_best(tmp_path):
    """Empty val set: improvement tracking falls back to the train loss so
    best / latest checkpoints and patience still function; the checkpoint is
    a torch .pt that A8's loader reads and the pipelines serve."""
    imgs, msks = _data(4)
    state, best, hist = _trainer(4).fit(imgs, msks, imgs[:0], msks[:0],
                                        epochs=1, ckpt_dir=tmp_path,
                                        verbose=False)
    assert best is not None
    assert (tmp_path / "best.pt").exists()
    assert (tmp_path / "latest.pt").exists()
    assert len((tmp_path / "metrics.jsonl").read_text().splitlines()) == 1
    tree = load_unet_weights(tmp_path / "best.pt")
    sd = state.model.state_dict()
    back = unet_state_dict_from_jax(tree)
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k
    pipe = GlottalPipelines(unet_variables=tree, dtype=torch.float32,
                            device="cpu")
    masks = pipe.segment_video(imgs[:2])
    assert tuple(masks.shape) == (2, 256, 256)


def test_unet_patience_and_best(tmp_path, monkeypatch):
    """Patience stops after that many epochs without improvement and best
    keeps the best epoch's weights; resume loads weights with a fresh
    optimizer."""
    imgs, msks = _data(2)
    losses = iter([0.5, 0.3, 0.4, 0.45, 0.2])
    snaps = []

    def fake_eval(state, *a, **k):
        snaps.append(tr.state_dict_cpu(state.model))
        return torch.tensor(next(losses))

    monkeypatch.setattr(tr, "unet_eval_loss_masked", fake_eval)
    t = _trainer(2)
    state, best, hist = t.fit(imgs, msks, imgs[:1], msks[:1], epochs=5,
                              patience=2, ckpt_dir=tmp_path, verbose=False)
    assert [h["loss/val"] for h in hist] == pytest.approx([0.5, 0.3, 0.4,
                                                           0.45])
    peak = unet_state_dict_from_jax(best)
    for k, v in peak.items():
        assert torch.equal(v, snaps[1][k]), k
    assert not all(torch.equal(v, state.model.state_dict()[k])
                   for k, v in peak.items())
    resumed = t.init_state(t.load_variables(tmp_path, "best"))
    for k, v in peak.items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k
    assert resumed.step == 0 and not resumed.opt.state


def test_unet_trainer_refuses_mesh():
    with pytest.raises(NotImplementedError):
        tr.UNetTrainer(mesh=object(), device="cpu")
