"""Port vs JAX package on the CPU: the networks.

Narrow models (YOLO widths (8,16,32,64,128), U-Net features (8,16,32,64)) are
built with the JAX package's modules (shapes from its initialiser, values
from numpy; BatchNorm statistics and affine parameters random so that folding
matters).  The same
weights are converted into the port's modules and the same frames go through
both, in float32.  Tolerance atol=rtol=1e-4: the two libraries sum the
convolution taps in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglottal_tpu.models import yolo as jyolo
from openglottal_tpu.models.unet import UNet as JUNet
from openglottal_tpu_torch.models import fold as tfold
from openglottal_tpu_torch.models import yolo as tyolo
from openglottal_tpu_torch.models.unet import UNet as TUNet
from openglottal_tpu_torch.utils.convert import (
    unet_state_dict_from_jax,
    yolo_state_dict_from_jax,
)
from openglottal_tpu_torch.utils.io import load_weights_npz

TOL = dict(atol=1e-4, rtol=1e-4)
YOLO_W = (8, 16, 32, 64, 128)
YOLO_D = (1, 1, 1, 1)    # the full-width test below runs the real (1, 2, 2, 1)
UNET_F = (8, 16, 32, 64)
_MEMO = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes side by side; PyTorch's
    intra-op thread pool in each of them oversubscribes the cores and makes
    the many small tensor ops here an order of magnitude slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_init(model, x_shape, seed):
    """A variable tree of the model's shapes filled from numpy: kernels
    N(0, 1/fan_in), biases small, BatchNorm overwritten by _randomise_bn.
    Shapes come from ``jax.eval_shape`` of the JAX initialiser (tracing only:
    running it would compile dozens of tiny random-number programs)."""
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros(x_shape, jnp.float32), train=False))
    rng = np.random.default_rng(seed)

    def fill(path, sd):
        if path[-1] == "kernel":
            fan_in = int(np.prod(sd.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, sd.shape).astype(np.float32)
        if path[-1] in ("scale", "var"):
            return np.ones(sd.shape, np.float32)
        if path[-1] == "bias" and "BatchNorm" not in path[-2]:
            return rng.normal(0, 0.1, sd.shape).astype(np.float32)
        return np.zeros(sd.shape, np.float32)

    def walk(t, path=()):
        return {k: walk(v, path + (k,)) if isinstance(v, dict)
                else fill(path + (k,), v) for k, v in t.items()}

    return walk(dict(shapes))


def _randomise_bn(tree, seed):
    """Overwrite BatchNorm scale/bias/mean/var from numpy (in place)."""
    rng = np.random.default_rng(seed)

    def walk(p, s):
        for k, v in p.items():
            if k.startswith("BatchNorm_"):
                n = v["scale"].shape
                v["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
                v["bias"] = rng.normal(0, 0.2, n).astype(np.float32)
                s[k]["mean"] = rng.normal(0, 0.2, n).astype(np.float32)
                s[k]["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
            elif isinstance(v, dict):
                walk(v, s.get(k, {}))

    walk(tree["params"], tree["batch_stats"])
    return tree


def _narrow_yolo():
    if "yolo" not in _MEMO:
        model = jyolo.YOLOv8(nc=1, width=YOLO_W, depth=YOLO_D)
        tree = _randomise_bn(_numpy_init(model, (1, 64, 64, 3), 0), 1)
        x = np.random.default_rng(2).uniform(0, 1, (3, 64, 64, 3)
                                             ).astype(np.float32)
        outs = jax.jit(lambda vv, xx: model.apply(vv, xx, train=False))(tree, x)
        _MEMO["yolo"] = (tree, x, [(np.array(b), np.array(c))
                                   for b, c in outs])
    return _MEMO["yolo"]


def _torch_yolo(tree, fuse, width=YOLO_W, depth=YOLO_D):
    sd = yolo_state_dict_from_jax(tree)
    if fuse:
        sd = tfold.fold_yolo(sd)
    m = tyolo.YOLOv8(nc=1, width=width, depth=depth, fuse_bn=fuse).eval()
    m.load_state_dict(sd, strict=True)
    return m


@pytest.mark.parametrize("fuse", [False, True])
def test_narrow_yolo_level_outputs(fuse):
    tree, x, want = _narrow_yolo()
    with torch.no_grad():
        got = _torch_yolo(tree, fuse)(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == 3
    for (gb, gc), (wb, wc) in zip(got, want):
        assert gb.shape == wb.shape and gc.shape == wc.shape   # NHWC-shaped
        np.testing.assert_allclose(gb.numpy(), wb, **TOL)
        np.testing.assert_allclose(gc.numpy(), wc, **TOL)


def test_narrow_yolo_max_conf_detect():
    tree, x, want = _narrow_yolo()
    jh, jb, jc = jyolo.max_conf_detect([(jnp.asarray(b), jnp.asarray(c))
                                        for b, c in want], 64, 64, 0.3)
    th, tb, tc = tyolo.max_conf_detect([(torch.from_numpy(b),
                                         torch.from_numpy(c))
                                        for b, c in want], 64, 64, 0.3)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-3, rtol=0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    # same decoded boxes and the same winning anchor
    tbx, tcf = tyolo.decode_boxes([(torch.from_numpy(b), torch.from_numpy(c))
                                   for b, c in want], 64, 64)
    jbx, jcf = jyolo.decode_boxes([(jnp.asarray(b), jnp.asarray(c))
                                   for b, c in want], 64, 64)
    np.testing.assert_allclose(tbx.numpy(), np.asarray(jbx), atol=1e-3, rtol=0)
    assert (tcf.numpy()[..., 0].argmax(1)
            == np.asarray(jcf)[..., 0].argmax(1)).all()


def test_max_conf_detect_first_anchor_wins_ties():
    outs = []
    for s in (8, 4, 2):
        b = torch.zeros((2, s, s, 64))
        c = torch.full((2, s, s, 1), -3.0)
        outs.append((b, c))
    outs[0][1][0, 2, 3, 0] = 2.0        # frame 0: two equal maxima
    outs[1][1][0, 1, 1, 0] = 2.0
    outs[2][1][1, 0, 1, 0] = 1.0        # frame 1: a single one
    has, box, conf = tyolo.max_conf_detect(outs, 64, 64, 0.25)
    jh, jb, jc = jyolo.max_conf_detect(
        [(jnp.asarray(b.numpy()), jnp.asarray(c.numpy())) for b, c in outs],
        64, 64, 0.25)
    np.testing.assert_array_equal(has.numpy(), np.asarray(jh))
    np.testing.assert_allclose(box.numpy(), np.asarray(jb), atol=1e-4, rtol=0)
    # centre of the first maximum: level 0, row 2, col 3, stride 8
    assert abs(float(box[0, 0] + box[0, 2]) / 2 - 28.0) < 1e-4


def test_anchors_match():
    tp, ts = tyolo.anchors_for(64, 96)
    jp, js = jyolo.anchors_for(64, 96)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _narrow_unet():
    if "unet" not in _MEMO:
        model = JUNet(features=UNET_F)
        tree = _randomise_bn(_numpy_init(model, (1, 64, 64, 1), 3), 4)
        x = np.random.default_rng(5).uniform(0, 1, (2, 128, 128, 1)
                                             ).astype(np.float32)
        want = np.asarray(jax.jit(
            lambda vv, xx: model.apply(vv, xx, train=False))(tree, x))
        _MEMO["unet"] = (tree, x, want)
    return _MEMO["unet"]


@pytest.mark.parametrize("fuse", [False, True])
def test_narrow_unet_logits(fuse):
    tree, x, want = _narrow_unet()
    sd = unet_state_dict_from_jax(tree)
    if fuse:
        sd = tfold.fold_unet(sd)
    m = TUNet(features=UNET_F, fuse_bn=fuse).eval()
    m.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)


def test_full_width_yolo_demo_weights():
    """Published n-scale widths, demo weights, 2 frames at 256x256."""
    tree = load_weights_npz("weights/demo_yolo.npz")
    x = np.random.default_rng(6).uniform(0, 1, (2, 256, 256, 3)
                                         ).astype(np.float32)
    model = jyolo.YOLOv8(nc=1)
    want = jax.jit(lambda vv, xx: model.apply(vv, xx, train=False))(tree, x)
    with torch.no_grad():
        got = _torch_yolo(tree, False, (16, 32, 64, 128, 256), (1, 2, 2, 1))(
            torch.from_numpy(x).permute(0, 3, 1, 2))
    for (gb, gc), (wb, wc) in zip(got, want):
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb), **TOL)
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), **TOL)


def test_bf16_model_keeps_float32_logits():
    tree, x, want = _narrow_unet()
    m = TUNet(features=UNET_F, fuse_bn=True).eval()
    m.load_state_dict(tfold.fold_unet(unet_state_dict_from_jax(tree)))
    m = m.to(torch.bfloat16)
    with torch.no_grad():
        got = m(torch.from_numpy(x[:1, :32, :32]).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
