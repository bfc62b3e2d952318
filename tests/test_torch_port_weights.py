"""Weight formats and small helpers, port vs JAX package on the CPU: the
torch ``.pt`` checkpoints (``utils/io``, ``utils/torch_import``,
``utils/yolo_import``), ``save_weights_npz``, the host letterboxes
(``ops/resize.letterbox_np``, ``utils``), ``models/unet.segment_frames``,
``models/yolo.YoloDetector`` and ``utils/retry``.

The checkpoints are built inside the tests as tests/test_torch_import.py and
tests/test_yolo_import.py build them: a torch model of the reference's
layout (the YOLOv8n as ultralytics lays it out and pickles it, a whole
module object), saved with ``torch.save``.  Each loads in both packages to
the same tree, bit-equal.  Models built from the trees agree with the JAX
package within the existing float32 tolerances (U-Net 2e-4, YOLO 2e-3:
convolutions summed in another order).
"""

import numpy as np
import pytest
import torch
import torch.nn as tnn

import cv2
import jax
import jax.numpy as jnp

from openglottal_tpu import utils as jutils
from openglottal_tpu.models.unet import UNet as JUNet
from openglottal_tpu.models.unet import segment_frames as jsegment_frames
from openglottal_tpu.models.yolo import YoloDetector as JYoloDetector
from openglottal_tpu.models.yolo import YOLOv8 as JYOLOv8
from openglottal_tpu.ops.resize import resize_bilinear as jresize_bilinear
from openglottal_tpu.utils import io as jio
from openglottal_tpu.utils.torch_import import (
    unet_to_torch_state_dict as junet_to_torch,
)
from openglottal_tpu.utils.yolo_import import (
    yolo_to_torch_state_dict as jyolo_to_torch,
)
from openglottal_tpu_torch import utils
from openglottal_tpu_torch.data import video
from openglottal_tpu_torch.models.unet import UNet, segment_frames
from openglottal_tpu_torch.models.yolo import YOLOv8, YoloDetector
from openglottal_tpu_torch.ops.resize import letterbox_np
from openglottal_tpu_torch.utils import io
from openglottal_tpu_torch.utils.convert import (
    unet_state_dict_from_jax,
    yolo_state_dict_from_jax,
)
from openglottal_tpu_torch.utils.retry import retry_transient
from openglottal_tpu_torch.utils.torch_import import (
    unet_from_torch,
    unet_to_torch_state_dict,
)
from openglottal_tpu_torch.utils.yolo_import import (
    yolo_from_torch,
    yolo_state_dict_from_pt,
    yolo_to_torch_state_dict,
)

NARROW = (4, 8, 16, 32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes side by side; PyTorch's
    intra-op thread pool in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=""):
    """{'/'-joined path: numpy array} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_same_tree(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert sorted(la) == sorted(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


# ── the reference U-Net as a torch model, saved as .pt ─────────────────────

class _DoubleConv(tnn.Module):
    def __init__(self, i, o):
        super().__init__()
        self.net = tnn.Sequential(
            tnn.Conv2d(i, o, 3, padding=1, bias=False), tnn.BatchNorm2d(o),
            tnn.ReLU(inplace=True),
            tnn.Conv2d(o, o, 3, padding=1, bias=False), tnn.BatchNorm2d(o),
            tnn.ReLU(inplace=True))

    def forward(self, x):
        return self.net(x)


class _RefUNet(tnn.Module):
    """The reference architecture rebuilt for the test."""

    def __init__(self, features=NARROW):
        super().__init__()
        self.downs = tnn.ModuleList()
        self.ups = tnn.ModuleList()
        ch = 1
        for f in features:
            self.downs.append(_DoubleConv(ch, f))
            ch = f
        self.bottleneck = _DoubleConv(ch, ch * 2)
        for f in reversed(features):
            self.ups.append(tnn.ConvTranspose2d(f * 2, f, 2, 2))
            self.ups.append(_DoubleConv(f * 2, f))
        self.head = tnn.Conv2d(features[0], 1, 1)

    def forward(self, x):
        skips = []
        for d in self.downs:
            x = d(x)
            skips.append(x)
            x = tnn.functional.max_pool2d(x, 2, 2)
        x = self.bottleneck(x)
        for i in range(0, len(self.ups), 2):
            x = self.ups[i](x)
            x = self.ups[i + 1](torch.cat([skips[-(i // 2 + 1)], x], 1))
        return self.head(x)


@pytest.fixture(scope="module")
def unet_pt(tmp_path_factory):
    torch.manual_seed(0)
    model = _RefUNet().eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, tnn.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.uniform_(0.5, 1.5)
    d = tmp_path_factory.mktemp("unet_pt")
    paths = {"raw": d / "unet.pt", "state_dict": d / "wrapped_sd.pt",
             "model": d / "wrapped_model.pt"}
    torch.save(model.state_dict(), paths["raw"])
    torch.save({"state_dict": model.state_dict(), "epoch": 3},
               paths["state_dict"])
    torch.save({"model": model.state_dict()}, paths["model"])
    return paths, model


@pytest.mark.parametrize("form", ["raw", "state_dict", "model"])
def test_unet_pt_loads_to_the_jax_packages_tree(unet_pt, form):
    paths, _ = unet_pt
    _assert_same_tree(io.load_unet_weights(paths[form]),
                      jio.load_unet_weights(paths[form]))


def test_unet_pt_model_outputs_and_round_trip(unet_pt):
    """The port's UNet from the loaded tree gives the torch model's and the
    JAX UNet's logits (2e-4); export -> import is exact."""
    paths, model = unet_pt
    tree = io.load_unet_weights(paths["raw"])
    x = np.random.default_rng(1).random((2, 1, 64, 64)).astype(np.float32)
    ours = UNet(features=NARROW)
    ours.load_state_dict(unet_state_dict_from_jax(tree), strict=True)
    with torch.no_grad():
        got = ours.eval()(torch.from_numpy(x)).numpy()
        want = model(torch.from_numpy(x)).numpy()
    jax_out = JUNet(features=NARROW).apply(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x.transpose(0, 2, 3, 1)),
        train=False)
    np.testing.assert_allclose(got, want, atol=2e-4)
    np.testing.assert_allclose(got, np.asarray(jax_out).transpose(0, 3, 1, 2),
                               atol=2e-4)
    sd = unet_to_torch_state_dict(tree)
    jsd = junet_to_torch(tree)
    assert sorted(sd) == sorted(jsd)
    for k in sd:
        np.testing.assert_array_equal(sd[k], np.asarray(jsd[k]), err_msg=k)
    _assert_same_tree(unet_from_torch(sd), tree)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(sd[k], v.numpy(), err_msg=k)


# ── YOLOv8n as ultralytics lays it out, pickled whole ───────────────────────

class Conv(tnn.Module):
    def __init__(self, c1, c2, k=1, s=1):
        super().__init__()
        self.conv = tnn.Conv2d(c1, c2, k, s, k // 2, bias=False)
        self.bn = tnn.BatchNorm2d(c2, eps=1e-3)
        self.act = tnn.SiLU()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class Bottleneck(tnn.Module):
    def __init__(self, c1, c2, shortcut=True):
        super().__init__()
        self.cv1 = Conv(c1, c2, 3)
        self.cv2 = Conv(c2, c2, 3)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(tnn.Module):
    def __init__(self, c1, c2, n=1, shortcut=False):
        super().__init__()
        self.c = c2 // 2
        self.cv1 = Conv(c1, c2, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = tnn.ModuleList(
            Bottleneck(self.c, self.c, shortcut) for _ in range(n))

    def forward(self, x):
        y = list(self.cv1(x).chunk(2, 1))
        y.extend(m(y[-1]) for m in self.m)
        return self.cv2(torch.cat(y, 1))


class SPPF(tnn.Module):
    def __init__(self, c1, c2, k=5):
        super().__init__()
        self.cv1 = Conv(c1, c1 // 2, 1)
        self.cv2 = Conv(c1 // 2 * 4, c2, 1)
        self.m = tnn.MaxPool2d(k, 1, k // 2)

    def forward(self, x):
        x = self.cv1(x)
        y1 = self.m(x)
        y2 = self.m(y1)
        return self.cv2(torch.cat([x, y1, y2, self.m(y2)], 1))


class DFL(tnn.Module):
    def __init__(self, c1=16):
        super().__init__()
        self.conv = tnn.Conv2d(c1, 1, 1, bias=False)
        self.conv.weight.data[:] = torch.arange(
            c1, dtype=torch.float32).view(1, c1, 1, 1)
        self.conv.requires_grad_(False)


class Detect(tnn.Module):
    def __init__(self, nc=1, ch=(64, 128, 256), reg_max=16):
        super().__init__()
        c2, c3 = max(16, ch[0] // 4, reg_max * 4), max(ch[0], min(nc, 100))
        self.cv2 = tnn.ModuleList(
            tnn.Sequential(Conv(c, c2, 3), Conv(c2, c2, 3),
                           tnn.Conv2d(c2, 4 * reg_max, 1)) for c in ch)
        self.cv3 = tnn.ModuleList(
            tnn.Sequential(Conv(c, c3, 3), Conv(c3, c3, 3),
                           tnn.Conv2d(c3, nc, 1)) for c in ch)
        self.dfl = DFL(reg_max)


class DetectionModel(tnn.Module):
    """The v8n layer indices of ultralytics' yolov8.yaml."""

    def __init__(self):
        super().__init__()
        up = tnn.Upsample(scale_factor=2, mode="nearest")
        self.model = tnn.Sequential(
            Conv(3, 16, 3, 2), Conv(16, 32, 3, 2), C2f(32, 32, 1, True),
            Conv(32, 64, 3, 2), C2f(64, 64, 2, True), Conv(64, 128, 3, 2),
            C2f(128, 128, 2, True), Conv(128, 256, 3, 2),
            C2f(256, 256, 1, True), SPPF(256, 256), up, tnn.Identity(),
            C2f(384, 128, 1), up, tnn.Identity(), C2f(192, 64, 1),
            Conv(64, 64, 3, 2), tnn.Identity(), C2f(192, 128, 1),
            Conv(128, 128, 3, 2), tnn.Identity(), C2f(384, 256, 1),
            Detect(1))


@pytest.fixture(scope="module")
def yolo_pt(tmp_path_factory):
    model = DetectionModel().eval()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "dfl" not in name:
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=g) * 0.01)
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=g) * 0.5 + 0.75)
    path = tmp_path_factory.mktemp("yolo_pt") / "fake_ultralytics_v8n.pt"
    torch.save({"model": model.half(), "epoch": 1,
                "train_args": {"imgsz": 256}}, path)
    return path, model.float()


def test_yolo_pt_loads_to_the_jax_packages_tree(yolo_pt):
    path, model = yolo_pt
    tree = io.load_yolo_weights(path)
    _assert_same_tree(tree, jio.load_yolo_weights(path))
    sd = yolo_state_dict_from_pt(path)
    assert sorted(sd) == sorted(model.state_dict())
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(sd[k], v.numpy(), err_msg=k)


def test_yolo_pt_model_outputs_and_round_trip(yolo_pt):
    """The port's YOLOv8 from the loaded tree gives the JAX YOLOv8's level
    outputs (2e-3); export -> import is exact and equal to the JAX
    package's export."""
    path, _ = yolo_pt
    tree = io.load_yolo_weights(path)
    x = np.random.default_rng(1).random((2, 64, 64, 3)).astype(np.float32)
    ours = YOLOv8(nc=1)
    ours.load_state_dict(yolo_state_dict_from_jax(tree), strict=True)
    with torch.no_grad():
        got = ours.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    want = JYOLOv8(nc=1).apply(jax.tree.map(jnp.asarray, tree),
                               jnp.asarray(x), train=False)
    for (gb, gc), (wb, wc) in zip(got, want):
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb), atol=2e-3)
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=2e-3)
    sd = yolo_to_torch_state_dict(tree)
    jsd = jyolo_to_torch(tree)
    assert sorted(sd) == sorted(jsd)
    for k in sd:
        np.testing.assert_array_equal(sd[k], np.asarray(jsd[k]), err_msg=k)
    _assert_same_tree(yolo_from_torch(sd), tree)


# ── .npz both ways; what is refused ─────────────────────────────────────────

def test_save_weights_npz_round_trips_with_the_jax_package(tmp_path):
    tree = io.load_weights_npz("weights/demo_yolo.npz")
    io.save_weights_npz(tree, tmp_path / "a" / "ours.npz")
    _assert_same_tree(jio.load_weights_npz(tmp_path / "a" / "ours.npz"), tree)
    jio.save_weights_npz(tree, tmp_path / "theirs.npz")
    _assert_same_tree(io.load_unet_weights(tmp_path / "theirs.npz"), tree)


def test_checkpoint_directories_and_missing_files_are_refused(tmp_path):
    with pytest.raises(NotImplementedError, match="orbax"):
        io.load_unet_weights(tmp_path)
    with pytest.raises(NotImplementedError, match="orbax"):
        io.load_yolo_weights(tmp_path)
    with pytest.raises(FileNotFoundError):
        io.load_yolo_weights(tmp_path / "nope.pt")


@pytest.mark.parametrize("suffix", [".npy", ".onnx"])
def test_unknown_suffixes_are_refused_not_unpickled(tmp_path, suffix):
    """Only .npz, .pt and .pth are read; a file of any other suffix is
    refused before anything is unpickled."""
    path = tmp_path / f"w{suffix}"
    torch.save({"w": torch.zeros(1)}, path)
    for load in (io.load_unet_weights, io.load_yolo_weights):
        with pytest.raises(ValueError, match=r"\.npz, \.pt or \.pth"):
            load(path)


class _Loud:
    """Pickles as a call of builtins.print, as a hostile file would pickle
    a call of exec."""

    def __reduce__(self):
        return (print, ("unpickled",))


def test_yolo_unpickler_stubs_builtins(tmp_path, capsys):
    """A checkpoint whose pickle calls a builtin loads with the call
    stubbed: nothing of builtins runs."""
    path = tmp_path / "loud.pt"
    torch.save({"model": _Loud()}, path)
    capsys.readouterr()
    with pytest.raises(ValueError, match="no parameters"):
        yolo_state_dict_from_pt(path)
    assert "unpickled" not in capsys.readouterr().out


# ── host letterboxes (cv2 on uint8) ─────────────────────────────────────────

@pytest.mark.parametrize("channels", [0, 3])
def test_letterboxes_equal_cv2(channels):
    rng = np.random.default_rng(channels)
    for h, w in [(240, 320), (200, 240), (256, 256), (37, 91), (300, 17)]:
        shape = (h, w, channels) if channels else (h, w)
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        boxed, pt, pl, ch, cw = utils.letterbox_with_info(img, 256, 5)
        np.testing.assert_array_equal(boxed, jutils.letterbox(img, 256, 5))
        np.testing.assert_array_equal(utils.letterbox(img), letterbox_np(img))
        assert (pt, pl, ch, cw) == jutils.letterbox_with_info(img)[1:]
        other = rng.integers(0, 256, shape, dtype=np.uint8)
        for interp, code in ((None, None), ("nearest", cv2.INTER_NEAREST),
                             ("linear", cv2.INTER_LINEAR),
                             (cv2.INTER_NEAREST, cv2.INTER_NEAREST)):
            np.testing.assert_array_equal(
                utils.letterbox_apply_geometry(other, 256, pt, pl, ch, cw, 0,
                                               interp),
                jutils.letterbox_apply_geometry(other, 256, pt, pl, ch, cw,
                                                0, code))
            np.testing.assert_array_equal(
                utils.unletterbox(boxed, pt, pl, ch, cw, h, w, interp),
                jutils.unletterbox(boxed, pt, pl, ch, cw, h, w, code))
    with pytest.raises(ValueError):
        utils.unletterbox(boxed, pt, pl, ch, cw, 5, 5, "cubic")


# ── segment_frames, YoloDetector ────────────────────────────────────────────

def _narrow_unet_tree(seed, size=64):
    v = JUNet(features=NARROW).init(jax.random.PRNGKey(seed),
                                    jnp.zeros((1, size, size, 1)),
                                    train=False)
    return jax.tree.map(np.asarray, v)


@pytest.mark.parametrize("threshold", [0.5, 0.3])
@pytest.mark.parametrize("hw", [(256, 256), (72, 100)])
def test_segment_frames_within_the_borderline_pixel_count(hw, threshold):
    """Masks equal to the JAX package's but where its probability lies
    within 1e-4 of the threshold (the two packages' float32 convolutions,
    the port's with BatchNorm folded as it serves, round such pixels to
    either side)."""
    tree = _narrow_unet_tree(3)
    frames = np.random.default_rng(4).integers(0, 256, (2,) + hw,
                                               dtype=np.uint8)
    got = segment_frames(tree, frames, threshold=threshold,
                         device="cpu").numpy()
    model = JUNet(features=NARROW)
    want = np.asarray(jsegment_frames(tree, jnp.asarray(frames), model=model,
                                      threshold=threshold))
    x = jnp.asarray(frames, jnp.float32)
    if hw != (256, 256):
        x = jresize_bilinear(x, 256, 256)
    prob = jax.nn.sigmoid(model.apply(tree, (x / 255.0)[..., None],
                                      train=False)[..., 0])
    if hw != (256, 256):
        prob = jresize_bilinear(prob, *hw)
    border = np.abs(np.asarray(prob) - threshold) < 1e-4
    assert got.shape == want.shape and got.dtype == bool
    assert not ((got != want) & ~border).any()
    m = utils.unet_segment_frame(frames[0], tree, device="cpu",
                                 threshold=threshold)
    np.testing.assert_array_equal(m, got[0].astype(np.uint8) * 255)


@pytest.mark.parametrize("hw", [(64, 64), (96, 128)])
def test_yolo_detector_matches_the_jax_package(hw):
    tree = io.load_weights_npz("weights/demo_yolo.npz")
    frames = np.random.default_rng(5).integers(0, 256, (3,) + hw + (3,),
                                               dtype=np.uint8)
    has, box, conf = YoloDetector(tree, conf=0.0, device="cpu"
                                  ).detect_frames(frames)
    w_has, w_box, w_conf = JYoloDetector(tree, conf=0.0).detect_frames(
        jnp.asarray(frames))
    np.testing.assert_array_equal(has.numpy(), np.asarray(w_has))
    np.testing.assert_allclose(conf.numpy(), np.asarray(w_conf), atol=1e-4)
    np.testing.assert_allclose(box.numpy(), np.asarray(w_box), atol=1e-2)


# ── utils surface, retry ────────────────────────────────────────────────────

def test_utils_metrics_and_reader_surface():
    rng = np.random.default_rng(9)
    p, g = rng.random((20, 20)) > 0.5, rng.random((20, 20)) > 0.5
    assert utils.dice(p, g) == jutils.dice(p, g)
    assert utils.iou(p, g) == jutils.iou(p, g)
    z = np.zeros((4, 4))
    assert utils.dice(z, z) == utils.iou(z, z) == 1.0
    logits = rng.normal(0, 1, (2, 8, 8, 1)).astype(np.float32)
    target = (rng.random((2, 8, 8, 1)) > 0.5).astype(np.float32)
    assert abs(float(utils.dice_loss(logits, target))
               - float(jutils.dice_loss(logits, target))) < 1e-6
    assert utils.load_frames_bgr is video.load_frames_bgr


def test_retry_transient():
    calls, errors, sleeps = [], [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return 7

    assert retry_transient(flaky, attempts=3, backoff_s=0.5,
                           on_error=lambda i, e: errors.append(i),
                           sleep=sleeps.append) == 7
    assert errors == [0, 1] and sleeps == [0.5, 1.0]
    with pytest.raises(ValueError, match="always"):
        retry_transient(lambda: (_ for _ in ()).throw(ValueError("always")),
                        attempts=2, sleep=sleeps.append)
    assert sleeps == [0.5, 1.0, 3.0]
