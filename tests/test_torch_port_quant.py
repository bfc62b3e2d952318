"""int8 serving of the port (``models/quant.py``, ``ops/qconv_cuda.py``,
the int8 routes of ``GlottalPipelines``) against the JAX package on the CPU.

Layer level: the plain version of ``og_qconv`` is held bit for bit to the
JAX package's jitted int8 layers on the same int8 input and qparams
(``_qconv_relu_q`` on every U-Net level's shape at narrow width, pad 1 and
the windowed decoder's pad 0; ``_YoloWalk.head_conv``), and ``silu_q`` to
``_YoloWalk.cbs`` (the SiLU's exp in XLA's CPU form, ``exp_xla``).
Model level (narrow U-Net 16-32-64-128 on 64² frames, YOLOv8n on 64²): the
port's own calibration against the JAX package's, the ``.npz`` interchange
both ways, int8 masks against the JAX package's, the windowed tail against
the full tail's window.  Pipeline level: ``GlottalPipelines(quant=...)``
against the JAX package's on two full-width 256² frames with the demo
weights and one calibration through the ``.npz``; the windowed redo, the
cohort, the routes that stay bfloat16, the constructor's checks and the
command line at narrow width.  JAX-side chunk sizes are shrunk in the tests
only, as tests/test_quant.py does.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openglottal_tpu import pipelines as jpipe
from openglottal_tpu.data.synthetic import synthetic_video
from openglottal_tpu.models import fold as jfold
from openglottal_tpu.models import quant as jq
from openglottal_tpu.models.unet import init_unet
from openglottal_tpu.models.yolo import init_yolo
from openglottal_tpu_torch import cli
from openglottal_tpu_torch.models import quant as tq
from openglottal_tpu_torch.models.fold import fold_unet, fold_yolo
from openglottal_tpu_torch.ops.qconv_cuda import qconv, qconv_plain
from openglottal_tpu_torch.pipelines import GlottalPipelines
from openglottal_tpu_torch.utils.convert import (
    unet_state_dict_from_jax,
    yolo_state_dict_from_jax,
)
from openglottal_tpu_torch.utils.io import load_weights_npz

NARROW = (16, 32, 64, 128)
SCALE_RTOL = 0.02       # port vs JAX calibration: bfloat16 convs round apart
_MEMO = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes side by side; PyTorch's
    intra-op thread pool in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _memo(key, make):
    if key not in _MEMO:
        _MEMO[key] = make()
    return _MEMO[key]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _frames(n, size, seed=7):
    """Smooth frames with a dark blob (tests/test_quant.py's recipe)."""
    y, x = np.mgrid[0:size, 0:size]
    out = []
    for i in range(n):
        cx, cy = size // 2 + 3 * i + seed, size // 2 - 2 * i
        blob = np.exp(-(((x - cx) / 9.0) ** 2 + ((y - cy) / 5.0) ** 2))
        base = 150 + 40 * np.sin(x / 11.0 + i) * np.cos(y / 13.0)
        out.append(np.clip(base - 120 * blob, 0, 255))
    return np.stack(out).astype(np.uint8)


def _perturbed(variables, seed):
    """Non-trivial BN statistics, so that activation ranges vary."""
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (np.abs(rng.standard_normal(a.shape)).astype(np.float32)
                      * 0.5 + 0.5
                      if getattr(p[-1], "key", "") == "var"
                      else 0.2 * rng.standard_normal(a.shape).astype(
                          np.float32)), variables["batch_stats"])
    return {"params": jax.device_get(variables["params"]),
            "batch_stats": jax.device_get(stats)}


def _unet_tree(size=64):
    """Narrow U-Net variables with perturbed BN statistics (numpy)."""
    def make():
        _, v = init_unet(jax.random.PRNGKey(3), features=NARROW,
                         dtype=jnp.float32, size=size)
        return _perturbed(v, 3)
    return _memo(("unet_tree", size), make)


def _fg_tree():
    """The narrow 256² U-Net with a steeper head (kernel x 20, bias + 7.1):
    its random logits, all within [-0.42, -0.25] on these videos, spread
    around zero, so that masks are neither empty nor full."""
    def make():
        t = _unet_tree(256)
        head = dict(t["params"]["Conv_0"])
        head["kernel"] = np.asarray(head["kernel"]) * 20.0
        head["bias"] = np.asarray(head["bias"]) + 7.1
        return {"params": {**t["params"], "Conv_0": head},
                "batch_stats": t["batch_stats"]}
    return _memo("fg_tree", make)


def _yolo_tree():
    def make():
        _, v = init_yolo(jax.random.PRNGKey(5), dtype=jnp.float32, size=64)
        return _perturbed(v, 5)
    return _memo("yolo_tree", make)


def _jax_unet_q():
    """The JAX package's calibration of the narrow U-Net on 4 frames."""
    def make():
        folded = jax.device_get(jfold.fold_unet(_unet_tree()))
        return folded, jq.quantize_unet(folded, _frames(4, 64))
    return _memo("jax_unet_q", make)


def _jax_yolo_q(n_calib=1):
    def make():
        folded = jax.device_get(jfold.fold_yolo(_yolo_tree()))
        x = np.random.default_rng(61).integers(0, 256, (n_calib, 64, 64, 3))
        return folded, x.astype(np.float32), jq.quantize_yolo(
            folded, x.astype(np.float32))
    return _memo(("jax_yolo_q", n_calib), make)


# ── quantize_weights ────────────────────────────────────────────────────────

def test_quantize_weights_bit_equal_to_jax():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((3, 3, 16, 32)).astype(np.float32)
    w[..., 3] *= 40.0
    w[..., 5] = 0.0                     # an all-zero channel
    a8, asw = tq.quantize_weights(w)
    b8, bsw = jq.quantize_weights(w)
    np.testing.assert_array_equal(a8, b8)
    np.testing.assert_array_equal(asw, bsw)
    assert a8.dtype == np.int8 and asw.dtype == np.float32 and asw[5] == 1.0


# ── og_qconv's plain version against the JAX package's int8 layers ─────────

def _layer(rng, cin, cout, k):
    w = rng.standard_normal((k, k, cin, cout)).astype(np.float32) * 0.05
    w8, sw = jq.quantize_weights(w)
    b = (rng.standard_normal(cout) * 0.5).astype(np.float32)
    return w8, sw, b


def _port_layer(w8, sw, b):
    return _t(w8.transpose(3, 0, 1, 2)), _t(sw), _t(b)


# every U-Net level's conv at narrow width (16-32-64-128, bottleneck 256) on
# small frames: (label, H, sources' channels, C_out, pad); the decoder's
# concat convs take two sources, pad 0 is the windowed decoder's
UNET_LEVELS = [
    ("enc0.1", 24, (16,), 16, 1), ("enc1.0", 12, (16,), 32, 1),
    ("enc2.1", 6, (64,), 64, 1), ("enc3.0", 4, (64,), 128, 1),
    ("bneck.0", 2, (128,), 256, 1), ("bneck.1", 2, (256,), 256, 1),
    ("dec0.0", 4, (128, 128), 128, 1), ("dec1.0", 6, (64, 64), 64, 1),
    ("dec2.0", 12, (32, 32), 32, 1), ("dec3.1", 24, (16,), 16, 1),
    ("dec2.0 window", 14, (32, 32), 32, 0), ("dec3.0 window", 18, (16, 16),
                                             16, 0),
]


@pytest.mark.parametrize("label,h,srcs,cout,pad", UNET_LEVELS,
                         ids=[c[0] for c in UNET_LEVELS])
def test_qconv_relu_q_bit_equal_to_jax(label, h, srcs, cout, pad):
    """relu_q == ``_qconv_relu_q`` under jax.jit, bit for bit: the fma of
    acc * (sx * sw) + b and the multiply by f32(1 / s_next) that XLA's
    compiled code takes."""
    rng = np.random.default_rng(len(label) * 31 + h)
    xs = [rng.integers(0, 128, (2, h, h, c)).astype(np.int8) for c in srcs]
    w8, sw, b = _layer(rng, sum(srcs), cout, 3)
    sx = float(rng.uniform(0.002, 0.02))
    src = tuple(_t(x) for x in xs)
    # the output scale that clips the largest fifth of a percent or so
    y = qconv(src if len(src) > 1 else src[0], *_port_layer(w8, sw, b), sx,
              pad=pad, epilogue="f32")
    sn = float(y.max()) / 127.0 * 0.9
    layer = {"w8": jnp.asarray(w8), "sw": jnp.asarray(sw),
             "b": jnp.asarray(b)}
    want = np.asarray(jax.jit(lambda x: jq._qconv_relu_q(
        x, layer, sx, sn, pad=pad))(jnp.concatenate(xs, -1)))
    got = qconv(src if len(src) > 1 else src[0], *_port_layer(w8, sw, b), sx,
                pad=pad, epilogue="relu_q", s_next=sn).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.05 < (got != 0).mean() < 0.95 and (got == 127).any()


def _jax_walk_cbs(q, x8, stride, residual):
    walk = jq._YoloWalk(None, "int8", q=q)
    res = (residual, "r") if residual is not None else None
    return walk.cbs("c", (x8, "x"), "y", stride=stride, residual=res)[0]


YOLO_CASES = [("3x3", 3, 1, False), ("3x3 s2", 3, 2, False),
              ("1x1", 1, 1, False), ("3x3 residual", 3, 1, True)]


@pytest.mark.parametrize("label,k,stride,res", YOLO_CASES,
                         ids=[c[0] for c in YOLO_CASES])
def test_qconv_silu_q_tracks_jax_cbs(label, k, stride, res):
    """silu_q == ``_YoloWalk.cbs`` (int8 mode) bit for bit: the SiLU's exp
    takes XLA's CPU form (``exp_xla``)."""
    rng = np.random.default_rng(11 + k + stride)
    x8 = rng.integers(-127, 128, (2, 16, 16, 32)).astype(np.int8)
    w8, sw, b = _layer(rng, 32, 48, k)
    ho = (16 + 2 * (k // 2) - k) // stride + 1
    r8 = (rng.integers(-127, 128, (2, ho, ho, 48)).astype(np.int8)
          if res else None)
    q = {"c": {"w8": jnp.asarray(w8), "sw": jnp.asarray(sw),
               "b": jnp.asarray(b)},
         "act_scales": {"x": 0.011, "y": 0.023, "r": 0.017}}
    want = np.asarray(jax.jit(lambda x, r: _jax_walk_cbs(q, x, stride, r))(
        x8, r8))
    got = qconv(_t(x8), *_port_layer(w8, sw, b), 0.011, stride=stride,
                pad=k // 2, epilogue="silu_q", s_next=0.023,
                residual=None if r8 is None else _t(r8),
                s_res=0.017).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != 0).mean() > 0.05 and np.unique(got).size > 64


def test_qconv_f32_bit_equal_to_jax_head_conv():
    """The f32 epilogue == ``_YoloWalk.head_conv`` (int8 mode), bit for
    bit, for C_out 64 and 1."""
    rng = np.random.default_rng(21)
    x8 = rng.integers(-127, 128, (2, 8, 8, 64)).astype(np.int8)
    for cout in (64, 1):
        w8, sw, b = _layer(rng, 64, cout, 1)
        q = {"h": {"w8": jnp.asarray(w8), "sw": jnp.asarray(sw),
                   "b": jnp.asarray(b)}, "act_scales": {"x": 0.013}}
        want = np.asarray(jax.jit(lambda x: jq._YoloWalk(
            None, "int8", q=q).head_conv("h", (x, "x")))(x8))
        got = qconv(_t(x8), *_port_layer(w8, sw, b), 0.013, pad=0,
                    epilogue="f32").numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_plain_qconv_sums_exactly_past_int16_and_float32():
    """Saturated inputs and weights, K = 9 * 512: sums of 7.4e7 (far above
    2**15, above 2**24) come out as the exact integer's float32 (an int8
    ``F.conv2d`` on the CPU wraps around instead)."""
    x = torch.full((1, 5, 5, 512), 127, dtype=torch.int8)
    w8 = torch.full((3, 3, 3, 512), 127, dtype=torch.int8)
    w8[1] = -127
    w8[2, :, :, :256] = 0
    one, zero = torch.ones(3), torch.zeros(3)
    got = qconv_plain(x, w8, one, zero, 1.0, epilogue="f32")
    acc = np.zeros((5, 5, 3), np.int64)
    xp = np.pad(np.full((5, 5, 512), 127, np.int64), ((1, 1), (1, 1), (0, 0)))
    wn = w8.numpy().astype(np.int64)
    for dy in range(3):
        for dx in range(3):
            acc += np.einsum("hwc,oc->hwo", xp[dy:dy + 5, dx:dx + 5],
                             wn[:, dy, dx])
    assert acc.max() == 9 * 512 * 127 * 127
    np.testing.assert_array_equal(got[0].numpy(), acc.astype(np.float32))


# ── qparams: calibration and the .npz interchange ───────────────────────────

def _port_unet_sd(tree):
    return fold_unet(unet_state_dict_from_jax(tree))


def test_quantize_unet_matches_jax():
    """The port's calibration from its own fold of the same weights, on
    the same frames: act_scales within 2 %, w8 and sw equal (the folds are
    bit-equal)."""
    folded, jqp = _jax_unet_q()
    qp = tq.quantize_unet(_port_unet_sd(_unet_tree()), _frames(4, 64))
    assert qp["act_scales"].keys() == jqp["act_scales"].keys()
    for k, v in jqp["act_scales"].items():
        assert abs(qp["act_scales"][k] - v) <= SCALE_RTOL * v, k
    ref = tq.qparams_from_jax(jqp)
    n = 0
    for name in ref:
        if not name.startswith("DoubleConv_"):
            continue
        for conv in ("Conv_0", "Conv_1"):
            a, b = qp[name][conv]["w8"], ref[name][conv]["w8"]
            np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                          err_msg=f"{name}.{conv}")
            np.testing.assert_array_equal(
                qp[name][conv]["sw"].numpy().view(np.int32),
                ref[name][conv]["sw"].numpy().view(np.int32))
            n += a.numel()
    assert n > 0


def _port_yolo_sd():
    return fold_yolo(yolo_state_dict_from_jax(_yolo_tree()))


def test_quantize_yolo_matches_jax():
    """The port's YOLOv8n calibration against the JAX package's on one
    frame (the JAX package's calibration pass adds frame 0's residual to
    every frame, test below): act_scales within 2 %, w8 within one step."""
    _, x, jqp = _jax_yolo_q(1)
    qp = tq.quantize_yolo(_port_yolo_sd(), x)
    assert qp["act_scales"].keys() == jqp["act_scales"].keys()
    for k, v in jqp["act_scales"].items():
        assert abs(qp["act_scales"][k] - v) <= SCALE_RTOL * v, k
    ref = tq.qparams_from_jax(jqp)
    assert set(qp) == set(ref)
    for path, layer in ref.items():
        if "w8" in layer:
            assert (qp[path]["w8"].int() - layer["w8"].int()).abs().max() <= 1


def test_yolo_calibration_takes_each_frames_residual():
    """On two frames at pct = 100 the port's taps are the max of its taps
    on each frame alone (every frame adds its own C2f residual); the JAX
    package's calibration pass adds frame 0's residual to both
    (``y + residual[0]``), so its C2f scales differ.  The port calibrates
    as the int8 forward computes."""
    sd = _port_yolo_sd()
    x = np.random.default_rng(62).integers(0, 256, (2, 64, 64, 3)).astype(
        np.float32)
    both = tq.quantize_yolo(sd, x)["act_scales"]
    a = tq.quantize_yolo(sd, x[:1])["act_scales"]
    b = tq.quantize_yolo(sd, x[1:])["act_scales"]
    pinned = {n for g in tq._FPN_GROUPS for n in g}
    for k in both:
        if k not in pinned:
            assert both[k] == max(a[k], b[k]), k
    jboth = jq.quantize_yolo(jax.device_get(jfold.fold_yolo(_yolo_tree())),
                             x)["act_scales"]
    assert any(abs(jboth[k] - both[k]) > SCALE_RTOL * both[k]
               for k in both if k.endswith("_cv1"))


def _flat_jax_yolo(tree):
    """The JAX package's ``load_qparams`` nests the yolo conv paths; its
    int8 walker indexes them flat (see ROADMAP C)."""
    out = {k: tree[k] for k in ("act_scales", "stem_bf16")}
    out.update(tq._flat_convs({k: v for k, v in tree.items()
                               if k not in out}))
    return out


def _assert_same_jax_trees(a, b):
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = jax.tree_util.tree_flatten_with_path(b)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        if isinstance(x, float):
            assert isinstance(y, float) and x == y, p
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype, (p, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y)


def test_npz_interchange_both_ways(tmp_path):
    """JAX save_qparams -> port load_qparams -> port save_qparams -> JAX
    load_qparams gives the JAX package's own reload, leaf for leaf (int8
    kernels, f32 scales and biases, bfloat16 leaves, float act_scales), and
    the port's load equals qparams_from_jax of the in-memory tree."""
    _, jqu = _jax_unet_q()
    _, _, jqy = _jax_yolo_q(1)
    tree = {"unet": jqu, "yolo": jqy}
    jq.save_qparams(tree, tmp_path / "jax.npz")
    port = tq.load_qparams(tmp_path / "jax.npz")
    tq.save_qparams(port, tmp_path / "port.npz")
    _assert_same_jax_trees(jq.load_qparams(tmp_path / "port.npz"),
                           jq.load_qparams(tmp_path / "jax.npz"))
    direct = tq.qparams_from_jax(tree)
    for model in tree:
        assert direct[model]["act_scales"] == port[model]["act_scales"]
        assert all(isinstance(v, float)
                   for v in port[model]["act_scales"].values())
        for key, node in direct[model].items():
            if key == "act_scales":
                continue
            layers = node if any(isinstance(v, dict) for v in node.values()) \
                else {"": node}
            for sub, layer in layers.items():
                other = port[model][key][sub] if sub else port[model][key]
                for leaf, t in layer.items():
                    assert other[leaf].dtype == t.dtype
                    assert torch.equal(other[leaf], t), (model, key, leaf)


# ── the int8 U-Net ──────────────────────────────────────────────────────────

def test_qunet_masks_agree_with_jax():
    """Carried-across qparams: the port's int8 masks agree with the JAX
    package's on > 99 % of pixels, and every flip sits where the JAX
    package's logit is within 10 % of its range of zero (the bfloat16 stem
    and upsamplers round apart; every int8 layer is exact)."""
    _, jqp = _jax_unet_q()
    g = _frames(4, 64, seed=2)
    logits = np.asarray(jax.jit(lambda q, x: jq.qunet_tail_from_d3_full(
        q, *jq.qunet_to_d3(q, x)))(jqp, jnp.asarray(g)))
    got = tq.qunet_masks(tq.qparams_from_jax(jqp), _t(g)).numpy()
    ref = logits > 0
    assert (got == ref).mean() > 0.99
    flips = got != ref
    if flips.any():
        assert np.abs(logits[flips]).max() < 0.1 * np.abs(logits).max()


def _window_setup():
    def make():
        folded = jax.device_get(jfold.fold_unet(_unet_tree(256)))
        g = (np.random.default_rng(7).random((1, 256, 256)) * 255).astype(
            np.uint8)
        qp = tq.quantize_unet(_port_unet_sd(_unet_tree(256)), g)
        enc = tq.qunet_to_d3(qp, _t(g))
        return qp, g, enc, tq.qunet_tail_from_d3_full(qp, *enc)
    return _memo("window", make)


def test_d3_split_composes_to_qunet_logits():
    qp, g, (x8, skip1, skip2), full = _window_setup()
    assert x8.shape == (1, 64, 64, 64) and x8.dtype == torch.int8
    assert skip1.shape == (1, 256, 256, 16) and skip2.shape == (1, 128, 128,
                                                                32)
    assert torch.equal(tq.qunet_logits(qp, _t(g)), full)
    assert torch.equal(tq.qunet_masks(qp, _t(g)), full > 0)


@pytest.mark.parametrize("origin", [(66, 38), (6, 6), (90, 90), (6, 90)])
def test_windowed_tail_equals_full_window(origin):
    """The windowed int8 tail equals the full tail's window, bit for bit,
    with the origin as ints and as 0-d tensors (the device form)."""
    qp, _, (x8, skip1, skip2), full = _window_setup()
    oy, ox = origin
    want = full[:, oy:oy + 160, ox:ox + 160]
    got = tq.qunet_tail_from_d3_window(qp, x8, skip1, skip2, oy, ox)
    assert torch.equal(got, want)
    got_t = tq.qunet_tail_from_d3_window(qp, x8, skip1, skip2,
                                         torch.tensor(oy), torch.tensor(ox))
    assert torch.equal(got_t, want)


# ── pipelines ───────────────────────────────────────────────────────────────

DEMO = dict(unet_variables="weights/demo_unet.npz",
            yolo_variables="weights/demo_yolo.npz", conf=0.25)


def _gray(t, seed=11, size=256):
    return np.ascontiguousarray(synthetic_video(t=t, size=size,
                                                seed=seed)[0][..., 0])


@pytest.fixture()
def _small_jax_chunks():
    """The JAX package's whole-video graphs pad to CHUNK frames; two here,
    in the test only (tests/test_quant.py does the same)."""
    old = jpipe.CHUNK, jpipe._bucket
    jpipe.CHUNK = 2
    jpipe._bucket = lambda t, chunk=2: max(chunk, -(-t // chunk) * chunk)
    yield
    jpipe.CHUNK, jpipe._bucket = old


def test_int8_pipelines_track_jax(tmp_path, _small_jax_chunks):
    """GlottalPipelines(quant="int8" | "int8-full") against the JAX
    package's on two 256² frames (the demo detector at full width, the
    narrow U-Net: the int8 routes never run the float U-Net; f32), with ONE
    calibration made by the port and carried through the .npz: unet
    (windowed) and unet-only within the JAX tests' 0.08 per-frame relative
    bound (tests/test_quant.py)."""
    g = _gray(2)
    w = dict(unet_variables=_fg_tree(), conf=DEMO["conf"],
             yolo_variables=load_weights_npz(DEMO["yolo_variables"]))
    ours = GlottalPipelines(quant="int8-full", dtype=torch.float32,
                            device="cpu", **w)
    ours.calibrate(g)
    ours.save_qparams(tmp_path / "q.npz")
    for mode in ("int8", "int8-full"):
        port = GlottalPipelines(quant=mode, dtype=torch.float32,
                                device="cpu", **w)
        port.load_qparams(tmp_path / "q.npz")
        if mode == "int8":
            port._qparams.pop("yolo")
        theirs = jpipe.GlottalPipelines(quant=mode, dtype=jnp.float32, **w)
        theirs.load_qparams(tmp_path / "q.npz")
        if mode == "int8":
            theirs._qparams.pop("yolo")
        else:
            theirs._qparams["yolo"] = _flat_jax_yolo(theirs._qparams["yolo"])
        got = port.yolo_unet_areas_gray(g).numpy()
        want = np.asarray(theirs.yolo_unet_areas_gray(g))
        assert (np.abs(got - want) / np.maximum(want, 1.0)).max() < 0.08, (
            mode, got, want)
        assert 0 < want.max() < 256 * 256
    got5 = port.unet_only_areas(g).numpy()
    want5 = np.asarray(theirs.unet_only_areas(g))
    assert (np.abs(got5 - want5) / np.maximum(want5, 1.0)).max() < 0.08


def _narrow_npz(tmp_path):
    """:func:`_fg_tree` (unfolded) as an .npz file."""
    path = tmp_path / "narrow_unet.npz"
    flat = {}

    def walk(prefix, node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(f"{prefix}/{k}" if prefix else k, v)
            else:
                flat[f"{prefix}/{k}"] = np.asarray(v)
    walk("", _fg_tree())
    np.savez(path, **flat)
    return str(path)


def _narrow(quant, **kw):
    return GlottalPipelines(unet_variables=_unet_tree(256),
                            yolo_variables=DEMO["yolo_variables"],
                            dtype=torch.float32, device="cpu", quant=quant,
                            **kw)


def test_windowed_redo_equals_full_frame_route():
    """Random-init detector with conf=0: boxes that do not fit the window,
    ``ok`` False, and the redo through the int8 full-frame route equals
    window_decoder=False bit for bit (same calibration)."""
    g = _gray(2, seed=9)
    _, yv = init_yolo(jax.random.PRNGKey(2), dtype=jnp.float32)
    kw = dict(unet_variables=_unet_tree(256), yolo_variables=jax.device_get(
        yv), conf=0.0, dtype=torch.float32, device="cpu", quant="int8")
    pw = GlottalPipelines(**kw)
    pf = GlottalPipelines(window_decoder=False, **kw)
    assert pw.window_decoder and not pf.window_decoder
    pw.calibrate(g)
    pf._qparams = pw._qparams
    pending = pw.yolo_unet_areas_deferred(g)
    assert pending[1] is not None and not bool(pending[1])
    want = pf.yolo_unet_areas_gray(g).numpy()
    np.testing.assert_array_equal(pw.yolo_unet_areas_resolve(pending), want)


def test_int8_cohort_equals_per_video():
    """The int8 cohort (mixed lengths, both routes) equals the per-video
    int8 calls exactly."""
    vids = [_gray(2, seed=1), _gray(1, seed=2)]
    for window in (None, False):
        p = _narrow("int8", window_decoder=window)
        p.calibrate(vids[0])
        per = [p.yolo_unet_areas_gray(v).numpy() for v in vids]
        multi = p.yolo_unet_areas_gray_multi(vids, max_k=2)
        for a, b in zip(multi, per):
            np.testing.assert_array_equal(a, b)


def test_quant_constructor_checks():
    with pytest.raises(ValueError, match="quant"):
        GlottalPipelines(unet_variables=_unet_tree(256), quant="fp4",
                         device="cpu")
    with pytest.raises(ValueError, match="folded"):
        GlottalPipelines(unet_variables=_unet_tree(256), quant="int8",
                         fold_bn=False, device="cpu")
    with pytest.raises(ValueError, match="calibrate"):
        GlottalPipelines(unet_variables=_unet_tree(256), quant="int8",
                         device="cpu").save_qparams("never.npz")


def test_bf16_routes_stay_unquantized():
    """Under quant, vft, colour input, other frame sizes, run_pipeline_full
    and streams take the float routes: equal to quant=None, and no
    calibration is made."""
    g = _gray(8, seed=4)
    q, f = _narrow("int8-full"), _narrow(None)
    np.testing.assert_array_equal(q.vft_areas(g), f.vft_areas(g))
    bgr = np.stack([g, np.roll(g, 1, 1), g], -1)[:2]
    np.testing.assert_array_equal(q.yolo_unet_areas(bgr).numpy(),
                                  f.yolo_unet_areas(bgr).numpy())
    small = np.ascontiguousarray(g[:2, :200, :240])
    np.testing.assert_array_equal(q.unet_only_areas(small).numpy(),
                                  f.unet_only_areas(small).numpy())
    np.testing.assert_array_equal(q.run_pipeline_full(g[:2], "unet")[3],
                                  f.run_pipeline_full(g[:2], "unet")[3])
    np.testing.assert_array_equal(q.stream_areas(iter([g[:2]]), "unet"),
                                  f.stream_areas(iter([g[:2]]), "unet"))
    assert q._qparams is None


def test_cli_run_quant_writes_then_reads_qparams(tmp_path, monkeypatch):
    """``run --quant int8 --qparams f.npz`` calibrates on the input video and
    writes the file; a second run reads it back (no calibration) and writes
    the same features; --qparams without --quant is a parser error."""
    import cv2

    g = _gray(3, seed=5)
    avi = str(tmp_path / "clip.avi")
    wr = cv2.VideoWriter(avi, 0, 30, (256, 256), isColor=False)
    for f in g:
        wr.write(f)
    wr.release()
    unet = _narrow_npz(tmp_path)
    qpath = tmp_path / "q" / "qp.npz"
    argv = ["run", avi, "--pipeline", "unet-only", "--unet-weights", unet,
            "--device", "cpu", "--quant", "int8", "--qparams", str(qpath)]
    calls = []
    orig = GlottalPipelines.calibrate
    monkeypatch.setattr(GlottalPipelines, "calibrate",
                        lambda self, x: calls.append(1) or orig(self, x))
    cli.main(argv + ["-o", str(tmp_path / "a")])
    assert qpath.exists() and len(calls) == 1
    cli.main(argv + ["-o", str(tmp_path / "b")])
    assert len(calls) == 1
    a = (tmp_path / "a" / "features.json").read_text()
    assert a == (tmp_path / "b" / "features.json").read_text()
    with pytest.raises(SystemExit) as e:
        cli.main(["run", avi, "--pipeline", "unet-only", "--unet-weights",
                  unet, "--device", "cpu", "--qparams", str(qpath)])
    assert e.value.code == 2
