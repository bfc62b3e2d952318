"""Weights across: the port's conversion of the JAX package's weight trees
equals the JAX package's own export to the torch layouts, array by array
(exact), and loads into the port's modules with ``strict=True``."""

import numpy as np
import pytest
import torch

from openglottal_tpu.models import fold as jfold
from openglottal_tpu.utils.torch_import import unet_to_torch_state_dict
from openglottal_tpu.utils.yolo_import import yolo_to_torch_state_dict
from openglottal_tpu_torch.models import fold as tfold
from openglottal_tpu_torch.models.unet import UNet
from openglottal_tpu_torch.models.yolo import YOLOv8
from openglottal_tpu_torch.utils.convert import (
    unet_state_dict_from_jax,
    yolo_state_dict_from_jax,
)
from openglottal_tpu_torch.utils.io import load_weights_npz, resolve_weights_path

CASES = {
    "yolo": ("weights/demo_yolo.npz", yolo_state_dict_from_jax,
             yolo_to_torch_state_dict, lambda fuse: YOLOv8(nc=1, fuse_bn=fuse),
             jfold.fold_yolo, tfold.fold_yolo, 297),
    "unet": ("weights/demo_unet.npz", unet_state_dict_from_jax,
             unet_to_torch_state_dict, lambda fuse: UNet(fuse_bn=fuse),
             jfold.fold_unet, tfold.fold_unet, 100),
}
_TREES = {}


def _tree(name):
    if name not in _TREES:
        _TREES[name] = load_weights_npz(CASES[name][0])
    return _TREES[name]


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


@pytest.mark.parametrize("name", ["yolo", "unet"])
def test_load_weights_npz(name):
    tree = _tree(name)
    assert set(tree) == {"params", "batch_stats"}
    assert sum(1 for _ in _leaves(tree)) == CASES[name][6]
    assert resolve_weights_path("nowhere/" + CASES[name][0].split("/")[1]
                                ).exists()      # weights/<basename> fallback


@pytest.mark.parametrize("name", ["yolo", "unet"])
def test_state_dict_equals_jax_export(name):
    _, to_sd, jax_export, _, _, _, _ = CASES[name]
    got, want = to_sd(_tree(name)), jax_export(_tree(name))
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


@pytest.mark.parametrize("name", ["yolo", "unet"])
def test_loads_strict(name):
    _, to_sd, _, make, _, _, _ = CASES[name]
    model = make(False)
    model.load_state_dict(to_sd(_tree(name)), strict=True)
    n = sum(p.numel() for p in model.parameters() if p.requires_grad)
    # trainable parameters = every leaf of the JAX "params" collection
    assert n == sum(np.asarray(v).size for v in _leaves(_tree(name)["params"]))


@pytest.mark.parametrize("name", ["yolo", "unet"])
def test_fold_equals_jax_fold(name):
    """Folding in the port == folding in the JAX package then converting,
    bit for bit: the same float32 operations in the same order, the square
    root correctly rounded as jnp.sqrt's."""
    _, to_sd, _, make, jax_fold, torch_fold, _ = CASES[name]
    sd = to_sd(_tree(name))
    assert not tfold.is_folded(sd)
    got = torch_fold(sd)
    assert tfold.is_folded(got)
    jfolded = jax_fold(_tree(name))
    jfolded = {"params": _np_tree(jfolded["params"])}
    want = to_sd(jfolded)                      # accepts an already-folded tree
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy().view(np.int32),
                                      want[k].numpy().view(np.int32),
                                      err_msg=k)
    make(True).load_state_dict(got, strict=True)
    assert torch_fold(got) is got              # idempotent


def _np_tree(t):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in t.items()}


@pytest.mark.parametrize("name,stem", [("yolo", tfold.YOLO_STEM),
                                       ("unet", tfold.UNET_STEM)])
def test_absorb_u8_scale(name, stem):
    sd = CASES[name][5](CASES[name][1](_tree(name)))
    out = tfold.absorb_u8_scale(sd, stem)
    assert out[stem].dtype == torch.float32
    np.testing.assert_array_equal(
        out[stem].numpy(), sd[stem].numpy() * np.float32(1.0 / 255.0))
    others = [k for k in sd if k != stem]
    assert all(out[k] is sd[k] for k in others)
