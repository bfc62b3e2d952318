"""The reference-name surfaces, port vs JAX package, on the CPU.

``compat.GlottisDataset`` (PNG frames and masks, letterboxed to 256²) and
``compat.GlottisDatasetHDF5`` (a reference-format HDF5 cache): without
augmentation every item is bit-equal to the JAX package's on the same PNGs
(written by cv2: gray and colour, 256² and other sizes, a label suffix) and
the same ``.h5``; with augmentation items keep the shape, dtype and a
binary mask, and repeat for a seed.  The re-exports: every name the JAX
package's four ``__init__`` files export (``__all__``, their lazy
``__getattr__`` sets and eager imports, read from their sources with
``ast``) resolves in the port to the object of the port's own module, and
importing the port's package loads neither torch nor any of its modules.
"""

import ast
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import openglottal_tpu
from openglottal_tpu import compat as jcompat
from openglottal_tpu import data as jdata
from openglottal_tpu_torch import compat

ROOT = Path(__file__).resolve().parents[1]
SIZES = [(256, 256), (200, 320), (288, 224), (160, 256)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def png_tree(tmp_path_factory):
    """images/ (colour and gray PNGs of four sizes) and labels/ (0/255
    masks under the image's name and as <stem>_seg.png)."""
    root = tmp_path_factory.mktemp("glottis")
    img_dir, lbl_dir = root / "images", root / "labels"
    img_dir.mkdir()
    lbl_dir.mkdir()
    rng = np.random.default_rng(0)
    names = []
    for i, (h, w) in enumerate(SIZES * 2):
        img = rng.integers(0, 256, (h, w, 3) if i % 2 else (h, w), np.uint8)
        yy, xx = np.mgrid[:h, :w]
        msk = (((yy - h / 2) / (h / 5)) ** 2 + ((xx - w / 2) / (w / 9)) ** 2
               < 1).astype(np.uint8) * 255
        name = f"f{i:02d}.png"
        cv2.imwrite(str(img_dir / name), img)
        cv2.imwrite(str(lbl_dir / name), msk)
        cv2.imwrite(str(lbl_dir / f"f{i:02d}_seg.png"), msk)
        names.append(name)
    return names, img_dir, lbl_dir


def _items(ds):
    return [ds[i] for i in range(len(ds))]


def _same(got, want):
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        for g, w in ((gx, wx), (gy, wy)):
            assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
            assert g.shape == (1, 256, 256) == w.shape
            assert torch.equal(g, w)


@pytest.mark.parametrize("label_suffix", ["", "_seg"])
def test_glottis_dataset_bit_equal_to_jax(png_tree, label_suffix):
    names, img_dir, lbl_dir = png_tree
    got = compat.GlottisDataset(names, img_dir, lbl_dir,
                                label_suffix=label_suffix)
    want = jcompat.GlottisDataset(names, img_dir, lbl_dir,
                                  label_suffix=label_suffix)
    assert len(got) == len(want) == len(names)
    _same(_items(got), _items(want))


def test_glottis_dataset_hdf5_bit_equal_to_jax(png_tree, tmp_path):
    from openglottal_tpu_torch.data.dataset import build_glottis_hdf5

    names, img_dir, lbl_dir = png_tree
    h5 = build_glottis_hdf5(names, img_dir, lbl_dir, tmp_path / "c.h5")
    got = compat.GlottisDatasetHDF5(h5)
    want = jcompat.GlottisDatasetHDF5(h5)
    assert got.h5_path == want.h5_path and len(got) == len(names)
    _same(_items(got), _items(want))
    # the PNG dataset's items are the cache's (same letterbox)
    _same(_items(got), _items(compat.GlottisDataset(names, img_dir,
                                                    lbl_dir)))


@pytest.mark.parametrize("kind", ["png", "hdf5"])
def test_augmented_items_shape_binary_and_seeded(png_tree, tmp_path, kind):
    from openglottal_tpu_torch.data.dataset import build_glottis_hdf5

    names, img_dir, lbl_dir = png_tree
    names = names[:3]
    if kind == "png":
        def make(seed):
            return compat.GlottisDataset(names, img_dir, lbl_dir,
                                         augment=True, seed=seed)
    else:
        h5 = build_glottis_hdf5(names, img_dir, lbl_dir, tmp_path / "a.h5")

        def make(seed):
            return compat.GlottisDatasetHDF5(h5, augment=True, seed=seed)
    a, b, c = _items(make(3)), _items(make(3)), _items(make(4))
    plain = _items(compat.GlottisDataset(names, img_dir, lbl_dir))
    for (x, y), (x2, y2), (x3, _), (xp, _) in zip(a, b, c, plain):
        assert x.shape == y.shape == (1, 256, 256)
        assert x.dtype == y.dtype == torch.float32
        assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
        assert set(torch.unique(y).tolist()) <= {0.0, 1.0}
        assert torch.equal(x, x2) and torch.equal(y, y2)
        assert not torch.equal(x, x3)
        assert not torch.equal(x, xp)


def test_missing_file_raises(png_tree):
    names, img_dir, lbl_dir = png_tree
    ds = compat.GlottisDataset(["absent.png"], img_dir, lbl_dir)
    with pytest.raises(FileNotFoundError, match="absent.png"):
        ds[0]


def _jax_exports(module_path: Path) -> set:
    """Names a JAX ``__init__`` exports: its eager ``from ... import``
    names, ``__all__``, the keys of a ``_REF_NAMES`` dict and the strings
    its ``__getattr__`` tests ``name`` against."""
    tree = ast.parse(module_path.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                         ast.Name):
            if node.targets[0].id == "__all__":
                names |= set(ast.literal_eval(node.value))
            elif node.targets[0].id == "_REF_NAMES":
                names |= {k.value for k in node.value.keys}
        elif isinstance(node, ast.FunctionDef) and node.name == "__getattr__":
            for n in ast.walk(node):
                if isinstance(n, ast.Compare) and isinstance(
                        n.comparators[0], (ast.Tuple, ast.Set)):
                    names |= {e.value for e in n.comparators[0].elts}
                elif (isinstance(n, ast.Assign) and isinstance(n.value,
                                                               ast.Set)):
                    names |= {e.value for e in n.value.elts}
                elif isinstance(n, ast.Compare) and isinstance(
                        n.comparators[0], ast.Constant):
                    names.add(n.comparators[0].value)
    return names - {"annotations"}


@pytest.mark.parametrize("package", ["", ".models", ".ops", ".data"])
def test_every_jax_export_resolves_in_the_port(package):
    import importlib

    jax_init = ROOT / "openglottal_tpu" / package.lstrip(".").replace(
        ".", "/") / "__init__.py"
    names = _jax_exports(jax_init)
    assert len(names) >= 4, names
    port = importlib.import_module(f"openglottal_tpu_torch{package}")
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, missing
    for n in names:
        obj = getattr(port, n)
        if n == "__version__":
            assert obj == openglottal_tpu.__version__
            continue
        home = importlib.import_module(obj.__module__)
        assert obj.__module__.startswith("openglottal_tpu_torch.")
        assert getattr(home, n) is obj, n
    if hasattr(port, "__all__"):
        assert set(port.__all__) <= names | {"__version__"}
    with pytest.raises(AttributeError):
        getattr(port, "no_such_name")


def test_reexport_sets_match_the_jax_package():
    import openglottal_tpu_torch as p
    from openglottal_tpu_torch import data

    assert set(p.__all__) == set(openglottal_tpu.__all__)
    assert set(data.__all__) == set(jdata._REF_NAMES) | {
        "load_frames_bgr", "bgr_to_gray_u8"}


def test_importing_the_port_loads_nothing_else():
    code = ("import sys, openglottal_tpu_torch, openglottal_tpu_torch.ops, "
            "openglottal_tpu_torch.models, openglottal_tpu_torch.data\n"
            "mods = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'numpy') or (m.startswith('openglottal_tpu_torch.') "
            "and m.count('.') > 1))\n"
            "print(mods)\n"
            "assert not mods, mods\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(ROOT))
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
