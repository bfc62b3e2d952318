"""Datasets, port vs JAX package (and cv2) on the CPU: the PNG reader
(``data/png.py``), cv2's INTER_NEAREST (``ops/resize.resize_nearest_cv2``),
``data/dataset.py``, ``data/crop_dataset.py``, ``data/yolo_dataset.py`` and
``data/kaggle_paths.py``.

Bit-equal throughout: the reader against ``cv2.imread`` (IMREAD_GRAYSCALE
and IMREAD_COLOR) on PNGs written in ``tmp_path`` with every row filter
(the port's writer, cv2's and PIL's), 8-bit gray, gray + alpha, RGB, RGBA
and palette, 1/2/4-bit gray and palette, odd sizes; the nearest resize
against cv2 at up- and down-scales; ``materialize_split`` (letterboxed and
not, a label suffix, the ``.npz`` cache shared with the JAX package),
the GT crop functions, the YOLO crop function (``weights/demo_yolo.npz`` on
12 frames, float32 detectors in both packages), ``mask_to_yolo``,
``build_yolo_dataset`` and ``load_yolo_arrays`` against the JAX package's.
"""

import json
import struct
import zlib

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from openglottal_tpu import pipelines as jpipe
from openglottal_tpu.data import crop_dataset as jcrop
from openglottal_tpu.data import dataset as jds
from openglottal_tpu.data import yolo_dataset as jyd
from openglottal_tpu.utils.io import load_weights_npz as jload
from openglottal_tpu_torch.data import crop_dataset, dataset, kaggle_paths
from openglottal_tpu_torch.data import png, yolo_dataset
from openglottal_tpu_torch.data.synthetic import synthetic_video
from openglottal_tpu_torch.ops.resize import resize_nearest_cv2
from openglottal_tpu_torch.pipelines import GlottalPipelines


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_as_cv2(path):
    for ours, flag in ((png.imread_gray, cv2.IMREAD_GRAYSCALE),
                       (png.imread_bgr, cv2.IMREAD_COLOR)):
        want = cv2.imread(str(path), flag)
        got = ours(path)
        assert got.dtype == np.uint8 and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=f"{path} {flag}")


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4)])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_reader_equals_cv2_for_every_filter(tmp_path, filters, channels):
    rng = np.random.default_rng(channels * 10 + len(filters))
    img = rng.integers(0, 256, (37, 53, channels)).astype(np.uint8)
    img[:5] = img[:5, :, :1]                       # gray pixels among colour
    img[5:9] = 255
    path = tmp_path / "x.png"
    png.write_png(path, img[..., 0] if channels == 1 else img,
                  filters=filters)
    _same_as_cv2(path)


def test_png_reader_equals_cv2_on_cv2_and_pil_files(tmp_path):
    rng = np.random.default_rng(1)
    colour = rng.integers(0, 256, (64, 80, 3)).astype(np.uint8)
    gray = rng.integers(0, 256, (31, 17)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "c.png"), colour)
    cv2.imwrite(str(tmp_path / "g.png"), gray)
    cv2.imwrite(str(tmp_path / "c9.png"), colour,
                [cv2.IMWRITE_PNG_COMPRESSION, 9])
    Image.fromarray(colour).save(tmp_path / "pil_rgb.png")
    Image.fromarray(np.dstack([colour, gray[:1, :1].repeat(64, 0).repeat(
        80, 1)])).save(tmp_path / "pil_rgba.png")
    for n_col in (2, 4, 16, 200):                  # 1/2/4/8-bit palettes
        idx = rng.integers(0, n_col, (29, 41)).astype(np.uint8)
        im = Image.fromarray(idx, mode="P")
        im.putpalette(rng.integers(0, 256, 3 * n_col).astype(
            np.uint8).tolist())
        im.save(tmp_path / f"pal{n_col}.png")
    Image.fromarray(gray > 128).save(tmp_path / "bits1.png")   # 1-bit gray
    for p in sorted(tmp_path.glob("*.png")):
        _same_as_cv2(p)


def test_png_reader_equals_cv2_on_low_bit_gray(tmp_path):
    """1-, 2- and 4-bit gray written by hand (PIL writes only 1-bit)."""
    rng = np.random.default_rng(2)
    for depth in (1, 2, 4):
        w, h = 19, 7
        v = rng.integers(0, 1 << depth, (h, w)).astype(np.uint8)
        per = 8 // depth
        rows = b""
        for y in range(h):
            packed = np.zeros((w + per - 1) // per, np.uint8)
            for x in range(w):
                packed[x // per] |= v[y, x] << (8 - depth * (x % per + 1))
            rows += b"\x00" + packed.tobytes()

        def chunk(k, b):
            return (struct.pack(">I", len(b)) + k + b
                    + struct.pack(">I", zlib.crc32(k + b) & 0xFFFFFFFF))

        data = (b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 0, 0,
                                             0, 0))
                + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))
        path = tmp_path / f"d{depth}.png"
        path.write_bytes(data)
        _same_as_cv2(path)


def test_png_reader_refuses_16_bit_and_interlaced(tmp_path):
    cv2.imwrite(str(tmp_path / "w.png"), np.full((4, 4), 999, np.uint16))
    with pytest.raises(ValueError, match="16-bit"):
        png.imread_gray(tmp_path / "w.png")
    data = bytearray(png.encode_png(np.zeros((4, 4), np.uint8)))
    data[28] = 1                                   # IHDR's interlace byte
    (tmp_path / "i.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="interlaced"):
        png.imread_bgr(tmp_path / "i.png")
    (tmp_path / "n.png").write_bytes(b"not a png")
    with pytest.raises(ValueError):
        png.imread_gray(tmp_path / "n.png")
    assert png.imread_gray(tmp_path / "missing.png") is None
    assert cv2.imread(str(tmp_path / "missing.png")) is None


@pytest.mark.parametrize("src", [(37, 53), (240, 320), (256, 256),
                                 (100, 7), (3, 300)])
def test_nearest_resize_equals_cv2(src):
    rng = np.random.default_rng(src[0])
    img = rng.integers(0, 256, src).astype(np.uint8)
    for out in ((256, 256), (192, 256), (19, 31), (255, 1), (512, 300)):
        want = cv2.resize(img, (out[1], out[0]),
                          interpolation=cv2.INTER_NEAREST)
        np.testing.assert_array_equal(resize_nearest_cv2(img, out[1], out[0]),
                                      want)
    colour = rng.integers(0, 256, src + (3,)).astype(np.uint8)
    np.testing.assert_array_equal(
        resize_nearest_cv2(colour, 97, 61),
        cv2.resize(colour, (97, 61), interpolation=cv2.INTER_NEAREST))


# ── dataset functions vs the JAX package ────────────────────────────────────

def _write_split(root, n=12, seed=0, suffix="", sizes=((256, 256),)):
    """PNG frames (gray, colour and letterboxed sizes) and masks of a
    realistic synthetic clip, and a training.json."""
    frames, masks = synthetic_video(t=n, seed=seed, realistic=True)
    img_dir, lbl_dir = root / "images", root / "labels"
    img_dir.mkdir(parents=True, exist_ok=True)
    lbl_dir.mkdir(parents=True, exist_ok=True)
    names = []
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        f = cv2.resize(frames[i], (w, h), interpolation=cv2.INTER_AREA)
        m = cv2.resize(masks[i].astype(np.uint8) * 255, (w, h),
                       interpolation=cv2.INTER_NEAREST)
        if i == 3:
            m[:] = 0                                # an empty mask
        name = f"f{i:03d}.png"
        png.write_png(img_dir / name, f[..., ::-1] if i % 2 else
                      cv2.cvtColor(f, cv2.COLOR_BGR2GRAY),
                      filters=(i % 5,))
        png.write_png(lbl_dir / f"f{i:03d}{suffix}.png", m)
        names.append(name)
    split = {"training": names[:8], "Val": names[8:], "test": names[:2]}
    (root / "training.json").write_text(json.dumps(split))
    return img_dir, lbl_dir, names


@pytest.mark.parametrize("suffix,sizes", [("", ((256, 256),)),
                                          ("_seg", ((240, 320), (256, 256),
                                                    (200, 150)))])
def test_materialize_split_and_gt_crops_match_jax(tmp_path, suffix, sizes):
    img_dir, lbl_dir, names = _write_split(tmp_path, suffix=suffix,
                                           sizes=sizes)
    ti, tm = dataset.materialize_split(names, img_dir, lbl_dir, suffix)
    ji, jm = jds.materialize_split(names, img_dir, lbl_dir, suffix)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tm, jm)
    # the .npz cache: the JAX package's key and layout, read either way
    cache = tmp_path / "cache"
    jds.materialize_split(names[:5], img_dir, lbl_dir, suffix,
                          cache_dir=cache)
    files = sorted(cache.iterdir())
    ci, cm = dataset.materialize_split(names[:5], img_dir, lbl_dir, suffix,
                                       cache_dir=cache)
    assert sorted(cache.iterdir()) == files
    np.testing.assert_array_equal(ci, ji[:5])
    for pad in (0, 8):
        tci, tcm = crop_dataset.materialize_gt_crops(
            names, img_dir, lbl_dir, pad=pad, label_suffix=suffix,
            cache_dir=tmp_path / "c2")
        jci, jcm = jcrop.materialize_gt_crops(names, img_dir, lbl_dir,
                                              pad=pad, label_suffix=suffix)
        assert len(tci) == len(names) - 1          # the empty mask skipped
        np.testing.assert_array_equal(tci, jci)
        np.testing.assert_array_equal(tcm, jcm)
    tai, tam = crop_dataset.materialize_gt_crops_arrays(ti, tm, pad=5)
    jai, jam = jcrop.materialize_gt_crops_arrays(ji, jm, pad=5)
    np.testing.assert_array_equal(tai, jai)
    np.testing.assert_array_equal(tam, jam)
    assert dataset.load_split_json(tmp_path / "training.json") == \
        jds.load_split_json(tmp_path / "training.json")
    with pytest.raises(FileNotFoundError):
        dataset.materialize_split(["nope.png"], img_dir, lbl_dir)


def test_materialize_yolo_crops_matches_jax(tmp_path, monkeypatch):
    """demo_yolo.npz on 12 frames, every frame gated on its own, float32 in
    both packages: the same frames kept and the same crops."""
    img_dir, lbl_dir, names = _write_split(tmp_path, seed=3)
    monkeypatch.setattr(jpipe, "CHUNK", 12)
    jp = jpipe.GlottalPipelines(yolo_variables=jload("weights/demo_yolo.npz"),
                                dtype=jnp.float32)
    tp = GlottalPipelines(yolo_variables="weights/demo_yolo.npz",
                          dtype=torch.float32, device="cpu")
    ti, tm = crop_dataset.materialize_yolo_crops(names, img_dir, lbl_dir, tp,
                                                 cache_dir=tmp_path / "c")
    ji, jm = jcrop.materialize_yolo_crops(names, img_dir, lbl_dir, jp)
    assert len(ti) > 0
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tm, jm)
    again = crop_dataset.materialize_yolo_crops(names, img_dir, lbl_dir, tp,
                                                cache_dir=tmp_path / "c")
    np.testing.assert_array_equal(again[0], ti)


def test_yolo_dataset_functions_match_jax(tmp_path):
    img_dir, lbl_dir, names = _write_split(
        tmp_path / "src", suffix="_seg", sizes=((256, 256), (240, 320)))
    for name in names[:6]:
        mp = lbl_dir / name.replace(".png", "_seg.png")
        assert yolo_dataset.mask_to_yolo(mp) == jyd.mask_to_yolo(mp)
        assert yolo_dataset.mask_to_yolo(mp, dilate=3, img_wh=(320, 240)) \
            == jyd.mask_to_yolo(mp, dilate=3, img_wh=(320, 240))
    tj = tmp_path / "src" / "training.json"
    ours = yolo_dataset.build_yolo_dataset(img_dir, lbl_dir, tj,
                                           tmp_path / "ours",
                                           mask_suffix="_seg")
    ref = jyd.build_yolo_dataset(img_dir, lbl_dir, tj, tmp_path / "ref",
                                 mask_suffix="_seg")
    assert ours.name == ref.name == "dataset.yaml"
    ofiles = sorted(p.relative_to(tmp_path / "ours")
                    for p in (tmp_path / "ours").rglob("*.txt"))
    rfiles = sorted(p.relative_to(tmp_path / "ref")
                    for p in (tmp_path / "ref").rglob("*.txt"))
    assert ofiles == rfiles and ofiles
    for f in ofiles:
        assert (tmp_path / "ours" / f).read_text() == \
            (tmp_path / "ref" / f).read_text()
    ti, tb = yolo_dataset.load_yolo_arrays(names, img_dir, lbl_dir,
                                           mask_suffix="_seg")
    ji, jb = jyd.load_yolo_arrays(names, img_dir, lbl_dir,
                                  mask_suffix="_seg")
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tb, jb)
    assert (tb[:, 0] < 0).sum() == 1                # the empty mask


def test_hdf5_cache_round_trip(tmp_path):
    pytest.importorskip("h5py")
    img_dir, lbl_dir, names = _write_split(tmp_path, n=4)
    out = dataset.build_glottis_hdf5(names, img_dir, lbl_dir,
                                     tmp_path / "x_train.h5")
    ti, tm = dataset.load_glottis_hdf5(out)
    ji, jm = jds.load_glottis_hdf5(out)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(
        ti, dataset.materialize_split(names, img_dir, lbl_dir)[0])


def test_kaggle_paths(tmp_path, monkeypatch):
    monkeypatch.setattr(kaggle_paths, "KAGGLE_INPUT", tmp_path / "missing")
    assert kaggle_paths.get_kaggle_bagls_path("training") is None
    monkeypatch.setattr(kaggle_paths, "KAGGLE_INPUT", tmp_path)
    assert kaggle_paths.get_kaggle_bagls_path("training") is None
    ds = tmp_path / "bagls-dataset" / "training"
    ds.mkdir(parents=True)
    (ds / "0_seg.png").write_bytes(b"")
    assert kaggle_paths.get_kaggle_bagls_path("training") == ds
    assert kaggle_paths.resolve_kaggle_data_paths("BAGLS", "training") == \
        (ds, ds)
    assert kaggle_paths.resolve_kaggle_data_paths("girafe", "training") is \
        None


# ── the command line ────────────────────────────────────────────────────────

def test_cli_build_dataset_and_train_commands(tmp_path, capsys, monkeypatch):
    """``cli build-dataset`` == the JAX package's build_yolo_dataset; ``cli
    train-unet`` and ``train-unet-crop --mode gt|yolo`` train on a PNG
    split (on the CPU, with the trainer and the detector narrowed to a U-Net
    of features 8-64 in f32 and an f32 detector) and end on their JSON lines
    with checkpoints that ``load_unet_weights`` reads."""
    import functools

    from openglottal_tpu_torch import cli, pipelines
    from openglottal_tpu_torch.train import unet_trainer
    from openglottal_tpu_torch.utils.io import load_unet_weights

    monkeypatch.setattr(unet_trainer, "UNetTrainer", functools.partial(
        unet_trainer.UNetTrainer, features=(8, 16, 32, 64),
        dtype=torch.float32))
    monkeypatch.setattr(pipelines, "GlottalPipelines", functools.partial(
        pipelines.GlottalPipelines, dtype=torch.float32))

    img_dir, lbl_dir, names = _write_split(tmp_path / "src", n=10)
    tj = str(tmp_path / "src" / "training.json")
    cli.main(["build-dataset", "--images-dir", str(img_dir), "--labels-dir",
              str(lbl_dir), "--training-json", tj, "--output-dir",
              str(tmp_path / "yd")])
    jyd.build_yolo_dataset(img_dir, lbl_dir, tj, tmp_path / "yd_ref")
    for f in (tmp_path / "yd_ref").rglob("*.txt"):
        rel = f.relative_to(tmp_path / "yd_ref")
        assert (tmp_path / "yd" / rel).read_text() == f.read_text()
    common = ["--images-dir", str(img_dir), "--labels-dir", str(lbl_dir),
              "--training-json", tj, "--epochs", "1", "--batch", "4",
              "--device", "cpu", "--cache-dir", str(tmp_path / "cache")]
    out = cli.main(["train-unet", *common, "--output-dir",
                    str(tmp_path / "u")])
    assert np.isfinite(out["best_val_loss"]) and out["epochs_run"] == 1
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == out
    load_unet_weights(tmp_path / "u" / "best.pt")
    out = cli.main(["train-unet", *common, "--output-dir",
                    str(tmp_path / "u2"), "--resume",
                    str(tmp_path / "u" / "best.pt")])
    assert np.isfinite(out["best_val_loss"])
    for mode in ("gt", "yolo"):
        out = cli.main(["train-unet-crop", *common, "--mode", mode,
                        "--yolo-weights", "weights/demo_yolo.npz",
                        "--output-dir", str(tmp_path / f"c_{mode}")])
        assert isinstance(out["best_val_loss"], float), mode
        rec = json.loads((tmp_path / f"c_{mode}" / "metrics.jsonl"
                          ).read_text().splitlines()[-1])
        assert np.isfinite(rec["loss/train"]), mode
        load_unet_weights(tmp_path / f"c_{mode}" / "latest.pt")
    with pytest.raises(SystemExit):
        cli.main(["train-unet-crop", *common, "--mode", "yolo"])
    with pytest.raises(SystemExit):
        cli.main(["build-dataset", "--images-dir", "x"])
