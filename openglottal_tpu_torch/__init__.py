"""PyTorch/CUDA port of openglottal_tpu for NVIDIA Hopper (H100).

Same layout and names as the JAX package (``models/yolo.py``,
``models/gate.py``, ``ops/blobs.py``, ``pipelines.py``, ``features.py`` ...)
so a reader finds each counterpart; PyTorch idiom inside.  The package
imports ``torch``, numpy and scipy (``matplotlib`` and ``h5py`` only inside
the functions that plot or read HDF5).  The hand-written CUDA kernels live
in ``csrc/`` and are compiled with ``nvcc`` at first use
(``ops/_build.py``).

Served: the five pipelines (``vft``, ``guided-vft``, ``unet``,
``crop-unet``, ``unet-only``) for gray or BGR video of any frame size,
through ``GlottalPipelines.extract_features`` and ``run_pipeline_full``,
with ``unet``'s windowed decoder on 256² monochrome video; cohorts of
videos (``*_gray_multi``); streams of chunks in bounded memory
(``stream_areas``, ``stream_features``); int8 serving (``quant="int8"`` /
``"int8-full"``, ``models/quant.py``); evaluation (``eval.py``); the AVI
reader with MJPG decoded on the card (``data/video.py``); training
(``train/``) with its datasets; the command line (``cli.py``: ``run``,
``build-dataset``, the trainers, ``eval-girafe``, ``eval-bagls``,
``sweep-bagls``, ``analyze-gaw``, ``plot-gaw``) over the scripts of
``scripts/`` (the self-test ``scripts/selftest_e2e.py`` among them); the
config and the reference's frame-at-a-time API and datasets
(``compat.py``).  Meshes raise ``NotImplementedError``.

The reference's top-level names (``UNet``, ``TemporalGate``,
``GlottalPipelines``, the ``compat`` classes and functions) resolve here
lazily: importing the package loads nothing else and needs no GPU.
"""

__version__ = "0.1.0"

_NAMES = {
    "UNet": "openglottal_tpu_torch.models.unet",
    "TemporalGate": "openglottal_tpu_torch.models.gate",
    "GlottalPipelines": "openglottal_tpu_torch.pipelines",
    **{n: "openglottal_tpu_torch.compat" for n in (
        "TemporalDetector", "VocalFoldTracker", "YOLOGuidedVFT",
        "extract_features_detector", "extract_features_yolo_guided_vft",
        "extract_features_unet")},
}


def _lazy(names: dict):
    """A module ``__getattr__`` resolving each name of ``names`` (name ->
    the module that defines it) by importing that module on first use; the
    four packages' re-exports share it."""
    def __getattr__(name):
        if name in names:
            import importlib

            return getattr(importlib.import_module(names[name]), name)
        raise AttributeError(name)
    return __getattr__


__getattr__ = _lazy(_NAMES)


__all__ = [*_NAMES, "__version__"]
