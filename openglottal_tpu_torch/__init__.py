"""PyTorch/CUDA port of openglottal_tpu for NVIDIA Hopper (H100).

Same layout and names as the JAX package (``models/yolo.py``,
``models/gate.py``, ``ops/blobs.py``, ``pipelines.py``, ``features.py`` ...)
so a reader finds each counterpart; PyTorch idiom inside.  The package
imports ``torch`` and numpy only.  The hand-written CUDA kernels live in
``csrc/`` and are compiled with ``nvcc`` at first use (``ops/_build.py``).

Ported so far: the five serving pipelines (``vft``, ``guided-vft``,
``unet``, ``crop-unet``, ``unet-only``) for gray or BGR video of any frame
size, through ``GlottalPipelines.extract_features`` and
``run_pipeline_full``, with ``unet``'s windowed decoder on 256² monochrome
video; cohorts of videos (``*_gray_multi``); streams of chunks in bounded
memory (``stream_areas``, ``stream_features``); the AVI reader
(``data/video.py``), the command line (``cli.py``), the config and the
frame-at-a-time API (``compat.py``).  Meshes and int8 raise
``NotImplementedError``.
"""

__version__ = "0.1.0"
