"""Data of the port: the AVI reader with its MJPG decoder (``video.py``,
``jpeg.py``), the PNG reader and writer (``png.py``), synthetic glottis
video (``synthetic.py``), host-to-device prefetch (``prefetch.py``), the
U-Net's training augmentation (``augment.py``) and datasets
(``dataset.py``, ``crop_dataset.py``, ``yolo_dataset.py``,
``kaggle_paths.py``).

The JAX package's names resolve here lazily: ``load_frames_bgr`` and
``bgr_to_gray_u8`` of ``video.py``, and the reference's
``openglottal/data.py`` surface, ``mask_to_yolo``, ``build_yolo_dataset``,
``build_glottis_hdf5``, ``load_glottis_hdf5``,
``resolve_kaggle_data_paths``, ``GlottisDataset`` and
``GlottisDatasetHDF5`` (``h5py`` is imported only by the HDF5 functions).
"""

from openglottal_tpu_torch import _lazy

_NAMES = {
    "load_frames_bgr": "openglottal_tpu_torch.data.video",
    "bgr_to_gray_u8": "openglottal_tpu_torch.data.video",
    "mask_to_yolo": "openglottal_tpu_torch.data.yolo_dataset",
    "build_yolo_dataset": "openglottal_tpu_torch.data.yolo_dataset",
    "build_glottis_hdf5": "openglottal_tpu_torch.data.dataset",
    "load_glottis_hdf5": "openglottal_tpu_torch.data.dataset",
    "resolve_kaggle_data_paths": "openglottal_tpu_torch.data.kaggle_paths",
    "GlottisDataset": "openglottal_tpu_torch.compat",
    "GlottisDatasetHDF5": "openglottal_tpu_torch.compat",
}


__getattr__ = _lazy(_NAMES)


__all__ = list(_NAMES)
