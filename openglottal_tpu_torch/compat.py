"""The reference's frame-at-a-time API: ``VocalFoldTracker``,
``YOLOGuidedVFT``, ``TemporalDetector`` and the ``extract_features_*``
functions, with the reference's call signatures.

Counterpart of the serving part of ``openglottal_tpu/compat.py``.  The
trackers step on the same carried functions as the streaming trackers
(``models/tracker.vft_step``, ``ygvft_step``), one frame per call;
``TemporalDetector.detect`` runs the detector on one frame at its own size
and steps the gate's state machine (``models/gate.gate_step``) on the host.
The batched pipelines (``GlottalPipelines``) are the fast path; these
classes are for code written against the reference's per-frame loops.
Each takes ``device`` (the CUDA device by default, ``"cpu"`` on purpose).

The reference's indexable datasets, ``GlottisDataset`` (PNG frames and
masks) and ``GlottisDatasetHDF5`` (a reference-format HDF5 cache), return
items as torch float tensors of shape (1, 256, 256) on the host, for
``DataLoader`` loops; the batched trainers (``train/``) are the fast path.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from openglottal_tpu_torch.data.augment import augment_batch
from openglottal_tpu_torch.data.dataset import (
    label_name,
    letterbox_pair,
    load_glottis_hdf5,
)
from openglottal_tpu_torch.data.png import imread_gray
from openglottal_tpu_torch.data.video import read_frames
from openglottal_tpu_torch.features import kinematic_features  # noqa: F401
from openglottal_tpu_torch.models.gate import GateParams, gate_init, gate_step
from openglottal_tpu_torch.models.tracker import (
    VFTParams,
    YGVFTParams,
    vft_initialize,
    vft_step,
    ygvft_initialize,
    ygvft_step,
)
from openglottal_tpu_torch.ops.resize import resize_linear_cv2
from openglottal_tpu_torch.pipelines import GlottalPipelines, resolve_device
from openglottal_tpu_torch.utils.io import load_yolo_weights


def _resize_to(frame: np.ndarray, w: int, h: int) -> np.ndarray:
    """A (H, W) frame resized to (h, w) where its size differs:
    ``cv2.resize(..., INTER_LINEAR)`` as ``ops/resize.resize_linear_cv2``
    emulates it."""
    frame = np.asarray(frame)
    if frame.shape[1] == w and frame.shape[0] == h:
        return frame
    return resize_linear_cv2(frame, w, h)


def _frame_tensor(frame, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(frame, np.float32)).to(
        device)


def _box(bbox, device):
    """(valid 0-d bool, box (4,) int32) of an (x1, y1, x2, y2) or None."""
    valid = torch.tensor(bbox is not None, device=device)
    box = torch.tensor([0, 0, 0, 0] if bbox is None
                       else [int(v) for v in bbox], dtype=torch.int32,
                       device=device)
    return valid, box


class _Carried:
    """The reference's state views of a tracker carry (prev, lmap,
    thresh)."""

    _carry = None

    @property
    def prev(self):
        return None if self._carry is None else self._carry[0].cpu().numpy()

    @property
    def lmap(self):
        return None if self._carry is None else self._carry[1].cpu().numpy()

    @property
    def thresh(self):
        return None if self._carry is None else float(self._carry[2])


class VocalFoldTracker(_Carried):
    """The motion tracker, one frame at a time: ``initialize(frames)``
    seeds the motion map and the threshold from gray frames (each resized
    to the first one's size); ``process_frame(frame)`` returns a uint8 mask
    (255 = glottis)."""

    def __init__(self, alpha: float = 0.98, beta: float = 0.7,
                 roi_threshold_ratio: float = 0.07, gaussian_ksize: int = 13,
                 glottal_percentile: int = 5, max_glottal_components: int = 2,
                 device=None):
        self.params = VFTParams(
            float(alpha), float(beta), float(roi_threshold_ratio),
            int(gaussian_ksize), float(glottal_percentile),
            int(max_glottal_components))
        self.device = resolve_device(device)
        self._w = self._h = None

    def initialize(self, frames) -> None:
        self._h, self._w = np.asarray(frames[0]).shape[:2]
        ff = np.stack([_resize_to(f, self._w, self._h).astype(np.float32)
                       for f in frames])
        self._carry = vft_initialize(_frame_tensor(ff, self.device),
                                     self.params)

    def process_frame(self, frame: np.ndarray) -> np.ndarray:
        f = _resize_to(frame, self._w, self._h)
        self._carry, mask = vft_step(self._carry,
                                     _frame_tensor(f, self.device),
                                     self.params)
        return mask.cpu().numpy().astype(np.uint8) * 255


class YOLOGuidedVFT(_Carried):
    """The guided tracker, one frame at a time: the detector's box is the
    ROI; ``bbox=None`` gives an empty mask for that frame."""

    def __init__(self, alpha: float = 0.98, beta: float = 0.7,
                 glottal_percentile: int = 5, gaussian_ksize: int = 13,
                 max_glottal_components: int = 2, device=None):
        self.params = YGVFTParams(
            float(alpha), float(beta), float(glottal_percentile),
            int(gaussian_ksize), int(max_glottal_components))
        self.device = resolve_device(device)

    def initialize(self, frames, bbox=None) -> None:
        ff = np.stack([np.asarray(f, np.float32) for f in frames])
        self._carry = ygvft_initialize(_frame_tensor(ff, self.device),
                                       *_box(bbox, self.device), self.params)

    def process_frame(self, frame: np.ndarray, bbox=None) -> np.ndarray:
        self._carry, mask = ygvft_step(
            self._carry, _frame_tensor(frame, self.device),
            *_box(bbox, self.device), self.params)
        return mask.cpu().numpy().astype(np.uint8) * 255


class TemporalDetector:
    """The detector with its temporal gate, one frame at a time
    (``detect``), and the handle the ``extract_features_*`` functions take.
    ``model_path``: YOLO weights (``.npz``)."""

    def __init__(self, model_path, conf: float = 0.25, max_shift_px: int = 30,
                 padding: int = 8, max_hold_frames: int = 3, device=None):
        self.variables = load_yolo_weights(model_path)
        self.conf = conf
        self.params = GateParams(float(max_shift_px), int(padding),
                                 int(max_hold_frames))
        self.device = resolve_device(device)
        self._detector = None
        self.reset()

    def reset(self) -> None:
        self._state = gate_init()

    def detect(self, frame_bgr: np.ndarray):
        """The gated box (x1, y1, x2, y2) of one BGR frame, or None.  The
        detector runs in float32 on the frame at its own size, with
        BatchNorm unfolded, as the reference's per-frame call does."""
        if self._detector is None:
            self._detector = GlottalPipelines(
                yolo_variables=self.variables, conf=self.conf,
                gate_params=self.params, dtype=torch.float32, fold_bn=False,
                device=self.device)
        h, w = frame_bgr.shape[:2]
        x = torch.from_numpy(np.ascontiguousarray(frame_bgr)).to(self.device)
        with torch.no_grad():
            has, box, _ = self._detector._yolo_chunk_bgr(x[None])
        det = (bool(has[0]), *box[0].cpu().numpy())
        self._state, (valid, obox) = gate_step(self._state, det, h, w,
                                               self.params)
        if not valid:
            return None
        return tuple(int(v) for v in obox)

    @property
    def crop_size(self):
        """(w, h) of the current crop, or None while no detection is
        held."""
        if not bool(self._state.valid):
            return None
        return (int(self._state.w), int(self._state.h))

    def crop(self, frame: np.ndarray, box):
        """The box's slice of the frame; the whole frame for None."""
        if box is None:
            return frame
        x1, y1, x2, y2 = box
        return frame[y1:y2, x1:x2]

    def _pipelines(self, unet_variables=None, crop_unet_variables=None):
        return GlottalPipelines(
            unet_variables=unet_variables,
            crop_unet_variables=crop_unet_variables,
            yolo_variables=self.variables, conf=self.conf,
            gate_params=self.params, device=self.device)


def extract_features_detector(avi_path, detector: TemporalDetector,
                              vft_init: int = 2):
    """Pipeline 1 (``vft``) on a video file, read onto the pipelines'
    device."""
    pipe = detector._pipelines()
    return pipe.extract_features(read_frames(avi_path, pipe.device), "vft")


def extract_features_yolo_guided_vft(avi_path, detector: TemporalDetector,
                                     ygvft_init: int = 2):
    """Pipeline 2 (``guided-vft``) on a video file, read onto the
    pipelines' device."""
    pipe = detector._pipelines()
    return pipe.extract_features(read_frames(avi_path, pipe.device),
                                 "guided-vft")


def extract_features_unet(avi_path, detector: TemporalDetector | None,
                          model_variables, device=None):
    """Pipeline 3 (``unet``), or ``unet-only`` without a detector, on a
    video file (read onto the pipelines' device); ``device`` places the
    pipelines when no detector does."""
    if detector is None:
        pipe = GlottalPipelines(unet_variables=model_variables, device=device)
        return pipe.extract_features(read_frames(avi_path, pipe.device),
                                     "unet-only")
    pipe = detector._pipelines(unet_variables=model_variables)
    return pipe.extract_features(read_frames(avi_path, pipe.device), "unet")


class GlottisDataset:
    """Drop-in indexable dataset matching the reference class
    (openglottal/models/unet.py:91-192): grayscale PNG frames and binary
    masks letterboxed to 256² (``data/png.imread_gray``,
    ``data/dataset.letterbox_pair``), optional train-time augmentation.

    Items are (image, mask) float32 tensors of shape (1, 256, 256), the
    image in [0, 1] and the mask in {0, 1}.  ``augment=True`` runs the
    port's augmentation (``data/augment.augment_batch``, on the host) with a
    ``torch.Generator`` seeded from ``seed``, so a dataset's draws repeat
    from run to run (the reference's ``random`` is unseeded).  The mask of
    ``fname`` is ``fname`` itself in ``lbl_dir``, or
    ``<stem><label_suffix>.png`` when ``label_suffix`` is given ("_seg" for
    BAGLS).
    """

    SIZE = 256

    def __init__(self, fnames, img_dir, lbl_dir, augment: bool = False,
                 label_suffix: str = "", seed: int = 0):
        self.fnames = list(fnames)
        self.img_dir = Path(img_dir)
        self.lbl_dir = Path(lbl_dir)
        self.augment = augment
        self.label_suffix = label_suffix
        self._gen = torch.Generator().manual_seed(seed)

    def __len__(self) -> int:
        return len(self.fnames)

    def __getitem__(self, idx: int):
        fname = self.fnames[idx]
        lbl = label_name(fname, self.label_suffix)
        img = imread_gray(self.img_dir / fname)
        msk = imread_gray(self.lbl_dir / lbl)
        if img is None or msk is None:
            raise FileNotFoundError(f"missing image or mask: {fname} / {lbl}")
        return _item(*letterbox_pair(img, msk), self.augment, self._gen)


class GlottisDatasetHDF5:
    """Drop-in indexable dataset over a reference-format HDF5 cache
    (openglottal/data.py:262-329): pre-letterboxed uint8 ``images`` /
    ``masks``, loaded once into host memory (``data/dataset.
    load_glottis_hdf5``, which imports ``h5py``: the card's machine has
    none), with the same items and augmentation as :class:`GlottisDataset`.
    """

    SIZE = 256

    def __init__(self, h5_path, augment: bool = False, seed: int = 0):
        self.h5_path = str(h5_path)
        self.images, self.masks = load_glottis_hdf5(h5_path)
        self.augment = augment
        self._gen = torch.Generator().manual_seed(seed)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx: int):
        return _item(self.images[idx], self.masks[idx], self.augment,
                     self._gen)


def _item(img: np.ndarray, msk: np.ndarray, augment: bool, gen):
    """(image, mask) float32 tensors (1, 256, 256) of a letterboxed uint8
    pair: the image / 255 and the mask > 0, or both augmented jointly."""
    if augment:
        return augment_batch(
            torch.from_numpy(np.ascontiguousarray(img))[None],
            torch.from_numpy((msk > 0).astype(np.uint8))[None], gen)
    x = img.astype(np.float32) / 255.0
    y = (msk > 0).astype(np.float32)
    return torch.from_numpy(x).unsqueeze(0), torch.from_numpy(y).unsqueeze(0)
