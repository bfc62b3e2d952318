"""Typed configuration: a dataclass tree with the code's effective
defaults, loadable from JSON or YAML with dotted-path overrides, read by
the command line.

Counterpart of ``openglottal_tpu/config.py``: the same tree, the same
defaults and the same loader.  Its ``gate_params``, ``vft_params`` and
``ygvft_params`` build the port's own parameter tuples.  YAML needs the
``yaml`` package, imported only when a YAML file is read or written.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Tuple

from openglottal_tpu_torch.models.gate import GateParams
from openglottal_tpu_torch.models.tracker import VFTParams, YGVFTParams


@dataclass
class DetectorConfig:
    conf: float = 0.25
    max_shift_px: float = 30.0
    padding: int = 8
    max_hold_frames: int = 3


@dataclass
class VFTConfig:
    alpha: float = 0.98
    beta: float = 0.7
    roi_threshold_ratio: float = 0.07
    gaussian_ksize: int = 13
    glottal_percentile: float = 5.0
    max_glottal_components: int = 2
    init_frames: int = 2


@dataclass
class GuidedVFTConfig:
    alpha: float = 0.98
    beta: float = 0.7
    glottal_percentile: float = 30.0
    gaussian_ksize: int = 13
    max_glottal_components: int = 2
    init_frames: int = 2


@dataclass
class UNetConfig:
    features: Tuple[int, ...] = (32, 64, 128, 256)
    threshold: float = 0.5


@dataclass
class YoloTrainConfig:
    epochs: int = 100  # train_yolo.py default; the paper used 2 (main.tex:319)
    imgsz: int = 256
    batch: int = 16
    lr: float = 1e-3


@dataclass
class UNetTrainConfig:
    epochs: int = 50
    batch: int = 16
    lr: float = 1e-3
    weight_decay: float = 0.01
    patience: int | None = None


@dataclass
class TrainingConfig:
    yolo: YoloTrainConfig = field(default_factory=YoloTrainConfig)
    unet: UNetTrainConfig = field(default_factory=UNetTrainConfig)


@dataclass
class DatasetConfig:
    img_size: int = 256
    dilate: int = 10


@dataclass
class MeshConfig:
    data: int = 0   # 0 = all available devices
    model: int = 1


@dataclass
class Config:
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    vft: VFTConfig = field(default_factory=VFTConfig)
    guided_vft: GuidedVFTConfig = field(default_factory=GuidedVFTConfig)
    unet: UNetConfig = field(default_factory=UNetConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    # ── factory helpers consumed across the framework ─────────────────────

    def gate_params(self) -> GateParams:
        d = self.detector
        return GateParams(d.max_shift_px, d.padding, d.max_hold_frames)

    def vft_params(self) -> VFTParams:
        v = self.vft
        return VFTParams(v.alpha, v.beta, v.roi_threshold_ratio,
                         v.gaussian_ksize, v.glottal_percentile,
                         v.max_glottal_components)

    def ygvft_params(self) -> YGVFTParams:
        g = self.guided_vft
        return YGVFTParams(g.alpha, g.beta, g.glottal_percentile,
                           g.gaussian_ksize, g.max_glottal_components)


def _update(obj, data: dict, path=""):
    for k, v in data.items():
        if not hasattr(obj, k):
            raise KeyError(f"unknown config key: {path}{k}")
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _update(cur, v, f"{path}{k}.")
        else:
            if isinstance(cur, tuple) and isinstance(v, list):
                v = tuple(v)
            setattr(obj, k, v)


def load_config(path=None, overrides: dict | None = None) -> Config:
    """Config from a JSON or YAML file (optional; ``.json`` is read as
    JSON, anything else as YAML) and dotted overrides (e.g.
    ``{"detector.conf": 0.1}``); an unknown key raises ``KeyError``."""
    cfg = Config()
    if path is not None:
        text = Path(path).read_text()
        if str(path).endswith(".json"):
            data = json.loads(text)
        else:
            import yaml

            data = yaml.safe_load(text)
        _update(cfg, data or {})
    for dotted, v in (overrides or {}).items():
        obj = cfg
        *parents, leaf = dotted.split(".")
        for p in parents:
            obj = getattr(obj, p)
        if not hasattr(obj, leaf):
            raise KeyError(f"unknown config key: {dotted}")
        cur = getattr(obj, leaf)
        if isinstance(cur, tuple) and isinstance(v, list):
            v = tuple(v)
        setattr(obj, leaf, v)
    return cfg


def save_default_yaml(path) -> None:
    """Write the defaults as YAML."""
    import yaml

    cfg = dataclasses.asdict(Config())
    Path(path).write_text(yaml.safe_dump(cfg, sort_keys=False))
