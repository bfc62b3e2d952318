"""YOLOv8n ``.pt`` checkpoints <-> the JAX package's weight trees, without
the ultralytics package.

Counterpart of ``openglottal_tpu/utils/yolo_import.py`` (the port's own
copy).  An ultralytics checkpoint is a torch zip archive whose pickle holds
a whole ``DetectionModel`` object, which cannot be unpickled without
ultralytics.  Here it is unpickled with every class that is not torch's,
numpy's or the standard library's replaced by a permissive stub (torch's
tensor and storage machinery stays real, so the tensors load as they are),
and the stubbed module graph's ``_modules`` / ``_parameters`` / ``_buffers``
are walked as ``nn.Module.state_dict()`` walks them, to recover the flat
``model.N.xxx`` keys.  Those map onto the JAX-layout tree layer by layer
(ultralytics yolov8n.yaml order -> the tree's call-order names):

  0/1        Conv P1, P2        -> ConvBNSiLU_0, ConvBNSiLU_1
  2/4/6/8    backbone C2f       -> C2f_0..3    (n = 1, 2, 2, 1)
  3/5/7      Conv P3, P4, P5    -> ConvBNSiLU_2..4
  9          SPPF               -> SPPF_0
  12/15      head C2f (up path) -> C2f_4, C2f_5
  16/19      head downsampling  -> ConvBNSiLU_5, ConvBNSiLU_6
  18/21      head C2f           -> C2f_6, C2f_7
  22         Detect: cv2 (box) / cv3 (cls) -> DetectHead_0 box{i}_* /
             cls{i}_* (dfl.conv.weight is the fixed arange projection)

Reading such a checkpoint unpickles objects (``weights_only=False``, with
the stub pickle module): load only checkpoints from a source you trust.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

# ultralytics layer index -> (tree C2f name, bottlenecks)
_C2F = {2: ("C2f_0", 1), 4: ("C2f_1", 2), 6: ("C2f_2", 2), 8: ("C2f_3", 1),
        12: ("C2f_4", 1), 15: ("C2f_5", 1), 18: ("C2f_6", 1), 21: ("C2f_7", 1)}
_CONV = {0: "ConvBNSiLU_0", 1: "ConvBNSiLU_1", 3: "ConvBNSiLU_2",
         5: "ConvBNSiLU_3", 7: "ConvBNSiLU_4", 16: "ConvBNSiLU_5",
         19: "ConvBNSiLU_6"}
_DETECT_LAYER = 22


class _Stub:
    """Stands in for any class of the pickle that is not imported (nor
    needed); keeps whatever state the pickle gives it."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif (isinstance(state, tuple) and len(state) == 2
              and isinstance(state[0], (dict, type(None)))):
            if state[0]:
                self.__dict__.update(state[0])
            if isinstance(state[1], dict):  # the __slots__ part
                self.__dict__.update(state[1])
        else:
            self.__dict__["_raw_state"] = state

    def __call__(self, *args, **kwargs):
        return _Stub()


class _StubUnpickler(pickle.Unpickler):
    """Real classes for torch, numpy and a few standard modules (tensors
    must rebuild); stubs for everything else (ultralytics.*, and
    ``builtins``: no name of it is needed to rebuild the tensors, and
    stubbing it keeps ``exec`` / ``eval`` out of reach of the pickle)."""

    _REAL = ("torch", "collections", "numpy", "argparse", "pathlib")

    def find_class(self, module, name):
        if module.split(".")[0] in self._REAL:
            try:
                return super().find_class(module, name)
            except Exception:   # noqa: BLE001 -- any unimportable name
                return _Stub
        return _Stub


class _StubPickleModule:
    """The pickle module handed to ``torch.load``."""

    Unpickler = _StubUnpickler
    load = staticmethod(pickle.load)
    # torch.load reads this on its error paths
    UnpicklingError = pickle.UnpicklingError


def _walk_module(obj, prefix: str, out: dict) -> None:
    """``nn.Module.state_dict()``'s flat keys, from a (possibly stubbed)
    module object graph."""
    d = getattr(obj, "__dict__", None)
    if not isinstance(d, dict):
        return
    for src in ("_parameters", "_buffers"):
        for name, t in (d.get(src) or {}).items():
            if t is not None and hasattr(t, "detach"):
                out[prefix + name] = t
    for name, m in (d.get("_modules") or {}).items():
        if m is not None:
            _walk_module(m, f"{prefix}{name}.", out)


def yolo_state_dict_from_pt(pt_path) -> dict:
    """The DetectionModel's ``state_dict`` (numpy float32) of an
    ultralytics-style ``.pt``, without ultralytics.  Accepts {"model":
    module} / {"ema": module} checkpoints (the EMA preferred, as
    ultralytics' own loader prefers it) and plain ``state_dict``s."""
    ckpt = torch.load(pt_path, map_location="cpu", weights_only=False,
                      pickle_module=_StubPickleModule)
    sd: dict = {}
    if isinstance(ckpt, dict) and (
            "model" in ckpt or "ema" in ckpt) and not hasattr(
            ckpt.get("model", ckpt.get("ema")), "items"):
        _walk_module(ckpt.get("ema") or ckpt.get("model"), "", sd)
        if not sd:
            raise ValueError(f"{pt_path}: found a model object but no "
                             f"parameters (unsupported checkpoint structure)")
    elif isinstance(ckpt, dict):
        inner = ckpt.get("state_dict", ckpt.get("model", ckpt))
        sd = dict(inner) if hasattr(inner, "items") else {}
        if not sd:
            raise ValueError(f"{pt_path}: no tensors found")
    return {k: np.asarray(v.detach().to(torch.float32).numpy()
                          if hasattr(v, "detach") else v, np.float32)
            for k, v in sd.items()}


def _conv_kernel(w) -> np.ndarray:
    # torch Conv2d (O, I, kH, kW) -> (kH, kW, I, O)
    return np.transpose(np.asarray(w, np.float32), (2, 3, 1, 0))


def _cbs(sd: dict, prefix: str):
    """An ultralytics Conv (conv + bn + SiLU) -> ConvBNSiLU params, stats."""
    params = {
        "Conv_0": {"kernel": _conv_kernel(sd[f"{prefix}.conv.weight"])},
        "BatchNorm_0": {
            "scale": np.asarray(sd[f"{prefix}.bn.weight"], np.float32),
            "bias": np.asarray(sd[f"{prefix}.bn.bias"], np.float32),
        },
    }
    stats = {"BatchNorm_0": {
        "mean": np.asarray(sd[f"{prefix}.bn.running_mean"], np.float32),
        "var": np.asarray(sd[f"{prefix}.bn.running_var"], np.float32),
    }}
    return params, stats


def _c2f(sd: dict, prefix: str, n: int):
    params, stats = {}, {}
    params["ConvBNSiLU_0"], stats["ConvBNSiLU_0"] = _cbs(sd, f"{prefix}.cv1")
    params["ConvBNSiLU_1"], stats["ConvBNSiLU_1"] = _cbs(sd, f"{prefix}.cv2")
    for i in range(n):
        bp, bs = {}, {}
        bp["ConvBNSiLU_0"], bs["ConvBNSiLU_0"] = _cbs(sd,
                                                      f"{prefix}.m.{i}.cv1")
        bp["ConvBNSiLU_1"], bs["ConvBNSiLU_1"] = _cbs(sd,
                                                      f"{prefix}.m.{i}.cv2")
        params[f"Bottleneck_{i}"] = bp
        stats[f"Bottleneck_{i}"] = bs
    return params, stats


def yolo_from_torch(pt_path_or_state_dict, prefix: str = "model.") -> dict:
    """An ultralytics YOLOv8n checkpoint (a ``.pt`` path or its
    ``state_dict``) -> the JAX-layout ``{params, batch_stats}`` tree."""
    if hasattr(pt_path_or_state_dict, "items"):
        sd = {k: np.asarray(v, np.float32)
              for k, v in pt_path_or_state_dict.items()}
    else:
        sd = yolo_state_dict_from_pt(pt_path_or_state_dict)
    if not any(k.startswith(prefix) for k in sd):
        prefix = ""     # a state_dict saved from the bare Sequential
    params: dict = {}
    stats: dict = {}
    for layer, name in _CONV.items():
        params[name], stats[name] = _cbs(sd, f"{prefix}{layer}")
    for layer, (name, n) in _C2F.items():
        params[name], stats[name] = _c2f(sd, f"{prefix}{layer}", n)
    params["SPPF_0"], stats["SPPF_0"] = {}, {}
    for j in (0, 1):
        params["SPPF_0"][f"ConvBNSiLU_{j}"], stats["SPPF_0"][
            f"ConvBNSiLU_{j}"] = _cbs(sd, f"{prefix}9.cv{j + 1}")
    head_p: dict = {}
    head_s: dict = {}
    for i in range(3):
        for branch, ours in (("cv2", "box"), ("cv3", "cls")):
            base = f"{prefix}{_DETECT_LAYER}.{branch}.{i}"
            head_p[f"{ours}{i}_0"], head_s[f"{ours}{i}_0"] = _cbs(
                sd, f"{base}.0")
            head_p[f"{ours}{i}_1"], head_s[f"{ours}{i}_1"] = _cbs(
                sd, f"{base}.1")
            head_p[f"{ours}{i}_2"] = {
                "kernel": _conv_kernel(sd[f"{base}.2.weight"]),
                "bias": np.asarray(sd[f"{base}.2.bias"], np.float32),
            }
    params["DetectHead_0"] = head_p
    stats["DetectHead_0"] = head_s
    return {"params": params, "batch_stats": stats}


def yolo_to_torch_state_dict(variables, prefix: str = "model.") -> dict:
    """The inverse: a JAX-layout tree -> an ultralytics-layout flat
    ``state_dict`` (numpy), for the reference toolchain and round trips."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: dict = {}

    def put_cbs(pfx, p, s):
        sd[f"{pfx}.conv.weight"] = np.transpose(
            np.asarray(p["Conv_0"]["kernel"]), (3, 2, 0, 1))
        sd[f"{pfx}.bn.weight"] = np.asarray(p["BatchNorm_0"]["scale"])
        sd[f"{pfx}.bn.bias"] = np.asarray(p["BatchNorm_0"]["bias"])
        sd[f"{pfx}.bn.running_mean"] = np.asarray(s["BatchNorm_0"]["mean"])
        sd[f"{pfx}.bn.running_var"] = np.asarray(s["BatchNorm_0"]["var"])

    for layer, name in _CONV.items():
        put_cbs(f"{prefix}{layer}", params[name], stats[name])
    for layer, (name, n) in _C2F.items():
        for j in (0, 1):
            put_cbs(f"{prefix}{layer}.cv{j + 1}",
                    params[name][f"ConvBNSiLU_{j}"],
                    stats[name][f"ConvBNSiLU_{j}"])
        for i in range(n):
            for j in (0, 1):
                put_cbs(f"{prefix}{layer}.m.{i}.cv{j + 1}",
                        params[name][f"Bottleneck_{i}"][f"ConvBNSiLU_{j}"],
                        stats[name][f"Bottleneck_{i}"][f"ConvBNSiLU_{j}"])
    for j in (0, 1):
        put_cbs(f"{prefix}9.cv{j + 1}", params["SPPF_0"][f"ConvBNSiLU_{j}"],
                stats["SPPF_0"][f"ConvBNSiLU_{j}"])
    hp, hs = params["DetectHead_0"], stats["DetectHead_0"]
    for i in range(3):
        for branch, ours in (("cv2", "box"), ("cv3", "cls")):
            base = f"{prefix}{_DETECT_LAYER}.{branch}.{i}"
            put_cbs(f"{base}.0", hp[f"{ours}{i}_0"], hs[f"{ours}{i}_0"])
            put_cbs(f"{base}.1", hp[f"{ours}{i}_1"], hs[f"{ours}{i}_1"])
            sd[f"{base}.2.weight"] = np.transpose(
                np.asarray(hp[f"{ours}{i}_2"]["kernel"]), (3, 2, 0, 1))
            sd[f"{base}.2.bias"] = np.asarray(hp[f"{ours}{i}_2"]["bias"])
    # the fixed DFL projection ultralytics carries as a buffer
    sd[f"{prefix}{_DETECT_LAYER}.dfl.conv.weight"] = \
        np.arange(16, dtype=np.float32).reshape(1, 16, 1, 1)
    return sd
