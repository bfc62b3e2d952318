"""Frame by frame, where the self-test's int8-full waveform leaves bf16's.

    python3 -m openglottal_tpu_torch.tools.int8full_waveforms \\
        --ckpt-dir OUTPUT_DIR [--device cuda] [--out detail.json]

Reads a self-test's trained checkpoints (``OUTPUT_DIR/unet/best.pt`` and
``OUTPUT_DIR/yolo/best.pt``, as ``scripts/selftest_e2e.py`` writes them),
rebuilds its first test video (40 frames from seed 990) and its int8
calibration frames (the first 64 training frames, seed 100), both of its
``--realistic`` form, and serves the video through ``unet``
three ways: bf16, ``quant="int8"`` (the int8 U-Net, the bf16 detector) and
``quant="int8-full"`` (the int8 detector too).  For each it writes the
waveform, and for the bf16 and the int8 detector each frame's detection
(has, box, confidence) and the gate's (valid, box), so that a waveform gap
can be put down to the detector, the gate or the segmenter.  The gate gap
(``int8full_rel_l1``) is the self-test's own number.  Runs on the card
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

N_FRAMES = 40       # the self-test's waveform frames (its first test video)
N_CALIB = 64        # its calibration frames


def selftest_frames():
    """(test gray (40, 256, 256) uint8, calibration gray (64, 256, 256)
    uint8): the realistic self-test's first test video and its first 64
    training frames (``make_dataset`` by video, so the first videos
    suffice)."""
    from openglottal_tpu_torch.data.video import bgr_to_gray_u8
    from openglottal_tpu_torch.scripts.selftest_e2e import make_dataset

    test = make_dataset(1, N_FRAMES, seed0=990, realistic=True)[0]
    train = make_dataset(3, 24, seed0=100, realistic=True)[0]
    return bgr_to_gray_u8(test), bgr_to_gray_u8(train)[:N_CALIB]


def _host(x) -> list:
    return x.float().cpu().numpy().tolist()


def detail(unet_vars, yolo_vars, gray, calib, device, qparams=None,
           routes=("bf16", "int8", "int8full")) -> dict:
    """route -> {"areas"} for each of ``routes`` ("bf16", "int8",
    "int8full"), and for "bf16" / "int8full" also the detector's and the
    gate's per-frame output.  The int8 routes calibrate on ``calib``, or
    "int8full" loads its calibration from ``qparams`` (an ``.npz`` that
    ``save_qparams`` of either package wrote) when given."""
    from openglottal_tpu_torch.models import quant as quant_mod
    from openglottal_tpu_torch.models.yolo import max_conf_detect
    from openglottal_tpu_torch.pipelines import GlottalPipelines

    g = torch.from_numpy(np.ascontiguousarray(gray)).to(device)
    out = {}
    for route, quant in (("bf16", None), ("int8", "int8"),
                         ("int8full", "int8-full")):
        if route not in routes:
            continue
        pipe = GlottalPipelines(unet_variables=unet_vars,
                                yolo_variables=yolo_vars, conf=0.25,
                                quant=quant, device=device)
        if route == "int8full" and qparams is not None:
            pipe.load_qparams(qparams)
        elif quant:
            pipe.calibrate(calib)
        out[route] = {"areas": _host(pipe.yolo_unet_areas_gray(g))}
        if route == "int8":
            continue
        with torch.no_grad():
            if quant:
                qp = pipe._q(g)["yolo"]
                cin = qp["stem_bf16"]["kernel"].shape[1]
                x = g.float()[..., None].expand(-1, -1, -1, cin)
                has, raw, conf = max_conf_detect(quant_mod.qyolo_forward(
                    qp, x, pipe.use_plain_kernels), *g.shape[1:], pipe.conf)
            else:
                has, raw, conf = pipe.detect_video_gray(g)
            valid, boxes = pipe._gate(has, raw, *g.shape[1:], True)
        out[route].update(has=_host(has), raw=_host(raw), conf=_host(conf),
                          valid=_host(valid), boxes=_host(boxes))
    return out


def rel_l1(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).sum() / max(np.abs(b).sum(), 1e-9))


def summary(d: dict) -> dict:
    """The gaps of a :func:`detail`: each quantized route's waveform
    against bf16's, and the frames where the int8 detector's decision,
    box or the gate's box differ from bf16's."""
    b, q = d["bf16"], d["int8full"]
    wave_at = np.nonzero(np.asarray(q["areas"]) != np.asarray(b["areas"]))[0]
    box = np.abs(np.asarray(q["raw"]) - np.asarray(b["raw"])).max(1)
    gbox = np.abs(np.asarray(q["boxes"]) - np.asarray(b["boxes"])).max(1)
    return {
        "int8_rel_l1": rel_l1(d["int8"]["areas"], b["areas"]),
        "int8full_rel_l1": rel_l1(q["areas"], b["areas"]),
        "frames_waveform_differs": wave_at.tolist(),
        "frames_has_differs": np.nonzero(np.asarray(q["has"])
                                         != np.asarray(b["has"]))[0].tolist(),
        "frames_gate_box_differs": np.nonzero(gbox > 0)[0].tolist(),
        "raw_box_max_abs_px": float(box.max()),
        "gate_box_max_abs_px": float(gbox.max()),
        "conf_bf16": b["conf"], "conf_int8": q["conf"]}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="int8full_waveforms")
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--device", default=None,
                   help="Torch device (default: the CUDA device).")
    p.add_argument("--out", default=None, help="Write the detail here.")
    args = p.parse_args(argv)

    from openglottal_tpu_torch.pipelines import resolve_device
    from openglottal_tpu_torch.utils.io import (
        load_unet_weights,
        load_yolo_weights,
    )

    ck = Path(args.ckpt_dir)
    gray, calib = selftest_frames()
    d = detail(load_unet_weights(ck / "unet" / "best.pt"),
               load_yolo_weights(ck / "yolo" / "best.pt"), gray, calib,
               resolve_device(args.device))
    s = summary(d)
    if args.out:
        Path(args.out).write_text(json.dumps({"detail": d, "summary": s}))
    print(json.dumps({k: v for k, v in s.items()
                      if not k.startswith("conf")}), flush=True)
    return {"detail": d, "summary": s}


if __name__ == "__main__":
    main()
