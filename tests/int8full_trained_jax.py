"""The self-test's int8-full waveform gap on one set of trained weights,
through the JAX package and through the port on the CPU (and, given its
file, the port on the card), frame by frame.  A script, not a test: the
trained checkpoints are made by a self-test run and are not in the
repository.

    JAX_PLATFORMS=cpu python tests/int8full_trained_jax.py \\
        --ckpt-dir OUTPUT_DIR [--card detail.json] [--out compare.json]

``OUTPUT_DIR`` holds a self-test's ``unet/best.pt`` and ``yolo/best.pt``
(``scripts/selftest_e2e.py --realistic``); ``--card`` is what
``python3 -m openglottal_tpu_torch.tools.int8full_waveforms --out`` wrote
on the card from the same checkpoints.  Both sides serve the self-test's
first test video (40 frames) through ``unet`` in bf16, ``quant="int8"``
and ``quant="int8-full"``, calibrated on its first 64 training frames, and
record the bf16 and the int8 detector's per-frame detections and the
gate's boxes (``int8full_waveforms.detail``); the port also serves
int8-full with the JAX package's calibration (its ``save_qparams`` file,
read by the port's ``load_qparams``), which tells the calibration from the
int8 forward.  Prints each side's ``summary`` and, between the sides, each
route's waveform gap.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from openglottal_tpu_torch.tools import int8full_waveforms as tw  # noqa: E402


def jax_detail(unet_vars, yolo_vars, gray, calib, qparams_out) -> dict:
    """:func:`int8full_waveforms.detail` through the JAX package; its
    int8-full calibration saved to ``qparams_out``."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from openglottal_tpu.models.gate import gate_scan
    from openglottal_tpu.models.quant import qyolo_outputs
    from openglottal_tpu.models.yolo import max_conf_detect
    from openglottal_tpu.pipelines import GlottalPipelines

    def host(x) -> list:
        return np.asarray(x, np.float32).tolist()

    out = {}
    h, w = gray.shape[1:]
    for route, quant in (("bf16", None), ("int8", "int8"),
                         ("int8full", "int8-full")):
        pipe = GlottalPipelines(unet_variables=unet_vars,
                                yolo_variables=yolo_vars, conf=0.25,
                                quant=quant)
        if quant:
            pipe.calibrate(calib)
        if route == "int8full":
            pipe.save_qparams(qparams_out)
        out[route] = {"areas": host(pipe.yolo_unet_areas_gray(gray))}
        print(f"jax {route}: waveform done", file=sys.stderr, flush=True)
        if route == "int8":
            continue
        if quant:
            qp = pipe._q(gray)["yolo"]
            x = jnp.asarray(gray, jnp.float32)[..., None]
            if qp["stem_bf16"]["kernel"].shape[2] == 3:
                x = jnp.broadcast_to(x, x.shape[:3] + (3,))
            has, raw, conf = max_conf_detect(qyolo_outputs(qp, x), h, w,
                                             pipe.conf)
        else:
            has, raw, conf = pipe.detect_video_gray(gray)
        valid, boxes = gate_scan(has, raw, h, w, params=pipe.gate_params)
        out[route].update(has=host(has), raw=host(raw), conf=host(conf),
                          valid=host(valid), boxes=host(boxes))
    return out


def between(a: dict, b: dict) -> dict:
    """Each route's waveform gap (rel L1, a against b, and the frames that
    differ), and the largest gap of the two detectors' confidences."""
    out = {}
    for route in ("bf16", "int8", "int8full"):
        x, y = np.asarray(a[route]["areas"]), np.asarray(b[route]["areas"])
        out[route] = {"rel_l1": tw.rel_l1(x, y),
                      "frames_differ": np.nonzero(x != y)[0].tolist()}
    for route in ("bf16", "int8full"):
        out[route]["conf_max_abs"] = float(np.abs(
            np.asarray(a[route]["conf"]) - np.asarray(b[route]["conf"])).max())
        out[route]["gate_box_max_abs_px"] = float(np.abs(
            np.asarray(a[route]["boxes"]) - np.asarray(b[route]["boxes"])
        ).max())
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--card", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from openglottal_tpu_torch.utils.io import (
        load_unet_weights,
        load_yolo_weights,
    )

    ck = Path(args.ckpt_dir)
    uv = load_unet_weights(ck / "unet" / "best.pt")
    yv = load_yolo_weights(ck / "yolo" / "best.pt")
    gray, calib = tw.selftest_frames()
    cpu = torch.device("cpu")
    jq_path = Path(args.out or "compare.json").with_suffix(".jax_qparams.npz")
    sides = {"jax_cpu": jax_detail(uv, yv, gray, calib, jq_path),
             "port_cpu": tw.detail(uv, yv, gray, calib, cpu)}
    # the port's int8-full served with the JAX package's calibration
    sides["port_cpu_jax_calib"] = {
        **sides["port_cpu"], **tw.detail(uv, yv, gray, calib, cpu, jq_path,
                                         routes=("int8full",))}
    if args.card:
        sides["port_card"] = json.loads(Path(args.card).read_text())["detail"]
    res = {"summary": {k: tw.summary(d) for k, d in sides.items()},
           "port_cpu_vs_jax_cpu": between(sides["port_cpu"],
                                          sides["jax_cpu"]),
           "port_cpu_jax_calib_vs_jax_cpu": between(
               sides["port_cpu_jax_calib"], sides["jax_cpu"])}
    if args.card:
        res["port_card_vs_port_cpu"] = between(sides["port_card"],
                                               sides["port_cpu"])
        res["port_card_vs_jax_cpu"] = between(sides["port_card"],
                                              sides["jax_cpu"])
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
