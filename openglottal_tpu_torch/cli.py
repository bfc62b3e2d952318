"""Command line of the port: a video file in, ``features.json`` out.

Counterpart of ``openglottal_tpu/cli.py``'s ``run`` command, with its flags:

    python -m openglottal_tpu_torch.cli run VIDEO --pipeline unet \\
        --yolo-weights weights/demo_yolo.npz \\
        --unet-weights weights/demo_unet.npz [--stream CHUNK] \\
        [--quant int8|int8-full [--calib VIDEO] [--qparams NPZ]] \
        [--device cuda|cpu] [-o results]

``--stream CHUNK`` decodes and serves the video CHUNK frames at a time in
bounded memory (``GlottalPipelines.stream_features``; bit-identical to the
whole-video call, for ``unet`` to its full-frame route and for the trackers
to their sequential forms); without it the whole video is decoded and
served (``extract_features``).  ``--device`` picks the device (the CUDA
device by default; ``cpu`` on purpose).  Videos are read by the port's own
AVI reader (``data/video.py``: uncompressed gray and BI_RGB, and MJPG,
which crosses to the device compressed and is decoded there) straight onto
the pipelines' device (``read_frames`` / ``iter_frames``).  Weights are
``.npz`` files or torch ``.pt`` / ``.pth`` checkpoints (``utils/io.py``),
such as the trainers' ``best.pt``.

``--quant int8`` serves the U-Net in int8 (``int8-full``: the detector too;
``models/quant.py``) on the routes the JAX package quantizes (``unet`` and
``unet-only`` on 256² video; streams stay bfloat16, as the JAX package's
do).  ``--qparams NPZ``: a calibration file loaded if it exists, else
written after calibrating (on ``--calib VIDEO``'s first 64 frames if given,
else on the input video's); its layout is the JAX package's, so either
package reads the other's.  ``--calib`` / ``--qparams`` without ``--quant``
is an error.

Training and dataset building, as the JAX package's command line has them
(``openglottal_tpu/cli.py:74-104``):

    python -m openglottal_tpu_torch.cli train-unet ...
    python -m openglottal_tpu_torch.cli train-unet-crop ... --mode gt|yolo
    python -m openglottal_tpu_torch.cli train-yolo ...
    python -m openglottal_tpu_torch.cli build-dataset --images-dir D \
        --labels-dir D --training-json J [--output-dir yolo_data] [--force]

Evaluation and analysis, as the JAX package's command line delegates them
(``openglottal_tpu/cli.py:84-90``):

    python -m openglottal_tpu_torch.cli eval-girafe ...   # GIRAFE Table 3
    python -m openglottal_tpu_torch.cli eval-bagls ...    # BAGLS test set
    python -m openglottal_tpu_torch.cli sweep-bagls ...   # YOLO conf sweep
    python -m openglottal_tpu_torch.cli analyze-gaw ...   # cohort GAW study
    python -m openglottal_tpu_torch.cli plot-gaw ...      # GAW plots

The ``train-*`` and these five commands hand their arguments to the port's
modules ``openglottal_tpu_torch/scripts/`` (``train_unet``,
``train_unet_crop``, ``train_yolo``, ``eval_girafe``, ``eval_bagls``,
``sweep_bagls_conf``, ``analyze_gaw``, ``plot_gaw``; each with its own
``--help``); they run on the card unless ``--device cpu`` is given.
``plot-gaw`` needs ``matplotlib``, as ``analyze-gaw``'s boxplot does (it is
skipped without it).  ``infer`` and ``benchmark`` are not ported yet;
``download-datasets`` needs a network and is not ported.
"""

from __future__ import annotations

import argparse
import os
import sys

PIPELINE_CHOICES = ("vft", "guided-vft", "unet", "unet-only", "crop-unet")
# training, evaluation and analysis commands -> the port's script modules
# (``scripts/``)
SCRIPT_COMMANDS = {"train-unet": "train_unet",
                   "train-unet-crop": "train_unet_crop",
                   "train-yolo": "train_yolo", "eval-girafe": "eval_girafe",
                   "eval-bagls": "eval_bagls",
                   "sweep-bagls": "sweep_bagls_conf",
                   "analyze-gaw": "analyze_gaw", "plot-gaw": "plot_gaw"}


def build_parser() -> tuple[argparse.ArgumentParser, argparse.ArgumentParser]:
    """(the parser, its ``run`` subparser)."""
    parser = argparse.ArgumentParser(
        prog="openglottal-tpu-torch",
        description="Automated glottal area segmentation from high-speed "
                    "videoendoscopy, on PyTorch and CUDA.")
    parser.add_argument("--config", help="JSON or YAML config path.")
    sub = parser.add_subparsers(dest="command", required=True)
    run_p = sub.add_parser("run", help="Run inference on a video file.")
    run_p.add_argument("video", help="Path to an input .avi video "
                       "(uncompressed, or MJPG: decoded on the device).")
    run_p.add_argument("--yolo-weights", help="YOLO weights, .npz (required "
                       "for vft, guided-vft, unet, crop-unet).")
    run_p.add_argument("--unet-weights", help="U-Net weights, .npz "
                       "(required for unet, unet-only).")
    run_p.add_argument("--crop-weights", help="Crop-trained U-Net weights, "
                       ".npz (required for crop-unet).")
    run_p.add_argument("--pipeline", choices=PIPELINE_CHOICES, default="unet")
    run_p.add_argument("--output", "-o", default="results")
    run_p.add_argument("--conf", type=float, default=None,
                       help="YOLO confidence threshold (default from config).")
    run_p.add_argument("--quant", choices=["int8", "int8-full"], default=None,
                       help="int8 serving: the U-Net post-training quantized "
                            "(calibrated on the input video unless --calib or "
                            "--qparams says otherwise), on the unet / "
                            "unet-only whole-video paths; 'int8-full' "
                            "quantizes the YOLO detector too.")
    run_p.add_argument("--calib", default=None, metavar="VIDEO",
                       help="int8 calibration video (its first 64 frames).")
    run_p.add_argument("--qparams", default=None, metavar="NPZ",
                       help="Persisted int8 calibration: loaded if the file "
                            "exists, else written after calibration (the JAX "
                            "package's .npz layout).")
    run_p.add_argument("--stream", type=int, default=0, metavar="CHUNK",
                       help="Process the video in CHUNK-frame segments with "
                            "bounded memory (all five pipelines; the results "
                            "equal whole-video processing, for unet its "
                            "full-frame route, for the trackers their "
                            "sequential forms).")
    run_p.add_argument("--device", default=None,
                       help="Torch device (default: the CUDA device; 'cpu' "
                            "runs on the CPU).")

    bd_p = sub.add_parser("build-dataset",
                          help="Build a YOLO detection dataset from masks.")
    bd_p.add_argument("--images-dir", required=True)
    bd_p.add_argument("--labels-dir", required=True)
    bd_p.add_argument("--training-json", required=True)
    bd_p.add_argument("--output-dir", default="yolo_data")
    bd_p.add_argument("--force", action="store_true")
    bd_p.add_argument("--mask-suffix", default="")
    for name, module in SCRIPT_COMMANDS.items():
        sub.add_parser(name, add_help=False,
                       help=f"openglottal_tpu_torch/scripts/{module}.py "
                            f"(its own --help).")
    return parser, run_p


def main(argv: list[str] | None = None):
    parser, run_p = build_parser()
    args, extra = parser.parse_known_args(argv)
    if args.command in SCRIPT_COMMANDS:
        import importlib

        module = importlib.import_module(
            f"openglottal_tpu_torch.scripts.{SCRIPT_COMMANDS[args.command]}")
        return module.main(extra)
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    if args.command == "run":
        _cmd_run(run_p, args)
    elif args.command == "build-dataset":
        _cmd_build_dataset(args)
    return None


def _cmd_build_dataset(args) -> None:
    from openglottal_tpu_torch.data.yolo_dataset import build_yolo_dataset

    yaml_path = build_yolo_dataset(
        images_dir=args.images_dir, labels_dir=args.labels_dir,
        training_json=args.training_json, output_dir=args.output_dir,
        force=args.force, mask_suffix=args.mask_suffix)
    print(f"YAML config written to {yaml_path}")


def _cmd_run(parser: argparse.ArgumentParser, args) -> None:
    if (args.calib or args.qparams) and not args.quant:
        parser.error("--calib/--qparams need --quant int8 or int8-full")
    if args.stream < 0:
        parser.error("--stream must be >= 0")
    needs_yolo = args.pipeline in ("vft", "guided-vft", "unet", "crop-unet")
    needs_unet = args.pipeline in ("unet", "unet-only")
    if needs_yolo and not args.yolo_weights:
        parser.error(f"--yolo-weights is required for the {args.pipeline} "
                     f"pipeline.")
    if needs_unet and not args.unet_weights:
        parser.error(f"--unet-weights is required for the {args.pipeline} "
                     f"pipeline.")
    if args.pipeline == "crop-unet" and not args.crop_weights:
        parser.error("--crop-weights is required for the crop-unet pipeline.")

    from openglottal_tpu_torch.config import load_config
    from openglottal_tpu_torch.data.video import iter_frames, read_frames
    from openglottal_tpu_torch.pipelines import CALIB_FRAMES, GlottalPipelines
    from openglottal_tpu_torch.utils.io import (
        load_unet_weights,
        load_yolo_weights,
        save_features_json,
    )

    cfg = load_config(args.config)
    if args.conf is not None:
        cfg.detector.conf = args.conf

    def weights(path, load):
        return load(path) if path else None

    pipe = GlottalPipelines(
        unet_variables=weights(args.unet_weights, load_unet_weights),
        crop_unet_variables=weights(args.crop_weights, load_unet_weights),
        yolo_variables=weights(args.yolo_weights, load_yolo_weights),
        conf=cfg.detector.conf, gate_params=cfg.gate_params(),
        vft_params=cfg.vft_params(), ygvft_params=cfg.ygvft_params(),
        quant=args.quant, device=args.device)

    def calib_frames(path):
        # the video's first CALIB_FRAMES frames, decoded on the device
        for x in iter_frames(path, chunk=CALIB_FRAMES, device=pipe.device):
            return x
        return read_frames(path, device=pipe.device)

    if args.quant:
        if args.qparams and os.path.exists(args.qparams):
            pipe.load_qparams(args.qparams)
        elif args.calib:
            pipe.calibrate(pipe.prepare(calib_frames(args.calib))[1])
        if args.qparams and not os.path.exists(args.qparams):
            if pipe._qparams is None:
                pipe.calibrate(pipe.prepare(calib_frames(args.video))[1])
            pipe.save_qparams(args.qparams)
            print(f"int8 calibration saved to {args.qparams}")
    if args.stream:
        feats = pipe.stream_features(
            iter_frames(args.video, chunk=args.stream, device=pipe.device),
            args.pipeline)
    else:
        feats = pipe.extract_features(
            read_frames(args.video, device=pipe.device), args.pipeline)
    if feats is None:
        print("No glottis detected — check your weights or input video.")
        sys.exit(1)

    out_path = os.path.join(args.output, "features.json")
    save_features_json(feats, out_path)
    print(f"Features saved to {out_path}")
    for k, v in feats.items():
        if not k.startswith("_"):
            print(f"  {k}: {v:.4f}" if isinstance(v, float) else f"  {k}: {v}")


if __name__ == "__main__":
    main()
