"""One GAW plot PNG per patient: the area waveform with its features in a
box (reference scripts/plot_gaw.py); ``--resume`` skips patients whose plot
exists.

Counterpart of ``scripts/plot_gaw.py``.  Videos are read by the port's AVI
reader (``data/video.read_frames``) and served through YOLO+UNet
(``GlottalPipelines.yolo_unet_areas``) on the card unless ``--device cpu``.
Needs ``matplotlib``, imported when the command runs (the card's machine
has none).

    python -m openglottal_tpu_torch.cli plot-gaw --raw-data-dir D \\
        --unet-weights W --yolo-weights W [--capture-fps 4000] \\
        [--output-dir results/gaw_plots] [--resume]
"""

from __future__ import annotations

import argparse
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="plot-gaw",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--raw-data-dir", required=True)
    p.add_argument("--unet-weights", required=True)
    p.add_argument("--yolo-weights", required=True)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--capture-fps", type=float, default=4000.0)
    p.add_argument("--output-dir", default="results/gaw_plots")
    p.add_argument("--resume", action="store_true",
                   help="Skip patients whose plot already exists.")
    p.add_argument("--device", default=None,
                   help="Torch device (default: the CUDA device).")
    return p


def main(argv: list[str] | None = None) -> list:
    """Returns the paths of the plots written."""
    args = build_parser().parse_args(argv)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from openglottal_tpu_torch.data.video import read_frames
    from openglottal_tpu_torch.features import kinematic_features
    from openglottal_tpu_torch.pipelines import GlottalPipelines
    from openglottal_tpu_torch.utils.io import (
        load_unet_weights,
        load_yolo_weights,
    )

    pipe = GlottalPipelines(
        unet_variables=load_unet_weights(args.unet_weights),
        yolo_variables=load_yolo_weights(args.yolo_weights),
        conf=args.conf, device=args.device)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    written = []
    for pdir in sorted(Path(args.raw_data_dir).iterdir()):
        if not pdir.is_dir():
            continue
        out_png = out_dir / f"{pdir.name}.png"
        if args.resume and out_png.exists():
            continue
        avis = sorted(pdir.glob("*.avi"))
        if not avis:
            continue
        frames = read_frames(avis[0], device=pipe.device)
        if len(frames) == 0:
            continue
        areas = pipe.yolo_unet_areas(frames).float().cpu().numpy()
        feats = kinematic_features(areas)

        fig, ax = plt.subplots(figsize=(10, 4))
        ax.plot(areas, lw=0.8)
        ax.set_xlabel("frame")
        ax.set_ylabel("glottal area (px)")
        ax.set_title(pdir.name)
        if feats is not None:
            f0 = (feats["f0"] * args.capture_fps if feats["f0"] is not None
                  else None)
            text = "\n".join([
                f"area_mean={feats['area_mean']:.1f}",
                f"open_quotient={feats['open_quotient']:.3f}",
                f"f0={f0:.1f} Hz" if f0 is not None else "f0=n/a",
                f"periodicity={feats['periodicity']:.3f}",
                f"cv={feats['cv']:.3f}",
            ])
            ax.text(0.99, 0.97, text, transform=ax.transAxes, va="top",
                    ha="right", fontsize=8,
                    bbox=dict(boxstyle="round", fc="white", alpha=0.8))
        fig.tight_layout()
        fig.savefig(out_png, dpi=120)
        plt.close(fig)
        written.append(out_png)
        print(f"  {out_png}", flush=True)
    return written


if __name__ == "__main__":
    main()
