"""Crop-mode U-Net training (reference scripts/train_unet_crop.py).

Counterpart of ``scripts/train_unet_crop.py``: materialises a crop dataset
(GT-bbox mode with +8 px pad, or YOLO-ROI mode skipping no-detection
frames, ``data/crop_dataset.py``), letterboxes crops to 256², caches them
(sha256-keyed; ``--cache-only`` exits after materialisation), then runs the
full-frame recipe.  ``--resume`` loads the weights with fresh BatchNorm
statistics and a fresh optimizer, as the reference script does.  The last
line printed is one JSON object {"best_val_loss"}.

    python -m openglottal_tpu_torch.scripts.train_unet_crop --images-dir D \\
        --labels-dir D --training-json training.json --mode yolo \\
        --yolo-weights weights/demo_yolo.npz
"""

from __future__ import annotations

import argparse
import json

from openglottal_tpu_torch.scripts.train_unet import add_common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="train-unet-crop",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--images-dir", required=True)
    p.add_argument("--labels-dir", required=True)
    p.add_argument("--training-json", required=True)
    p.add_argument("--label-suffix", default="")
    p.add_argument("--mode", choices=["gt", "yolo"], default="gt")
    p.add_argument("--yolo-weights", default=None,
                   help="Required for --mode yolo.")
    p.add_argument("--crop-pad", type=int, default=8)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--patience", type=int, default=None)
    p.add_argument("--resume", default=None)
    p.add_argument("--cache-dir", default="outputs/cache")
    p.add_argument("--cache-only", action="store_true")
    p.add_argument("--output-dir", default="outputs/unet_crop")
    add_common(p)
    return p


def main(argv: list[str] | None = None) -> dict | None:
    p = build_parser()
    args = p.parse_args(argv)
    if args.mode == "yolo" and not args.yolo_weights:
        p.error("--yolo-weights is required for --mode yolo")

    from openglottal_tpu_torch.data.crop_dataset import (
        materialize_gt_crops,
        materialize_yolo_crops,
    )
    from openglottal_tpu_torch.data.dataset import load_split_json
    from openglottal_tpu_torch.train.unet_trainer import UNetTrainer

    splits = load_split_json(args.training_json)
    pipe = None
    if args.mode == "yolo":
        from openglottal_tpu_torch.pipelines import GlottalPipelines
        from openglottal_tpu_torch.utils.io import load_yolo_weights

        pipe = GlottalPipelines(
            yolo_variables=load_yolo_weights(args.yolo_weights),
            conf=args.conf, device=args.device)

    def build(fnames):
        if args.mode == "gt":
            return materialize_gt_crops(fnames, args.images_dir,
                                        args.labels_dir, pad=args.crop_pad,
                                        label_suffix=args.label_suffix,
                                        cache_dir=args.cache_dir)
        return materialize_yolo_crops(fnames, args.images_dir,
                                      args.labels_dir, pipe,
                                      label_suffix=args.label_suffix,
                                      cache_dir=args.cache_dir)

    tr_i, tr_m = build(splits["training"])
    va_i, va_m = build(splits["Val"])
    print(f"crops: train {len(tr_i)} / val {len(va_i)}")
    if args.cache_only:
        print("cache built — exiting (--cache-only).")
        return None

    trainer = UNetTrainer(lr=args.lr, batch_size=args.batch,
                          device=args.device)
    state = None
    if args.resume:
        from openglottal_tpu_torch.utils.io import load_unet_weights

        state = trainer.init_state(load_unet_weights(args.resume),
                                   keep_stats=False)
    state, best, history = trainer.fit(
        tr_i, tr_m, va_i, va_m, epochs=args.epochs, patience=args.patience,
        ckpt_dir=args.output_dir, state=state)
    out = {"best_val_loss": min(h["loss/val"] for h in history)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
