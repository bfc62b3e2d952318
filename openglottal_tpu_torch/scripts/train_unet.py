"""Full-frame U-Net training on GIRAFE / BAGLS PNG splits.

Counterpart of ``scripts/train_unet.py``: the reference recipe (0.5·BCE +
0.5·dice, AdamW lr 1e-3 + cosine T_max = epochs, batch 16, 50 epochs,
best-val checkpoint, --patience, --resume loads weights with a fresh
optimizer).  The whole dataset is materialised to device-resident uint8
arrays once and every step runs on the card (``train/unet_trainer.py``).
Checkpoints: OUTPUT_DIR/best.pt, latest.pt and metrics.jsonl.  The last
line printed is one JSON object {"best_val_loss", "epochs_run"}.

    python -m openglottal_tpu_torch.scripts.train_unet --images-dir D \\
        --labels-dir D --training-json training.json [--epochs 50] ...
"""

from __future__ import annotations

import argparse
import json


def add_common(p: argparse.ArgumentParser) -> None:
    """The flag the port's trainers add to the reference's."""
    p.add_argument("--device", default=None,
                   help="Torch device (default: the CUDA device).")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="train-unet",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--images-dir", required=True)
    p.add_argument("--labels-dir", required=True)
    p.add_argument("--training-json", required=True)
    p.add_argument("--label-suffix", default="", help='"_seg" for BAGLS.')
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--patience", type=int, default=None)
    p.add_argument("--resume", default=None, help="Weights to warm-start from "
                   "(.npz or torch .pt); optimizer starts fresh.")
    p.add_argument("--output-dir", default="outputs/unet")
    p.add_argument("--cache-dir", default="outputs/cache")
    p.add_argument("--val-key", default="Val")
    p.add_argument("--tensorboard", default=None,
                   help="TensorBoard log dir (reference train_unet.py:166).")
    p.add_argument("--hdf5-cache", default=None,
                   help="Load a reference-format HDF5 cache instead of PNGs "
                        "(expects <name>_train.h5 / _val.h5; needs h5py).")
    add_common(p)
    return p


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)

    from openglottal_tpu_torch.data.dataset import (
        load_split_json,
        materialize_split,
    )
    from openglottal_tpu_torch.train.unet_trainer import UNetTrainer

    splits = load_split_json(args.training_json)
    print(f"train {len(splits['training'])} / val {len(splits[args.val_key])}")
    if args.hdf5_cache:
        from openglottal_tpu_torch.data.dataset import load_glottis_hdf5

        tr_i, tr_m = load_glottis_hdf5(f"{args.hdf5_cache}_train.h5")
        va_i, va_m = load_glottis_hdf5(f"{args.hdf5_cache}_val.h5")
    else:
        tr_i, tr_m = materialize_split(splits["training"], args.images_dir,
                                       args.labels_dir, args.label_suffix,
                                       cache_dir=args.cache_dir)
        va_i, va_m = materialize_split(splits[args.val_key], args.images_dir,
                                       args.labels_dir, args.label_suffix,
                                       cache_dir=args.cache_dir)

    trainer = UNetTrainer(lr=args.lr, batch_size=args.batch,
                          device=args.device)
    state = None
    if args.resume:
        from openglottal_tpu_torch.utils.io import load_unet_weights

        state = trainer.init_state(load_unet_weights(args.resume))
        print(f"Resumed weights from {args.resume} (fresh optimizer)")

    state, best, history = trainer.fit(
        tr_i, tr_m, va_i, va_m, epochs=args.epochs, patience=args.patience,
        ckpt_dir=args.output_dir, state=state,
        tensorboard_dir=args.tensorboard)
    out = {"best_val_loss": min(h["loss/val"] for h in history),
           "epochs_run": len(history)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
