"""YOLOv8n glottis detector training (owning what the reference delegated
to ultralytics, scripts/train_yolo.py:107-121).

Counterpart of ``scripts/train_yolo.py``.  Labels come straight from the
segmentation masks (tight bbox + 10 px dilation, reference data.py:28-68);
``--subset-frac`` mirrors the reference's quick-run knob (:81-96).
``--resume`` loads the weights with fresh BatchNorm statistics and a fresh
optimizer, as the reference script does.  Checkpoints: OUTPUT_DIR/best.pt,
latest.pt (ultralytics-layout ``state_dict``) and metrics.jsonl.  The last
line printed is one JSON object {"final_val_recall", "best_val_recall"}.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from openglottal_tpu_torch.scripts.train_unet import add_common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="train-yolo",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--images-dir", required=True)
    p.add_argument("--labels-dir", required=True)
    p.add_argument("--training-json", required=True)
    p.add_argument("--mask-suffix", default="")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--patience", type=int, default=None,
                   help="early stop after N epochs without recall/val "
                        "improvement")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--subset-frac", type=float, default=1.0)
    p.add_argument("--dilate", type=int, default=10)
    p.add_argument("--output-dir", default="outputs/yolo")
    p.add_argument("--resume", default=None)
    p.add_argument("--no-mosaic", action="store_true",
                   help="Disable mosaic4 (ultralytics default is on).")
    p.add_argument("--close-mosaic", type=int, default=10,
                   help="Disable mosaic for the last N epochs (ultralytics "
                        "default 10).")
    add_common(p)
    return p


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)

    from openglottal_tpu_torch.data.dataset import load_split_json
    from openglottal_tpu_torch.data.yolo_dataset import load_yolo_arrays
    from openglottal_tpu_torch.train.yolo_trainer import YoloTrainer

    splits = load_split_json(args.training_json)
    train_fnames = splits["training"]
    val_fnames = splits["Val"]
    if args.subset_frac < 1.0:
        rng = np.random.default_rng(42)  # reference uses seed 42 (:83)
        k = max(1, int(len(train_fnames) * args.subset_frac))
        train_fnames = list(rng.choice(train_fnames, k, replace=False))

    print(f"train {len(train_fnames)} / val {len(val_fnames)}")
    tr_i, tr_b = load_yolo_arrays(train_fnames, args.images_dir,
                                  args.labels_dir, dilate=args.dilate,
                                  mask_suffix=args.mask_suffix)
    va_i, va_b = load_yolo_arrays(val_fnames, args.images_dir,
                                  args.labels_dir, dilate=args.dilate,
                                  mask_suffix=args.mask_suffix)

    trainer = YoloTrainer(lr=args.lr, batch_size=args.batch,
                          device=args.device)
    state = None
    if args.resume:
        from openglottal_tpu_torch.utils.io import load_yolo_weights

        state = trainer.init_state(load_yolo_weights(args.resume),
                                   keep_stats=False)

    state, best, history = trainer.fit(
        tr_i, tr_b, va_i, va_b, epochs=args.epochs, patience=args.patience,
        mosaic=not args.no_mosaic, close_mosaic=args.close_mosaic,
        ckpt_dir=args.output_dir, state=state)
    out = {"final_val_recall": history[-1].get("recall/val"),
           "best_val_recall": max((h.get("recall/val") or 0)
                                  for h in history)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
