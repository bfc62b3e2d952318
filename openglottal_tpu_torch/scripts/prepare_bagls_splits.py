"""Build BAGLS's training.json (reference scripts/prepare_bagls_splits.py):
N.png + N_seg.png pairs, a seed-42 shuffle, a validation split.

Counterpart of ``scripts/prepare_bagls_splits.py``, with its flags; the
shuffle is the standard library's ``random`` with the same seed, so the
JSON written is byte-equal to the JAX package's.

    python -m openglottal_tpu_torch.scripts.prepare_bagls_splits \\
        --data-dir D [--output bagls_training.json] [--val-frac 0.1] \\
        [--seed 42] [--max-images N]
"""

from __future__ import annotations

import argparse
import json
import random
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="prepare-bagls-splits",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--data-dir", required=True,
                   help="Directory with N.png and N_seg.png pairs.")
    p.add_argument("--output", default="bagls_training.json")
    p.add_argument("--val-frac", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--max-images", type=int, default=0)
    return p


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    d = Path(args.data_dir)
    fnames = sorted(
        f.name for f in d.iterdir()
        if f.suffix == ".png" and not f.name.endswith("_seg.png")
        and (d / f"{f.stem}_seg.png").exists()
    )
    if args.max_images:
        fnames = fnames[: args.max_images]
    rng = random.Random(args.seed)
    rng.shuffle(fnames)
    n_val = int(len(fnames) * args.val_frac)
    splits = {"training": sorted(fnames[n_val:]),
              "Val": sorted(fnames[:n_val])}
    with open(args.output, "w") as f:
        json.dump(splits, f, indent=2)
    print(f"{args.output}: train {len(splits['training'])} / "
          f"val {len(splits['Val'])}")
    return splits


if __name__ == "__main__":
    main()
