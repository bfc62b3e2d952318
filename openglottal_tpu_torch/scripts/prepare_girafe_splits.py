"""Build GIRAFE's training.json (reference scripts/prepare_girafe_splits.py):
the fixed test patients (57A3, 61, 63, 64), a seed-42 shuffle of the rest,
10 % of it for validation.

Counterpart of ``scripts/prepare_girafe_splits.py``, with its flags; the
shuffle is the standard library's ``random`` with the same seed, so the
JSON written is byte-equal to the JAX package's.

    python -m openglottal_tpu_torch.scripts.prepare_girafe_splits \\
        --images-dir D [--output training.json] [--val-frac 0.1] [--seed 42]
"""

from __future__ import annotations

import argparse
import json
import random
from pathlib import Path

TEST_PATIENTS = {"patient57A3", "patient61", "patient63", "patient64"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="prepare-girafe-splits",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--images-dir", required=True)
    p.add_argument("--output", default="training.json")
    p.add_argument("--val-frac", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=42)
    return p


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    fnames = sorted(f.name for f in Path(args.images_dir).iterdir()
                    if f.suffix == ".png")
    test = [f for f in fnames
            if "_".join(f.split("_")[:-1]) in TEST_PATIENTS]
    rest = [f for f in fnames if f not in set(test)]
    rng = random.Random(args.seed)
    rng.shuffle(rest)
    n_val = int(len(rest) * args.val_frac)
    splits = {"training": sorted(rest[n_val:]), "Val": sorted(rest[:n_val]),
              "test": sorted(test)}
    with open(args.output, "w") as f:
        json.dump(splits, f, indent=2)
    print(f"{args.output}: train {len(splits['training'])} / "
          f"val {len(splits['Val'])} / test {len(splits['test'])}")
    return splits


if __name__ == "__main__":
    main()
