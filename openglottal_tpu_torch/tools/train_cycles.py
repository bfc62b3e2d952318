"""Per-pass SM cycles and occupancy of ``og_unet_augment`` and
``og_bce_dice`` (``csrc/train.cu``), on one CUDA device.

    python3 -m openglottal_tpu_torch.tools.train_cycles [--out DIR]

Copies this checkout's ``csrc/train.cu``, instruments the copy with
``tools/blob_cycles.instrument`` and builds it beside the package's own
libraries: thread 0 of each block stores ``clock64()`` where a kernel
starts, after each of its barriers (``__syncthreads();``, the cluster's
``cluster_wait();`` and the frame's ``mbar_wait(...);``) and where it ends,
and there also the block's SM.  The copy also gets ``og_train_occupancy``:
how many of the augment's clusters the card holds at once, and the two
kernels' blocks an SM and shared bytes a block.  Nothing of it is kept in
``csrc/``.

Inputs: the trainers' shapes, a drawn augmentation of 16 frames of 256² and
the loss on (16, 1, 256, 256) logits.  The instrumented kernels' outputs
are held bit-equal to the package's own kernels' (the marks change no
arithmetic).  Prints one JSON line: the occupancy and, for each kernel, its
blocks grouped by their number of marks (a sample without blur skips the
blur's barriers; the loss's last block runs the finish), each group's
cycles between consecutive marks (median and max over its blocks), and for
the augment the blocks alone on an SM and sharing one; with the card's
name, power limit and SM clock (nvidia-smi).  With ``--out`` the line also
goes to ``DIR/train_cycles.jsonl``.  Kernel times in turns, the plain
versions, the stress families and other checkouts are
``chip_smoke.py --train [--against DIR]``.  Fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

from openglottal_tpu_torch.tools import blob_cycles

_BARRIER = re.compile(r"(__syncthreads\(\)\s*;|cluster_wait\(\)\s*;"
                      r"|mbar_wait\([^;]*\)\s*;)")

# (uses the kernels and constants of this checkout's train.cu)
_OCCUPANCY = """
// out: {clusters of augment_kernel the card holds at once for a batch of b,
// its blocks an SM, its shared bytes a block, bce_dice_kernel's blocks an
// SM, its shared bytes a block}
extern "C" int og_train_occupancy(int b, int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      augment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, AUG_SMEM);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(AUG_RANKS, b > 0 ? b : 1);
  cfg.blockDim = dim3(AUG_THREADS);
  cfg.dynamicSmemBytes = AUG_SMEM;
  e = cudaOccupancyMaxActiveClusters(&out[0], augment_kernel, &cfg);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[1], augment_kernel, AUG_THREADS, AUG_SMEM);
  if (e != cudaSuccess) return (int)e;
  out[2] = AUG_SMEM;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, bce_dice_kernel);
  if (e != cudaSuccess) return (int)e;
  out[4] = (int)fa.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], bce_dice_kernel, BCE_THREADS, 0);
}
"""


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def served_inputs(dev):
    """The trainers' shapes: (imgs, msks, params, noise) of a drawn
    augmentation of 16 frames of 256², and (logits, targets) of the loss on
    (16, 1, 256, 256)."""
    import numpy as np
    import torch

    from openglottal_tpu_torch.data import augment

    rng = np.random.default_rng(7)
    gen = torch.Generator(device=dev).manual_seed(7)
    imgs = torch.from_numpy(rng.integers(0, 256, (16, 256, 256)).astype(
        np.uint8)).to(dev)
    msks = torch.from_numpy((rng.random((16, 256, 256)) > 0.8).astype(
        np.uint8)).to(dev)
    params, noise = augment.sample_params(16, gen, dev)
    x = torch.from_numpy(rng.normal(0, 4, (16, 1, 256, 256)).astype(
        np.float32)).to(dev)
    t = torch.from_numpy((rng.random((16, 1, 256, 256)) > 0.8).astype(
        np.float32)).to(dev)
    return (imgs, msks, params, noise), (x, t)


def mark_groups(clk, blocks: int, sm_split: bool = False) -> list:
    """The stored marks of ``blocks`` blocks ((MAX_BLOCKS, MARKS) int64),
    grouped by each block's number of marks: [{marks, blocks, cycles
    between consecutive marks (median, max), the block's total (median,
    max)}], and with ``sm_split`` the same for the blocks alone on their SM
    and those sharing one."""
    import numpy as np

    m = blob_cycles.MARKS
    clk = clk[:blocks]
    n = clk[:, m - 1]
    sm = clk[:, m - 2]
    shared = np.bincount(sm, minlength=int(sm.max()) + 1)[sm] > 1

    def stats(rows) -> dict:
        d = np.diff(rows, axis=1)
        return {"blocks": int(len(rows)),
                "cycles_median": np.median(d, 0).tolist(),
                "cycles_max": d.max(0).tolist(),
                "total_median": float(np.median(d.sum(1))),
                "total_max": float(d.sum(1).max())}

    out = []
    for k in sorted(int(v) for v in np.unique(n) if v > 0):
        sel = n == k
        rows = clk[sel, :min(k, m - 2)]
        g = {"marks": k, **stats(rows)}
        if sm_split:
            for tag, part in (("alone_on_sm", ~shared[sel]),
                              ("sharing_sm", shared[sel])):
                if part.any():
                    g[tag] = stats(rows[part])
        out.append(g)
    return out


def main(argv=None) -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_cycles: no CUDA device", file=sys.stderr)
        return 1
    from openglottal_tpu_torch.ops import _build
    from openglottal_tpu_torch.ops import train_cuda as T
    from openglottal_tpu_torch.tools.train_stress import same_bits

    dev = torch.device("cuda")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    patched = _build.BUILD_DIR / "train_cycles.cu"
    patched.write_text(blob_cycles.instrument(
        (_build.CSRC_DIR / "train.cu").read_text(), _BARRIER, _OCCUPANCY))
    lib = _build.build_others({"train_cycles": patched})["train_cycles"][0]
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.og_unet_augment.argtypes = [p] * 7 + [i, p]
    lib.og_bce_dice.argtypes = [p] * 5 + [i, i, i, p]
    lib.og_read_pass_clock.argtypes = [p, i]
    lib.og_train_occupancy.argtypes = [i, p]
    stream = torch.cuda.current_stream().cuda_stream

    occ = (ctypes.c_int * 5)()
    _build.check(lib.og_train_occupancy(16, occ), "og_train_occupancy")
    (imgs, msks, params, noise), (x, t) = served_inputs(dev)
    b = imgs.shape[0]

    def read(blocks):
        torch.cuda.synchronize()
        clk = np.zeros((blob_cycles.MAX_BLOCKS, blob_cycles.MARKS), np.int64)
        _build.check(lib.og_read_pass_clock(clk.ctypes.data, blocks), "read")
        return clk

    clock = _smi("clocks.sm")
    img = torch.empty((b, 256, 256), dtype=torch.float32, device=dev)
    msk = torch.empty_like(img)
    _build.check(lib.og_clear_pass_clock(), "clear")
    _build.check(lib.og_unet_augment(
        imgs.data_ptr(), msks.data_ptr(), params.data_ptr(),
        noise.data_ptr(), img.data_ptr(), msk.data_ptr(), None, b, stream),
        "og_unet_augment")
    aug_blocks = 8 * b                  # the cluster of 8 blocks a sample
    aug_clk = read(aug_blocks)
    partial = torch.zeros(T.BCE_BLOCKS * 4 + 1, dtype=torch.float32,
                          device=dev)
    out = torch.empty(6, dtype=torch.float32, device=dev)
    _build.check(lib.og_clear_pass_clock(), "clear")
    _build.check(lib.og_bce_dice(
        x.data_ptr(), t.data_ptr(), None, partial.data_ptr(), out.data_ptr(),
        b, x.numel() // b, T.BCE_BLOCKS, stream), "og_bce_dice")
    bce_clk = read(T.BCE_BLOCKS)
    sums, cnt, loss = T._bce_dice_cuda(x, t, None)
    equal = {"unet_augment": same_bits(
                 (img, msk), T.unet_augment(imgs, msks, params, noise)),
             "bce_dice": same_bits(
                 (out,), (torch.cat([sums, cnt.reshape(1), loss.reshape(1)]),))}
    line = {"card": _smi("name,power.limit"), "sm_clock": clock,
            "occupancy": {
                "augment_clusters_at_once": occ[0],
                "augment_blocks_per_sm": occ[1],
                "augment_smem_bytes": occ[2],
                "bce_dice_blocks_per_sm": occ[3],
                "bce_dice_smem_bytes": occ[4]},
            "shape_augment": list(imgs.shape),
            "augment_samples_with_blur": int((params[:, 7] != 0).sum()),
            "shape_loss": list(x.shape),
            "bit_equal_to_the_package_kernels": equal,
            "augment": mark_groups(aug_clk, aug_blocks, sm_split=True),
            "bce_dice": mark_groups(bce_clk, T.BCE_BLOCKS)}
    print(json.dumps(line), flush=True)
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        with open(Path(args.out) / "train_cycles.jsonl", "w") as f:
            f.write(json.dumps(line) + "\n")
    if not all(equal.values()):
        print(f"train_cycles: instrumented outputs differ: {equal}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
