"""Per-pass SM cycles and occupancy of the training kernels of
``csrc/train.cu`` (``og_unet_augment``, ``og_bce_dice`` and its backward,
``og_tal_assign``), on one CUDA device; the launch floor of
``og_tal_assign``'s grid.

    python3 -m openglottal_tpu_torch.tools.train_cycles [--out DIR]

Copies this checkout's ``csrc/train.cu``, instruments the copy with
``tools/blob_cycles.instrument`` and builds it beside the package's own
libraries: thread 0 of each block stores ``clock64()`` where a kernel
starts, after each of its barriers (``__syncthreads();``, the cluster's
``cluster_wait();`` and the frame's ``mbar_wait(...);``) and where it ends,
and there also the block's SM.  In ``og_tal_assign`` lane 0 of each gt's
warp also stores ``clock64()`` where that gt's selection ends
(``og_gt_clock``).  The copy also gets ``og_train_occupancy`` (how many of
the augment's clusters the card holds at once; the kernels' blocks an SM,
registers, local bytes and shared bytes) and ``og_tal_floor``: an empty
kernel of ``og_tal_assign``'s grid (a block of 256 threads an image, the
same dynamic shared memory), which ``chip_smoke.py --train`` times in its
queued protocol as the TAL's launch floor.  Nothing of it is kept in
``csrc/``.

Inputs: the trainers' shapes, a drawn augmentation of 16 frames of 256²,
the loss and its backward on (16, 1, 256, 256) logits, and the TAL at B =
16, A = 1,344 (256²), M = 4 on ``tools/train_stress.py``'s ``m4`` case and
with its first gt repeated four times (all 40 rounds run).  The
instrumented kernels' outputs are held bit-equal to the package's own
kernels' (the marks change no arithmetic); each kernel's marks are those of
the second of two launches (code and inputs warm).  Prints one JSON line: the
occupancy and, for each kernel, its blocks grouped by their number of marks
(a sample without blur skips the blur's barriers; the loss's last block
runs the finish), each group's cycles between consecutive marks (median and
max over its blocks), for the augment the blocks alone on an SM and sharing
one, and for the TAL each gt's selection (from the barrier before it to its
warp's mark); with the card's name, power limit and SM clock (nvidia-smi).
With ``--out`` the line also goes to ``DIR/train_cycles.jsonl``.  Kernel
times in turns, the plain versions, the stress families and other
checkouts are ``chip_smoke.py --train [--against DIR]``.  Fails without a
CUDA device.
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

# where each gt's selection ends in og_tal_assign (lane 0 of its warp)
_GT_MARK = "take_n[w] = r;"
_GT_HEADER = f"""
__device__ long long og_gt_clock[{blob_cycles.MAX_BLOCKS} * 8];
__device__ __forceinline__ void og_gt_mark(int w) {{
  if (blockIdx.x < {blob_cycles.MAX_BLOCKS})
    og_gt_clock[blockIdx.x * 8 + w] = clock64();
}}
"""

# (uses the kernels and constants of this checkout's train.cu)
_OCCUPANCY = """
// out: {clusters of augment_kernel the card holds at once for a batch of b,
// its blocks an SM, its shared bytes a block, bce_dice_kernel's blocks an
// SM, its shared bytes a block; bce_dice_bwd's blocks an SM, registers,
// local bytes; tal_assign_kernel's (at tal_a anchors, tal_m gts) blocks an
// SM, registers, local bytes, shared bytes a block}
extern "C" int og_train_occupancy(int b, int tal_a, int tal_m, int* out) {
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
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], bce_dice_kernel, BCE_THREADS, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[5], bce_dice_bwd, BWD_THREADS, 0);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, bce_dice_bwd);
  if (e != cudaSuccess) return (int)e;
  out[6] = fa.numRegs;
  out[7] = (int)fa.localSizeBytes;
  const size_t smem = tal_smem(tal_a, tal_m);
  e = cudaFuncSetAttribute(tal_assign_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[8], tal_assign_kernel, TAL_THREADS, smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, tal_assign_kernel);
  if (e != cudaSuccess) return (int)e;
  out[9] = fa.numRegs;
  out[10] = (int)fa.localSizeBytes;
  out[11] = (int)(smem + fa.sharedSizeBytes);
  return 0;
}

extern "C" int og_read_gt_clock(long long* host, int blocks) {
  const int n = blocks < MAX_GT_BLOCKS ? blocks : MAX_GT_BLOCKS;
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, og_gt_clock, sizeof(long long) * 8 * n));
}

// The launch floor of og_tal_assign: an empty kernel of its grid.
__global__ void og_tal_floor_kernel() {}

extern "C" int og_tal_floor(int b, int a, int m, cudaStream_t stream) {
  const size_t smem = tal_smem(a, m);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        og_tal_floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  og_tal_floor_kernel<<<b, TAL_THREADS, smem, stream>>>();
  return (int)cudaGetLastError();
}
""".replace("MAX_GT_BLOCKS", str(blob_cycles.MAX_BLOCKS))
OCCUPANCY_FIELDS = (
    "augment_clusters_at_once", "augment_blocks_per_sm", "augment_smem_bytes",
    "bce_dice_blocks_per_sm", "bce_dice_smem_bytes",
    "bce_dice_bwd_blocks_per_sm", "bce_dice_bwd_registers",
    "bce_dice_bwd_local_bytes", "tal_assign_blocks_per_sm",
    "tal_assign_registers", "tal_assign_local_bytes", "tal_assign_smem_bytes")


def instrumented_source(src: str) -> str:
    """``train.cu``'s text with the marks: after every barrier
    (``blob_cycles.instrument``), each gt's selection end in
    ``og_tal_assign``, and the occupancy, gt-clock reader and launch-floor
    entries."""
    if src.count(_GT_MARK) != 1:
        raise ValueError(f"train.cu: expected one {_GT_MARK!r}")
    text = blob_cycles.instrument(
        src.replace(_GT_MARK, _GT_MARK + " og_gt_mark(w);"), _BARRIER,
        _OCCUPANCY)
    at = max(m.end() for m in re.finditer(r"#include[^\n]*\n", text))
    return text[:at] + _GT_HEADER + text[at:]


def build_copy() -> ctypes.CDLL:
    """The instrumented copy of this checkout's ``train.cu``, built beside
    the package's libraries, its entries' argument types set."""
    from openglottal_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    patched = _build.BUILD_DIR / "train_cycles.cu"
    patched.write_text(instrumented_source(
        (_build.CSRC_DIR / "train.cu").read_text()))
    lib = _build.build_others({"train_cycles": patched})["train_cycles"][0]
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.og_unet_augment.argtypes = [p] * 7 + [i, p]
    lib.og_bce_dice.argtypes = [p] * 5 + [i, i, i, p]
    lib.og_bce_dice_bwd.argtypes = [p] * 6 + [i, i, p]
    lib.og_tal_assign.argtypes = [p] * 8 + [i, i, i, p]
    lib.og_read_pass_clock.argtypes = [p, i]
    lib.og_read_gt_clock.argtypes = [p, i]
    lib.og_train_occupancy.argtypes = [i, i, i, p]
    lib.og_tal_floor.argtypes = [i, i, i, p]
    return lib


def tal_floor(lib, b: int, a: int, m: int):
    """fn() launching the empty kernel of ``og_tal_assign``'s grid for b
    images, a anchors, m gts on the current stream."""
    import torch

    from openglottal_tpu_torch.ops import _build

    def fn():
        _build.check(lib.og_tal_floor(
            b, a, m, torch.cuda.current_stream().cuda_stream), "og_tal_floor")
    return fn


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


def gt_selection(clk, gclk, blocks: int, m: int) -> list:
    """Each gt's selection in cycles, from the barrier before it (thread
    0's mark before the last barrier's) to the end mark of its warp:
    [{gt, median, max}]."""
    import numpy as np

    # a block's marks: its start, one after each barrier, its end
    at = clk[:blocks, blob_cycles.MARKS - 1] - 3
    d = gclk[:blocks, :m] - clk[np.arange(blocks), at][:, None]
    return [{"gt": w, "median": float(np.median(d[:, w])),
             "max": float(d[:, w].max())} for w in range(m)]


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
    from openglottal_tpu_torch.tools import train_stress as ts

    dev = torch.device("cuda")
    lib = build_copy()
    stream = torch.cuda.current_stream().cuda_stream
    (imgs, msks, params, noise), (x, t) = served_inputs(dev)
    b = imgs.shape[0]
    label, *tal = ts.tal_cases("m4", 256)[0]
    cls, pred, gt, gv = (torch.from_numpy(v).to(dev) for v in tal)
    pts = torch.from_numpy(ts.tal_pts(256)).to(dev)
    tb, ta = cls.shape
    tm = gt.shape[1]

    occ = (ctypes.c_int * len(OCCUPANCY_FIELDS))()
    _build.check(lib.og_train_occupancy(b, ta, tm, occ), "og_train_occupancy")

    def read(blocks, gt_clock=False):
        torch.cuda.synchronize()
        clk = np.zeros((blob_cycles.MAX_BLOCKS, blob_cycles.MARKS), np.int64)
        _build.check(lib.og_read_pass_clock(clk.ctypes.data, blocks), "read")
        if not gt_clock:
            return clk
        gclk = np.zeros((blob_cycles.MAX_BLOCKS, 8), np.int64)
        _build.check(lib.og_read_gt_clock(gclk.ctypes.data, blocks), "read")
        return clk, gclk

    def twice(name, launch):
        """The marks of a launch that follows a first one (code and inputs
        warm, as in a run of launches)."""
        _build.check(launch(), name)
        torch.cuda.synchronize()
        _build.check(lib.og_clear_pass_clock(), "clear")
        _build.check(launch(), name)

    clock = _smi("clocks.sm")
    img = torch.empty((b, 256, 256), dtype=torch.float32, device=dev)
    msk = torch.empty_like(img)
    twice("og_unet_augment", lambda: lib.og_unet_augment(
        imgs.data_ptr(), msks.data_ptr(), params.data_ptr(),
        noise.data_ptr(), img.data_ptr(), msk.data_ptr(), None, b, stream))
    aug_blocks = 8 * b                  # the cluster of 8 blocks a sample
    aug_clk = read(aug_blocks)
    partial = torch.zeros(T.BCE_BLOCKS * 4 + 1, dtype=torch.float32,
                          device=dev)
    out = torch.empty(6, dtype=torch.float32, device=dev)
    twice("og_bce_dice", lambda: lib.og_bce_dice(
        x.data_ptr(), t.data_ptr(), None, partial.data_ptr(), out.data_ptr(),
        b, x.numel() // b, T.BCE_BLOCKS, stream))
    bce_clk = read(T.BCE_BLOCKS)
    sums, cnt, loss = T._bce_dice_cuda(x, t, None)
    # the backward: one pass of 512 blocks at this size (two 16-byte groups
    # of x and t a thread)
    g = torch.tensor(1.0, device=dev)
    sn = torch.cat([sums, cnt.reshape(1)])
    grad = torch.empty_like(x)
    twice("og_bce_dice_bwd", lambda: lib.og_bce_dice_bwd(
        x.data_ptr(), t.data_ptr(), None, sn.data_ptr(), g.data_ptr(),
        grad.data_ptr(), b, x.numel() // b, stream))
    bwd_blocks = -(-x.numel() // (4 * 2 * 256))
    bwd_clk = read(bwd_blocks)
    # the TAL: drawn gts, then the first gt four times (all 40 rounds)
    tal_lines = {}
    equal_tal = True
    for what, g4 in (("m4 256²", gt), ("first gt four times",
                                       gt[:, :1].repeat(1, tm, 1)
                                       .contiguous())):
        v4 = gv if g4 is gt else gv[:, :1].repeat(1, tm).contiguous()
        best = torch.empty((tb, ta), dtype=torch.int32, device=dev)
        asg = torch.empty((tb, ta), dtype=torch.bool, device=dev)
        tsc = torch.empty((tb, ta), dtype=torch.float32, device=dev)
        twice("og_tal_assign", lambda: lib.og_tal_assign(
            cls.data_ptr(), pred.data_ptr(), g4.data_ptr(), v4.data_ptr(),
            pts.data_ptr(), best.data_ptr(), asg.data_ptr(), tsc.data_ptr(),
            tb, ta, tm, stream))
        clk, gclk = read(tb, gt_clock=True)
        equal_tal &= ts.same_bits((best, asg, tsc),
                                  T.tal_assign(cls, pred, g4, v4, pts))
        tal_lines[what] = {
            "marks": mark_groups(clk, tb),
            "gt_selection_cycles": gt_selection(clk, gclk, tb, tm),
            "assigned": int(asg.sum())}
    equal = {"unet_augment": ts.same_bits(
                 (img, msk), T.unet_augment(imgs, msks, params, noise)),
             "bce_dice": ts.same_bits(
                 (out,), (torch.cat([sums, cnt.reshape(1), loss.reshape(1)]),)),
             "bce_dice_bwd": ts.same_bits(
                 (grad,), (T._bce_dice_bwd_cuda(x, t, None, sums, cnt, g),)),
             "tal_assign": equal_tal}
    line = {"card": _smi("name,power.limit"), "sm_clock": clock,
            "occupancy": dict(zip(OCCUPANCY_FIELDS, occ)),
            "shape_augment": list(imgs.shape),
            "augment_samples_with_blur": int((params[:, 7] != 0).sum()),
            "shape_loss": list(x.shape),
            "shape_tal": {"b": tb, "a": ta, "m": tm},
            "tal_marks": "start, after each of the two barriers, end: "
                         "candidates, selection (the slowest gt), "
                         "resolve",
            "bit_equal_to_the_package_kernels": equal,
            "augment": mark_groups(aug_clk, aug_blocks, sm_split=True),
            "bce_dice": mark_groups(bce_clk, T.BCE_BLOCKS),
            "bce_dice_bwd": mark_groups(bwd_clk, bwd_blocks),
            "tal_assign": tal_lines}
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
