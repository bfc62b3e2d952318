#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # everything
    python3 chip_smoke.py --kernels-only  # build + kernel checks
    python3 chip_smoke.py --qconv         # build + og_qconv alone: its stress
        # cases, then every U-Net layer shape in turns with PR 10's kernel
        # (tools/qconv_pr10.cu), cuDNN's bf16 conv and _int_mm
    python3 chip_smoke.py --train         # build + the training phase alone
        # (the "train" line and the entries of csrc/train.cu's kernels)
    python3 chip_smoke.py --mjpg          # build + the MJPG read path alone
        # (the "mjpg" line and the two JPEG kernels' entries, in turns with
        # PR 13's, tools/jpeg_pr13.cu)
    python3 chip_smoke.py --selftest      # build + the self-tests and the
        # evaluation commands alone (the "selftest", "eval_cli" and
        # "selftest_plain" lines)
    python3 chip_smoke.py --blobs         # build + the union-find alone: the
        # occupancy line, the union-find stress (the "blob_stress" line) and
        # every launch guided-vft and vft make, held equal to the plain
        # versions; with --against DIR, those launches in turns beside both
        # pipelines' walls (the "against" line)
    python3 chip_smoke.py --against DIR [DIR ...]
        # everything, then the kernels (csrc/blobs.cu and csrc/scan.cu) of
        # this checkout and of each DIR (the root of another checkout, e.g. a
        # parent commit unpacked by ``git archive`` into a git-ignored
        # directory) timed in turns through this checkout's wrappers, this
        # checkout's motion-map launch in turns with the stage an older
        # checkout served in its place (eager absdiff and blur + og_lmap_ema),
        # and an older checkout's one-chunk og_box_count in turns with this
        # one on the served chunk

The kernels of ``openglottal_tpu_torch/csrc`` (``blobs.cu``, ``scan.cu``,
``areas.cu``, ``qconv.cu``, ``eval.cu``, ``jpeg.cu``, ``train.cu``) are
built with nvcc, one process each, all started together.

The ``selftest`` line (ROADMAP A11a): the port's end-to-end self-test
(``openglottal_tpu_torch/scripts/selftest_e2e.py``) with ``--realistic``
at its default epochs (U-Net 60 with patience 15, crop U-Net 40, YOLOv8n
20) in a temporary directory: every gate's value and pass / fail beside
the JAX package's committed artifact's value
(``results/selftest_eval_realistic_r5.json``), the stage seconds, the
epochs run, the launches of every kernel (the trainers', the evaluation's
counts, the gate, og_qconv, og_box_count must each launch), each launch
held against its plain version (of each training kernel's, one in
``TRAIN_HOLD_EVERY``), and where the int8-full and full-frame waveforms
differ from bf16's; a failed gate fails the run.  The ``eval_cli`` line:
``eval-girafe``, ``eval-bagls``, ``sweep-bagls`` and ``analyze-gaw``
through the port's command line on the self-test's ``best.pt``
checkpoints, on a tree written here (the self-test's test frames as
GIRAFE's four test patients, PNGs by ``data/png.write_png``, the split by
the port's ``prepare_girafe_splits``; BAGLS-shaped pairs of four sizes;
six Raw_Data patients, each AVI its own cut of
``tests/data/mjpg/real_256_64.avi``), each command's Dice rows, launches
and wall, every launch held against its plain version, the GIRAFE frames'
U-Net-only Dice held within ``EVAL_CARD_VS_CPU_TOL`` of the self-test's
own evaluation of them, and each ``analyze-gaw`` record equal to its
patient's clip served alone, with a finite p for every feature whose
values are not all tied.  The ``selftest_plain`` line: the self-test without
``--realistic``, beside ``results/selftest_eval_girafe.json``.

The ``train`` line (ROADMAP A9): the three training kernels of
``csrc/train.cu`` (``og_unet_augment``, ``og_bce_dice`` and its backward,
``og_tal_assign``) held against their plain versions on stress inputs
(``train_stress``) and on every launch of the fits, the f32 step and the
command line below (masks, ``best_gt`` and ``assigned`` exact, floats
within ``TRAIN_TOL``);
``UNetTrainer.fit`` at full width (bf16, batch 16, 2 epochs over 64
realistic synthetic frames, 16 for validation) and ``YoloTrainer.fit`` at
YOLOv8n width (a mosaic epoch, a close-mosaic epoch), each loss finite and
falling, both checkpoints read back by ``utils/io`` and served through
``GlottalPipelines`` (``unet-only``, then ``unet`` with both trained
models); one f32 U-Net step from ``demo_unet.npz`` on the card against the
CPU (loss, gradient norm); ``cli train-unet`` and ``train-unet-crop --mode
yolo`` on a PNG split written by ``data/png.py``; ms per train step in
turns and each kernel's ms against its bound; ``og_tal_assign``'s launch
floor (``tal_assign_vs_floor``: an empty kernel of its grid from
``tools/train_cycles.py``'s instrumented copy, timed as the kernels are).

Builds the CUDA kernels from ``openglottal_tpu_torch/csrc`` with nvcc, holds
each against its plain PyTorch version (exact equality) -- the union-find's
labelling entry points also on ``tools/blob_stress.py``'s families at the
served shapes, every width edge of its bit planes, T = 1 to 2757, single
rows and columns, 216x215 / 217x215 / 256x256 and unaligned buffers (the
``blob_stress`` line; ``occupancy`` gives each stack's form) -- then serves 502-frame
256x256 synthetic videos through ``GlottalPipelines.extract_features`` with
the demo weights — ``guided-vft``, ``unet`` and ``vft``, bfloat16 and float32
— and checks that the kernels were launched on those paths, that every
launch equals its plain version on the path's own inputs and that the
results are right; then the blob filter's two routes against each other and
the sequential tracker forms (every launch held too); then all five
pipelines (with ``crop-unet`` and ``unet-only``) on colour 256x256, gray
240x320 and colour 200x240 video through ``extract_features`` and
``run_pipeline_full`` (its ``entry_points`` line: launches held, walls,
device kernels and host syncs per video, the union-find's layout, card vs
CPU and bf16 vs f32 waveforms).  The two scans of
``csrc/scan.cu`` are also held against their plain versions on stress
sequences that reach their rare branches, from 1 to 20000 frames, and timed
bare (the C launch alone) and through their wrappers; the motion map on
random frames of every ksize class, edge and stress shapes and unaligned
buffers, and timed at vft's served inputs in every band/cluster layout (its
``motion_map`` line: bare and wrapper ms at the served T and at T = 1, the
bound, the eager absdiff-and-blur it replaces, per-phase SM cycles).  The
in-box count of ``csrc/areas.cu`` (``og_box_count``) is held against its
plain version on stress inputs (all, none and some frames valid, boxes
inside, across, at the edges of and outside the window, ragged N, bfloat16
and float32); the ``windowed`` line serves ``unet``'s windowed decoder on
502 frames of gray 256² at full width in bf16 and f32 against the
full-frame route (``ok``, per-frame area difference, bf16 vs f32, a video
whose boxes do not fit and its redo, host syncs, device kernels, walls of
the two routes in turns).  The cohort kernels — ``og_gate_scan_batch`` and
``og_thresh_chain_batch`` (K = 1 ... 64 ragged sequences of 0 to 20000
frames, from carried-in states, unaligned, resumed across three launches),
``og_box_count`` over tables of 1, 3 and 8 chunks and the union-find on
4000 frames and on the largest stack the cohort rule allows — are held
against their plain versions with the others; the ``cohort`` line serves
the three cohort entries on eight 256² videos of 502, 502, 380, 130, 129,
128, 3 and 1000 frames (two realistic) in bf16 and f32 against the
per-video calls (exact), with a video that must be redone, ``max_k = 3``
and ``fetch=False``, every recorded launch held, then walls per video at
K = 1, 2, 4, 8, 16 in turns with the per-video calls, host syncs per
sub-batch, device kernels per video, peak memory beside the K rule's
estimate and the batched kernels' times.  The ``stream`` line streams all
five pipelines through ``stream_areas`` on a 502-frame video in three
splits (bf16; f32 and colour on one ragged split), each exactly equal to
its whole-video call, every launch of the ragged streams held against its
plain version, with walls per frame in turns, host syncs per chunk, the
peak memory of a 4000-frame stream, ``prefetch`` 2 against 0, and a Y800
AVI through the port's reader and ``python -m openglottal_tpu_torch.cli run
--stream 128`` against ``extract_features``.  The int8 convolution of
``csrc/qconv.cu`` (``og_qconv``) is held exactly equal to its plain version
on every int8 layer shape of the U-Net and YOLOv8n with each epilogue (and
the edge cases of ``qconv_stress_cases``, both of the kernel's forms), its
silu_q cases also to the plain version run on the CPU; the ``quant`` line
serves ``unet`` in the int8 modes ("int8", "int8-full") on both routes, its
cohort and ``unet-only`` on the 502-frame video, calibrated on its first 64
frames, every og_qconv launch held equal to its plain version, int8 against
bf16 waveforms, windowed against full-frame, save / load, card against
CPU, host syncs, og_qconv per layer beside its bound, PR 10's kernel in
turns, cuDNN's bf16 conv and ``torch._int_mm``, the int8 U-Net stage's
device ms and walls in turns.  The count kernels of ``csrc/eval.cu``
(``og_frame_counts``, ``og_otsu_counts``) are held exactly equal to their
plain versions on stress inputs (``EVAL_SHAPES``: all-zero and all-one
frames, empty, one-pixel and edge boxes, odd frame sizes, bool and uint8
masks, unaligned buffers); the ``eval`` line runs ``eval.evaluate_patient``
over the five pipelines on a 502-frame colour video in bf16 and f32 with
its synthetic masks as the ground truth, every recorded launch held, walls
per video, host syncs, device kernels, and the card's float32 rows against
the CPU port's on 12 frames.  The MJPG decode kernels of ``csrc/jpeg.cu``
(``og_jpeg_entropy``, ``og_jpeg_idct_bgr``) are held exactly equal to their
plain versions (``data/jpeg.py``) on 64 stress streams
(``tools/jpeg_stress.py``: every sampling form, odd sizes, restart
intervals, extreme coefficients, 16-bit quantisers, no DHT), on 14
synchronisation stress streams (codes of equal lengths, restart intervals
of one MCU, segments shorter than a subsequence, 32-bit DC symbols, junk
after the last block, a frame one block short) and two broken ones, the
entropy decode with its default subsequence length and its smallest, and
4:2:x of odd height is refused; the ``mjpg`` line reads every
fixture of ``tests/data/mjpg`` on the card against the digests of cv2's
frames written beside them (the one it refuses, refused), and a
502-frame 256² MJPG clip whole and in chunks of 128 (every launch held,
every frame against its cv2 digest), serves it through ``unet`` bf16
whole, streamed and by the command line with the waveform equal to the
same frames from host memory, and times the kernels at 64 and 502 frames
in turns with PR 13's (``tools/jpeg_pr13.cu``), the read from disk to the
card (host syncs, the host parse's share) and unet after it, in turns with
the same frames as a BI_RGB 24-bit and as a Y800 AVI.  Prints
the registers and spills ptxas reports for every kernel, the thread blocks
per SM each blob entry point's launch gets, and the device kernels (by
``torch.profiler``) of each served path and of each scan wrapper's call.
Needs a CUDA device and nvcc; fails (non-zero exit, no result line) without
them.  Every phase prints one JSON line; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import math
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

T_FRAMES = 502          # one high-speed clip
N_CHUNKS = 4            # its 128-frame chunks (pipelines.CHUNK)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM, non-tensor-core rate (int32 has no
#                             row of its own in the data sheet; same order)


def say(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


BUSY_CYCLES = 20_000_000    # ~10 ms of device spinning ahead of a timed window
TIMING = "queued"           # how every kernel's ``ms`` is taken, see time_cuda


def keep_device_busy() -> None:
    """Queue ~10 ms of spinning on the current stream (the one place that
    knows how; any kernel that spins for a fixed time would do)."""
    import torch

    spin = getattr(torch.cuda, "_sleep", None)
    if spin is None:
        raise RuntimeError("chip_smoke: this torch has no torch.cuda._sleep; "
                           "keep_device_busy needs another spin kernel")
    spin(BUSY_CYCLES)


def time_cuda(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps launches, by CUDA events.

    A wrapper's host side (checks, ``torch.empty``, the ctypes call) costs
    tens of microseconds, more than a small kernel runs.  So the device is
    first kept busy for ~10 ms: the launches queue up behind that, and the
    two events then bracket back-to-back device work instead of the host's
    enqueue rate (``TIMING = "queued"``)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    keep_device_busy()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def time_host(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the host clock, each ending synchronised
    (for plain versions that loop on the host)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def ptxas_summary(log: str) -> dict:
    """{kernel: {registers, spill_stores, spill_loads, stack_bytes}} from the
    output of ``nvcc -Xptxas -v``."""
    def plain_name(sym):
        # the last component of an Itanium-mangled (nested) name, with its
        # integer template arguments (motion_map_kernel<2,6>)
        if not sym.startswith("_Z"):
            return sym
        pos, parts = (3 if sym.startswith("_ZN") else 2), []
        while pos < len(sym) and sym[pos].isdigit():
            n = re.match(r"\d+", sym[pos:]).group()
            pos += len(n)
            parts.append(sym[pos:pos + int(n)])
            pos += int(n)
        if not parts:
            return sym
        targs = re.match(r"I((?:Lin?\d+E)+)E", sym[pos:])
        if targs:
            vals = [("-" if v.startswith("n") else "") + v.lstrip("n")
                    for v in re.findall(r"Li(n?\d+)E", targs.group(1))]
            return f"{parts[-1]}<{','.join(vals)}>"
        return parts[-1]

    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = out.setdefault(plain_name(m.group(1)), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn is not None:
            fn.update(stack_bytes=int(m[1]), spill_stores=int(m[2]),
                      spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            fn["registers"] = int(m[1])
    return out


# ── og_qconv's stress cases ─────────────────────────────────────────────
# every int8 layer shape of the U-Net (32-64-128-256-512, 256² frames, the
# windowed decoder's valid convolutions) and of YOLOv8n (n scale, 256²
# input), at two frames: (label, H, W, sources' channels, C_out, k, stride,
# pad, epilogue, residual); a decoder concat takes two sources (K split
# over two pointers)
QCONV_UNET = (
    ("enc0.1", 256, 256, (32,), 32), ("enc1.0", 128, 128, (32,), 64),
    ("enc1.1", 128, 128, (64,), 64), ("enc2.0", 64, 64, (64,), 128),
    ("enc2.1", 64, 64, (128,), 128), ("enc3.0", 32, 32, (128,), 256),
    ("enc3.1", 32, 32, (256,), 256), ("bneck.0", 16, 16, (256,), 512),
    ("bneck.1", 16, 16, (512,), 512), ("dec0.0", 32, 32, (256, 256), 256),
    ("dec0.1", 32, 32, (256,), 256), ("dec1.0", 64, 64, (128, 128), 128),
    ("dec1.1", 64, 64, (128,), 128), ("dec2.0", 128, 128, (64, 64), 64),
    ("dec2.1", 128, 128, (64,), 64), ("dec3.0", 256, 256, (32, 32), 32),
    ("dec3.1", 256, 256, (32,), 32))
QCONV_UNET_WINDOW = (
    ("dec2.0 window", 86, 86, (64, 64), 64), ("dec2.1 window", 84, 84, (64,), 64),
    ("dec3.0 window", 164, 164, (32, 32), 32),
    ("dec3.1 window", 162, 162, (32,), 32))
QCONV_YOLO = (
    # (label, H, W, sources, C_out, k, stride, residual)
    ("cbs1", 128, 128, (16,), 32, 3, 2, False),
    ("c2f0.cv1", 64, 64, (32,), 32, 1, 1, False),
    ("c2f0.m0.cv1", 64, 64, (16,), 16, 3, 1, False),
    ("c2f0.m0.cv2", 64, 64, (16,), 16, 3, 1, True),
    ("c2f0.cv2", 64, 64, (32, 16), 32, 1, 1, False),
    ("cbs2", 64, 64, (32,), 64, 3, 2, False),
    ("c2f1.m.cv2", 32, 32, (32,), 32, 3, 1, True),
    ("c2f1.cv2", 32, 32, (128,), 64, 1, 1, False),
    ("cbs3", 32, 32, (64,), 128, 3, 2, False),
    ("c2f2.cv2", 16, 16, (256,), 128, 1, 1, False),
    ("cbs4", 16, 16, (128,), 256, 3, 2, False),
    ("c2f3.m0.cv2", 8, 8, (128,), 128, 3, 1, True),
    ("c2f3.cv2", 8, 8, (256, 128), 256, 1, 1, False),
    ("sppf.cv1", 8, 8, (256,), 128, 1, 1, False),
    ("sppf.cv2", 8, 8, (512,), 256, 1, 1, False),
    ("c2f4.cv1", 16, 16, (384,), 128, 1, 1, False),
    ("c2f4.cv2", 16, 16, (128, 64), 128, 1, 1, False),
    ("c2f5.cv1", 32, 32, (192,), 64, 1, 1, False),
    ("c2f5.m0.cv1", 32, 32, (32,), 32, 3, 1, False),
    ("cbs5", 32, 32, (64,), 64, 3, 2, False),
    ("c2f6.cv1", 16, 16, (192,), 128, 1, 1, False),
    ("cbs6", 16, 16, (128,), 128, 3, 2, False),
    ("c2f7.cv1", 8, 8, (384,), 256, 1, 1, False),
    ("box0_0", 32, 32, (64,), 64, 3, 1, False),
    ("box2_0", 8, 8, (256,), 64, 3, 1, False),
    ("cls1_0", 16, 16, (128,), 64, 3, 1, False))
QCONV_YOLO_HEAD = (("box0_2", 32, 32, (64,), 64), ("cls0_2", 32, 32, (64,), 1),
                   ("box2_2", 8, 8, (64,), 64), ("cls2_2", 8, 8, (64,), 1))


def qconv_stress_cases(dev, seed: int = 0, frames: int = 2):
    """(label, x, w8, sw, b, keyword arguments) of og_qconv's stress cases on
    device ``dev``: every layer shape above with random int8 data, each
    epilogue, pad 0 / 1, stride 1 / 2, C_in 16, C_out 1, two sources along K
    (the second a channel slice of a wider tensor), windows cut at odd
    origins (strided views), a ragged M, saturated inputs (the largest
    accumulators) and every scale drawn so that outputs clip both ways."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def i8(*shape, lo=-127, hi=128):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int8)
                                ).to(dev)

    def layer(cin, cout, k):
        w8 = i8(cout, k, k, cin)
        sw = torch.from_numpy(rng.uniform(1e-4, 3e-3, cout).astype(np.float32))
        b = torch.from_numpy(rng.normal(0, 0.5, cout).astype(np.float32))
        return w8, sw.to(dev), b.to(dev)

    def scales(cin, k):
        # the s32 sums reach ~ 40 sqrt(K) * 127; pick sx so that y spans a
        # few units, and s_next so that some outputs clip at +-127
        sx = float(rng.uniform(0.5, 2.0)) / (40.0 * math.sqrt(k * k * cin))
        return sx, float(rng.uniform(0.5, 2.0)) / 127.0 * 2.0

    cases = []
    for label, h, w, srcs, cout in QCONV_UNET:
        xs = tuple(i8(frames, h, w, c, lo=0) for c in srcs)   # ReLU'd inputs
        sx, sn = scales(sum(srcs), 3)
        cases.append((label, xs if len(xs) > 1 else xs[0],
                      *layer(sum(srcs), cout, 3),
                      dict(sx=sx, pad=1, epilogue="relu_q", s_next=sn)))
    for label, h, w, srcs, cout in QCONV_UNET_WINDOW:
        # a window cut at an odd origin out of a larger frame (a view)
        xs = tuple(i8(frames, h + 9, w + 7, c, lo=0)[:, 5:5 + h, 3:3 + w]
                   for c in srcs)
        sx, sn = scales(sum(srcs), 3)
        cases.append((label, xs if len(xs) > 1 else xs[0],
                      *layer(sum(srcs), cout, 3),
                      dict(sx=sx, pad=0, epilogue="relu_q", s_next=sn)))
    for label, h, w, srcs, cout, k, stride, res in QCONV_YOLO:
        if len(srcs) == 2:
            # the second source a channel slice of a wider tensor
            wide = i8(frames, h, w, 2 * srcs[1])
            xs = (i8(frames, h, w, srcs[0]), wide[..., srcs[1]:])
        else:
            xs = (i8(frames, h, w, srcs[0]),)
        sx, sn = scales(sum(srcs), k)
        kw = dict(sx=sx, stride=stride, pad=k // 2, epilogue="silu_q",
                  s_next=sn)
        if res:
            ho = out_size_(h, k, stride, k // 2)
            kw.update(residual=i8(frames, ho, ho, 2 * cout)[..., cout:],
                      s_res=float(rng.uniform(0.005, 0.05)))
        cases.append((label, xs if len(xs) > 1 else xs[0],
                      *layer(sum(srcs), cout, k), kw))
    for label, h, w, srcs, cout in QCONV_YOLO_HEAD:
        sx, _ = scales(srcs[0], 1)
        cases.append((label, i8(frames, h, w, srcs[0]),
                      *layer(srcs[0], cout, 1),
                      dict(sx=sx, pad=0, epilogue="f32")))
    # ragged M (3 frames of 9x11, not a multiple of the 128-pixel tile),
    # every epilogue, stride 2, C_out 1 and 17 (partial column tiles)
    for epi in ("relu_q", "silu_q", "f32"):
        for cout, stride in ((1, 1), (17, 2), (80, 1)):
            sx, sn = scales(48, 3)
            cases.append((f"ragged {epi} cout={cout} s={stride}",
                          i8(3, 9, 11, 48), *layer(48, cout, 3),
                          dict(sx=sx, stride=stride, pad=1, epilogue=epi,
                               s_next=None if epi == "f32" else sn)))
    # saturated: every input and weight at +-127, K = 9 * 512 (the largest
    # sums the served layers make, ~7.4e7 > 2**24: the f32 cast rounds)
    x = torch.full((1, 16, 16, 512), 127, dtype=torch.int8, device=dev)
    w8, sw, b = layer(512, 64, 3)
    w8 = torch.where(w8 >= 0, 127, -127).to(torch.int8)
    w8[:8] = 127
    for epi in ("relu_q", "f32"):
        cases.append((f"saturated {epi}", x, w8, sw, b,
                      dict(sx=1e-6, pad=1, epilogue=epi,
                           s_next=None if epi == "f32" else 0.5)))
    cases.extend(qconv_tiling_cases(dev, rng, i8, layer, scales))
    return cases


def qconv_tiling_cases(dev, rng, i8, layer, scales) -> list:
    """The stress cases of og_qconv's tiling (128 output pixels by the whole
    of C_out up to 256, C_out 512 as two column tiles, 128 bytes of K a
    stage): M tails of 1 to 127 rows past a 128-row tile at C_out 256 and
    512; two K sources with c0 = 32 and with c0 != c1 under a 3x3 window;
    C_in 16 and 48 under a 3x3 stride-2 window; a source whose pixels are
    48 bytes apart (16-byte, not 128-byte aligned); the f32 head at C_out 1
    and 17; the largest sums of both signs over two column tiles."""
    import torch

    cases = []
    # (frames, H, W): M = frames * H * W = 128 q + tail
    for (fr, h, w), cout in (((1, 1, 129), 256), ((1, 1, 191), 512),
                             ((1, 1, 192), 256), ((1, 1, 193), 512),
                             ((1, 1, 255), 256), ((3, 5, 9), 512),
                             ((2, 9, 15), 256), ((1, 1, 1), 512)):
        sx, sn = scales(64, 3)
        cases.append((f"M tail {fr * h * w % 128} of {fr * h * w} cout={cout}",
                      i8(fr, h, w, 64, lo=0), *layer(64, cout, 3),
                      dict(sx=sx, pad=1, epilogue="relu_q", s_next=sn)))
    for c0, c1, cout in ((32, 32, 32), (48, 16, 64)):
        wide = i8(2, 40, 36, c0 + c1 + 16, lo=0)
        xs = (i8(2, 40, 36, c0, lo=0), wide[..., 16:16 + c1])
        sx, sn = scales(c0 + c1, 3)
        cases.append((f"two sources {c0}+{c1} 3x3", xs,
                      *layer(c0 + c1, cout, 3),
                      dict(sx=sx, pad=1, epilogue="relu_q", s_next=sn)))
    for cin, epi in ((16, "silu_q"), (48, "relu_q"), (48, "silu_q")):
        sx, sn = scales(cin, 3)
        cases.append((f"C_in {cin} 3x3 s2 {epi}", i8(2, 37, 30, cin),
                      *layer(cin, 32, 3),
                      dict(sx=sx, stride=2, pad=1, epilogue=epi, s_next=sn)))
    # pixels 48 bytes apart: a 32-channel slice of a 48-channel tensor,
    # cut as a window at an odd origin
    wide = i8(2, 50, 44, 48, lo=0)
    sx, sn = scales(32, 3)
    cases.append(("48-byte pixel stride window", wide[:, 3:43, 5:41, 16:],
                  *layer(32, 64, 3),
                  dict(sx=sx, pad=0, epilogue="relu_q", s_next=sn)))
    for cout in (1, 17):
        sx, _ = scales(64, 1)
        cases.append((f"f32 head cout={cout}", i8(2, 32, 32, 64),
                      *layer(64, cout, 1), dict(sx=sx, pad=0, epilogue="f32")))
    # the halo form (stride 1, rows of 64 or 128 output pixels): two
    # sources whose k32 step spans both (48 + 16 channels), a window view
    # whose pixels are 48 bytes apart, pad 0, C_out 128 (two blocks a
    # tile), 17 and the f32 head at C_out 1, a 1x1 layer, an odd count of
    # 64-pixel rows, a row of 130 pixels (a tile past its end)
    wide = i8(2, 64, 128, 64, lo=0)
    sx, sn = scales(64, 3)
    cases.append(("halo two sources 48+16", (wide[..., :48], i8(2, 64, 128,
                                                                16, lo=0)),
                  *layer(64, 64, 3),
                  dict(sx=sx, pad=1, epilogue="relu_q", s_next=sn)))
    wide = i8(2, 70, 136, 48, lo=0)
    sx, sn = scales(32, 3)
    cases.append(("halo 48-byte pixel stride window",
                  wide[:, 3:67, 5:133, 16:], *layer(32, 32, 3),
                  dict(sx=sx, pad=1, epilogue="relu_q", s_next=sn)))
    cases.append(("halo pad 0", wide[:, 2:68, 3:133, :32], *layer(32, 64, 3),
                  dict(sx=sx, pad=0, epilogue="relu_q", s_next=sn)))
    for cout, epi in ((128, "relu_q"), (17, "silu_q"), (1, "f32")):
        sx, sn = scales(32, 3)
        cases.append((f"halo cout={cout} {epi}", i8(2, 64, 64, 32, lo=0),
                      *layer(32, cout, 3),
                      dict(sx=sx, pad=1, epilogue=epi,
                           s_next=None if epi == "f32" else sn)))
    sx, sn = scales(64, 1)
    cases.append(("halo 1x1", i8(2, 32, 128, 64), *layer(64, 64, 1),
                  dict(sx=sx, pad=0, epilogue="silu_q", s_next=sn)))
    for (h, w), cout in (((63, 64), 32), ((5, 130), 64), ((3, 30), 128)):
        sx, sn = scales(32, 3)
        cases.append((f"halo {h}x{w} cout={cout}", i8(3, h, w, 32, lo=0),
                      *layer(32, cout, 3),
                      dict(sx=sx, pad=1, epilogue="relu_q", s_next=sn)))
    # the largest sums of both signs: +-127 inputs and weights, K = 9 * 512,
    # C_out 512 (two column tiles); rows of w = +-127 everywhere
    x = torch.full((1, 16, 16, 512), 127, dtype=torch.int8, device=dev)
    w8, sw, b = layer(512, 512, 3)
    w8 = torch.where(w8 >= 0, 127, -127).to(torch.int8)
    w8[:8], w8[300:308] = 127, -127
    for epi in ("relu_q", "f32"):
        cases.append((f"largest |sum| cout=512 {epi}", x, w8, sw, b,
                      dict(sx=1e-6, pad=1, epilogue=epi,
                           s_next=None if epi == "f32" else 0.5)))
    return cases


def out_size_(h: int, k: int, stride: int, pad: int) -> int:
    return (h + 2 * pad - k) // stride + 1


# the entry points' inputs: (a) colour 256², (b) gray 240x320 (not square,
# not 256²), (c) a short colour clip smaller than 256 on its long side
ENTRY_INPUTS = (("colour_256x256", T_FRAMES), ("gray_240x320", T_FRAMES),
                ("colour_200x240", 64))


def tint(frames):
    """A colour video from a gray one: the three channels made unequal."""
    import numpy as np

    f = frames.astype(np.int16)
    f[..., 0] = f[..., 0] * 7 // 8
    f[..., 2] = np.minimum(f[..., 2] + 12, 255)
    return f.astype(np.uint8)


def entry_video(kind: str, seed: int, t: int):
    """One of the ENTRY_INPUTS videos, cut from ``synthetic_video``: (t,
    256, 256, 3) colour, (t, 240, 320) gray or (t, 200, 240, 3) colour."""
    import numpy as np

    from openglottal_tpu_torch.data.synthetic import synthetic_video

    if kind == "colour_256x256":
        return tint(synthetic_video(t=t, size=256, seed=seed)[0])
    if kind == "gray_240x320":
        f = synthetic_video(t=t, size=320, seed=seed, center=(160.0, 160.0))[0]
        return np.ascontiguousarray(f[:, 40:280, :, 0])
    f = synthetic_video(t=t, size=240, seed=seed, center=(120.0, 120.0))[0]
    return tint(np.ascontiguousarray(f[:, 20:220]))


def entry_points(pipes, cpu_pipe, counted, expect_counts, check_features,
                 hold_record, host_syncs, device_kernels, layout_of) -> dict:
    """All five pipelines on each ENTRY_INPUTS video through
    ``extract_features`` (bf16): the launches of each run counted (from 0)
    and held equal to their plain versions, the features checked (f0 of the
    synthetic glottis), walls over two distinct videos, device kernels and
    host syncs per video, the union-find layout of each blob launch; then
    ``run_pipeline_full`` (shapes, masks against areas, areas equal to
    ``extract_features``'); 12-frame float32 waveforms on the card against
    the CPU, and bf16 against float32 for the U-Net pipelines.  Raises on
    any failed check; returns the phase's line."""
    import numpy as np
    import torch

    from openglottal_tpu_torch.ops import blobs_cuda
    from openglottal_tpu_torch.pipelines import PIPELINES

    bf16, f32 = pipes["bf16"], pipes["f32"]
    expected = {
        "vft": {"gate_scan": 1, "cc": 2, "motion_map": 2, "cc_batch": 4,
                "min_prop_batch": 8, "thresh_chain": 1},
        "guided-vft": {"gate_scan": 1, "thresh_chain": 1, "dual_cc_batch": 1,
                       "dual_min_prop_batch": 1, "min_prop_batch": 2},
        "crop-unet": {"gate_scan": 1}, "unet-only": {}}
    line = {k: {} for k in ("inputs", "launches", "features",
                            "wall_ms_per_video", "n_device_kernels_per_video",
                            "host_syncs_per_video", "host_sync_sites",
                            "union_find_layouts")}
    line["launches_held"] = 0
    waves, first = {}, {}
    for kind, t in ENTRY_INPUTS:
        vids = [entry_video(kind, s, t) for s in (0, 1)]
        first[kind] = vids[0]
        line["inputs"][kind] = list(vids[0].shape)
        for pipeline in PIPELINES:
            key = f"{kind}:{pipeline}/bf16"
            bf16.extract_features(vids[1], pipeline)          # warm-up
            record = []
            feats, got = counted(
                lambda: bf16.extract_features(vids[0], pipeline), record)
            # unet (the full-frame route on these inputs): the gate carried
            # across the 128-frame chunks and one in-box count per chunk
            n_chunks = -(-t // 128)
            want = expected.get(pipeline, {"gate_scan": n_chunks,
                                           "box_count": n_chunks})
            expect_counts(key, got, {k: want.get(k, 0) for k in got})
            line["launches"][key] = got
            line["features"][key] = check_features(key, feats, frames=t)
            waves[(kind, pipeline)] = feats["_area"]
            hold_record(key, record)
            line["launches_held"] += len(record)
            shapes = sorted({tuple(inp[0].shape[-2:]) for name, inp, _ in record
                             if name in blobs_cuda.LAUNCHES})
            line["union_find_layouts"][key] = {
                f"{h}x{w}": {**layout_of(h, w), "grids": (
                    "shared memory" if layout_of(h, w)["smem_bytes"] > 0
                    else "device memory")} for h, w in shapes}
            ms = []
            for v in vids:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                bf16.extract_features(v, pipeline)
                ms.append((time.perf_counter() - t0) * 1e3)
            line["wall_ms_per_video"][key] = ms
            line["n_device_kernels_per_video"][key] = sum(device_kernels(
                lambda: bf16.extract_features(vids[0], pipeline)).values())
            (line["host_syncs_per_video"][key],
             line["host_sync_sites"][key]) = host_syncs(
                lambda: bf16.extract_features(vids[0], pipeline))
            masks, valid, boxes, areas = bf16.run_pipeline_full(vids[0],
                                                                pipeline)
            a = areas.cpu().numpy()
            if (masks.shape != (t, *vids[0].shape[1:3])
                    or masks.dtype != torch.bool or a.shape != (t,)):
                raise AssertionError(f"{key}: run_pipeline_full shapes "
                                     f"{tuple(masks.shape)} {a.shape}")
            if (valid is None) != (pipeline == "unet-only"):
                raise AssertionError(f"{key}: run_pipeline_full gate outputs")
            if pipeline in ("unet-only", "crop-unet", "guided-vft") and not \
                    np.array_equal(a, masks.sum((1, 2)).float().cpu().numpy()):
                raise AssertionError(f"{key}: areas are not the masks' counts")
            if not np.array_equal(a, feats["_area"]):
                raise AssertionError(f"{key}: run_pipeline_full areas differ "
                                     f"from extract_features'")
    # 12 frames, float32: the card (CUDA kernels) against the CPU (plain
    # versions), and bf16 against float32 for the U-Net pipelines
    card_vs_cpu, bf16_vs_f32 = {}, {}
    for kind in ("colour_256x256", "gray_240x320"):
        small = first[kind][:12]
        for pipeline in PIPELINES:
            a = cpu_pipe.extract_features(small, pipeline)["_area"]
            b = f32.extract_features(small, pipeline)["_area"]
            rel = float(np.abs(a - b).sum() / max(a.sum(), 1.0))
            card_vs_cpu[f"{kind}:{pipeline}"] = rel
            if rel >= 0.05:
                raise AssertionError(f"{kind}:{pipeline}: card vs CPU "
                                     f"relative L1 {rel} on 12 frames")
        for pipeline in ("unet-only", "crop-unet"):
            w32 = f32.extract_features(first[kind], pipeline)["_area"]
            rel = float(np.abs(waves[(kind, pipeline)] - w32).sum()
                        / w32.sum())
            bf16_vs_f32[f"{kind}:{pipeline}"] = rel
            if rel >= 0.05:
                raise AssertionError(f"{kind}:{pipeline}: bf16 vs f32 "
                                     f"relative L1 {rel}")
    line["card_vs_cpu_rel_l1_12_frames_f32"] = card_vs_cpu
    line["bf16_vs_f32_rel_l1"] = bf16_vs_f32
    line["compared"] = ("every recorded launch exactly equal to its plain "
                        "version; run_pipeline_full areas equal to "
                        "extract_features'")
    return line


def windowed_phase(pipes, weights, videos, counted, expect_counts,
                   hold_record, host_syncs, device_kernels) -> dict:
    """Pipeline 3's windowed decoder on 502 frames of gray 256² at full
    width (the main path's videos: ``synthetic_video(realistic=False)``,
    channel 0), bf16 and float32, against ``window_decoder=False`` on the
    same card: ``ok``; per-frame areas (f32: within 2.0 px, the JAX
    package's pin between the routes); bf16 against f32 (relative L1 <
    0.05); the launches of both routes counted and held equal to their
    plain versions; a video whose boxes move too far within a chunk (its
    frames from 64 on shifted up by 60 rows), whose ``ok`` must be False
    and whose redo must equal the full-frame route exactly; host syncs and
    device kernels per video; walls of the two routes in turns over three
    distinct videos.  Raises on any failed check; returns the phase's
    line."""
    import numpy as np
    import torch

    from openglottal_tpu_torch.models.unet import chunk_window_origin
    from openglottal_tpu_torch.pipelines import CHUNK, WIN, GlottalPipelines

    routes = {tag: {"windowed": pipe,
                    "full": GlottalPipelines(dtype=pipe.dtype,
                                             window_decoder=False, **weights)}
              for tag, pipe in pipes.items()}
    v = videos[0]
    line = {"video": "synthetic_video(t=502, size=256, seed=0, "
                     "realistic=False), channel 0",
            "window": WIN, "launches": {}, "launches_held": 0}
    areas = {}
    for tag, r in routes.items():
        if not r["windowed"].window_decoder:
            raise AssertionError(f"{tag}: window_decoder=None did not turn "
                                 f"the windowed decoder on")
        for route, pipe in r.items():
            pipe.extract_features(videos[1], "unet")           # warm-up

            def run(pipe=pipe):
                pending = pipe.yolo_unet_areas_deferred(v)
                return pipe.yolo_unet_areas_resolve(pending), pending[1]

            record = []
            (a, ok), got = counted(run, record)
            expect_counts(f"windowed phase {route}/{tag}", got,
                          {k: (N_CHUNKS if k in ("gate_scan", "box_count")
                               else 0) for k in got})
            hold_record(f"windowed {route}/{tag}", record)
            line["launches_held"] += len(record)
            line["launches"][f"{route}/{tag}"] = got
            if route == "windowed":
                if ok is None or not bool(ok):
                    raise AssertionError(f"{tag}: the windowed decoder did "
                                         f"not fit the served video")
                line[f"ok_{tag}"] = True
            areas[(route, tag)] = a
    gray = routes["bf16"]["windowed"]._to_gray(v)
    valid, boxes = routes["bf16"]["windowed"]._gated(None, gray)
    line["chunk_windows_oy_ox_fits"] = [
        [int(o[1]), int(o[2]), bool(o[0])] for o in (
            chunk_window_origin(boxes[i:i + CHUNK], valid[i:i + CHUNK], 256,
                                256, WIN, lattice=4, margin=6)
            for i in range(0, T_FRAMES, CHUNK))]
    diff = np.abs(areas[("windowed", "f32")] - areas[("full", "f32")])
    line["f32_windowed_vs_full_max_abs_px"] = float(diff.max())
    line["f32_frames_differing"] = int((diff > 0).sum())
    if diff.max() > 2.0:
        raise AssertionError(f"windowed vs full-frame areas differ by "
                             f"{diff.max()} px (limit 2.0)")
    for route in ("windowed", "full"):
        w32 = areas[(route, "f32")]
        rel = float(np.abs(areas[(route, "bf16")] - w32).sum() / w32.sum())
        line[f"bf16_vs_f32_rel_l1_{route}"] = rel
        if rel >= 0.05:
            raise AssertionError(f"{route}: bf16 vs f32 relative L1 {rel}")
    line["bf16_windowed_vs_full_max_abs_px"] = float(np.abs(
        areas[("windowed", "bf16")] - areas[("full", "bf16")]).max())

    # a video that does not fit: ok False, and the redo is the full route
    moved = v.copy()
    moved[64:] = np.roll(v[64:], -60, axis=1)
    forced = {}
    for tag, r in routes.items():
        pending = r["windowed"].yolo_unet_areas_deferred(moved)
        if pending[1] is None or bool(pending[1]):
            raise AssertionError(f"{tag}: the moved video fitted the window")
        redo = r["windowed"].yolo_unet_areas_resolve(pending)
        want = r["full"].extract_features(moved, "unet")["_area"]
        if not np.array_equal(redo, want):
            raise AssertionError(f"{tag}: the redo differs from the "
                                 f"full-frame route")
        forced[tag] = {"ok": False, "redo_equals_full_route": True}
    line["forced_non_fitting_video"] = {
        "video": "frames 64.. shifted up by 60 rows", **forced}

    bf16 = routes["bf16"]
    line["host_syncs_per_video"], line["host_sync_sites"] = {}, {}
    line["n_device_kernels_per_video"] = {}
    for route, pipe in bf16.items():
        n, sites = host_syncs(lambda: pipe.extract_features(v, "unet"))
        line["host_syncs_per_video"][route] = n
        line["host_sync_sites"][route] = sites
        line["n_device_kernels_per_video"][route] = sum(device_kernels(
            lambda: pipe.extract_features(v, "unet")).values())
    if line["host_syncs_per_video"]["windowed"] != 2:
        raise AssertionError(f"windowed route: "
                             f"{line['host_syncs_per_video']['windowed']} "
                             f"host syncs per video, expected 2")
    # walls in turns: windowed, full, full, windowed, ... over 3 videos
    walls = {f"{route}/{tag}": [] for tag in routes for route in routes[tag]}
    for tag, r in routes.items():
        order = ["windowed", "full", "full", "windowed", "windowed", "full"]
        for k, route in enumerate(order):
            vid = videos[1 + k // 2]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r[route].extract_features(vid, "unet")
            walls[f"{route}/{tag}"].append((time.perf_counter() - t0) * 1e3)
    line["wall_ms_per_video_in_turns"] = walls
    line["turn_order"] = "per dtype: windowed, full, full, windowed, " \
                         "windowed, full (videos 1, 1, 2, 2, 3, 3)"
    return line


INT8_OPS_PER_S = 1979e12    # H100 SXM data sheet, dense int8 tensor cores
QUANT_COHORT = (502, 380, 128, 3)


def rel_l1(a, b) -> float:
    """sum |a - b| / sum |b| of two waveforms."""
    import numpy as np

    return float(np.abs(a - b).sum() / max(float(np.abs(b).sum()), 1.0))


def qconv_runner(inputs, kw):
    """(kernel fn, plain fn, bytes moved, operations) of one recorded
    og_qconv launch: the sources, weights, scales and residual read once,
    the output written once; two operations per MAC."""
    import math as _m

    from openglottal_tpu_torch.ops import qconv_cuda

    xs, w8, sw, b, res = inputs
    x = xs if len(xs) > 1 else xs[0]
    n, h, w = xs[0].shape[:3]
    cout, kh, kw_, cin = w8.shape
    ho = qconv_cuda.out_size(h, kh, kw["stride"], kw["pad"])
    wo = qconv_cuda.out_size(w, kw_, kw["stride"], kw["pad"])
    out_elem = 4 if kw["epilogue"] == "f32" else 1
    nbytes = (sum(_m.prod(s.shape) for s in xs) + w8.numel() + 8 * cout
              + n * ho * wo * cout * (out_elem + (res is not None)))
    ops = 2 * n * ho * wo * cout * kh * kw_ * cin
    return (lambda: qconv_cuda.qconv(x, w8, sw, b, **kw, residual=res),
            lambda: qconv_cuda.qconv_plain(x, w8, sw, b, **kw, residual=res),
            nbytes, ops)


def qconv_stress(dev, hold) -> tuple:
    """og_qconv on every stress case (``qconv_stress_cases``) against its
    plain version, int8 bytes and float32 bits (``hold(name, got, want)``
    raises on a difference); the silu_q cases also against the plain
    version run on the CPU (the SiLU's exp is written out, so the bytes are
    the same there).  Returns (labels, labels of the silu_q cases)."""
    import torch

    from openglottal_tpu_torch.ops import qconv_cuda

    def cpu(t):
        return None if t is None else (
            tuple(s.cpu() for s in t) if isinstance(t, tuple) else t.cpu())

    labels, silu = [], []
    for label, x, w8, sw, b, kw in qconv_stress_cases(dev):
        got = qconv_cuda.qconv(x, w8, sw, b, **kw)
        want = qconv_cuda.qconv_plain(x, w8, sw, b, **kw)
        if got.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        hold("qconv", got, want)
        if kw["epilogue"] == "silu_q":
            on_cpu = qconv_cuda.qconv_plain(
                cpu(x), w8.cpu(), sw.cpu(), b.cpu(),
                **{k: cpu(v) if k == "residual" else v
                   for k, v in kw.items()})
            if not torch.equal(got.cpu(), on_cpu):
                raise AssertionError(f"qconv {label}: the kernel's silu_q "
                                     f"bytes differ from the plain version "
                                     f"on the CPU")
            silu.append(label)
        labels.append(label)
    return labels, silu


@contextlib.contextmanager
def qconv_library(lib):
    """Routes ops/qconv_cuda's launches through another build of the kernel
    (PR 10's first form, tools/qconv_pr10.cu: the same C interface and
    Args) for a timing in turns; the served paths never load it."""
    from openglottal_tpu_torch.ops import qconv_cuda

    own = qconv_cuda._lib
    qconv_cuda._lib = lambda: lib
    try:
        yield
    finally:
        qconv_cuda._lib = own


def pr10_qconv_library():
    """tools/qconv_pr10.cu built like the package's sources (its own
    library, loaded beside csrc/qconv.cu's) -> (library, ptxas summary)."""
    from openglottal_tpu_torch.ops import _build

    lib, log = _build.build_others(
        {"qconv_pr10": Path("openglottal_tpu_torch/tools/qconv_pr10.cu")},
        ("-Xptxas", "-v"))["qconv_pr10"]
    lib.og_qconv.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.og_qconv.restype = ctypes.c_int
    return lib, ptxas_summary(log)


def pr13_jpeg_library():
    """tools/jpeg_pr13.cu (PR 13's two JPEG kernels, their C interface)
    built like the package's sources, loaded beside csrc/jpeg.cu's ->
    (library, ptxas summary)."""
    from openglottal_tpu_torch.ops import _build

    lib, log = _build.build_others(
        {"jpeg_pr13": Path("openglottal_tpu_torch/tools/jpeg_pr13.cu")},
        ("-Xptxas", "-v"))["jpeg_pr13"]
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.og_jpeg_entropy.argtypes = [p, p, i] + [p] * 6 + [i] * 7 + [p]
    lib.og_jpeg_idct_bgr.argtypes = [p, p, p] + [i] * 10 + [p]
    lib.og_jpeg_entropy.restype = lib.og_jpeg_idct_bgr.restype = ctypes.c_int
    return lib, ptxas_summary(log)


def pr13_entropy(lib, dp):
    """PR 13's og_jpeg_entropy on a packed chunk on the card (the wrapper's
    outputs: coefficients, error flags)."""
    import torch

    from openglottal_tpu_torch.ops import _build, jpeg_cuda

    geo = dp.geo
    coef = torch.empty((dp.t, geo.nblk, 64), dtype=torch.int16,
                       device=dp.device)
    err = torch.zeros((dp.t,), dtype=torch.int32, device=dp.device)
    ncomp, mcux, mcuy, hs0, vs0 = jpeg_cuda._layout(geo)
    _build.check(lib.og_jpeg_entropy(
        dp.data.data_ptr(), dp.segs.data_ptr(), dp.segs.shape[0],
        dp.tables.data_ptr(), dp.slots.data_ptr(), dp.comp.data_ptr(),
        dp.quant.data_ptr(), coef.data_ptr(), err.data_ptr(), ncomp, mcux,
        mcux * mcuy, hs0, vs0, geo.nblk, dp.slots.shape[1],
        torch.cuda.current_stream().cuda_stream), "jpeg_entropy (PR 13)")
    return coef, err


def pr13_idct(lib, coef, dp):
    """PR 13's og_jpeg_idct_bgr (the wrapper's output)."""
    import torch

    from openglottal_tpu_torch.data import jpeg
    from openglottal_tpu_torch.ops import _build, jpeg_cuda

    geo = dp.geo
    form = jpeg.colour_form(geo)
    out = torch.empty((dp.t, geo.h, geo.w) + (() if form == jpeg.FORM_GRAY
                                              else (3,)),
                      dtype=torch.uint8, device=dp.device)
    ncomp, mcux, mcuy, hs0, vs0 = jpeg_cuda._layout(geo)
    _build.check(lib.og_jpeg_idct_bgr(
        coef.data_ptr(), dp.quant.data_ptr(), out.data_ptr(), dp.t, geo.h,
        geo.w, ncomp, mcux, mcuy, hs0, vs0, geo.nblk, form,
        torch.cuda.current_stream().cuda_stream), "jpeg_idct_bgr (PR 13)")
    return out


def mjpg_bounds(p, coef) -> dict:
    """{kernel: (bound ms, "bytes" | "operations")} of a packed chunk and
    its coefficients (on the card).  Bytes: the packed chunk, the
    coefficients, the flags and the pixels, each once.  Operations: ~8 a
    symbol (a non-zero coefficient, and an EOB a block: lookup, shift,
    extend); the IDCT's 16 passes of 8 points a block (~64 multiply-adds
    each) and ~12 a pixel for the colour."""
    geo = p.geo
    coef_bytes = coef.numel() * 2
    out_bytes = p.t * geo.h * geo.w * (1 if geo.ncomp == 1 else 3)
    symbols = int((coef != 0).sum()) + geo.nblk * p.t
    work = {"jpeg_entropy": (p.nbytes + coef_bytes + 4 * p.t, 8 * symbols),
            "jpeg_idct_bgr": (coef_bytes + p.quant.nbytes + out_bytes,
                              p.t * geo.nblk * 16 * 64 * 2
                              + 12 * out_bytes // 3 * 2)}
    out = {}
    for name, (nbytes, ops) in work.items():
        t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        out[name] = (max(t_b, t_o), "bytes" if t_b >= t_o else "operations")
    return out


def mjpg_turns(dev, hold, chunks, pr13) -> dict:
    """Both JPEG kernels and PR 13's (tools/jpeg_pr13.cu) on the same packed
    chunks, in turns in one process (PR 13's, this one's, this one's, PR
    13's; each a time_cuda of 20 queued launches, TIMING), their outputs
    held equal first; per chunk and kernel the ms of both forms, the bound
    and both ratios."""
    from openglottal_tpu_torch.ops import jpeg_cuda

    lib, _ = pr13
    out = {}
    for p in chunks:
        dp = jpeg_cuda.upload(p, dev)
        coef, err = jpeg_cuda.entropy_decode(dp)
        old_coef, old_err = pr13_entropy(lib, dp)
        hold("jpeg_entropy", err.cpu(), old_err.cpu())
        hold("jpeg_entropy", coef.cpu(), old_coef.cpu())
        hold("jpeg_idct_bgr", jpeg_cuda.idct_bgr(coef, dp).cpu(),
             pr13_idct(lib, coef, dp).cpu())
        bounds = mjpg_bounds(p, coef)
        forms = {"jpeg_entropy": (lambda: pr13_entropy(lib, dp),
                                  lambda: jpeg_cuda.entropy_decode(dp)),
                 "jpeg_idct_bgr": (lambda: pr13_idct(lib, coef, dp),
                                   lambda: jpeg_cuda.idct_bgr(coef, dp))}
        for name, (old, new) in forms.items():
            ms = {"pr13": [], "this": []}
            for who in ("pr13", "this", "this", "pr13"):
                ms[who].append(time_cuda(old if who == "pr13" else new, 20))
            bound, by = bounds[name]
            out[f"{name} T={p.t}"] = {
                "ms": min(ms["this"]), "pr13_ms": min(ms["pr13"]),
                "bound_ms": bound, "bound_by": by,
                "ratio": min(ms["this"]) / bound,
                "pr13_ratio": min(ms["pr13"]) / bound, "ms_in_turns": ms}
    return out


def qconv_tiling(n, h, w, srcs, cout, k, stride, pad) -> dict:
    """og_qconv's form for a layer, its tile width, ring stages, thread
    blocks an SM, dynamic shared memory and 64-pixel blocks a warpgroup's
    tile (from the built library; the form and stages held against the
    wrapper's own statement of the rules, ``qconv_cuda.halo_stages``)."""
    from openglottal_tpu_torch.ops import _build, qconv_cuda

    lib = _build.load("qconv")
    bn = lib.og_qconv_tile_n(cout)
    if bn != qconv_cuda.tile_n(cout):
        raise AssertionError(f"og_qconv_tile_n({cout}) = {bn}, the wrapper's "
                             f"tile_n says {qconv_cuda.tile_n(cout)}")
    a = qconv_cuda._Args()
    a.c0, a.c1 = srcs[0], sum(srcs[1:])
    a.n, a.h, a.w_in, a.cout, a.kh, a.kw = n, h, w, cout, k, k
    a.stride, a.pad = stride, pad
    a.ho = qconv_cuda.out_size(h, k, stride, pad)
    a.wo = qconv_cuda.out_size(w, k, stride, pad)
    shape = (ctypes.c_int * 4)()
    lib.og_qconv_form.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    halo = lib.og_qconv_form(ctypes.byref(a), shape)
    want = qconv_cuda.halo_stages(a.ho, a.wo, a.c0, a.c1, cout, k, k, stride)
    if (shape[0] if halo else 0) != want:
        raise AssertionError(f"og_qconv_form: {halo} / {shape[0]} stages, "
                             f"the wrapper's halo_stages says {want}")
    return {"form": "halo" if halo else "gather", "tile_n": bn,
            "stages": shape[0], "blocks_per_sm": shape[1],
            "smem_bytes": shape[2], "blocks_of_64_a_tile": shape[3]}


def quant_layer_times(dev, frames: int = 128, pr10_lib=None) -> list:
    """Per U-Net layer shape at ``frames`` frames: og_qconv's ms beside its
    bound (max of 2 MACs / 1,979 TOPS and bytes / 3.35 TB/s), PR 10's
    kernel in turns (``pr10_lib``: PR 10, new, new, PR 10, each the mean of
    10 queued launches; the two outputs must be equal), cuDNN's bfloat16
    conv at the same shape (channels_last, bias and ReLU not included) and
    ``torch._int_mm`` over the layer's im2col matrix (for the record only:
    it computes the s32 product, not the layer)."""
    import torch
    import torch.nn.functional as F

    rows = []
    for label, h, w, srcs, cout in QCONV_UNET + QCONV_UNET_WINDOW:
        pad = 0 if "window" in label else 1
        cin = sum(srcs)
        xs = tuple(torch.randint(0, 127, (frames, h, w, c), dtype=torch.int8,
                                 device=dev) for c in srcs)
        x = xs if len(xs) > 1 else xs[0]
        w8 = torch.randint(-127, 128, (cout, 3, 3, cin), dtype=torch.int8,
                           device=dev)
        sw = torch.full((cout,), 1e-3, device=dev)
        b = torch.zeros(cout, device=dev)
        inputs = (xs, w8, sw, b, None)
        kw = dict(sx=1e-3, stride=1, pad=pad, epilogue="relu_q", s_next=0.05)
        kfn, _, nbytes, ops = qconv_runner(inputs, kw)
        turns = {"new": [], "pr10": []}
        if pr10_lib is not None:
            with qconv_library(pr10_lib):
                turns["pr10"].append(time_cuda(kfn, 10))
                old_out = kfn()
        turns["new"] += [time_cuda(kfn, 10), time_cuda(kfn, 10)]
        if pr10_lib is not None:
            with qconv_library(pr10_lib):
                turns["pr10"].append(time_cuda(kfn, 10))
            if not torch.equal(kfn(), old_out):
                raise AssertionError(f"qconv {label}: the kernel and PR 10's "
                                     f"differ")
            del old_out
        ms = sum(turns["new"]) / 2
        xb = torch.randn(frames, cin, h, w, device=dev, dtype=torch.bfloat16
                         ).contiguous(memory_format=torch.channels_last)
        wb = torch.randn(cout, cin, 3, 3, device=dev, dtype=torch.bfloat16
                         ).contiguous(memory_format=torch.channels_last)
        cudnn_ms = time_cuda(lambda: F.conv2d(xb, wb, padding=pad), 10)
        del xb
        ho = h + 2 * pad - 2
        m = frames * ho * ho
        a = torch.randint(-127, 128, (m, 9 * cin), dtype=torch.int8,
                          device=dev)
        bm = torch.randint(-127, 128, (9 * cin, cout), dtype=torch.int8,
                           device=dev)
        try:
            int_mm_ms = time_cuda(lambda: torch._int_mm(a, bm), 5)
        except RuntimeError as e:          # shapes _int_mm refuses
            int_mm_ms = f"refused: {str(e)[:80]}"
        del a, bm, xs, x
        t_ops = ops / INT8_OPS_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append({"layer": label, "shape": [frames, h, w, cin, cout],
                     "pad": pad, "ms": ms, "ms_turns": turns["new"],
                     "pr10_ms": (sum(turns["pr10"]) / 2 if turns["pr10"]
                                 else None),
                     "pr10_ms_turns": turns["pr10"],
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "tensor_tops": ops / ms / 1e9,
                     "cudnn_bf16_ms": cudnn_ms, "int_mm_im2col_ms": int_mm_ms,
                     **qconv_tiling(frames, h, w, srcs, cout, 3, 1, pad)})
        torch.cuda.empty_cache()
    return rows


def quant_phase(pipes, weights, videos, counted, expect_counts, hold_record,
                host_syncs, device_kernels, smi) -> tuple:
    """int8 serving (``GlottalPipelines(quant="int8" | "int8-full")``) of
    ``unet`` (windowed with its ok redo, and full-frame), its cohort and
    ``unet-only`` on the main path's 502-frame videos, demo weights,
    conf 0.25, calibrated on video 0's first 64 frames: every og_qconv launch
    of the main runs held exactly equal to its plain version; int8 vs bf16
    waveforms (relative L1 < 0.05, the JAX selftest's int8-full gate), int8
    windowed vs full-frame (<= 2.0 px a frame), the "int8" gate equal to
    the bf16 run's, a cohort of mixed lengths equal to the per-video calls,
    save -> load equal, card vs CPU on 12 frames (< 0.05), host syncs per
    video; then per-layer times, the int8 U-Net stage's device ms and walls
    per video in turns.  Raises on any failed check; returns (the phase's
    line, the "int8" windowed main run's record, its launch counts)."""
    import numpy as np
    import torch

    from openglottal_tpu_torch.models import quant as quant_mod
    from openglottal_tpu_torch.models.unet import chunk_window_origin
    from openglottal_tpu_torch.pipelines import CHUNK, WIN, GlottalPipelines

    bf = torch.bfloat16
    v = videos[0]
    t0 = time.perf_counter()
    q = {}
    for mode in ("int8", "int8-full"):
        for route, win in (("windowed", None), ("full", False)):
            q[(mode, route)] = GlottalPipelines(dtype=bf, quant=mode,
                                                window_decoder=win, **weights)
        q[(mode, "windowed")].calibrate(v)
        q[(mode, "full")]._qparams = q[(mode, "windowed")]._qparams
    torch.cuda.synchronize()
    line = {"video": "synthetic_video(t=502, size=256, seed=0, "
                     "realistic=False), channel 0; calibrated on its first "
                     "64 frames", "calibration_s": time.perf_counter() - t0,
            "nvidia_smi": smi, "launches": {}, "launches_held": 0}
    bf16 = {"windowed": pipes["bf16"],
            "full": GlottalPipelines(dtype=bf, window_decoder=False,
                                     **weights)}
    for p in [*q.values(), bf16["full"]]:
        p.extract_features(videos[1], "unet")            # warm-up (cuDNN)

    # the main runs, every launch counted and held
    n_q = {"int8": 17, "int8-full": 17 + 62}     # og_qconv launches a chunk
    areas, main_record, main_counts = {}, None, None
    for (mode, route), p in q.items():
        def run(p=p):
            pending = p.yolo_unet_areas_deferred(v)
            return p.yolo_unet_areas_resolve(pending), pending[1]

        record = []
        (a, ok), got = counted(run, record)
        expect_counts(f"quant {mode}/{route}", got,
                      {k: (n_q[mode] * N_CHUNKS if k == "qconv" else
                           N_CHUNKS if k in ("gate_scan", "box_count") else 0)
                       for k in got})
        if route == "windowed" and (ok is None or not bool(ok)):
            raise AssertionError(f"{mode}: the windowed int8 decoder did not "
                                 f"fit the served video")
        hold_record(f"quant {mode}/{route}", record)
        line["launches_held"] += len(record)
        line["launches"][f"{mode}/{route}"] = got
        areas[(mode, route)] = a
        if (mode, route) == ("int8", "windowed"):
            main_record, main_counts = record, got
        else:
            del record
    want = {r: bf16[r].extract_features(v, "unet")["_area"] for r in bf16}
    for (mode, route), a in areas.items():
        rel = rel_l1(a, want[route])
        line[f"int8_vs_bf16_rel_l1_{mode}_{route}"] = rel
        if rel >= 0.05:
            raise AssertionError(f"{mode}/{route}: int8 vs bf16 relative L1 "
                                 f"{rel} (limit 0.05)")
    for mode in ("int8", "int8-full"):
        d = np.abs(areas[(mode, "windowed")] - areas[(mode, "full")])
        line[f"windowed_vs_full_max_abs_px_{mode}"] = float(d.max())
        if d.max() > 2.0:
            raise AssertionError(f"{mode}: windowed vs full-frame int8 areas "
                                 f"differ by {d.max()} px (limit 2.0)")
        u8 = q[(mode, "windowed")].unet_only_areas(v).cpu().numpy()
        ub = pipes["bf16"].unet_only_areas(v).cpu().numpy()
        rel = rel_l1(u8, ub)
        line[f"int8_vs_bf16_rel_l1_{mode}_unet_only"] = rel
        if rel >= 0.05:
            raise AssertionError(f"{mode}/unet-only: int8 vs bf16 relative "
                                 f"L1 {rel} (limit 0.05)")
    # "int8" keeps the bf16 detector: its gate is the bf16 run's
    gray = pipes["bf16"]._to_gray(v)
    gq = q[("int8", "windowed")]._unet_gated(None, gray, True)
    gb = pipes["bf16"]._unet_gated(None, gray, True)
    if not (torch.equal(gq[2], gb[2]) and torch.equal(gq[3], gb[3])):
        raise AssertionError("int8: the gate's valid/boxes differ from the "
                             "bf16 run's")
    line["int8_gate_equals_bf16"] = True
    boxes, valid = gq[3], gq[2]
    line["chunk_windows_oy_ox_fits"] = [
        [int(o[1]), int(o[2]), bool(o[0])] for o in (
            chunk_window_origin(boxes[i:i + CHUNK], valid[i:i + CHUNK], 256,
                                256, WIN, lattice=4, margin=6)
            for i in range(0, T_FRAMES, CHUNK))]

    # a cohort of mixed lengths against the per-video calls (exact)
    cohort = [vid[:t] for vid, t in zip(videos, QUANT_COHORT)]
    for mode in ("int8", "int8-full"):
        p = q[(mode, "windowed")]
        multi = p.yolo_unet_areas_gray_multi(cohort)
        for i, (a, g) in enumerate(zip(multi, cohort)):
            if not np.array_equal(a, p.yolo_unet_areas_gray(g).cpu().numpy()):
                raise AssertionError(f"{mode} cohort: video {i} differs from "
                                     f"its per-video call")
    line["cohort_equals_per_video"] = {"lengths": list(QUANT_COHORT),
                                       "modes": ["int8", "int8-full"]}

    # save -> load: the same waveform; card vs CPU on 12 frames
    qfile = Path("openglottal_tpu_torch/build/quant_check/qparams.npz")
    q[("int8-full", "windowed")].save_qparams(qfile)
    back = GlottalPipelines(dtype=bf, quant="int8-full", **weights)
    back.load_qparams(qfile)
    if not np.array_equal(back.extract_features(v, "unet")["_area"],
                          areas[("int8-full", "windowed")]):
        raise AssertionError("int8-full: the reloaded calibration's waveform "
                             "differs")
    line["save_load_same_waveform"] = True
    small = v[:12]
    card = GlottalPipelines(dtype=torch.float32, quant="int8", **weights)
    cpu = GlottalPipelines(dtype=torch.float32, quant="int8", device="cpu",
                           **weights)
    card.load_qparams(qfile)
    cpu.load_qparams(qfile)
    for p in (card, cpu):
        p._qparams.pop("yolo")
    a_cpu = cpu.yolo_unet_areas(small).numpy()
    a_card = card.yolo_unet_areas(small).cpu().numpy()
    line["card_vs_cpu_rel_l1_12_frames"] = rel_l1(a_card, a_cpu)
    if line["card_vs_cpu_rel_l1_12_frames"] >= 0.05:
        raise AssertionError(f"int8: card vs CPU relative L1 "
                             f"{line['card_vs_cpu_rel_l1_12_frames']}")

    # host syncs and device kernels per video, int8 against bf16
    line["host_syncs_per_video"], line["host_sync_sites"] = {}, {}
    line["n_device_kernels_per_video"] = {}
    for key, p in (("bf16/windowed", bf16["windowed"]),
                   ("bf16/full", bf16["full"]),
                   *((f"{m}/{r}", q[(m, r)]) for m, r in q)):
        n, sites = host_syncs(lambda: p.extract_features(v, "unet"))
        line["host_syncs_per_video"][key] = n
        line["host_sync_sites"][key] = sites
        line["n_device_kernels_per_video"][key] = sum(device_kernels(
            lambda: p.extract_features(v, "unet")).values())
    for m, r in q:
        if line["host_syncs_per_video"][f"{m}/{r}"] != \
                line["host_syncs_per_video"][f"bf16/{r}"]:
            raise AssertionError(f"{m}/{r}: host syncs per video differ from "
                                 f"the bf16 route's")

    # the int8 U-Net stage on one 128-frame chunk, by CUDA events, against
    # the bf16 U-Net's, both routes (the window at chunk 0's origin)
    qp = q[("int8", "windowed")]._qparams["unet"]
    g = gray[:CHUNK]
    _, oy, ox = chunk_window_origin(boxes[:CHUNK], valid[:CHUNK], 256, 256,
                                    WIN, lattice=4, margin=6)
    unet = pipes["bf16"].unet
    xin = pipes["bf16"]._unet_input(g)

    def bf16_window():
        d3, s2, s1 = unet.apply_to_d3(xin)
        return unet.tail_from_ymw(unet.mid_window(d3, s2, oy, ox, WIN), s1,
                                  oy, ox, WIN)

    enc = quant_mod.qunet_to_d3(qp, g)
    stage = {
        "int8_to_d3": lambda: quant_mod.qunet_to_d3(qp, g),
        "int8_window_tail": lambda: quant_mod.qunet_tail_from_d3_window(
            qp, *enc, oy, ox, WIN),
        "int8_full_tail": lambda: quant_mod.qunet_tail_from_d3_full(qp, *enc),
        "int8_windowed_unet": lambda: quant_mod.qunet_tail_from_d3_window(
            qp, *quant_mod.qunet_to_d3(qp, g), oy, ox, WIN),
        "int8_full_unet": lambda: quant_mod.qunet_logits(qp, g),
        "bf16_windowed_unet": bf16_window,
        "bf16_full_unet": lambda: unet.logits(xin)}
    line["unet_stage_device_ms_per_chunk"] = {
        k: time_cuda(f, 5) for k, f in stage.items()}
    del enc

    # walls per video in turns, over three distinct videos
    walls = {}
    for route in ("windowed", "full"):
        order = [("bf16", bf16[route]), ("int8", q[("int8", route)]),
                 ("int8-full", q[("int8-full", route)])]
        order = order + order[::-1]
        for tag, p in order:
            for vid in videos[1:4]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                p.extract_features(vid, "unet")
                walls.setdefault(f"{tag}/{route}", []).append(
                    (time.perf_counter() - t0) * 1e3)
    line["wall_ms_per_video_in_turns"] = walls
    line["turn_order"] = ("per route: bf16, int8, int8-full, int8-full, "
                          "int8, bf16, each over videos 1, 2, 3")
    pr10_lib, line["pr10_kernel_ptxas"] = pr10_qconv_library()
    rows = quant_layer_times(torch.device("cuda"), pr10_lib=pr10_lib)
    line["layers_128_frames"] = rows
    line["chunk_sum_17_layers_ms"] = {
        k: sum(r[k] for r in rows[:len(QCONV_UNET)])
        for k in ("ms", "pr10_ms", "bound_ms", "cudnn_bf16_ms")}
    return line, main_record, main_counts


# the cohort: eight 256² gray videos of these lengths, two of them realistic
COHORT_LENGTHS = (502, 502, 380, 130, 129, 128, 3, 1000)
COHORT_PIPELINES = ("guided-vft", "vft", "unet")
WALL_KS = (1, 2, 4, 8, 16)


def cohort_phase(pipes, videos, counted, expect_counts, hold_record,
                 host_syncs, device_kernels, runners, against_libs) -> tuple:
    """Cohort serving: the three cohort entries (``guided_vft_areas_gray
    _multi``, ``vft_areas_gray_multi``, ``yolo_unet_areas_gray_multi``) on a
    cohort of eight 256² gray videos (lengths COHORT_LENGTHS: two of the
    main path's videos, two ``realistic=True`` clips, slices of 129, 128 and
    3 frames, and a 1000-frame clip), bf16 and f32, each video's waveform
    held exactly equal to the per-video call; the launches counted (one
    batched gate, one batched chain and one set of union-find launches per
    guided-vft sub-batch) and every recorded launch held equal to its plain
    version; a second cohort with a video whose boxes leave the decoder's
    window (redone), ``max_k = 3`` and ``fetch=False``; then, in bf16 on 16
    distinct 502-frame videos, walls per video at K = 1, 2, 4, 8, 16 and the
    rule's K in turns with the per-video calls, host syncs per sub-batch,
    device kernels per video, peak memory against the rule's estimate, and
    the batched kernels' times.  Raises on any failed check; returns (the
    phase's line, the guided-vft cohort's record and launch counts)."""
    import numpy as np
    import torch

    from openglottal_tpu_torch.data.synthetic import synthetic_video
    from openglottal_tpu_torch.ops import _build, areas_cuda, scan_cuda
    from openglottal_tpu_torch.pipelines import (
        CHUNK,
        VFT_INIT,
        YGVFT_INIT,
        cohort_fixed_bytes,
        cohort_video_bytes,
    )

    def gray(t, seed, realistic):
        f, _ = synthetic_video(t=t, size=256, seed=seed, realistic=realistic)
        return np.ascontiguousarray(f[..., 0])

    cohort = [videos[0], videos[1], gray(380, 6, True), gray(130, 7, True),
              videos[2][:129].copy(), videos[3][128:256].copy(),
              videos[2][200:203].copy(), gray(1000, 5, False)]
    assert tuple(len(v) for v in cohort) == COHORT_LENGTHS
    per_video = {
        "guided-vft": lambda p, v: p.guided_vft_areas(v),
        "vft": lambda p, v: p.vft_areas(v),
        "unet": lambda p, v: p.yolo_unet_areas_resolve(
            p.yolo_unet_areas_deferred(v))}
    multi = {
        "guided-vft": lambda p, vs, **kw: p.guided_vft_areas_gray_multi(
            vs, **kw),
        "vft": lambda p, vs, **kw: p.vft_areas_gray_multi(vs, **kw),
        "unet": lambda p, vs, **kw: p.yolo_unet_areas_gray_multi(vs, **kw)}
    shortest = {"guided-vft": YGVFT_INIT + 2, "vft": VFT_INIT + 5, "unet": 1}

    def equal(got, want):
        if got is None or want is None:
            return got is None and want is None
        if isinstance(got, torch.Tensor):
            got = got.cpu().numpy()
        return bool(np.array_equal(got, want))

    line = {"videos": {"lengths": list(COHORT_LENGTHS),
                       "realistic": [False, False, True, True, False, False,
                                     False, False]},
            "compared": "each video's waveform exactly equal to the "
                        "per-video call; every recorded launch exactly equal "
                        "to its plain version",
            "equal": {}, "launches": {}, "per_video_launches": {},
            "sub_batch_k": {}, "launches_held": {}}
    records, guided_counts = {}, None
    for tag, pipe in pipes.items():
        for name in COHORT_PIPELINES:
            want, pv_counts = counted(
                lambda: [per_video[name](pipe, v) for v in cohort])
            rec = [] if tag == "bf16" else None
            got, got_counts = counted(lambda: multi[name](pipe, cohort), rec)
            bad = [i for i, (g, w) in enumerate(zip(got, want))
                   if not equal(g, w)]
            if bad:
                raise AssertionError(f"cohort {name}/{tag}: videos {bad} "
                                     f"differ from the per-video calls")
            run = [t for t in COHORT_LENGTHS if t >= shortest[name]]
            k = pipe.sub_batch_k(name, run)
            subs = [run[j:j + k] for j in range(0, len(run), k)]
            expected = dict(pv_counts, gate_scan=0, gate_scan_batch=len(subs))
            if name == "guided-vft":
                expected.update(thresh_chain=0, thresh_chain_batch=len(subs),
                                dual_cc_batch=len(subs),
                                dual_min_prop_batch=len(subs),
                                min_prop_batch=2 * len(subs))
            elif name == "unet":
                expected.update(
                    gate_scan=pv_counts["gate_scan"], gate_scan_batch=0,
                    box_count=sum(max(-(-t // CHUNK) for t in sub)
                                  for sub in subs))
            expect_counts(f"cohort {name}/{tag}", got_counts, expected)
            line["equal"][f"{name}/{tag}"] = True
            line["launches"][f"{name}/{tag}"] = got_counts
            line["per_video_launches"][f"{name}/{tag}"] = pv_counts
            line["sub_batch_k"][f"{name}/{tag}"] = k
            if rec is not None:
                records[name] = rec
                if name == "guided-vft":
                    guided_counts = got_counts
    for name, rec in records.items():
        hold_record(f"cohort {name}", rec)
        line["launches_held"][name] = len(rec)

    # the realistic clips: gate-valid share, and whether their boxes fit
    # guided-vft's 128² window and unet's decoder windows
    bf16 = pipes["bf16"]
    line["realistic"] = {}
    for i in (2, 3):
        g = bf16._to_gray(cohort[i])
        valid, boxes = bf16._gated(None, g)
        side = int((boxes[:, 2:] - boxes[:, :2]).max())
        line["realistic"][f"video {i} ({len(cohort[i])} frames)"] = {
            "gate_valid_share": float(valid.float().mean()),
            "max_box_side": side,
            "guided_vft_boxes_fit_128_window": side <= 126,
            "unet_windows_fit": bool(bf16._unet_gated(None, g, True)[1])}

    # a video whose boxes leave the window (frames 64.. of a main-path video
    # moved up by 60 rows: the windowed_phase's), max_k = 3, fetch=False
    moved = videos[0].copy()
    moved[64:] = np.roll(videos[0][64:], -60, axis=1)
    variant = [moved, cohort[3], cohort[4], cohort[6]]
    line["variants"] = {"videos": "[502 frames moved (its boxes leave the "
                                  "window), 130, 129, 3]", "max_k": 3}
    for tag, pipe in pipes.items():
        if pipe.yolo_unet_areas_deferred(moved)[1].item():
            raise AssertionError(f"{tag}: the moved video fitted the window")
        for name in COHORT_PIPELINES:
            want = [per_video[name](pipe, v) for v in variant]
            runs = {"max_k=3": multi[name](pipe, variant, max_k=3)}
            if name == "unet":
                runs["max_k=3 fetch=False"] = multi[name](
                    pipe, variant, max_k=3, fetch=False)
                if not all(isinstance(a, torch.Tensor) and a.is_cuda
                           for a in runs["max_k=3 fetch=False"]):
                    raise AssertionError("fetch=False gave no device tensors")
            for key, got in runs.items():
                if not all(equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"cohort {name}/{tag} {key}: a video "
                                         f"differs from the per-video call")
                line["equal"][f"{name}/{tag} {key}"] = True
    line["equal"]["redo_of_the_moved_video"] = True

    # ── numbers, bf16, 16 distinct 502-frame videos ─────────────────────
    pool = [np.ascontiguousarray(np.roll(videos[i % 4], 3 * (i // 4), axis=2))
            for i in range(16)]
    walls, rule_k = {}, {}
    for name in COHORT_PIPELINES:
        rule_k[name] = {"pool_of_16": bf16.sub_batch_k(name, [502] * 16),
                        "cohort_of_65": bf16.sub_batch_k(name, [502] * 65)}
        walls[name] = {}
        for k in sorted(set(WALL_KS) | {rule_k[name]["pool_of_16"]}):
            vids = pool[:k]
            w = {"per_video": [], "cohort": []}
            for mode in ("per_video", "cohort", "cohort", "per_video"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if mode == "cohort":
                    multi[name](bf16, vids, max_k=k)
                else:
                    for v in vids:
                        per_video[name](bf16, v)
                w[mode].append((time.perf_counter() - t0) * 1e3 / k)
            walls[name][str(k)] = {
                "ms_per_video": w, "frames_per_s": {
                    m: 502 / (float(np.median(x)) / 1e3) for m, x in w.items()}}
    line["k_rule"] = rule_k
    line["walls_bf16"] = walls
    line["turn_order"] = "per K: per-video calls, cohort, cohort, per-video"

    syncs, kernels_per_video, peak = {}, {}, {}
    for name in COHORT_PIPELINES:
        n, sites = host_syncs(lambda: multi[name](bf16, pool[:8], max_k=8))
        n1, _ = host_syncs(lambda: per_video[name](bf16, pool[0]))
        syncs[name] = {"per_sub_batch_of_8": n, "per_video_call": n1,
                       "sites": sites}
        kernels_per_video[name] = {
            "cohort_of_8": sum(device_kernels(
                lambda: multi[name](bf16, pool[:8], max_k=8)).values()) / 8,
            "per_video_call": sum(device_kernels(
                lambda: per_video[name](bf16, pool[0])).values())}
        peak[name] = {}
        for k in (4, 16):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            multi[name](bf16, pool[:k], max_k=k)
            torch.cuda.synchronize()
            peak[name][str(k)] = {
                "measured_bytes": torch.cuda.max_memory_allocated() - base,
                "rule_estimate_bytes": cohort_fixed_bytes(name, 502, 2)
                + k * cohort_video_bytes(name, 502, 2)}
    line["host_syncs"] = syncs
    line["device_kernels_per_video"] = kernels_per_video
    line["peak_memory_bf16"] = peak

    # ── the batched kernels' times (CUDA events, queued) ────────────────
    times = {}
    for rname, kname in (("guided-vft", "gate_scan_batch"),
                         ("guided-vft", "thresh_chain_batch"),
                         ("guided-vft", "dual_cc_batch"),
                         ("guided-vft", "dual_min_prop_batch"),
                         ("guided-vft", "min_prop_batch")):
        for j, (name, inputs, kw) in enumerate(records[rname]):
            if name != kname:
                continue
            kfn, _, nbytes, ops = runners(name, inputs, kw)
            times[f"{name} #{j}"] = {
                "shape": list(max(inputs, key=torch.numel).shape),
                "wrapper_ms": time_cuda(kfn, 20),
                "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                                ops / FP32_OPS_PER_S) * 1e3}
    # the C launches alone, on buffers made once
    so = scan_cuda.lib()
    _, (g_has, g_raw), g_kw = next(r for r in records["guided-vft"]
                                   if r[0] == "gate_scan_batch")
    _, (t_th0, t_cur, t_npx, t_act), t_kw = next(
        r for r in records["guided-vft"] if r[0] == "thresh_chain_batch")
    k_g = len(g_kw["offsets"]) - 1
    g_keep = (g_has.contiguous(), g_raw.to(torch.float32).contiguous(),
              torch.empty(g_has.shape, dtype=torch.bool, device="cuda"),
              torch.empty((g_has.numel(), 4), dtype=torch.int32,
                          device="cuda"),
              torch.zeros((k_g, 6), dtype=torch.int32, device="cuda"))
    g_off = scan_cuda.offsets_arg(g_kw["offsets"])
    t_keep = (t_th0.contiguous(), t_cur.contiguous(), t_npx.contiguous(),
              t_act.contiguous(), torch.empty_like(t_cur))
    t_off = scan_cuda.offsets_arg(t_kw["offsets"])
    beta = t_kw["beta"]
    times["gate_scan_batch bare"] = time_cuda(lambda: _build.check(
        so.og_gate_scan_batch(*(x.data_ptr() for x in g_keep), g_off, k_g,
                              256.0, 256.0, 30.0, 8, 3, scan_cuda.stream()),
        "og_gate_scan_batch"), 50)
    times["thresh_chain_batch bare"] = time_cuda(lambda: _build.check(
        so.og_thresh_chain_batch(*(x.data_ptr() for x in t_keep), t_off,
                                 k_g, float(np.float32(beta)),
                                 float(np.float32(1.0 - beta)),
                                 scan_cuda.stream()),
        "og_thresh_chain_batch"), 50)
    # the in-box count: the served (128, 160, 160) bf16 chunk alone, and a
    # table of 8 such chunks (chunk 0 of 8 videos of a cohort)
    rec8 = []
    counted(lambda: multi["unet"](bf16, pool[:8], max_k=8), rec8)
    table8 = next(inp for name, inp, _ in rec8 if name == "box_count")
    thr = 0.0
    chunk1 = (table8[0]._replace(out=None),)
    box = {}
    for label, chunks in (("table of 1", chunk1),
                          ("table of 8", tuple(c._replace(out=None)
                                               for c in table8))):
        kfn, pfn, nbytes, ops = runners("box_count", chunks, {"thr": thr})
        if not all(torch.equal(g, w_) for g, w_ in zip(kfn(), pfn())):
            raise AssertionError(f"box_count {label} differs from plain")
        box[label] = {"chunks": len(chunks),
                      "shape": list(chunks[0].x.shape),
                      "dtype": str(chunks[0].x.dtype),
                      "ms": time_cuda(kfn, 50),
                      "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                                      ops / FP32_OPS_PER_S) * 1e3,
                      "plain_ms": time_cuda(pfn, 5)}
    times["box_count"] = box
    if against_libs is not None:
        # the older checkouts' og_box_count (one block per frame, the C
        # interface of one chunk) in turns with this one on the served chunk
        import ctypes

        libs = against_libs()
        c = chunk1[0]
        ox_ = c.ox.to(torch.int64).reshape(())
        oy_ = c.oy.to(torch.int64).reshape(())
        v8 = c.valid.contiguous()
        b32 = c.boxes.to(torch.int32).contiguous()
        want = areas_cuda.box_count_table(chunk1, thr, use_plain=True)[0]
        fns = {"this": lambda: areas_cuda.box_count_table(chunk1, thr)[0]}
        for d, lib_ in libs.items():
            a = lib_.get("areas")
            if a is None or hasattr(a, "og_box_count_entry_bytes"):
                continue
            p_, i_, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            a.og_box_count.argtypes = [p_, i_, f_, p_, p_, p_, p_, i_, i_, p_,
                                       i_, i_, i_, p_]
            a.og_box_count.restype = ctypes.c_int

            def old(a=a):
                out = torch.empty((c.x.shape[0],), dtype=torch.float32,
                                  device="cuda")
                _build.check(a.og_box_count(
                    c.x.data_ptr(), 1 if c.x.dtype == torch.bfloat16 else 0,
                    thr, v8.data_ptr(), b32.data_ptr(), oy_.data_ptr(),
                    ox_.data_ptr(), 0, 0, out.data_ptr(), *c.x.shape,
                    torch.cuda.current_stream().cuda_stream), "old box_count")
                return out
            fns[d] = old
        turns = {k_: [] for k_ in fns}
        for k_ in [*fns, *reversed(fns)]:
            if not torch.equal(fns[k_](), want):
                raise AssertionError(f"box_count of {k_} differs from plain")
            turns[k_].append(time_cuda(fns[k_], 50))
        times["box_count_against"] = {
            "order": [*fns, *reversed(fns)], "ms_each_turn": turns,
            "ms": {k_: sum(v) / len(v) for k_, v in turns.items()}}
    line["kernel_times"] = times
    return line, records["guided-vft"], guided_counts


STREAM_SPLITS = ([T_FRAMES], [128, 128, 128, 118], [1, 1, 37, 200, 263])
STREAM_PIPELINES = ("unet", "unet-only", "crop-unet", "vft", "guided-vft")
STREAM_LONG = 4000      # frames of the memory run


def write_y800_avi(path, gray) -> None:
    """A (T, H, W) uint8 video as an uncompressed 8-bit gray AVI (fourcc
    Y800): the RIFF header lists, one ``00db`` chunk per frame, no index."""
    import struct

    t, h, w = gray.shape

    def chunk(cid, data):
        return cid + struct.pack("<I", len(data)) + data + b"\0" * (
            len(data) & 1)

    def lst(kind, *parts):
        return chunk(b"LIST", kind + b"".join(parts))

    bih = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 8, b"Y800", w * h, 0, 0,
                      0, 0)
    avih = struct.pack("<10I", 250, 0, 0, 0, t, 0, 1, 0, w, h) + b"\0" * 16
    head = lst(b"hdrl", chunk(b"avih", avih),
               lst(b"strl", chunk(b"strh", b"vidsY800" + b"\0" * 48),
                   chunk(b"strf", bih)))
    movi = lst(b"movi", *(chunk(b"00db", f.tobytes()) for f in gray))
    Path(path).write_bytes(chunk(b"RIFF", b"AVI " + head + movi))


def stream_phase(pipes, weights, videos, counted, hold_record, host_syncs,
                 smi) -> tuple:
    """Streaming: ``stream_areas`` of all five pipelines on a 502-frame gray
    256² video in bf16, in the splits STREAM_SPLITS (one chunk; the
    128-frame lattice; boundaries off it, with seeds across chunks), each
    held exactly equal to its whole-video call (``unet`` to its full-frame
    route, the trackers to their sequential forms) and compared with the
    default forms (windowed ``unet``, frame-parallel trackers); ``unet`` and
    ``guided-vft`` in f32 on 128 frames, and colour chunks through ``unet``,
    ``crop-unet`` and ``guided-vft``, on a ragged split.  The launches of
    the ragged bf16 streams are recorded and every one held equal to its
    plain version.  Then walls per frame against the whole-video calls in
    turns, host syncs per chunk, peak device memory of a 4000-frame ``unet``
    stream against 502-frame whole-video calls, ``prefetch=2`` against
    ``prefetch=0`` in turns, and the AVI round trip: a Y800 file written
    here, ``iter_frames_bgr`` against ``load_frames_bgr`` and the frames
    written, and ``python -m openglottal_tpu_torch.cli run --stream 128``
    in a subprocess against ``extract_features``.  Raises on any failed
    check; returns (the phase's line, {path: launch counts})."""
    import os

    import numpy as np
    import torch

    from openglottal_tpu_torch.data.video import (
        iter_frames_bgr,
        load_frames_bgr,
    )
    from openglottal_tpu_torch.pipelines import (
        CHUNK,
        GlottalPipelines,
        _box_area_sums,
    )

    t_start = time.perf_counter()
    seq = {tag: GlottalPipelines(dtype=p.dtype, parallel_trackers=False,
                                 window_decoder=False, **weights)
           for tag, p in pipes.items()}

    def chunks(v, splits):
        i = 0
        for n in splits:
            yield v[i:i + n]
            i += n

    whole = {
        "unet": lambda p, v: p.yolo_unet_areas(v).cpu().numpy(),
        "unet-only": lambda p, v: p.unet_only_areas(v).cpu().numpy(),
        "crop-unet": lambda p, v: _box_area_sums(
            *p.crop_unet_masks(v)).cpu().numpy(),
        "vft": lambda p, v: p.vft_areas(v),
        "guided-vft": lambda p, v: p.guided_vft_areas(v)}

    def split_name(s):
        return "-".join(map(str, s))

    ragged = STREAM_SPLITS[-1]
    v0 = videos[0]
    line = {"frames": T_FRAMES, "splits": [list(s) for s in STREAM_SPLITS],
            "compared": "each stream exactly equal to its whole-video call "
                        "(unet: window_decoder=False; trackers: "
                        "parallel_trackers=False); every recorded launch "
                        "exactly equal to its plain version",
            "equal": {}, "launches": {}, "vs_default_forms": {}}
    records, path_counts = {}, {}
    bf16 = seq["bf16"]
    for name in STREAM_PIPELINES:
        want = whole[name](bf16, v0)
        for splits in STREAM_SPLITS:
            rec = [] if splits is ragged else None
            got, got_counts = counted(
                lambda: bf16.stream_areas(chunks(v0, splits), name), rec)
            if not np.array_equal(got, want):
                raise AssertionError(
                    f"stream {name}/bf16 {split_name(splits)}: differs from "
                    f"the whole-video call (max abs diff "
                    f"{float(np.abs(got - want).max())})")
            line["equal"][f"{name}/bf16 {split_name(splits)}"] = True
            if rec is not None:
                records[name] = rec
                path_counts[f"stream-{name}/bf16"] = got_counts
                line["launches"][name] = got_counts
        n_slices = -(-T_FRAMES // CHUNK)
        got_counts = path_counts[f"stream-{name}/bf16"]
        if name != "unet-only" and got_counts["gate_scan"] != n_slices:
            raise AssertionError(f"stream {name}: gate_scan launched "
                                 f"{got_counts['gate_scan']} times, "
                                 f"expected {n_slices}")
        if name == "unet" and got_counts["box_count"] != n_slices:
            raise AssertionError("stream unet: one box_count per slice")
        if name in ("vft", "guided-vft") and not all(
                got_counts[k] > 0 for k in ("cc", "motion_map",
                                            "thresh_chain")):
            raise AssertionError(f"stream {name}: a tracker kernel was not "
                                 f"launched ({got_counts})")
        # against the default forms of the whole-video call
        if name == "unet":
            d = float(np.abs(want - pipes["bf16"].yolo_unet_areas(
                v0).cpu().numpy()).max())
            if d > 2.0:
                raise AssertionError(f"stream unet vs windowed route: {d} px")
            line["vs_default_forms"]["unet_max_area_diff_vs_windowed_px"] = d
        elif name in ("vft", "guided-vft"):
            d = float(np.abs(want - whole[name](pipes["bf16"], v0)).max())
            if name == "vft" and d != 0.0:
                raise AssertionError(f"stream vft differs from the "
                                     f"frame-parallel form by {d} px")
            line["vs_default_forms"][
                f"{name}_max_area_diff_vs_frame_parallel_px"] = d
    for name, rec in records.items():
        if name == "unet-only":
            continue            # it launches no hand-written kernel
        hold_record(f"stream {name}", rec)
    line["launches_held"] = {k: len(v) for k, v in records.items()}

    # f32 on 128 frames; colour chunks, bf16
    f32_splits = [1, 1, 37, 89]
    for name in ("unet", "guided-vft"):
        v = videos[1][:128]
        want = whole[name](seq["f32"], v)
        got = seq["f32"].stream_areas(chunks(v, f32_splits), name)
        if not np.array_equal(got, want):
            raise AssertionError(f"stream {name}/f32 differs")
        line["equal"][f"{name}/f32 128 frames {split_name(f32_splits)}"] = True
    colour = tint(videos[2])
    for name in ("unet", "crop-unet", "guided-vft"):
        want = whole[name](bf16, colour)
        got = bf16.stream_areas(chunks(colour, ragged), name)
        if not np.array_equal(got, want) or not (want > 0).any():
            raise AssertionError(f"stream {name}/bf16 colour differs")
        line["equal"][f"{name}/bf16 colour {split_name(ragged)}"] = True

    # ── numbers, bf16 ───────────────────────────────────────────────────
    lattice = STREAM_SPLITS[1]
    walls = {}
    for name in STREAM_PIPELINES:
        v = videos[3]
        w = {"whole": [], "stream": []}
        for mode in ("whole", "stream", "stream", "whole"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "whole":
                whole[name](bf16, v)
            else:
                bf16.stream_areas(chunks(v, lattice), name)
            w[mode].append((time.perf_counter() - t0) * 1e3 / T_FRAMES)
        walls[name] = w
    line["walls_ms_per_frame"] = walls
    line["walls_order"] = "whole, stream, stream, whole; split " \
        f"{split_name(lattice)}; whole = the form the stream equals"

    syncs = {}
    for name in STREAM_PIPELINES:
        for pf in (2, 0):
            n, sites = host_syncs(lambda: bf16.stream_areas(
                chunks(videos[2], lattice), name, prefetch=pf))
            syncs[f"{name} prefetch={pf}"] = {
                "total": n, "per_chunk": n / len(lattice), "sites": sites}
    line["host_syncs"] = {"chunks": len(lattice), "counts": syncs}

    # peak device memory above the start: a 4000-frame unet stream in
    # 128-frame chunks (502 and 1000 frames too) beside 502-frame
    # whole-video calls on both routes
    long_video = np.concatenate([np.roll(videos[i % 4], 5 * (i // 4), axis=2)
                                 for i in range(-(-STREAM_LONG // T_FRAMES))]
                                )[:STREAM_LONG]

    def peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    mem = {}
    for t in (T_FRAMES, 1000, STREAM_LONG):
        mem[f"stream {t} frames"] = peak(lambda: bf16.stream_areas(
            chunks(long_video[:t], [CHUNK] * -(-t // CHUNK)), "unet"))
    mem["whole 502 frames, full-frame route"] = peak(
        lambda: bf16.yolo_unet_areas(videos[0]))
    mem["whole 502 frames, windowed route"] = peak(
        lambda: pipes["bf16"].yolo_unet_areas(videos[0]))
    if mem[f"stream {STREAM_LONG} frames"] > \
            mem["whole 502 frames, full-frame route"]:
        raise AssertionError(f"stream peak memory above the whole-video "
                             f"call's: {mem}")
    line["peak_memory_bytes_bf16_unet"] = mem
    line["long_stream_equal"] = bool(np.array_equal(
        bf16.stream_areas(chunks(long_video, [CHUNK] * 32), "unet"),
        bf16.yolo_unet_areas(long_video).cpu().numpy()))
    if not line["long_stream_equal"]:
        raise AssertionError("4000-frame unet stream differs")

    pf_walls = {"prefetch=2": [], "prefetch=0": []}
    for pf in (2, 0, 0, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bf16.stream_areas(chunks(long_video[:1024], [CHUNK] * 8), "unet",
                          prefetch=pf)
        pf_walls[f"prefetch={pf}"].append(
            (time.perf_counter() - t0) * 1e3 / 1024)
    line["prefetch_walls_ms_per_frame"] = {
        "pipeline": "unet", "frames": 1024, "order": "2, 0, 0, 2",
        **pf_walls}

    # ── the AVI reader and the command line ─────────────────────────────
    out_dir = Path("openglottal_tpu_torch/build/stream_check")
    out_dir.mkdir(parents=True, exist_ok=True)
    avi = out_dir / "clip.avi"
    write_y800_avi(avi, v0)
    full = load_frames_bgr(avi)
    parts = list(iter_frames_bgr(avi, chunk=128))
    if ([len(p) for p in parts] != [128, 128, 128, 118]
            or not np.array_equal(np.concatenate(parts), full)
            or not all(np.array_equal(full[..., c], v0) for c in range(3))):
        raise AssertionError("AVI reader: frames differ from those written")
    cmd = [sys.executable, "-m", "openglottal_tpu_torch.cli", "run", str(avi),
           "--pipeline", "unet", "--stream", "128",
           "--yolo-weights", weights["yolo_variables"],
           "--unet-weights", weights["unet_variables"],
           "--output", str(out_dir)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(Path.cwd())})
    cli_s = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"cli run failed: {r.stderr[-2000:]}")
    got = json.loads((out_dir / "features.json").read_text())
    want = bf16.extract_features(full, "unet")
    default = pipes["bf16"].extract_features(full, "unet")
    same = {k: bool(np.array_equal(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64)))
            for k in want}
    if got.keys() != want.keys() or not all(same.values()):
        raise AssertionError(f"cli features differ from extract_features: "
                             f"{same}")
    line["avi_round_trip"] = {
        "frames": len(full), "chunks": [len(p) for p in parts],
        "bytes": avi.stat().st_size,
        "cli": " ".join(cmd[1:3] + ["run", "VIDEO"] + cmd[5:9]),
        "cli_seconds": cli_s,
        "features_equal_extract_features_full_frame_route": True,
        "features_equal_extract_features_windowed_route": all(
            np.array_equal(np.asarray(got[k], np.float64),
                           np.asarray(default[k], np.float64))
            for k in default)}
    avi.unlink()
    line["nvidia_smi"] = smi
    line["seconds"] = time.perf_counter() - t_start
    return line, path_counts


# ── evaluation: the count kernels of csrc/eval.cu and evaluate_patient ──────

# the union-find's labelling entry points (og_dual_cc, og_cc_batch, og_cc)
# on tools/blob_stress.py's families: pools of every family at the served
# shapes (guided-vft's 128x128 windows, vft's 48x40 crops) cycled into
# stacks of T frames (a frame as the plain version alone; the wave edges
# of both forms and the cohort), every width edge of the 32-bit bit planes
# at 37 and 128 rows, single-row and single-column frames, the largest frame
# of the labelling form (216x215), the first of the device-memory form
# (217x215) and 256x256, and buffers that start off a 16-byte boundary
BLOB_STRESS_T = (1, 263, 264, 265, 500, 502, 2757)
BLOB_STRESS_WIDTHS = (1, 31, 32, 33, 40, 63, 64, 65, 127, 128, 129)
BLOB_SERVED = ((128, 128), (48, 40))
BLOB_BIG = ((216, 215), (217, 215), (256, 256))
BLOB_LINES = ((1, 128), (128, 1), (1, 40), (48, 1))


def blob_stress_shapes() -> list:
    """(T, H, W) of every stack blob_stress launches."""
    from openglottal_tpu_torch.tools.blob_stress import FAMILIES

    pool = 4 * (len(FAMILIES) - 2)
    return ([(pool, h, w) for h, w in BLOB_SERVED]
            + [(t, h, w) for h, w in BLOB_SERVED for t in BLOB_STRESS_T]
            + [(len(FAMILIES) - 1, h, w) for h in (37, 128)
               for w in BLOB_STRESS_WIDTHS]
            + [(4, h, w) for h, w in BLOB_LINES]
            + [(len(FAMILIES) - 2, h, w) for h, w in BLOB_BIG])


def blob_stress(dev, hold, unaligned) -> dict:
    """og_dual_cc on the families' dual codes, og_cc_batch (8- and
    4-connected) and og_cc (each pool frame alone) on their masks, each held
    exactly equal to its plain version on every stack of
    ``blob_stress_shapes``; the min-prop entry points on the served pools.
    A stack of T frames cycles its pool, so its plain labels are the pool's
    cycled (labels are frame-local).  Raises on a difference."""
    import numpy as np
    import torch

    from openglottal_tpu_torch.ops import blobs_cuda
    from openglottal_tpu_torch.tools.blob_stress import (
        FAMILIES,
        stress_codes,
        stress_masks,
    )

    planes = [f for f in FAMILIES if f not in ("row", "column")]
    launches = {"dual_cc_batch": 0, "cc_batch": 0, "cc": 0,
                "min_prop_batch": 0, "dual_min_prop_batch": 0}
    stacks = []

    def held(masks, codes, masks_want=None, codes_want=None):
        """The three labelling launches on one stack against their plain
        versions (or the given plain labels)."""
        want = (codes_want if codes_want is not None
                else blobs_cuda.dual_cc_plain(codes))
        hold("dual_cc_batch", blobs_cuda.dual_cc_batch(codes), want)
        launches["dual_cc_batch"] += 1
        for conn in (8, 4):
            want = (masks_want[conn] if masks_want is not None
                    else blobs_cuda.cc_plain(masks, conn))
            hold("cc_batch", blobs_cuda.cc_batch(masks, conn), want)
            launches["cc_batch"] += 1
        stacks.append(list(masks.shape))

    def on_dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    # the served shapes: a pool of every family, then stacks of T frames
    for h, w in BLOB_SERVED:
        masks = on_dev(np.concatenate([stress_masks(f, h, w, 4, seed=i)
                                       for i, f in enumerate(planes)]))
        codes = on_dev(np.concatenate([stress_codes(f, h, w, 4, seed=i)
                                       for i, f in enumerate(planes)]))
        n = len(masks)
        dual = blobs_cuda.dual_cc_plain(codes)
        lab = {conn: blobs_cuda.cc_plain(masks, conn) for conn in (8, 4)}
        held(masks, codes, lab, dual)
        for conn in (8, 4):
            for i in range(n):
                hold("cc", blobs_cuda.cc(masks[i], conn), lab[conn][i])
                launches["cc"] += 1
        # the init forms (the fixpoint body) on the same pool
        init = torch.from_numpy(np.random.default_rng(h).integers(
            0, h * w + 1, (n, h, w)).astype(np.int32)).to(dev)
        hold("dual_min_prop_batch", blobs_cuda.dual_min_prop_batch(codes, init),
             blobs_cuda.dual_min_prop_plain(codes, init))
        launches["dual_min_prop_batch"] += 1
        for conn in (8, 4):
            hold("min_prop_batch", blobs_cuda.min_prop_batch(masks, init, conn),
                 blobs_cuda.min_prop_plain(masks, init, conn))
            launches["min_prop_batch"] += 1
        for t in BLOB_STRESS_T:
            idx = torch.arange(t, device=dev) % n
            held(masks[idx].contiguous(), codes[idx].contiguous(),
                 {conn: lab[conn][idx] for conn in (8, 4)}, dual[idx])
        # from buffers that start 1, 3 and 8 bytes past a 16-byte boundary
        for by in (1, 3, 8):
            held(unaligned(masks, by), unaligned(codes, by), lab, dual)
    # every width edge of the bit planes, at 37 rows (frames off 16-byte
    # boundaries, a height between powers of two for the rounds) and 128
    for h in (37, 128):
        for w in BLOB_STRESS_WIDTHS:
            masks = on_dev(np.concatenate(
                [stress_masks(f, h, w, 1, seed=w) for f in planes]
                + [np.random.default_rng(w).random((1, h, w)) < 0.5]))
            codes = on_dev(np.concatenate(
                [stress_codes(f, h, w, 1, seed=w) for f in planes]
                + [np.random.default_rng(w).integers(0, 3, (1, h, w))
                   .astype(np.uint8)]))
            held(masks, codes)
            for conn in (8, 4):
                hold("cc", blobs_cuda.cc(masks[-1], conn),
                     blobs_cuda.cc_plain(masks[-1:], conn)[0])
                launches["cc"] += 1
    # single rows and single columns
    for h, w in BLOB_LINES:
        fam = "row" if h == 1 else "column"
        held(on_dev(stress_masks(fam, h, w, 4, seed=w)),
             on_dev(stress_codes(fam, h, w, 4, seed=w)))
    # the largest labelling frame, the first fixpoint one, and 256x256
    for h, w in BLOB_BIG:
        held(on_dev(np.concatenate([stress_masks(f, h, w, 1, seed=3)
                                    for f in planes])),
             on_dev(np.concatenate([stress_codes(f, h, w, 1, seed=3)
                                    for f in planes])))
    return {"families": list(FAMILIES), "stacks": len(stacks),
            "shapes": sorted({tuple(x) for x in stacks}),
            "launches_held": launches}


# (frames, h, w) of the count kernels' stress inputs: the served 256², odd
# sizes whose frames do not start on 16-byte boundaries, a wide ragged
# frame, 1x1 frames
EVAL_SHAPES = ((10, 256, 256), (10, 37, 53), (10, 240, 320), (7, 17, 300),
               (3, 1, 1))
# the card's float32 evaluation rows against the CPU port's, a frame: the
# mask tolerance of tests/test_torch_port_eval.py (a Dice or IoU step of
# 0.01 is a few pixels of a glottis mask)
EVAL_CARD_VS_CPU_TOL = 0.01


def eval_stress_inputs(dev, t, h, w, seed):
    """(pred, gt, valid, boxes, gray) of t frames at (h, w): all-zero and
    all-one frames, empty boxes, one-pixel boxes at two corners, boxes at,
    across and past the frame's edges and outside it, invalid frames, a
    bimodal gray frame with a dark glottis and all-0 / all-255 frames."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    pred = rng.random((t, h, w)) < 0.4
    gt = rng.random((t, h, w)) < 0.3
    pred[0] = False
    pred[1] = True
    gt[1] = True
    gt[2 % t] = False
    boxes = np.stack([rng.integers(-10, w, t), rng.integers(-10, h, t),
                      rng.integers(0, w + 10, t), rng.integers(0, h + 10, t)],
                     1)
    boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2])
    special = [[0, 0, w, h], [w - 1, h - 1, w, h], [5, 5, 5, 9],
               [0, 0, 1, 1], [-30, -30, w + 30, h + 30], [w, h, w + 5, h + 5],
               [w // 3, -4, w - 2, h // 2]]
    for i, b in enumerate(special[:t]):
        boxes[i] = b
    valid = rng.random(t) < 0.8
    valid[:min(t, 5)] = True
    valid[-1] = False
    g = rng.normal(170, 12, (t, h, w))
    g[:, h // 5:h // 2, w // 4:w // 2] = rng.normal(45, 9, (
        t, h // 2 - h // 5, w // 2 - w // 4))
    g = np.clip(g, 0, 255).astype(np.uint8)
    g[-1] = 0
    g[-2] = 255
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return (to(pred), to(gt), to(valid), to(boxes.astype(np.int32)), to(g),
            to((pred * rng.integers(1, 256, (t, h, w))).astype(np.uint8)))


def eval_stress(dev, hold, unaligned) -> list:
    """og_frame_counts (unmasked, box-masked, both from one pass) and
    og_otsu_counts (with and without gt) on every EVAL_SHAPES input,
    bool and uint8 masks, 16-byte aligned and unaligned buffers (pred and
    gt at the same and at different offsets), each held exactly equal to
    its plain version (``hold(name, got, want)`` raises on a difference);
    thresholds by their bits.  Returns the cases' labels."""
    import torch

    from openglottal_tpu_torch.ops import eval_cuda

    labels = []
    for t, h, w in EVAL_SHAPES:
        pred, gt, valid, boxes, gray, pred_u8 = eval_stress_inputs(
            dev, t, h, w, seed=h * 1000 + w)
        gt_u8 = gt.to(torch.uint8) * 255
        for tag, p, g in (
                ("bool", pred, gt), ("uint8", pred_u8, gt_u8),
                ("bool+uint8", pred, gt_u8),
                ("unaligned 1/1", unaligned(pred, 1), unaligned(gt, 1)),
                ("unaligned 3/8", unaligned(pred_u8, 3), unaligned(gt, 8))):
            for kw in ({}, {"valid": valid, "boxes": boxes},
                       {"valid": valid, "boxes": boxes, "unmasked": True}):
                hold("frame_counts", eval_cuda.frame_counts(p, g, **kw),
                     eval_cuda.frame_counts(p, g, **kw, use_plain=True))
                labels.append(f"frame_counts {t}x{h}x{w} {tag} "
                              f"{'+'.join(kw) or 'unmasked'}")
        for tag, gr, g in (("gt", gray, gt), ("gt uint8", gray, gt_u8),
                           ("no gt", gray, None),
                           ("unaligned", unaligned(gray, 5),
                            unaligned(gt, 2))):
            (kt, kc), (pt, pc) = (
                eval_cuda.otsu_counts(gr, g, valid, boxes),
                eval_cuda.otsu_counts(gr, g, valid, boxes, use_plain=True))
            hold("otsu_counts", kt.view(torch.int32), pt.view(torch.int32))
            hold("otsu_counts", kc, pc)
            labels.append(f"otsu_counts {t}x{h}x{w} {tag}")
    return labels


def eval_runner(name, inputs, kw):
    """(kernel fn, plain fn, bytes moved, operations) of one recorded launch
    of og_frame_counts or og_otsu_counts.  Bytes: the masks read once (the
    Otsu launch: the in-box gray pixels and the whole gt), valid, boxes and
    the outputs; operations: per pixel the two byte tests and the AND (and
    the in-box test and two more ANDs when box-masked), per in-box pixel of
    the Otsu launch the histogram add, the compare and the AND, and its
    256-bin walk (eight float operations a bin)."""
    from openglottal_tpu_torch.ops import eval_cuda

    if name == "frame_counts":
        pred, gt, valid, boxes = inputs
        t = pred.shape[0]
        px = pred.numel()
        boxed = boxes is not None
        nbytes = 2 * px + (17 * t if boxed else 0) + t * (
            24 if kw["unmasked"] else 12)
        return (lambda: eval_cuda.frame_counts(pred, gt, valid, boxes, **kw),
                lambda: eval_cuda.frame_counts(pred, gt, valid, boxes, **kw,
                                               use_plain=True),
                nbytes, px * (6 if boxed else 3))
    gray, gt, valid, boxes = inputs
    t = gray.shape[0]
    inbox = int(eval_cuda.inbox_masks(boxes, *gray.shape[1:]).sum())
    nbytes = inbox + (0 if gt is None else gt.numel()) + t * (17 + 4 + 12)
    return (lambda: eval_cuda.otsu_counts(gray, gt, valid, boxes),
            lambda: eval_cuda.otsu_counts(gray, gt, valid, boxes,
                                          use_plain=True),
            nbytes, 3 * inbox + 8 * 256 * t)


def eval_phase(pipes, cpu_pipe, counted, expect_counts, hold_record,
               host_syncs, device_kernels, smi) -> tuple:
    """``eval.evaluate_patient`` with the demo weights (U-Net, crop U-Net
    and YOLO, conf 0.25) on a 502-frame synthetic 256² colour video (the
    realistic form: texture, noise and blur, so that no row is trivially
    1.0) with its ``synthetic_video`` masks as the ground truth, bf16 and
    float32: the
    five pipelines' rows (keys, lengths, values in [0, 1]); og_frame_counts
    launched 3 times (U-Net masks unmasked and box-masked from one pass,
    the crop U-Net, the guided tracker) and og_otsu_counts once; every
    recorded launch (the blob kernels and scans of the path too) held
    exactly equal to its plain version; ``aggregate``; host syncs and
    device kernels per video; walls per video over three distinct videos;
    the card's float32 rows against the CPU port's on a 12-frame clip:
    ``yolo+otsu`` bit-equal on every frame whose gate (valid, box) agrees
    (the frames whose gate differs are listed), and every row within
    EVAL_CARD_VS_CPU_TOL a frame.  Raises on any
    failed check; returns (the phase's line, the bf16 run's record, its
    launch counts)."""
    import numpy as np
    import torch

    from openglottal_tpu_torch.data.synthetic import synthetic_video
    from openglottal_tpu_torch.eval import PIPELINES, aggregate, \
        evaluate_patient
    from openglottal_tpu_torch.pipelines import YGVFT_INIT

    def patient(seed, t=T_FRAMES):
        f, m = synthetic_video(t=t, size=256, seed=seed, realistic=True)
        return tint(f), np.ascontiguousarray(m)

    def check_rows(where, rows, t):
        if list(rows) != PIPELINES:
            raise AssertionError(f"{where}: pipelines {list(rows)}")
        for name, r in rows.items():
            n = t - (YGVFT_INIT if name == "yolo+motion" else 0)
            for k in ("dice", "iou"):
                x = r[k]
                if (x.shape != (n,) or x.dtype != np.float32
                        or not ((x >= 0) & (x <= 1)).all()):
                    raise AssertionError(f"{where}: {name} {k} {x.shape} "
                                         f"{x.dtype} outside [0, 1]")
            if (r["det"] is None) != (name == "unet-only") or (
                    r["det"] is not None and r["det"].shape != (n,)):
                raise AssertionError(f"{where}: {name} det")

    line = {"nvidia_smi": smi, "frames": T_FRAMES,
            "input": "synthetic_video(t=502, size=256, realistic=True), "
                     "tinted to colour; ground truth: its masks"}
    frames, gt = patient(0)
    record, counts = None, None
    expected = {"frame_counts": 3, "otsu_counts": 1, "gate_scan": 1}
    for tag, pipe in pipes.items():
        evaluate_patient(pipe, *patient(1, 64))          # warm-up (cuDNN)
        rec = []
        rows, got = counted(lambda: evaluate_patient(pipe, frames, gt), rec)
        expect_counts(f"eval/{tag}", got, expected)
        check_rows(f"eval/{tag}", rows, T_FRAMES)
        hold_record(f"eval/{tag}", rec)
        if tag == "bf16":
            record, counts = rec, got
        walls = []
        for s in (2, 3, 4):
            f_s, m_s = patient(s)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            evaluate_patient(pipe, f_s, m_s)
            walls.append((time.perf_counter() - t0) * 1e3)
        agg = aggregate({"p0": rows})
        line[tag] = {
            "launches": got, "launches_held": len(rec),
            "wall_ms_per_video": walls,
            "aggregate": {k: {m: v[m] for m in ("dice", "iou", "dice50",
                                                  "det_recall", "n_frames")}
                          for k, v in agg.items()}}
    syncs, sites = host_syncs(lambda: evaluate_patient(pipes["bf16"], frames,
                                                       gt))
    line["host_syncs_per_video"], line["host_sync_sites"] = syncs, sites
    line["device_kernels_per_video_bf16"] = sum(device_kernels(
        lambda: evaluate_patient(pipes["bf16"], frames, gt)).values())

    # the card's float32 rows against the CPU port's on 12 frames
    clip, clip_gt = frames[:12], gt[:12]
    card = evaluate_patient(pipes["f32"], clip, clip_gt)
    cpu = evaluate_patient(cpu_pipe, clip, clip_gt)
    gates = []
    for p in (pipes["f32"], cpu_pipe):
        v, b = p.gated_boxes(clip, True)
        gates.append((v.cpu().numpy(), b.cpu().numpy()))
    agree = (gates[0][0] == gates[1][0]) & (gates[0][1] == gates[1][1]).all(1)
    max_diff = {}
    for name in PIPELINES:
        c, h = card[name], cpu[name]
        if name == "yolo+otsu":
            for k in ("dice", "iou"):
                if not np.array_equal(c[k][agree].view(np.int32),
                                      h[k][agree].view(np.int32)):
                    raise AssertionError(f"eval: yolo+otsu {k} on the card "
                                         f"differs from the CPU's where the "
                                         f"gates agree")
        d = max(float(np.abs(c[k] - h[k]).max()) for k in ("dice", "iou"))
        if d > EVAL_CARD_VS_CPU_TOL:
            raise AssertionError(f"eval: {name} card vs CPU differs by {d} "
                                 f"(limit {EVAL_CARD_VS_CPU_TOL})")
        max_diff[name] = d
    line["card_vs_cpu_12_frames_f32"] = {
        "frames_whose_gate_differs": np.nonzero(~agree)[0].tolist(),
        "yolo_otsu_bit_equal_where_gates_agree": True,
        "max_abs_diff_dice_iou": max_diff,
        "rows_bit_equal": {n: bool(np.array_equal(card[n]["dice"],
                                                  cpu[n]["dice"])
                                   and np.array_equal(card[n]["iou"],
                                                      cpu[n]["iou"]))
                           for n in PIPELINES}}
    return line, record, counts


# ── MJPG: baseline-JPEG decode on the card (csrc/jpeg.cu) ───────────────────

MJPG_DIR = Path(__file__).resolve().parent / "tests" / "data" / "mjpg"
MJPG_REAL = "real_256_64.avi"       # repeated into the T_FRAMES-frame clip
MJPG_PLAIN_FRAMES = 64              # frames the plain versions are timed on
MJPG_WEIGHTS = dict(unet_variables="weights/demo_unet.npz",
                    yolo_variables="weights/demo_yolo.npz", conf=0.25)


def mjpg_stress_cases() -> list:
    """(label, JPEG frames) of the decoder's stress streams
    (tools/jpeg_stress.py): every sampling form, sizes that are not
    multiples of 16 (1x1, 37x53, 72x136; 4:2:x, whose odd heights are
    refused, at 2x1 and 38x53), restart intervals of 1 and 5 MCUs, DC
    differences of +-2047 and AC levels of +-1023, every zero run (ZRL
    chains, blocks without an EOB, blocks of only a DC term), 16-bit
    quantisation tables whose products wrap int16, frames without a DHT."""
    from openglottal_tpu_torch.tools.jpeg_stress import stress_frames

    cases, seed = [], 0
    for kind in ("extreme", "dense", "sparse", "noise"):
        for sampling in ("gray", "4:4:4", "4:2:2", "4:2:0"):
            for (h, w), restart, qmax, dht in (((37, 53), 0, 1, True),
                                               ((16, 16), 1, 65535, True),
                                               ((1, 1), 0, 255, False),
                                               ((72, 136), 5, 255, False)):
                if sampling in ("4:2:2", "4:2:0"):
                    h += h % 2
                cases.append((
                    f"{kind} {sampling} {h}x{w} restart {restart} q<={qmax}"
                    f"{'' if dht else ' annex-K'}",
                    stress_frames(kind, h, w, sampling, t=3, seed=seed,
                                  restart=restart, quant_max=qmax, dht=dht)))
                seed += 1
    return cases


def mjpg_parse(frames, first: int = 0):
    """JPEG frames -> the packed chunk, tables carried as a video carries
    them."""
    from openglottal_tpu_torch.data import jpeg

    state = jpeg.JpegState()
    return jpeg.pack([jpeg.parse_frame(f, state, first + i)
                      for i, f in enumerate(frames)], first)


def mjpg_hold(dev, hold, p, unaligned_by: int = 0, sub_bits=None):
    """Both kernels on one packed chunk against their plain versions (the
    entropy decode's coefficients and error flags, the IDCT of the plain
    coefficients and of the kernel's); the packed bytes ``unaligned_by``
    bytes (a multiple of 4) past a fresh allocation; the entropy decode with
    subsequences of ``sub_bits`` bits (None: the wrapper's default).  Of a
    chunk with a flagged frame, the flags and the other frames'
    coefficients; returns the flagged frames' count."""
    import torch

    from openglottal_tpu_torch.data import jpeg
    from openglottal_tpu_torch.ops import jpeg_cuda

    dp = jpeg_cuda.upload(p, dev)
    if unaligned_by:
        buf = torch.empty(dp.data.numel() + unaligned_by, dtype=torch.uint8,
                          device=dev)
        dp.data = buf[unaligned_by:].copy_(dp.data)
    coef, err = (jpeg_cuda.entropy_decode(dp) if sub_bits is None
                 else jpeg_cuda.launch_entropy(dp, sub_bits))
    want_coef, want_err = jpeg.entropy_decode_plain(p)
    hold("jpeg_entropy", err.cpu(), torch.from_numpy(want_err))
    if want_err.any():
        good = torch.from_numpy(want_err == 0)
        hold("jpeg_entropy", coef.cpu()[good],
             torch.from_numpy(want_coef)[good])
        return int(want_err.sum())
    hold("jpeg_entropy", coef.cpu(), torch.from_numpy(want_coef))
    want = torch.from_numpy(jpeg.idct_bgr_plain(want_coef, p))
    hold("jpeg_idct_bgr", jpeg_cuda.idct_bgr(coef, dp).cpu(), want)
    hold("jpeg_idct_bgr", jpeg_cuda.idct_bgr(
        torch.from_numpy(want_coef).to(dev), dp).cpu(), want)
    return 0


def mjpg_stress(dev, hold) -> dict:
    """The stress streams, each at two byte offsets with the wrapper's
    subsequence length and once with the kernel's smallest; the
    synchronisation stress streams (tools/jpeg_stress.sync_stress_cases) at
    both lengths, the frame one block short flagged and the junk never; and
    two broken streams (cut short; all-ones codes), at both lengths, whose
    error flags must equal the plain version's and whose read must raise
    naming the frame."""
    from openglottal_tpu_torch.ops import jpeg_cuda
    from openglottal_tpu_torch.tools.jpeg_stress import sync_stress_cases

    s_min = jpeg_cuda._lib().og_jpeg_entropy_min_sub_bits()
    lengths = (jpeg_cuda.SUB_BITS, s_min)
    cases = mjpg_stress_cases()
    for k, (_, frames) in enumerate(cases):
        p = mjpg_parse(frames)
        mjpg_hold(dev, hold, p)
        mjpg_hold(dev, hold, p, 4 * (1 + k % 3))
        mjpg_hold(dev, hold, p, sub_bits=s_min)
    sync_cases = sync_stress_cases()
    sync_flagged = {}
    for label, frames in sync_cases:
        p = mjpg_parse(frames)
        for sub_bits in lengths:
            n = mjpg_hold(dev, hold, p, 4, sub_bits)
            if n != (1 if label.startswith("one block short") else 0):
                raise AssertionError(f"jpeg: {label}: {n} frames flagged at "
                                     f"S = {sub_bits}")
        sync_flagged[label] = n
    good = next(f for c, f in cases if c.startswith("noise 4:2:0 38x53"))
    body = good[1].index(b"\xff\xda")
    short = good[1][:body + 40]
    ones = good[1][:body + 20] + b"\xff\x00" * 64 + b"\xff\xd9"
    broken = {}
    for name, frame in (("short", short), ("all-ones codes", ones)):
        p = mjpg_parse([good[0], frame, good[2]])
        broken[name] = mjpg_hold(dev, hold, p)
        if broken[name] != 1 or mjpg_hold(dev, hold, p, 0, s_min) != 1:
            raise AssertionError(f"jpeg: the {name} frame was not flagged")
        try:
            jpeg_cuda.decode(p, dev)
        except ValueError as e:
            if "frame 1" not in str(e):
                raise
        else:
            raise AssertionError(f"jpeg: the {name} frame did not raise")
    # 4:2:x of odd height is refused on the host, before any upload
    from openglottal_tpu_torch.tools.jpeg_stress import stress_frames
    for sampling in ("4:2:2", "4:2:0"):
        try:
            mjpg_parse(stress_frames("noise", 37, 53, sampling, t=1))
        except ValueError as e:
            if f"{sampling} of odd height" not in str(e):
                raise
        else:
            raise AssertionError(f"jpeg: {sampling} of odd height was "
                                 f"decoded")
    return {"cases": len(cases), "frames": sum(len(f) for _, f in cases),
            "labels": [c for c, _ in cases], "broken_streams_flagged": broken,
            "sub_bits_held": list(lengths),
            "sync_cases_flagged": sync_flagged,
            "odd_height_4_2_x_refused": True}


def mjpg_phase(dev, pipe, hold, counted, host_syncs, device_kernels, smi,
               logs, stress=None) -> tuple:
    """The MJPG read path on the card.  The stress streams and every
    fixture of tests/data/mjpg (cv2- and PIL-written) through both kernels
    against their plain versions, the card's frames against the digests of
    cv2's frames written beside the fixtures; then a T_FRAMES-frame 256²
    clip (the realistic fixture's 64 frames repeated: MJPG frames are
    independent) read by ``read_frames`` and ``iter_frames`` (chunks of
    128), every launch held against the plain version of its frames, every
    frame against its cv2 digest, served through ``unet`` (bf16, whole and
    streamed, and through the command line both ways) with its waveform
    equal to the same frames served from host memory; the kernels' times at
    64 and 502 frames in turns with PR 13's (``mjpg_turns``), bounds,
    registers, the entropy decode at three subsequence lengths, the plain
    versions' times, host syncs per clip, the device work of one decode,
    the read from disk to the card (the host parse's share measured) and
    unet's time, in turns with the same frames as a BI_RGB 24-bit AVI and
    as a Y800 AVI.  Returns (the phase's line, the kernels' entries)."""
    import hashlib
    import tempfile

    import numpy as np
    import torch

    from openglottal_tpu_torch import cli
    from openglottal_tpu_torch.data import jpeg
    from openglottal_tpu_torch.data.video import (
        _pieces,
        bgr_to_gray_u8,
        iter_frames,
        read_frames,
    )
    from openglottal_tpu_torch.ops import jpeg_cuda
    from openglottal_tpu_torch.tools.jpeg_stress import (
        jpeg_frames_of,
        write_mjpg_avi,
    )

    t_phase = time.perf_counter()
    line = {"stress": stress or mjpg_stress(dev, hold)}
    digests = json.loads((MJPG_DIR / "digests.json").read_text())

    def sha(frames):
        x = frames.cpu().numpy()
        if x.ndim == 3:
            x = np.repeat(x[..., None], 3, axis=-1)
        return [hashlib.sha256(np.ascontiguousarray(f).tobytes()).hexdigest()
                for f in x]

    def hold_launches(record, plain_of):
        """Each recorded launch equal to the plain version of its frames:
        ``plain_of(frame number)`` -> (coefficients, BGR) of the plain
        decode."""
        n = 0
        for name, inputs, outputs in record:
            if name == "jpeg_entropy":
                frames_ = range(inputs.t)
                coef, err = outputs
                if int(err.abs().sum()) != 0:
                    raise AssertionError("jpeg_entropy flagged a good frame")
                want = torch.from_numpy(np.stack(
                    [plain_of(i)[0] for i in frames_]))
                hold("jpeg_entropy", coef.cpu(), want)
            else:
                want = np.stack([plain_of(i)[1] for i in range(inputs[1].t)])
                hold("jpeg_idct_bgr", outputs.cpu(), torch.from_numpy(want))
            n += 1
        return n

    # every fixture: the card's frames == the plain decode, and == cv2's
    # digests where the fixture was decoded exactly when it was written
    fixtures, held, plain = {}, 0, {}
    for name, d in sorted(digests.items()):
        path = MJPG_DIR / name
        if "refused" in d:
            try:
                read_frames(path, dev)
            except ValueError as e:
                if str(e) != d["refused"]:
                    raise
            else:
                raise AssertionError(f"{name}: read, not refused")
            fixtures[name] = {"refused": d["refused"]}
            continue
        record = []
        jpeg_cuda.RECORD = record
        try:
            got = read_frames(path, dev)
        finally:
            jpeg_cuda.RECORD = None
        p = mjpg_parse(jpeg_frames_of(path))
        coef, _ = jpeg.entropy_decode_plain(p)
        bgr = jpeg.idct_bgr_plain(coef, p)
        plain[name] = (p, coef, bgr)
        held += hold_launches(record, lambda i: (coef[i], bgr[i]))
        hold("jpeg_idct_bgr", got.cpu(), torch.from_numpy(bgr))
        match = sum(a == b for a, b in zip(sha(got), d["sha256"]))
        if match != len(d["sha256"]):
            raise AssertionError(f"{name}: {len(d['sha256']) - match} frames "
                                 f"differ from cv2's")
        fixtures[name] = {"shape": list(got.shape), "sampling": p.geo.sampling,
                          "frames_equal_to_cv2": f"{match}/{len(d['sha256'])}"}
    line["fixtures"] = fixtures

    # the served clip: the realistic fixture's frames repeated
    real = jpeg_frames_of(MJPG_DIR / MJPG_REAL)
    tmp = Path(tempfile.mkdtemp(prefix="mjpg_"))
    clip = tmp / "clip.avi"
    write_mjpg_avi(clip, [real[i % len(real)] for i in range(T_FRAMES)], 256,
                   256)
    p64, coef64, bgr64 = plain[MJPG_REAL]
    want_sha = [digests[MJPG_REAL]["sha256"][i % len(real)]
                for i in range(T_FRAMES)]

    def plain_of(first):
        return lambda i: (coef64[(first + i) % len(real)],
                          bgr64[(first + i) % len(real)])

    record = []
    frames, launches = counted(lambda: read_frames(clip, dev), record)
    held += hold_launches(record, plain_of(0))
    if sha(frames) != want_sha:
        raise AssertionError("clip: the card's frames differ from cv2's")
    launches = {k: v for k, v in launches.items() if v}
    if launches != {"jpeg_entropy": 1, "jpeg_idct_bgr": 1}:
        raise AssertionError(f"clip: launches {launches}")
    host = frames.cpu().numpy()
    srecord = []
    chunks, slaunches = counted(
        lambda: list(iter_frames(clip, chunk=128, device=dev)), srecord)
    slaunches = {k: v for k, v in slaunches.items() if v}
    n_chunks = -(-T_FRAMES // 128)
    if slaunches != {"jpeg_entropy": n_chunks, "jpeg_idct_bgr": n_chunks}:
        raise AssertionError(f"clip in chunks of 128: launches {slaunches}")
    first = 0
    for k in range(0, len(srecord), 2):
        held += hold_launches(srecord[k:k + 2], plain_of(first))
        first += srecord[k][1].t
    if not torch.equal(torch.cat(chunks), frames):
        raise AssertionError("clip: iter_frames differs from read_frames")
    p = mjpg_parse([real[i % len(real)] for i in range(T_FRAMES)])
    p128 = mjpg_parse([real[i % len(real)] for i in range(128)])
    line["clip"] = {
        "frames": T_FRAMES, "avi_bytes": clip.stat().st_size,
        "packed_bytes_crossing": p.nbytes,
        "bgr_bytes": int(frames.numel()),
        "launches_whole": launches, "launches_stream_128": slaunches,
        "frames_equal_to_cv2_digests": T_FRAMES,
        "host_syncs_read_frames": host_syncs(lambda: read_frames(clip, dev)),
        "host_syncs_iter_frames_128": host_syncs(
            lambda: list(iter_frames(clip, chunk=128, device=dev))),
        "device_work_one_decode_128_frames": device_kernels(
            lambda: jpeg_cuda.decode(p128, dev))}
    line["launches_held_equal_to_plain"] = held

    # served through unet (bf16): whole and streamed, against host frames
    def features(x):
        f = pipe.extract_features(x, "unet")
        if f is None or f["_area"].shape != (T_FRAMES,) or not np.isfinite(
                f["_area"]).all():
            raise AssertionError("mjpg clip: bad unet waveform")
        return f

    f_dev = features(read_frames(clip, dev))
    f_host = features(host)
    s_dev = pipe.stream_features(iter_frames(clip, chunk=128, device=dev),
                                 "unet")
    s_host = pipe.stream_features(
        (host[i:i + 128] for i in range(0, T_FRAMES, 128)), "unet")
    # served on a stream of the caller's: the decoded chunks come from the
    # prefetch thread, whose decode the caller's stream must wait for
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        s_side = pipe.stream_features(
            iter_frames(clip, chunk=128, device=dev), "unet")
    torch.cuda.synchronize()
    for a, b, what in ((f_dev, f_host, "whole"), (s_dev, s_host, "stream"),
                       (s_side, s_host, "stream on a side stream")):
        if not np.array_equal(a["_area"], b["_area"]):
            raise AssertionError(f"mjpg clip, {what}: the waveform from card "
                                 f"frames differs from host frames")
    outs = {}
    for tag, extra in (("whole", []), ("stream_128", ["--stream", "128"])):
        out_dir = tmp / tag
        cli.main(["run", str(clip), "--pipeline", "unet", "--yolo-weights",
                  "weights/demo_yolo.npz", "--unet-weights",
                  "weights/demo_unet.npz", "-o", str(out_dir), "--device",
                  str(dev), *extra])
        outs[tag] = json.loads((out_dir / "features.json").read_text())
    line["served"] = {
        "unet_bf16_whole_equal_to_host_frames": True,
        "unet_bf16_stream_128_equal_to_host_frames": True,
        "unet_bf16_stream_128_on_a_side_stream_equal": True,
        "stream_equal_to_whole": bool(np.array_equal(s_dev["_area"],
                                                     f_dev["_area"])),
        "f0": f_dev["f0"], "cli_features": outs}

    # times: the kernels at the served chunk and at MJPG_PLAIN_FRAMES frames
    # in turns with PR 13's (CUDA events), their bounds, and the plain
    # versions on the host at MJPG_PLAIN_FRAMES frames
    pr13 = pr13_jpeg_library()
    turns = mjpg_turns(dev, hold, (p64, p), pr13)
    sub = jpeg_cuda.upload(p64, dev)
    coef_sub, _ = jpeg_cuda.entropy_decode(sub)
    geo = p.geo
    entries = []
    ptx = ptxas_summary(logs.get("jpeg", ""))
    for name, pfn in (
            ("jpeg_entropy", lambda: jpeg.entropy_decode_plain(p64)),
            ("jpeg_idct_bgr",
             lambda: jpeg.idct_bgr_plain(coef_sub.cpu().numpy(), p64))):
        whole, part = turns[f"{name} T={p.t}"], turns[f"{name} T={p64.t}"]
        stem = name.split("_", 1)[1]
        entries.append({
            "name": name, "route": "cuda",
            "source": "openglottal_tpu_torch/csrc/jpeg.cu",
            "c_entry": f"og_{name}",
            "replaces": "openglottal_tpu/data/video.py:32",
            "path": "mjpg", "launches": launches[name],
            "launches_stream_128": slaunches[name],
            "device_launches_per_call": 1,
            **({"sub_bits": jpeg_cuda.SUB_BITS}
               if name == "jpeg_entropy" else {}),
            "max_abs_err": 0,
            "ms": whole["ms"], "ms_at_plain_frames": part["ms"],
            "pr13_ms": whole["pr13_ms"],
            "pr13_ms_at_plain_frames": part["pr13_ms"],
            "plain_ms": time_host(pfn, 1), "plain_frames": MJPG_PLAIN_FRAMES,
            "bound_ms": whole["bound_ms"], "bound_by": whole["bound_by"],
            "bound_ms_at_plain_frames": part["bound_ms"],
            "library_ms": None,
            "library": "n/a: no PyTorch call decodes JPEG (torchvision is "
                       "absent)",
            "shapes": [[p.t, geo.nblk, 64]],
            "ptxas": {k: v for k, v in ptx.items() if k.startswith(stem)},
            "pr13_ptxas": {k: v for k, v in pr13[1].items()
                           if k.startswith(stem)}})
    line["kernel_times"] = {e["name"]: {k: e[k] for k in (
        "ms", "ms_at_plain_frames", "pr13_ms", "pr13_ms_at_plain_frames",
        "plain_ms", "bound_ms", "bound_ms_at_plain_frames", "bound_by",
        "ptxas", "pr13_ptxas")} for e in entries}
    line["kernel_turns_with_pr13"] = turns
    # og_jpeg_entropy's subsequence length (the wrapper's SUB_BITS) against
    # shorter and longer ones, at the served chunk
    dp = jpeg_cuda.upload(p, dev)
    line["jpeg_entropy_ms_by_sub_bits"] = {
        s_: time_cuda(lambda s_=s_: jpeg_cuda.launch_entropy(dp, s_), 10)
        for s_ in (1024, 1536, 2048)}

    # the read from disk to a device tensor, and what it costs end to end:
    # the MJPG clip against the same decoded frames as a BI_RGB 24-bit AVI
    # (colour too, so the same full-frame unet route; uploaded decoded) and
    # as Y800 (one channel, unet's windowed route), in turns.  The host
    # parse (the RIFF walk, the marker parse, the unstuffing and the pack)
    # is timed alone, so its share of the MJPG read is measured.
    y800 = tmp / "clip_y800.avi"
    write_y800_avi(y800, bgr_to_gray_u8(host))
    bgr24 = tmp / "clip_bgr24.avi"      # BI_RGB: compression 0, bottom up
    write_mjpg_avi(bgr24, [np.ascontiguousarray(f[::-1]).tobytes()
                           for f in host], 256, 256, fourcc=b"\0\0\0\0")
    if not torch.equal(read_frames(bgr24, dev), frames):
        raise AssertionError("the BI_RGB clip's frames differ from the MJPG "
                             "clip's")

    def host_parse():
        for _, body, first in _pieces(clip, 512):
            jpeg.pack(body, first)

    parse_ms = [time_host(host_parse, 1) for _ in range(3)]
    clips = {"mjpg": clip, "bgr24": bgr24, "y800": y800}
    read_ms = {k: [] for k in clips}
    unet_ms = {k: [] for k in clips}
    for tag in ("mjpg", "bgr24", "y800", "y800", "bgr24", "mjpg"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = read_frames(clips[tag], dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pipe.extract_features(x, "unet")
        t2 = time.perf_counter()
        read_ms[tag].append((t1 - t0) * 1e3)
        unet_ms[tag].append((t2 - t1) * 1e3)
        del x
    line["read"] = {
        "what": "read_frames: disk -> uint8 tensor on the card, synchronised",
        "ms_per_frame": {k: min(v) / T_FRAMES for k, v in read_ms.items()},
        "mjpg_host_parse_ms_per_frame": min(parse_ms) / T_FRAMES,
        "mjpg_host_parse_share_of_read": min(parse_ms) / min(read_ms["mjpg"]),
        "unet_bf16_ms_per_frame_after_read": {
            k: min(v) / T_FRAMES for k, v in unet_ms.items()}}
    line["decode_ms_per_frame"] = min(read_ms["mjpg"]) / T_FRAMES
    line["read_ms_in_turns"] = read_ms
    line["unet_bf16_ms_in_turns"] = unet_ms
    line["host_parse_ms"] = parse_ms
    line["unet_bf16_wall_ms_in_turns"] = {
        k: [r + u for r, u in zip(read_ms[k], unet_ms[k])] for k in clips}
    line["walls_note"] = ("wall = read + unet; mjpg and bgr24 hold the same "
                          "colour frames and take unet's full-frame route; "
                          "y800 crosses one channel and takes the windowed "
                          "route")
    line["nvidia_smi"] = smi
    line["phase_seconds"] = time.perf_counter() - t_phase
    return line, entries


# ── training (ROADMAP A9): the three kernels of csrc/train.cu ───────────────

# (the kernels are held within tools/train_stress.py's TRAIN_TOL of their
# plain versions)
TRAIN_REPLACES = {
    "unet_augment": "openglottal_tpu/data/augment.py:112",
    "bce_dice": "openglottal_tpu/train/unet_trainer.py:49",
    "bce_dice_bwd": "openglottal_tpu/train/unet_trainer.py:66",
    "tal_assign": "openglottal_tpu/train/yolo_loss.py:98"}
TRAIN_C_ENTRY = {"unet_augment": "og_unet_augment", "bce_dice": "og_bce_dice",
                 "bce_dice_bwd": "og_bce_dice_bwd",
                 "tal_assign": "og_tal_assign"}


def train_runner(name, inputs, kw):
    """(kernel fn, plain fn, bytes moved, operations) of one recorded
    launch of a training kernel; both fns return a tuple of tensors whose
    integer / bool members are held exact and float members within
    TRAIN_TOL."""
    from openglottal_tpu_torch.ops import train_cuda as T

    if name == "unet_augment":
        imgs, msks, params, noise = inputs
        px = imgs.numel()
        # u8 frame and mask, the parameter rows; f32 image and mask written;
        # the f32 noise only of the samples that add it (the kernel reads
        # no other)
        noisy = int((params[:, 5] != 0).sum())
        return (lambda: T.unet_augment(imgs, msks, params, noise),
                lambda: T.unet_augment_plain(imgs, msks, params, noise),
                px * (1 + 1 + 4 + 4) + params.numel() * 4
                + noisy * (px // imgs.shape[0]) * 4, px * 60)
    if name == "bce_dice":
        logits, targets, valid = inputs
        n = logits.numel()

        def kfn():
            sums, cnt, loss = T._bce_dice_cuda(logits, targets, valid)
            return (loss, sums, cnt)

        def pfn():
            sums, cnt = T.bce_dice_sums_plain(logits, targets, valid)
            return (T._loss_from_sums(sums, cnt), sums, cnt)
        return kfn, pfn, n * 8, n * 30
    if name == "bce_dice_bwd":
        logits, targets, valid, sums, cnt, g = inputs
        n = logits.numel()
        return (lambda: (T._bce_dice_bwd_cuda(logits, targets, valid, sums,
                                              cnt, g),),
                lambda: (T.bce_dice_grad_plain(logits, targets, valid, sums,
                                               cnt, g),),
                n * 12, n * 20)
    if name != "tal_assign":
        raise AssertionError(f"{name}: not a training kernel")
    cls, pred, gt, gv, pts = inputs
    b, a = cls.shape
    m = gt.shape[1]
    return (lambda: T.tal_assign(cls, pred, gt, gv, pts),
            lambda: T.tal_assign_plain(cls, pred, gt, gv, pts),
            b * a * (4 + 16 + 4 + 1 + 4) + a * 8 + b * m * 17,
            b * m * a * (40 + 2 * 10))


def hold_train(name, got, want, max_err: dict) -> None:
    """Integer and bool outputs exactly equal, float outputs within
    TRAIN_TOL of the plain version (relative to the value for the 0-d loss
    and its sums, absolute for images and gradients scaled by their
    largest)."""
    import torch

    from openglottal_tpu_torch.tools.train_stress import TRAIN_TOL

    torch.cuda.synchronize()
    for k, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape:
            raise AssertionError(f"{name}: shape {g.shape} vs {w.shape}")
        if not g.dtype.is_floating_point or (name == "unet_augment"
                                             and k == 1):   # the mask
            if not torch.equal(g, w):
                raise AssertionError(f"{name}: {g.dtype} output differs from "
                                     f"the plain version")
            continue
        diff = float((g.double() - w.double()).abs().max()) if g.numel() \
            else 0.0
        scale = float(w.double().abs().max()) if w.numel() else 1.0
        rel = diff / max(scale, 1e-30) if name.startswith("bce") else diff
        max_err[name] = max(max_err.get(name, 0.0), rel)
        if not rel <= TRAIN_TOL[name]:
            raise AssertionError(f"{name}: kernel and plain version differ by "
                                 f"{rel} (limit {TRAIN_TOL[name]})")


def order_model(name, inputs):
    """The output of ``og_unet_augment`` / ``og_bce_dice`` /
    ``og_tal_assign`` on ``inputs`` as their models in
    ``tools/train_stress.py`` form it (the order of the augment's mean and
    the loss's sums; the TAL's selection), in the tuples of
    ``train_runner``'s kernel fns, or None for the backward."""
    from openglottal_tpu_torch.tools import train_stress as ts

    if name == "unet_augment":
        return ts.augment_model(*inputs)
    if name == "bce_dice":
        sums, cnt, loss = ts.bce_dice_model(*inputs)
        return (loss, sums, cnt)
    if name == "tal_assign":
        return ts.tal_select_model(*inputs)
    return None


def hold_train_bits(name, got, again, inputs, want) -> None:
    """A training kernel's output bit-equal to a repeat launch's, for the
    three with models to the model's, and og_tal_assign's to its plain
    version's ``want`` (the same rounded operations and selection)."""
    import torch

    from openglottal_tpu_torch.tools.train_stress import same_bits

    torch.cuda.synchronize()
    if not same_bits(got, again):
        raise AssertionError(f"{name}: a repeat launch differs in its bits")
    if name == "tal_assign" and not same_bits(got, want):
        raise AssertionError("tal_assign: differs in its bits from its plain "
                             "version")
    model = order_model(name, inputs)
    if model is not None and not same_bits(got, model):
        raise AssertionError(f"{name}: differs in its bits from its order "
                             f"model (tools/train_stress.py)")


def train_stress(dev, max_err: dict) -> tuple:
    """Each training kernel against its plain version (within TRAIN_TOL,
    masks exact), a repeat launch (bit-equal) and, for og_unet_augment,
    og_bce_dice and og_tal_assign, its model (bit-equal) on
    ``tools/train_stress.py``'s families (augment: batches of 1, 3, 16, 17
    with every flag on and off, angle, scale, blur, brightness and contrast
    extremes, black, saturated and constant frames, unaligned frames; loss:
    logits of ±40 and ±88, soft targets, masked and all-invalid rows, other
    sizes; the backward on those and on rows not a multiple of 4, logits
    one element past an allocation, one row, all-invalid masked calls; the
    TAL at 256² and 64² anchors: M = 1, 4, 8, invalid, whole-frame, edge and
    zero-area gts, fewer than 10 candidates and none, ties within and across
    gts, batches of 1 and 17).
    -> (labels, [(label, kernel name, kernel fn, plain output)])."""
    import torch

    from openglottal_tpu_torch.tools.train_stress import stress_inputs

    labels, items = [], []

    def case(label, name, inputs):
        kfn, pfn, _, _ = train_runner(name, inputs, {})
        got, want = kfn(), pfn()
        hold_train(name, got, want, max_err)
        hold_train_bits(name, got, kfn(), inputs, want)
        labels.append(label)
        items.append((label, name, kfn, want))
        return got

    g = torch.tensor(0.75, device=dev)
    for kind, label, inputs in stress_inputs(dev):
        if kind == "augment":
            case(f"unet_augment stress {label}", "unet_augment", inputs)
        elif kind == "tal":
            case(f"tal_assign stress {label}", "tal_assign", inputs)
        else:       # a loss or backward case: the forward gives the sums
            _, sums, cnt = case(f"bce_dice stress {label}", "bce_dice",
                                inputs)
            case(f"bce_dice_bwd stress {label}", "bce_dice_bwd",
                 (*inputs, sums, cnt, g))
    return labels, items


def step_profile(fn, top: int = 8) -> dict:
    """One call of fn() under torch.profiler: its wall ms, the device's
    busy ms (the sum of its kernels' and copies' times), their count, and
    the ``top`` device kernels by time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    def self_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    rows = [(e.key[:60], self_us(e) / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and self_us(e) > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_items": sum(r[2] for r in rows),
            "top": [{"kernel": k, "ms": ms, "count": n}
                    for k, ms, n in rows[:top]]}


def write_png_split(root, frames_bgr, masks, names_val: int):
    """A PNG split (images/, labels/, training.json) of BGR frames and
    {0,1} masks, written by the port's zlib PNG writer."""
    import json as _json

    from openglottal_tpu_torch.data.png import write_png

    img_dir, lbl_dir = root / "images", root / "labels"
    img_dir.mkdir(parents=True, exist_ok=True)
    lbl_dir.mkdir(parents=True, exist_ok=True)
    names = []
    for i, (f, m) in enumerate(zip(frames_bgr, masks)):
        name = f"{i:04d}.png"
        write_png(img_dir / name, f[..., ::-1], filters=(i % 5,))
        write_png(lbl_dir / name, m.astype("uint8") * 255)
        names.append(name)
    (root / "training.json").write_text(_json.dumps(
        {"training": names[:-names_val], "Val": names[-names_val:]}))
    return img_dir, lbl_dir, root / "training.json"


def train_phase(dev, smi, counted, logs, turns=None):
    """Training on the card (ROADMAP A9): the kernels against their plain
    versions, a repeat launch and their order models on stress inputs and
    on every launch of the fits; UNetTrainer and YoloTrainer at full width;
    card vs CPU; the command line.  ``turns`` (with ``--against``) takes
    [(label, kernel name, kernel fn, plain output)] of the stress cases and
    the fits' launches and returns the in-turns line's fields.  Returns
    (the "train" line, the kernels' entries)."""
    import math as _math
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from openglottal_tpu_torch import cli
    from openglottal_tpu_torch.data.synthetic import synthetic_video
    from openglottal_tpu_torch.ops import train_cuda as T
    from openglottal_tpu_torch.pipelines import GlottalPipelines
    from openglottal_tpu_torch.tools.train_stress import TRAIN_TOL
    from openglottal_tpu_torch.train import unet_trainer as ut
    from openglottal_tpu_torch.train import yolo_trainer as yt
    from openglottal_tpu_torch.utils.io import (
        load_unet_weights,
        load_weights_npz,
        load_yolo_weights,
    )

    t_phase = time.perf_counter()
    max_err: dict = {}
    # the instrumented copy of train.cu (its empty kernel of the TAL's grid
    # is the TAL's launch floor), built while the stress cases run
    from concurrent.futures import ThreadPoolExecutor

    from openglottal_tpu_torch.tools import train_cycles
    pool = ThreadPoolExecutor(1)
    copy = pool.submit(train_cycles.build_copy)
    pool.shutdown(wait=False)
    stress, stress_items = train_stress(dev, max_err)
    work = Path(tempfile.mkdtemp(prefix="og_train_", dir="."))
    line = {"nvidia_smi": smi, "stress_cases": len(stress)}
    try:
        # 64 realistic synthetic frames (+ 16 for validation), 256²
        frames, masks = synthetic_video(t=80, seed=5, realistic=True)
        gray = np.ascontiguousarray(
            (frames.astype(np.float32) @ np.float32([0.114, 0.587, 0.299])
             ).round().clip(0, 255).astype(np.uint8))
        msk = masks.astype(np.uint8)

        # ── (b) UNetTrainer.fit at full width, bf16, batch 16 ─────────────
        trainer = ut.UNetTrainer(device=dev, seed=0)
        record: list = []
        (state, best, hist), unet_counts = counted(lambda: trainer.fit(
            gray[:64], msk[:64], gray[64:], msk[64:], epochs=2,
            ckpt_dir=work / "unet", verbose=False), record)
        losses = [h["loss/train"] for h in hist]
        if not all(_math.isfinite(v) for v in losses) or losses[1] >= \
                losses[0]:
            raise AssertionError(f"UNetTrainer: train losses {losses} are not "
                                 f"finite and falling")
        if not all(_math.isfinite(h["loss/val"]) for h in hist):
            raise AssertionError(f"UNetTrainer: val losses {hist}")
        for name in ("unet_augment", "bce_dice", "bce_dice_bwd"):
            if unet_counts[name] == 0:
                raise AssertionError(f"{name} not launched by UNetTrainer.fit")
        unet_tree = load_unet_weights(work / "unet" / "best.pt")
        load_unet_weights(work / "unet" / "latest.pt")
        pipe = GlottalPipelines(unet_variables=unet_tree, device=dev)
        _, _, _, areas = pipe.run_pipeline_full(frames[:12], "unet-only")
        areas = areas.float().cpu().numpy()
        if areas.shape != (12,) or not np.isfinite(areas).all():
            raise AssertionError("the trained U-Net did not serve unet-only")
        line["unet_fit"] = {"history": hist, "launches": unet_counts,
                            "served_unet_only_areas_12": areas.tolist()}

        # ── (c) YoloTrainer.fit at YOLOv8n width: mosaic, close-mosaic ─────
        boxes = yt.boxes_from_masks(msk)
        rgb = np.ascontiguousarray(frames[..., ::-1])
        ytr = yt.YoloTrainer(device=dev, seed=0)
        (ystate, ybest, yhist), yolo_counts = counted(lambda: ytr.fit(
            rgb[:64], boxes[:64], rgb[64:], boxes[64:], epochs=2,
            close_mosaic=1, ckpt_dir=work / "yolo", verbose=False), record)
        step_losses = [v for h in yhist for v in h.pop("loss/steps")]
        if [h["mosaic"] for h in yhist] != [True, False]:
            raise AssertionError(f"YoloTrainer: mosaic schedule {yhist}")
        if not all(_math.isfinite(v) for v in step_losses) or \
                step_losses[-1] >= step_losses[0]:
            raise AssertionError(f"YoloTrainer: step losses {step_losses} "
                                 f"are not finite and falling")
        if yolo_counts["tal_assign"] != len(step_losses):
            raise AssertionError(f"tal_assign launched "
                                 f"{yolo_counts['tal_assign']} times for "
                                 f"{len(step_losses)} steps")
        yolo_tree = load_yolo_weights(work / "yolo" / "best.pt")
        load_yolo_weights(work / "yolo" / "latest.pt")
        pipe = GlottalPipelines(unet_variables=unet_tree,
                                yolo_variables=yolo_tree, conf=0.0,
                                device=dev)
        _, valid, _, yareas = pipe.run_pipeline_full(frames[:12], "unet")
        yareas = yareas.float().cpu().numpy()
        if yareas.shape != (12,) or not np.isfinite(yareas).all():
            raise AssertionError("the trained models did not serve unet")
        line["yolo_fit"] = {"history": yhist, "step_losses": step_losses,
                            "launches": yolo_counts,
                            "served_unet_valid_12": int(valid.sum()),
                            "served_unet_areas_12": yareas.tolist()}

        # ── (d) card vs CPU: one f32 U-Net step without augmentation ───────
        demo = load_weights_npz("weights/demo_unet.npz")
        x_u8 = torch.from_numpy(gray[:2])
        m_u8 = torch.from_numpy(msk[:2])
        out = {}

        def f32_step(where):
            st = ut.UNetTrainer(device=where, dtype=torch.float32
                                ).init_state(demo)
            loss = ut.unet_step(st, x_u8.to(where).float() * T.INV255.to(
                where), m_u8.to(where).float(), torch.float32)
            gn = torch.sqrt(sum((p.grad.double() ** 2).sum()
                                for p in st.model.parameters()
                                if p.grad is not None))
            return float(loss), float(gn)

        out["cpu"] = f32_step("cpu")
        out["cuda"], f32_counts = counted(lambda: f32_step("cuda"), record)
        rel_loss = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
        rel_gn = abs(out["cuda"][1] - out["cpu"][1]) / abs(out["cpu"][1])
        if rel_loss > 1e-4 or rel_gn > 1e-3:
            raise AssertionError(f"card vs CPU U-Net step: loss rel "
                                 f"{rel_loss}, grad norm rel {rel_gn}")
        line["card_vs_cpu_f32_step"] = {"loss": out, "loss_rel": rel_loss,
                                        "grad_norm_rel": rel_gn,
                                        "launches": f32_counts}

        # ── (e) the command line on a PNG split written here ──────────────
        img_dir, lbl_dir, tj = write_png_split(work / "png", frames[:24],
                                               masks[:24], 8)
        common = ["--images-dir", str(img_dir), "--labels-dir", str(lbl_dir),
                  "--training-json", str(tj), "--epochs", "1", "--batch",
                  "8", "--cache-dir", str(work / "cache")]
        t0 = time.perf_counter()
        (cli_unet, cli_crop), cli_counts = counted(lambda: (
            cli.main(["train-unet", *common, "--output-dir",
                      str(work / "cli_unet")]),
            cli.main(["train-unet-crop", *common, "--mode", "yolo",
                      "--yolo-weights", "weights/demo_yolo.npz",
                      "--output-dir", str(work / "cli_crop")])), record)
        for name in ("unet_augment", "bce_dice", "bce_dice_bwd"):
            if cli_counts[name] == 0:
                raise AssertionError(f"{name} not launched by the cli")
        if not _math.isfinite(cli_unet["best_val_loss"]):
            raise AssertionError(f"cli train-unet: {cli_unet}")
        load_unet_weights(work / "cli_unet" / "best.pt")
        load_unet_weights(work / "cli_crop" / "latest.pt")
        line["cli"] = {"train_unet": cli_unet, "train_unet_crop_yolo":
                       cli_crop, "launches": cli_counts,
                       "wall_s": time.perf_counter() - t0}

        # ── (a) every launch of (b)-(e) held against its plain version, a
        # repeat launch and (og_unet_augment, og_bce_dice) its order model ─
        per: dict = {}
        held = 0
        fit_items = []
        for k, (name, inputs, kw) in enumerate(record):
            kfn, pfn, nbytes, ops = train_runner(name, inputs, kw)
            got, want = kfn(), pfn()
            hold_train(name, got, want, max_err)
            hold_train_bits(name, got, kfn(), inputs, want)
            shape = "x".join(map(str, inputs[0].shape))
            fit_items.append((f"{name} fit {shape} #{k}", name, kfn, want))
            held += 1
            e = per.setdefault(name, {"bytes": nbytes, "ops": ops,
                                      "inputs": (inputs, kw),
                                      "shape": list(inputs[0].shape)})
            if nbytes > e["bytes"]:
                per[name] = {"bytes": nbytes, "ops": ops,
                             "inputs": (inputs, kw),
                             "shape": list(inputs[0].shape)}
        line["launches_held_equal_to_plain"] = held
        line["repeat_launches_bit_equal"] = held + len(stress)
        line["order_models_bit_equal"] = sum(
            1 for _, n, _, _ in stress_items + fit_items
            if n in ("unet_augment", "bce_dice"))
        if held != len(record):
            raise AssertionError("not every training launch was held")
        if turns is not None:
            line["against"] = turns(stress_items + fit_items)
        del fit_items, stress_items

        # ── kernel ms at the served (largest) shapes, plain ms, bounds ─────
        entries = []
        for name in ("unet_augment", "bce_dice", "bce_dice_bwd",
                     "tal_assign"):
            e = per[name]
            kfn, pfn, nbytes, ops = train_runner(name, *e["inputs"])
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / FP32_OPS_PER_S * 1e3
            path = "yolo-train" if name == "tal_assign" else "unet-train"
            entries.append({
                "name": name, "route": "cuda",
                "source": "openglottal_tpu_torch/csrc/train.cu",
                "c_entry": TRAIN_C_ENTRY[name],
                "replaces": TRAIN_REPLACES[name], "path": path,
                "launches": (yolo_counts if name == "tal_assign"
                             else unet_counts)[name],
                "max_abs_err": max_err.get(name, 0.0),
                "tolerance": TRAIN_TOL[name],
                "ms": time_cuda(kfn, 20), "plain_ms": time_cuda(pfn, 3),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None, "shape": e["shape"]})
        if "tal_assign" in per:
            # M = 1 and one gt repeated four times (all 40 rounds), and the
            # launch floor: an empty kernel of the same grid, timed alike
            cls, pred, gt, gv, pts = per["tal_assign"]["inputs"][0]
            g4 = gt[:, :1].repeat(1, 4, 1).contiguous()
            v4 = gv[:, :1].repeat(1, 4).contiguous()
            line["tal_assign_ms_m1_m4"] = [
                time_cuda(lambda: T.tal_assign(cls, pred, gt[:, :1]
                                               .contiguous(),
                                               gv[:, :1].contiguous(), pts),
                          20),
                time_cuda(lambda: T.tal_assign(cls, pred, g4, v4, pts), 20)]
            tal = next(e for e in entries if e["name"] == "tal_assign")
            floor = time_cuda(train_cycles.tal_floor(
                copy.result(), cls.shape[0], cls.shape[1], gt.shape[1]), 20)
            tal["launch_floor_ms"] = floor
            line["tal_assign_vs_floor"] = {
                "shape": {"b": cls.shape[0], "a": cls.shape[1],
                          "m": gt.shape[1]},
                "ms": tal["ms"], "bound_ms": tal["bound_ms"],
                "launch_floor_ms": floor, "ms_over_floor": tal["ms"] / floor,
                "ms_over_bound": tal["ms"] / tal["bound_ms"]}
        del record, per

        # ── (f) ms per train step, in turns ───────────────────────────────
        dev_imgs = torch.from_numpy(gray[:16]).to(dev)
        dev_msks = torch.from_numpy(msk[:16]).to(dev)
        im4 = torch.from_numpy(rgb[np.arange(64).reshape(16, 4)]).to(dev)
        bx4 = torch.from_numpy(np.where(boxes[:64] >= 0, boxes[:64], 0)
                               .reshape(16, 4, 4).astype(np.float32)).to(dev)
        vd4 = torch.from_numpy(boxes[:64, 0].reshape(16, 4) >= 0).to(dev)
        steps = {
            "unet_bf16_b16": lambda: ut.unet_train_step(
                state, dev_imgs, dev_msks, trainer.gen, torch.bfloat16),
            "unet_f32_b16": lambda: ut.unet_train_step(
                state, dev_imgs, dev_msks, trainer.gen, torch.float32),
            "yolo_mosaic_bf16_b16": lambda: yt.yolo_train_step(
                ystate, im4, bx4, vd4, ytr.gen, True, torch.bfloat16),
            "yolo_close_mosaic_bf16_b16": lambda: yt.yolo_train_step(
                ystate, im4[:, 0].contiguous(), bx4[:, 0].contiguous(),
                vd4[:, 0].contiguous(), ytr.gen, False, torch.bfloat16)}
        step_ms = {k: [] for k in steps}
        for k, fn in steps.items():
            fn()
        for turn in range(2):
            for k, fn in (steps.items() if turn == 0
                          else reversed(list(steps.items()))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
                step_ms[k].append((time.perf_counter() - t0) * 1e3 / 5)
        line["train_step_ms_in_turns"] = step_ms
        line["train_step_profile"] = {k: step_profile(fn)
                                      for k, fn in steps.items()}

    finally:
        shutil.rmtree(work, ignore_errors=True)
    line["ptxas"] = ptxas_summary(logs.get("train", ""))
    line["max_err"] = max_err
    line["phase_seconds"] = time.perf_counter() - t_phase
    return line, entries


# the self-test's training launches held against their plain versions: one
# in TRAIN_HOLD_EVERY of each training kernel's (its first, then every
# TRAIN_HOLD_EVERY-th); every launch of the other kernels
TRAIN_HOLD_EVERY = 25


class SampledRecord(list):
    """A launch record (``*_cuda.RECORD``) that keeps every launch but the
    training kernels', of which it keeps one in ``every``; the others are
    dropped before their inputs are held, so that a long fit does not keep
    every batch on the card."""

    def __init__(self, every: int):
        super().__init__()
        self.every, self.seen = every, {}

    def append(self, launch):
        name = launch[0]
        if name in TRAIN_C_ENTRY:
            k = self.seen.get(name, 0)
            self.seen[name] = k + 1
            if k % self.every:
                return
        super().append(launch)


def hold_jpeg_launch(launch, hold) -> None:
    """One recorded MJPG launch against the plain decode of its own packed
    chunk: the entropy decode's coefficients and error flags, or the IDCT
    of the coefficients it was given."""
    import torch

    from openglottal_tpu_torch.data import jpeg

    name, a, b = launch
    if name == "jpeg_entropy":
        coef, err = b
        want_coef, want_err = jpeg.entropy_decode_plain(a.host())
        hold(name, err.cpu(), torch.from_numpy(want_err))
        hold(name, coef.cpu(), torch.from_numpy(want_coef))
        return
    (coef, dp), out = a, b
    hold(name, out.cpu(), torch.from_numpy(
        jpeg.idct_bgr_plain(coef.cpu().numpy(), dp.host())))


SELFTEST_JAX = {True: "results/selftest_eval_realistic_r5.json",
                False: "results/selftest_eval_girafe.json"}
# kernels the self-test's path must launch: the trainers', the evaluation's
# counts, the gate, the int8 convolution and the in-box count
SELFTEST_KERNELS = ("unet_augment", "bce_dice", "bce_dice_bwd", "tal_assign",
                    "frame_counts", "otsu_counts", "gate_scan", "qconv",
                    "box_count")


def jax_selftest_values(realistic: bool) -> dict:
    """gate -> the value the JAX package's committed self-test artifact
    gives it (None where that artifact lacks the key: the plain form's
    holds only the evaluation table)."""
    from openglottal_tpu_torch.scripts.selftest_e2e import GATES, gate_value

    art = json.loads((Path(__file__).resolve().parent
                      / SELFTEST_JAX[realistic]).read_text())
    art = {**art.get("aggregate", {}), **art}
    out = {}
    for name in GATES:
        try:
            out[name] = gate_value(art, name)
        except (KeyError, TypeError):
            out[name] = None
    return out


def waveform_diff(out, pipe) -> dict:
    """Where the self-test's int8-full and windowed waveforms differ from
    bf16's on its first test video: frames, largest difference, and the
    bf16 detector's confidence on those frames (``pipe``: the trained
    models in bf16)."""
    import numpy as np

    from openglottal_tpu_torch.scripts.selftest_e2e import make_dataset

    w = out["waveforms"]
    frames = make_dataset(1, len(w["bf16"]), seed0=990,
                          realistic=out["realistic"])[0]
    conf = pipe.detect_video(frames)[2].float().cpu().numpy()
    diff = {}
    for route in ("int8full", "fullframe"):
        d = np.abs(np.asarray(w[route]) - np.asarray(w["bf16"]))
        at = np.nonzero(d)[0]
        diff[route] = {"frames_differing": int(len(at)),
                       "max_abs_px": float(d.max()) if len(d) else 0.0,
                       "frames": at.tolist()[:16],
                       "bf16_conf_there": conf[at].tolist()[:16]}
    diff["bf16_conf_min"] = float(conf.min())
    diff["frames_conf_below_0.5"] = int((conf < 0.5).sum())
    return diff


def selftest_phase(dev, smi, counted, hold_any, realistic: bool, work):
    """The port's end-to-end self-test (scripts/selftest_e2e.py) at its
    default epochs on the card, in ``work`` -> (its line, its result); its
    launches held against their plain versions by ``hold_any`` (the
    training kernels' sampled, SampledRecord); a failed gate, a launch that
    differs or a kernel of its path never launched raises."""
    from openglottal_tpu_torch.pipelines import GlottalPipelines
    from openglottal_tpu_torch.scripts import selftest_e2e as st
    from openglottal_tpu_torch.utils.io import (
        load_unet_weights,
        load_yolo_weights,
    )

    argv = ["--output-dir", str(work)] + (["--realistic"] if realistic else [])
    args = st.build_parser().parse_args(argv + ["--device", str(dev)])
    # (the epochs' log lines stay in the checkpoints' metrics.jsonl)
    record = SampledRecord(TRAIN_HOLD_EVERY)
    out, launches = counted(lambda: st.run_args(args, verbose=False), record)
    key = "selftest" if realistic else "selftest_plain"
    n_held = hold_any(key, record)
    del record
    out["realistic"] = realistic
    jax_vals = jax_selftest_values(realistic)
    gates = {name: {"value": st.gate_value(out["report"], name),
                    "pass": passed, "jax_artifact": jax_vals[name]}
             for name, passed in out["gates"].items()}
    pipe = GlottalPipelines(
        unet_variables=load_unet_weights(work / "unet" / "best.pt"),
        yolo_variables=load_yolo_weights(work / "yolo" / "best.pt"),
        device=dev)
    line = {"nvidia_smi": smi, "realistic": realistic, "argv": argv,
            "ok": out["ok"], "gates": gates,
            "jax_artifact": SELFTEST_JAX[realistic],
            "stage_seconds": out["stage_seconds"],
            "epochs_run": out["epochs_run"], "seconds": out["seconds"],
            "report": out["report"], "launches": launches,
            "launches_held_equal_to_plain": n_held,
            "held": (f"every launch but the training kernels', of which one "
                     f"in {TRAIN_HOLD_EVERY} (within TRAIN_TOL)"),
            "waveform_diff": waveform_diff(out, pipe)}
    say(key, **line)
    missing = [k for k in SELFTEST_KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"self-test: {missing} never launched")
    if not out["ok"]:
        raise AssertionError("self-test gates failed: " + ", ".join(
            f"{k}={v['value']}" for k, v in gates.items() if not v["pass"]))
    return line, out


# the tree the command-line phase writes: GIRAFE's four test patients (the
# self-test's test frames, 20 a patient) and one training patient, BAGLS-
# shaped pairs of mixed sizes, and Raw_Data patients whose AVIs are cuts of
# the MJPG fixture's 64 frames, each its own (first frame, frame count)
CLI_GIRAFE = ("patient57A3", "patient61", "patient63", "patient64")
CLI_BAGLS_SIZES = ((256, 256), (200, 256), (160, 256), (256, 224))
CLI_RAW = (("patient01", "Healthy", 0, 40), ("patient02", "Healthy", 5, 44),
           ("patient03", "Healthy", 10, 48), ("patient04", "Paresis", 15, 39),
           ("patient05", "Polyps", 20, 36), ("patient06", "Nodules", 25, 32))


def write_cli_tree(root, frames, masks, train_frames, train_masks):
    """GIRAFE/{Training/imagesTr,labelsTr,Raw_Data} and BAGLS/test under
    ``root``, PNGs by ``data/png.write_png``; the split by the port's
    ``prepare_girafe_splits``.  Returns the paths."""
    from openglottal_tpu_torch.data.png import write_png
    from openglottal_tpu_torch.scripts import prepare_girafe_splits
    from openglottal_tpu_torch.tools.jpeg_stress import (
        jpeg_frames_of,
        write_mjpg_avi,
    )

    img_dir = root / "GIRAFE" / "Training" / "imagesTr"
    lbl_dir = root / "GIRAFE" / "Training" / "labelsTr"
    raw = root / "GIRAFE" / "Raw_Data"
    bagls = root / "BAGLS" / "test"
    for d in (img_dir, lbl_dir, raw, bagls):
        d.mkdir(parents=True, exist_ok=True)
    per = len(frames) // len(CLI_GIRAFE)
    named = [(f"{p}_{k:03d}.png", frames[i * per + k], masks[i * per + k])
             for i, p in enumerate(CLI_GIRAFE) for k in range(per)]
    named += [(f"patient01_{k:03d}.png", f, m)
              for k, (f, m) in enumerate(zip(train_frames, train_masks))]
    for name, f, m in named:
        write_png(img_dir / name, f[..., ::-1])
        write_png(lbl_dir / name, m.astype("uint8") * 255)
    split = root / "training.json"
    prepare_girafe_splits.main(["--images-dir", str(img_dir),
                                "--output", str(split)])
    real = jpeg_frames_of(MJPG_DIR / MJPG_REAL)
    for name, status, first, count in CLI_RAW:
        (raw / name).mkdir()
        write_mjpg_avi(raw / name / f"{name}.avi", real[first:first + count],
                       256, 256)
        (raw / name / "metadata.json").write_text(
            json.dumps({"disorder status": status}))
    for i, (f, m) in enumerate(zip(frames[::5], masks[::5])):
        h, w = CLI_BAGLS_SIZES[i % len(CLI_BAGLS_SIZES)]
        write_png(bagls / f"{i}.png", f[:h, :w, ::-1])
        write_png(bagls / f"{i}_seg.png", m[:h, :w].astype("uint8") * 255)
    return img_dir, lbl_dir, raw, bagls, split


def eval_cli_phase(dev, smi, counted, hold_any, work, st_out) -> dict:
    """eval-girafe, eval-bagls, sweep-bagls and analyze-gaw through the
    port's command line on the card with the self-test's ``best.pt``
    checkpoints (in ``work``), on a tree written here -> the line.  Every
    launch is held against its plain version (``hold_any``); the U-Net-only
    Dice of each GIRAFE frame within EVAL_CARD_VS_CPU_TOL of the self-test's
    own evaluation of it; each analyze-gaw record equal to its patient's
    clip served alone, and each Mann-Whitney p finite where the feature's
    values are not all tied."""
    import numpy as np
    import torch

    from openglottal_tpu_torch import cli
    from openglottal_tpu_torch.scripts.selftest_e2e import make_dataset

    frames, masks, _ = make_dataset(2, 40, seed0=990, realistic=True)
    tr_f, tr_m, _ = make_dataset(1, 4, seed0=900, realistic=True)
    img_dir, lbl_dir, raw, bagls, split = write_cli_tree(
        work / "tree", frames, masks, tr_f, tr_m)
    w = {k: str(work / sub / "best.pt") for k, sub in (
        ("unet", "unet"), ("crop", "unet_crop"), ("yolo", "yolo"))}
    weights = ["--unet-weights", w["unet"], "--yolo-weights", w["yolo"]]
    runs = {
        "eval-girafe": ["--images-dir", str(img_dir), "--labels-dir",
                        str(lbl_dir), "--training-json", str(split),
                        "--raw-data-dir", str(raw), "--crop-weights",
                        w["crop"], "--output-json",
                        str(work / "out" / "girafe.json")],
        "eval-bagls": ["--test-dir", str(bagls), "--crop-weights", w["crop"],
                       "--crop-pad", "8", "--output-json",
                       str(work / "out" / "bagls.json")],
        "sweep-bagls": ["--test-dir", str(bagls), "--crop-weights",
                        w["crop"], "--output-json",
                        str(work / "out" / "sweep.json")],
        "analyze-gaw": ["--raw-data-dir", str(raw), "--output-dir",
                        str(work / "out" / "gaw")],
    }
    line = {"nvidia_smi": smi, "tree": {
        "girafe_test_frames": len(frames), "bagls_test_pairs": len(
            list(bagls.glob("*_seg.png"))), "raw_data_patients": len(CLI_RAW),
        "raw_avi": f"tests/data/mjpg/{MJPG_REAL}"}}
    results = {}
    record: list = []
    for cmd, argv in runs.items():
        t0 = time.perf_counter()
        out, launches = counted(lambda: cli.main([cmd, *argv, *weights]),
                                record)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        results[cmd] = out
        if cmd == "eval-girafe":
            rows = {p: {k: r[k] for k in ("dice", "iou", "dice50",
                                          "det_recall", "n_frames")}
                    for p, r in out["aggregate"].items()}
        elif cmd == "eval-bagls":
            rows = {p: {"dice": float(np.mean(r["dice"])),
                        "iou": float(np.mean(r["iou"])), "n_frames": len(
                            r["dice"])}
                    for p, r in out.items() if p != "det_stats"}
            rows["det_stats"] = out["det_stats"]
        elif cmd == "sweep-bagls":
            rows = {str(r["tau"]): {"det_recall": r["det_recall"],
                                    "crop_dice": r["crop"]["dice"],
                                    "full_dice": r["full"]["dice"]}
                    for r in out["sweep"]}
        else:
            rows = {r["patient"]: {k: r[k] for k in ("status", "area_mean",
                                                    "f0", "periodicity")}
                    for r in out["records"]}
            rows["stats"] = out["stats"]
            rows["boxplot_written"] = (work / "out" / "gaw" /
                                       "gaw_boxplots.png").exists()
        line[cmd] = {"rows": rows, "wall_s": wall, "launches": {
            k: v for k, v in launches.items() if v}}

    # checks: every Dice finite in [0, 1], the row counts, and the GIRAFE
    # frames' U-Net-only Dice against the self-test's evaluation
    g = results["eval-girafe"]["aggregate"]
    if g["unet-only"]["n_frames"] != len(frames):
        raise AssertionError(f"eval-girafe: {g['unet-only']['n_frames']} "
                             f"frames, not {len(frames)}")
    for cmd in ("eval-girafe", "eval-bagls"):
        vals = ([d for r in g.values() for d in r["dices"]]
                if cmd == "eval-girafe" else
                [d for p, r in results[cmd].items() if p != "det_stats"
                 for d in r["dice"]])
        if not all(0.0 <= d <= 1.0 for d in vals):
            raise AssertionError(f"{cmd}: a Dice outside [0, 1]")
    mine = np.asarray(g["unet-only"]["dices"])
    ref = np.concatenate([st_out["per_patient"][f"synth{k}"]["unet-only"]
                          ["dice"] for k in range(2)])
    line["eval-girafe"]["unet_only_vs_selftest_max_abs"] = float(
        np.abs(mine - ref).max())
    if np.abs(mine - ref).max() > EVAL_CARD_VS_CPU_TOL:
        raise AssertionError("eval-girafe U-Net-only Dice differs from the "
                             "self-test's evaluation of the same frames")
    line["launches_held_equal_to_plain"] = hold_any("eval_cli", record)
    del record
    line["analyze-gaw"]["checks"] = gaw_checks(dev, results["analyze-gaw"],
                                               raw, w)
    if len(results["sweep-bagls"]["sweep"]) != 8:
        raise AssertionError("sweep-bagls: not every tau swept")
    say("eval_cli", **line)
    return line


def gaw_checks(dev, gaw, raw, w) -> dict:
    """analyze-gaw's records against each patient's clip served alone (the
    port's reader and ``yolo_unet_areas``, no prefetch, no deferred read):
    equal features, one record a patient, the records all different (each
    clip is its own cut); and each Mann-Whitney p finite unless every value
    of its feature is tied (a feature with fewer than 3 values in a group
    is not tested, as in the JAX script; area_mean always is).  Raises on a
    miss; returns what it checked."""
    import math as _math

    from openglottal_tpu_torch.data.video import read_frames
    from openglottal_tpu_torch.features import kinematic_features
    from openglottal_tpu_torch.pipelines import GlottalPipelines
    from openglottal_tpu_torch.scripts.analyze_gaw import (
        CAPTURE_FPS,
        FEATURES,
    )
    from openglottal_tpu_torch.utils.io import (
        load_unet_weights,
        load_yolo_weights,
    )

    recs = {r["patient"]: r for r in gaw["records"]}
    if sorted(recs) != sorted(n for n, *_ in CLI_RAW):
        raise AssertionError(f"analyze-gaw: records for {sorted(recs)}")
    pipe = GlottalPipelines(unet_variables=load_unet_weights(w["unet"]),
                            yolo_variables=load_yolo_weights(w["yolo"]),
                            device=dev)
    for name, status, _, count in CLI_RAW:
        frames = read_frames(raw / name / f"{name}.avi", device=dev)
        if len(frames) != count:
            raise AssertionError(f"{name}: {len(frames)} frames read")
        feats = kinematic_features(pipe.yolo_unet_areas(frames))
        if feats["f0"] is not None:
            feats["f0"] = feats["f0"] * CAPTURE_FPS
        alone = {k: feats[k] for k in FEATURES}
        got = {k: recs[name][k] for k in FEATURES}
        if got != alone or recs[name]["status"] != status:
            raise AssertionError(f"analyze-gaw {name}: {got} / "
                                 f"{recs[name]['status']}, served alone "
                                 f"{alone} / {status}")
    rows = [tuple(r[k] for k in FEATURES) for r in recs.values()]
    if len(set(rows)) != len(rows):
        raise AssertionError("analyze-gaw: two patients' records are equal")
    tied = [f for f in FEATURES if len({r[f] for r in recs.values()}) == 1]
    for feat, st_ in gaw["stats"].items():
        if feat not in tied and not _math.isfinite(st_["p"]):
            raise AssertionError(f"analyze-gaw: p of {feat} is {st_['p']}")
    if "area_mean" not in gaw["stats"]:
        raise AssertionError("analyze-gaw: no test of area_mean")
    return {"records_equal_to_each_clip_alone": len(recs),
            "records_distinct": True, "features_tied": tied,
            "p": {k: v["p"] for k, v in gaw["stats"].items()}}


def selftests(dev, smi, counted, hold_any) -> None:
    """The self-test with --realistic, the evaluation commands on its
    checkpoints, then the plain self-test; each in a temporary directory
    outside the checkout, removed after."""
    import shutil
    import tempfile

    for realistic in (True, False):
        work = Path(tempfile.mkdtemp(prefix="og_selftest_"))
        try:
            _, out = selftest_phase(dev, smi, counted, hold_any, realistic,
                                    work)
            if realistic:
                eval_cli_phase(dev, smi, counted, hold_any, work, out)
        finally:
            shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from openglottal_tpu_torch.data.synthetic import (
        blob_stress_masks,
        gate_stress_sequence,
        synthetic_video,
        thresh_stress_sequence,
    )
    from openglottal_tpu_torch.models import gate as gate_mod
    from openglottal_tpu_torch.models import tracker as tracker_mod
    from openglottal_tpu_torch.ops import (
        _build,
        areas_cuda,
        blobs,
        blobs_cuda,
        eval_cuda,
        jpeg_cuda,
        qconv_cuda,
        scan_cuda,
        train_cuda,
    )
    from openglottal_tpu_torch.ops.blur import gaussian_blur
    from openglottal_tpu_torch.pipelines import GlottalPipelines

    args = sys.argv[1:]
    kernels_only = "--kernels-only" in args
    blobs_only = "--blobs" in args
    against = args[args.index("--against") + 1:] if "--against" in args else []
    if "--against" in args and not against:
        print("chip_smoke: --against needs at least one directory",
              file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), nvidia_smi=smi)

    # ── build ───────────────────────────────────────────────────────────
    t0 = time.perf_counter()
    logs = _build.build_all(("-Xptxas", "-v"))
    say("build", seconds=round(time.perf_counter() - t0, 2),
        sources=[f"openglottal_tpu_torch/csrc/{n}.cu" for n in _build.SOURCES],
        ptxas={n: ptxas_summary(log) for n, log in logs.items()})

    if "--qconv" in args:
        # og_qconv alone: the stress cases, then every U-Net layer shape in
        # turns with PR 10's kernel
        def hold_equal(name, got, want):
            if not torch.equal(got, want):
                raise AssertionError(f"{name}: differs from its plain version")

        labels, silu = qconv_stress(dev, hold_equal)
        pr10_lib, pr10_ptxas = pr10_qconv_library()
        rows = quant_layer_times(dev, pr10_lib=pr10_lib)
        say("qconv", nvidia_smi=smi, stress_cases=len(labels),
            silu_equal_to_plain_on_cpu=len(silu), pr10_ptxas=pr10_ptxas,
            layers_128_frames=rows, chunk_sum_17_layers_ms={
                k: sum(r[k] for r in rows[:len(QCONV_UNET)])
                for k in ("ms", "pr10_ms", "bound_ms", "cudnn_bf16_ms")})
        return 0

    # the form the union-find takes (labelling or fixpoint), where it keeps
    # its grids, and how many of its blocks share an SM, at each shape a
    # launch below takes (one rule in blobs.cu decides the form of every
    # entry point; og_layout reads it)
    lib = _build.load("blobs")
    lib.og_layout.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.og_layout.restype = ctypes.c_int

    def layout_of(h, w, t=1 << 30, init=False):
        """og_layout of a launch of t frames of h x w (with or without an
        init grid); raises on a CUDA error."""
        out = (ctypes.c_longlong * 7)()
        err = lib.og_layout(t, h, w, int(init), out)
        if err != 0 or out[6] <= 0:
            raise AssertionError(f"og_layout({t}, {h}, {w}, {init}): error "
                                 f"{err}, blocks per SM {out[6]}")
        return {"form": "labelling" if out[2] else "fixpoint",
                "smem_bytes": out[0], "scratch_bytes": out[1],
                "frames_per_block": out[2], "warps_per_frame": out[3],
                "threads_per_block": out[4], "blocks": out[5],
                "blocks_per_sm": out[6]}

    # the widest frame of 215 columns whose grids fit shared memory, and one
    # row more (the first that takes the device-memory layout)
    w_edge = 215
    h_fit = max(h for h in range(1, 1024)
                if layout_of(h, w_edge)["smem_bytes"] > 0)
    # (entry point, T, H, W, init) of every launch the served paths make
    path_shapes = (("dual_cc_batch", 500, 128, 128, False),
                   ("dual_cc_batch cohort", 2757, 128, 128, False),
                   ("dual_min_prop_batch", 500, 128, 128, True),
                   ("min_prop_batch", 500, 128, 128, True),
                   ("min_prop_batch", 502, 48, 40, True),
                   ("cc_batch", 502, 48, 40, False), ("cc", 1, 48, 40, False))
    stress_shapes = [(128, 128), (256, 256), (100, 140), (h_fit, w_edge),
                     (h_fit + 1, w_edge)]
    say("occupancy",
        path_shapes={f"{k} {t}x{h}x{w}": layout_of(h, w, t, init)
                     for k, t, h, w, init in path_shapes},
        stress_shapes={f"{t}x{h}x{w}{' init' if init else ''}":
                       layout_of(h, w, t, init)
                       for h, w in stress_shapes for t in (1, 8)
                       for init in (False, True)},
        blob_stress_shapes={f"{t}x{h}x{w}": layout_of(h, w, t)
                            for t, h, w in blob_stress_shapes()})

    def counts() -> dict:
        return {**blobs_cuda.LAUNCHES, **scan_cuda.LAUNCHES,
                **areas_cuda.LAUNCHES, **qconv_cuda.LAUNCHES,
                **eval_cuda.LAUNCHES, **jpeg_cuda.LAUNCHES,
                **train_cuda.LAUNCHES}

    def reset_counts() -> None:
        blobs_cuda.reset_launch_counts()
        scan_cuda.reset_launch_counts()
        areas_cuda.reset_launch_counts()
        qconv_cuda.reset_launch_counts()
        eval_cuda.reset_launch_counts()
        jpeg_cuda.reset_launch_counts()
        train_cuda.reset_launch_counts()

    # ── kernels vs plain versions on stress inputs (exact) ──────────────
    max_err = {k: 0 for k in counts()}

    def hold(name, got, want):
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise AssertionError(f"{name}: shape {got.shape} vs {want.shape}")
        err = int((got.long() - want.long()).abs().max())
        max_err[name] = max(max_err[name], err)
        if err != 0:
            raise AssertionError(f"{name}: kernel and plain version differ "
                                 f"(max abs diff {err})")

    def unaligned(x, by):
        """x copied to an address ``by`` elements past a fresh allocation."""
        return torch.empty(x.numel() + by, dtype=x.dtype, device=dev
                           )[by:].view(x.shape).copy_(x)

    def counted(fn, record=None):
        """fn() with every launch count set to 0 just before and read just
        after; launches are also recorded into ``record`` when given."""
        blobs_cuda.RECORD = scan_cuda.RECORD = areas_cuda.RECORD = record
        qconv_cuda.RECORD = eval_cuda.RECORD = jpeg_cuda.RECORD = record
        train_cuda.RECORD = record
        reset_counts()
        try:
            out = fn()
            return out, counts()
        finally:
            blobs_cuda.RECORD = scan_cuda.RECORD = areas_cuda.RECORD = None
            qconv_cuda.RECORD = eval_cuda.RECORD = jpeg_cuda.RECORD = None
            train_cuda.RECORD = None

    def host_syncs(fn):
        """(count, sites) of the host synchronisations one call of fn()
        makes, by PyTorch's sync debug mode."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        # (switching the debug mode on warns once itself, from torch/cuda)
        hits = [w for w in caught if "synchroniz" in str(w.message)
                and not w.filename.endswith("torch/cuda/__init__.py")]
        return len(hits), sorted(
            {f"{'/'.join(w.filename.split('/')[-2:])}:{w.lineno}" for w in hits})

    def device_kernels(fn):
        """{name: count} of the device work (kernels, copies, fills) that one
        call of fn() runs, by torch.profiler."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if (getattr(e, "device_time_total", 0) > 0
                    and e.device_type == torch.autograd.DeviceType.CUDA):
                out[e.key[:72]] = out.get(e.key[:72], 0) + e.count
        return out


    def links(code):
        """Neighbour links this input makes the union-find test and join:
        pairs of equal non-zero code (left, up; both diagonals for code 1),
        plus one root chase per active pixel."""
        c = code
        n = int(((c[:, :, 1:] == c[:, :, :-1]) & (c[:, :, 1:] != 0)).sum())
        n += int(((c[:, 1:] == c[:, :-1]) & (c[:, 1:] != 0)).sum())
        n += int(((c[:, 1:, 1:] == c[:, :-1, :-1]) & (c[:, 1:, 1:] == 1)).sum())
        n += int(((c[:, 1:, :-1] == c[:, :-1, 1:]) & (c[:, 1:, :-1] == 1)).sum())
        return n + int((c != 0).sum())

    def region_code(region, conn):
        return region.to(torch.uint8) * (1 if conn == 8 else 2)

    def runners(name, inputs, kw):
        """(kernel fn, plain fn, bytes moved, operations) for one launch."""
        if name == "qconv":
            return qconv_runner(inputs, kw)
        if name in eval_cuda.LAUNCHES:
            return eval_runner(name, inputs, kw)
        if name == "dual_cc_batch":
            (code,) = inputs
            px = code.numel()
            return (lambda: blobs_cuda.dual_cc_batch(code),
                    lambda: blobs_cuda.dual_cc_plain(code), px * 5, links(code))
        if name == "dual_min_prop_batch":
            code, init = inputs
            px = code.numel()
            return (lambda: blobs_cuda.dual_min_prop_batch(code, init),
                    lambda: blobs_cuda.dual_min_prop_plain(code, init),
                    px * 9, links(code) + px)
        if name == "min_prop_batch":
            region, init = inputs
            conn = kw["connectivity"]
            px = region.numel()
            return (lambda: blobs_cuda.min_prop_batch(region, init, conn),
                    lambda: blobs_cuda.min_prop_plain(region, init, conn),
                    px * 9, links(region_code(region, conn)) + px)
        if name == "cc_batch":
            (region,) = inputs
            conn = kw["connectivity"]
            return (lambda: blobs_cuda.cc_batch(region, conn),
                    lambda: blobs_cuda.cc_plain(region, conn),
                    region.numel() * 5, links(region_code(region, conn)))
        if name == "cc":
            (region,) = inputs
            conn = kw["connectivity"]
            return (lambda: blobs_cuda.cc(region, conn),
                    lambda: blobs_cuda.cc_plain(region[None], conn)[0],
                    region.numel() * 5,
                    links(region_code(region[None], conn)))
        if name == "gate_scan":
            has, raw = inputs
            n = has.numel()
            args = (kw["frame_h"], kw["frame_w"], kw["params"])
            nbytes, ops = n * (1 + 16 + 1 + 16), n * 40
            if not bool(kw["state"].any()):         # from the initial state
                return (lambda: gate_mod.gate_scan(has, raw, *args),
                        lambda: gate_mod.gate_scan(has, raw, *args,
                                                   use_plain=True),
                        nbytes, ops)
            # from the carry the launch started from (a chunk of unet's
            # carried gate starts where the one before ended)
            st = gate_mod.state_from_buffer(kw["state"])
            return (lambda: gate_mod.gate_scan_carry(st, has, raw, *args)[1],
                    lambda: gate_mod.gate_scan_carry(st, has, raw, *args,
                                                     use_plain=True)[1],
                    nbytes, ops)
        if name == "box_count":
            # a table of chunks (one on the per-video routes); bytes: the
            # in-box elements of every x (all the count must read), valid,
            # boxes and the output; one compare and one add each
            chunks = tuple(c._replace(out=None) for c in inputs)
            thr = kw["thr"]
            inbox = sum(int(areas_cuda.box_count_plain(
                c.x, float("-inf"), c.valid, c.boxes, c.oy, c.ox).sum())
                for c in chunks)
            n = sum(c.x.shape[0] for c in chunks)
            return (lambda: tuple(areas_cuda.box_count_table(chunks, thr)),
                    lambda: tuple(areas_cuda.box_count_table(
                        chunks, thr, use_plain=True)),
                    inbox * chunks[0].x.element_size() + n * (1 + 16 + 4),
                    2 * inbox)
        if name == "gate_scan_batch":
            has, raw = inputs
            off = kw["offsets"]
            args = (kw["frame_h"], kw["frame_w"], kw["params"])
            st = kw["state"]
            n, k_ = has.numel(), len(off) - 1
            nbytes, ops = n * (1 + 16 + 1 + 16) + k_ * 48, n * 40
            if not bool(st.any()):                  # from the initial states
                return (lambda: gate_mod.gate_scan_batch(has, raw, off, *args),
                        lambda: gate_mod.gate_scan_batch(has, raw, off, *args,
                                                         use_plain=True),
                        nbytes, ops)
            return (lambda: gate_mod.gate_scan_batch(has, raw, off, *args,
                                                     state=st.clone()),
                    lambda: gate_mod.gate_scan_batch(has, raw, off, *args,
                                                     state=st.clone(),
                                                     use_plain=True),
                    nbytes, ops)
        if name == "thresh_chain_batch":
            th0, cur, npx, act = inputs
            off, beta = kw["offsets"], kw["beta"]
            n = cur.numel()
            return (lambda: tracker_mod.thresh_chain_batch(th0, cur, npx, act,
                                                           off, beta),
                    lambda: tracker_mod.thresh_chain_batch(
                        th0, cur, npx, act, off, beta, use_plain=True),
                    n * (4 + 4 + 1 + 4) + 4 * (len(off) - 1), n * 4)
        if name == "motion_map":
            p0, fr, l0, act = inputs
            args = (p0, fr, l0, act, kw["alpha"], kw["ksize"])
            # per pixel-step: the subtract, 2K products and 2K - 2 sums of
            # the blur, alpha*d and the fma (2); the frames read once, the
            # maps written once, prev0 and lmap0 read once
            return (lambda: tracker_mod.motion_map(*args),
                    lambda: tracker_mod.motion_map(*args, use_plain=True),
                    fr.numel() * 8 + p0.numel() * 8 + act.numel(),
                    fr.numel() * (4 * kw["ksize"] + 2))
        th0, cur, npx, act = inputs
        n = cur.numel()
        return (lambda: tracker_mod._thresh_chain(th0, cur, npx, act, kw["beta"]),
                lambda: tracker_mod._thresh_chain(th0, cur, npx, act, kw["beta"],
                                                  use_plain=True),
                n * (4 + 4 + 1 + 4) + 4, n * 4)

    held = {}          # path -> launches held against their plain versions

    def hold_record(key, record):
        """Every launch of a recorded run held equal to its plain version
        on the run's own inputs."""
        for name, inputs, kw in record:
            kfn, pfn, _, _ = runners(name, inputs, kw)
            got, want = kfn(), pfn()
            if isinstance(got, tuple):
                for g, w_ in zip(got, want):
                    hold(name, g, w_)
            elif got.dtype.is_floating_point:
                hold(name, got.view(torch.int32), want.view(torch.int32))
            else:
                hold(name, got, want)
            held[key] = held.get(key, 0) + 1
        if held.get(key, 0) != len(record):
            raise AssertionError(f"{key}: not every launch was held")

    train_err: dict = {}     # the self-test's training launches: worst gap

    def hold_any(key, record) -> int:
        """:func:`hold_record` of a record that also holds training launches
        (within TRAIN_TOL, ``hold_train``) and MJPG launches (exact, on the
        plain decode of their chunk) -> the launches held under ``key``."""
        train = [r for r in record if r[0] in TRAIN_C_ENTRY]
        mjpg = [r for r in record if r[0].startswith("jpeg_")]
        hold_record(key, [r for r in record if r[0] not in TRAIN_C_ENTRY
                          and not r[0].startswith("jpeg_")])
        for name, inputs, kw in train:
            kfn, pfn, _, _ = train_runner(name, inputs, kw)
            hold_train(name, kfn(), pfn(), train_err)
        for launch in mjpg:
            hold_jpeg_launch(launch, hold)
        held[key] = held.get(key, 0) + len(train) + len(mjpg)
        if held[key] != len(record):
            raise AssertionError(f"{key}: not every launch was held")
        return held[key]

    # ── other checkouts' kernels through this checkout's wrappers ───────
    @contextlib.contextmanager
    def kernel_libraries(libs):
        """The wrappers launch the kernels of ``libs`` ({source: library},
        the same C interfaces) inside the block."""
        saved = {n: _build._libs[n] for n in libs}
        _build._libs.update(libs)
        blobs_cuda._configured = scan_cuda._configured = False
        areas_cuda._configured = eval_cuda._configured = False
        train_cuda._configured = False
        try:
            yield
        finally:
            _build._libs.update(saved)
            blobs_cuda._configured = scan_cuda._configured = False
            areas_cuda._configured = eval_cuda._configured = False
            train_cuda._configured = False

    def identical(got, want):
        """Exact equality of a kernel's output(s), floats by their bits."""
        if isinstance(got, tuple):
            return all(identical(g, w_) for g, w_ in zip(got, want))
        if got.dtype.is_floating_point:
            got, want = got.view(torch.int32), want.view(torch.int32)
        return torch.equal(got, want)

    built_against = {}

    def against_libraries():
        """{tag: {source: library}} of this checkout and of every --against
        checkout (built once, all nvcc processes started together), and the
        builds with their compiler output."""
        # (an older checkout may lack a later source; this checkout's
        # library then serves its wrappers)
        if not built_against:
            built_against["built"] = _build.build_others(
                {f"{src}_against{i}":
                 Path(d) / f"openglottal_tpu_torch/csrc/{src}.cu"
                 for i, d in enumerate(against) for src in _build.SOURCES
                 if (Path(d) / f"openglottal_tpu_torch/csrc/{src}.cu"
                     ).exists()},
                ("-Xptxas", "-v"))
        built = built_against["built"]
        return ({"this": {src: _build.load(src) for src in _build.SOURCES},
                 **{d: {src: built[f"{src}_against{i}"][0]
                        for src in _build.SOURCES
                        if f"{src}_against{i}" in built}
                    for i, d in enumerate(against)}}, built)

    def train_against(items) -> dict:
        """The training kernels of this checkout and of every --against
        checkout on the same inputs, through this checkout's wrappers: each
        checkout's output bit-identical to this checkout's and within
        TRAIN_TOL of the plain version (masks exact), then timed in turns
        (this, a, a, this; a checkout's ``ms`` is the mean of its turns).
        items: (label, kernel name, kernel fn, plain output)."""
        libs, built = against_libraries()
        order = [*libs, *reversed(libs)]
        first, err = {}, {}
        each = {label: {tag: [] for tag in libs} for label, *_ in items}
        for tag in order:
            with kernel_libraries(libs[tag]):
                for label, name, kfn, want in items:
                    if not each[label][tag]:
                        got = kfn()
                        hold_train(name, got, want, err)
                        if label not in first:
                            first[label] = got
                        elif not identical(got, first[label]):
                            raise AssertionError(
                                f"{tag}: {label} differs in its bits from "
                                f"this checkout's kernel")
                    each[label][tag].append(time_cuda(kfn, 20))
        mean = {label: {t: sum(v) / len(v) for t, v in by.items()}
                for label, by in each.items()}
        groups = {}
        for label, name, _, _ in items:
            g = groups.setdefault(f"{name} {label.split()[1]}",
                                  {t: [] for t in libs})
            for tag, v in mean[label].items():
                g[tag].append(v)
        return {"order": order, "timing": TIMING, "items": len(items),
                "compared": "every checkout's output bit-identical to this "
                "checkout's; within TRAIN_TOL of the plain version, masks "
                "exact", "max_err_vs_plain": err,
                "ptxas": {d: ptxas_summary(built[f"train_against{i}"][1])
                          for i, d in enumerate(against)
                          if f"train_against{i}" in built},
                "ms_mean_over_items": {
                    k: {t: sum(v) / len(v) for t, v in g.items()}
                    for k, g in groups.items()},
                "ms_each_item": mean}

    train_turns = train_against if against else None

    if "--train" in args:
        # the training phase alone: its kernels, both trainers, the CLI
        train_line, train_entries = train_phase(dev, smi, counted, logs,
                                                train_turns)
        say("train", compared="masks, best_gt and assigned exact; floats "
            "within TRAIN_TOL of the plain version; og_tal_assign "
            "bit-equal to it", **train_line)
        print(json.dumps({"kernels": train_entries, "timing": TIMING}),
              flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if "--selftest" in args:
        # the self-test (realistic, then plain) and the commands alone
        selftests(dev, smi, counted, hold_any)
        say("selftest_holds", launches_held=held,
            selftest_training_max_err=train_err)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if "--mjpg" in args:
        # the MJPG read path alone: its stress streams, fixtures and clip
        mjpg_line, mjpg_entries = mjpg_phase(
            dev, GlottalPipelines(dtype=torch.bfloat16, **MJPG_WEIGHTS), hold,
            counted, host_syncs, device_kernels, smi, logs)
        say("mjpg", compared="exact equality with the plain version, every "
            "stress stream and every recorded launch", **mjpg_line)
        print(json.dumps({"kernels": mjpg_entries, "timing": TIMING}),
              flush=True)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    rng = np.random.default_rng(0)
    stress = []
    first_batch = []     # index of each shape's first batch in ``stress``
    # (8,128,128) shared-memory path, (4,256,256) device-memory path,
    # (3,100,140) ragged, then the last frame size that fits shared memory
    # and one row more; all 14 stress masks are cycled through each shape
    for n, (h, w) in zip((8, 4, 3, 7, 7), stress_shapes):
        first_batch.append(len(stress))
        pool = blob_stress_masks(h, w, seed=13)
        for i in range(0, len(pool), n):
            m = pool[i:i + n]
            if len(m) < n:
                m = np.concatenate([m, pool[:n - len(m)]])
            stress.append(m)
    for m_np in stress:
        t, h, w = m_np.shape
        masks = torch.from_numpy(m_np).to(dev)
        init = torch.from_numpy(
            rng.integers(0, h * w + 1, (t, h, w)).astype(np.int32)).to(dev)
        code = (2 - masks.to(torch.uint8))
        code3 = torch.from_numpy(
            rng.integers(0, 3, (t, h, w)).astype(np.uint8)).to(dev)
        for cd in (code, code3):
            got = blobs_cuda.dual_cc_batch(cd)
            hold("dual_cc_batch", got, blobs_cuda.dual_cc_plain(cd))
            # equals two single-region runs through the single-region kernel
            idx = torch.arange(h * w, dtype=torch.int32, device=dev
                               ).view(1, h, w).expand(t, -1, -1).contiguous()
            two = torch.where(cd == 1,
                              blobs_cuda.min_prop_batch(cd == 1, idx, 8),
                              blobs_cuda.min_prop_batch(cd == 2, idx, 4))
            hold("dual_cc_batch", got, two)
            got = blobs_cuda.dual_min_prop_batch(cd, init)
            hold("dual_min_prop_batch", got,
                 blobs_cuda.dual_min_prop_plain(cd, init))
            two = torch.where(cd == 1,
                              blobs_cuda.min_prop_batch(cd == 1, init, 8),
                              blobs_cuda.min_prop_batch(cd == 2, init, 4))
            hold("dual_min_prop_batch", got, two)
        for conn in (4, 8):
            hold("min_prop_batch", blobs_cuda.min_prop_batch(masks, init, conn),
                 blobs_cuda.min_prop_plain(masks, init, conn))
            # plain labelling: the whole stack in one launch, and frame by
            # frame through the single-frame entry point
            want = blobs_cuda.cc_plain(masks, conn)
            hold("cc_batch", blobs_cuda.cc_batch(masks, conn), want)
            for i in range(t):
                hold("cc", blobs_cuda.cc(masks[i], conn), want[i])
        for cd in (code, code3):
            # the dual kernel equals the single-region kernel region by region
            hold("cc_batch",
                 torch.where(cd == 1, blobs_cuda.cc_batch(cd == 1, 8),
                             blobs_cuda.cc_batch(cd == 2, 4)),
                 blobs_cuda.dual_cc_batch(cd))
    # the one-thread scans on random sequences (hold / expiry / drift clamp)
    for seed in range(4):
        r = np.random.default_rng(seed)
        n = 700
        has = torch.from_numpy(r.random(n) > 0.3).to(dev)
        c = np.cumsum(r.normal(0, 14, (n, 2)), 0) % 256
        wh = r.uniform(8, 60, (n, 2))
        x1y1 = np.clip(c - wh / 2, 0, 255)
        raw = torch.from_numpy(
            np.concatenate([x1y1, x1y1 + wh], 1).astype(np.float32)).to(dev)
        kv, kb = gate_mod.gate_scan(has, raw, 256, 256)
        pv, pb = gate_mod.gate_scan(has, raw, 256, 256, use_plain=True)
        hold("gate_scan", kv, pv)
        hold("gate_scan", kb, pb)
        cur = torch.from_numpy((r.integers(0, 256, n)
                                + r.choice([0.0, 0.3, 0.7], n)
                                ).astype(np.float32)).to(dev)
        npx = torch.from_numpy(r.choice([0.0, 10.0, 11.0, 900.0], n)
                               .astype(np.float32)).to(dev)
        act = torch.from_numpy(np.arange(n) < n - 20).to(dev)
        th0 = torch.tensor(float(r.uniform(20, 200)), device=dev)
        k = tracker_mod._thresh_chain(th0, cur, npx, act, 0.7)
        p = tracker_mod._thresh_chain(th0, cur, npx, act, 0.7, use_plain=True)
        hold("thresh_chain", k.view(torch.int32), p.view(torch.int32))

    # the motion map (blurred absdiff and recurrence in one launch) on random
    # integer-valued frames with an inactive prefix and tail: every ksize
    # class (1 tap, cv2's table, the served 13, the most the kernel takes),
    # T = 1 and T not a multiple of the 32-frame chunk, frames one row or
    # column wider than the blur's radius, the guided-vft window and the
    # 256x256 stress frame, and buffers at unaligned addresses
    def map_inputs(tl, hl, wl, seed):
        r = np.random.default_rng(seed)
        fr = torch.from_numpy(r.integers(0, 256, (tl, hl, wl)).astype(
            np.float32)).to(dev)
        p0 = torch.from_numpy(r.integers(0, 256, (hl, wl)).astype(
            np.float32)).to(dev)
        l0 = torch.from_numpy(r.uniform(0, 40, (hl, wl)).astype(
            np.float32)).to(dev)
        act = torch.from_numpy((np.arange(tl) >= min(2, tl - 1))
                               & (np.arange(tl) < max(tl - 9, 1))).to(dev)
        return p0, fr, l0, act

    def hold_map(p0, fr, l0, act, alpha, ksize):
        k = tracker_mod.motion_map(p0, fr, l0, act, alpha, ksize)
        p = tracker_mod.motion_map(p0, fr, l0, act, alpha, ksize,
                                   use_plain=True)
        hold("motion_map", k.view(torch.int32), p.view(torch.int32))

    map_cases = [((300, 61, 97), a, ks) for a in (0.98, 0.3)
                 for ks in (1, 5, 13, 31)]
    map_cases += [((1, 48, 40), 0.98, 13), ((33, 48, 40), 0.98, 13),
                  ((45, 61, 97), 0.3, 13), ((502, 48, 40), 0.98, 13),
                  ((40, 7, 50), 0.98, 13), ((40, 50, 7), 0.98, 13),
                  ((40, 16, 16), 0.3, 31), ((500, 128, 128), 0.98, 13),
                  ((4, 256, 256), 0.98, 13), ((4, 256, 256), 0.3, 31),
                  # many rounds of the cluster's slices
                  ((4100, 48, 40), 0.98, 13)]
    for i, ((tl, hl, wl), alpha, ksize) in enumerate(map_cases):
        hold_map(*map_inputs(tl, hl, wl, i), alpha, ksize)
    p0, fr, l0, act = map_inputs(77, 61, 97, 99)
    hold_map(unaligned(p0, 3), unaligned(fr, 1), unaligned(l0, 2),
             unaligned(act, 5), 0.98, 13)

    # the two one-block scans on stress sequences that reach their rare
    # branches (jumps of max_shift and one ulp either side of it, holds,
    # expiry, re-acquisition, boxes outside and larger than the frame, a
    # carried-in valid state; n_px at the fallback edge, an inactive tail),
    # at lengths on both sides of the kernels' 4096-frame tile, from buffers
    # at 16-B aligned and unaligned addresses
    def gate_state_bits(st):
        """The carry as 6 int32 (floats by their bits), for exact compares."""
        v = [x.item() if isinstance(x, torch.Tensor) else x for x in st]
        f = np.array(v[1:3], np.float32).view(np.int32)
        return torch.tensor([int(bool(v[0])), int(f[0]), int(f[1]), int(v[3]),
                             int(v[4]), int(v[5])])

    def hold_gate(has, raw, st, params=gate_mod.GateParams()):
        ks, (kv, kb) = gate_mod.gate_scan_carry(st, has, raw, 256, 256, params)
        ps, (pv, pb) = gate_mod.gate_scan_carry(st, has, raw, 256, 256, params,
                                                use_plain=True)
        hold("gate_scan", kv, pv)
        hold("gate_scan", kb, pb)
        hold("gate_scan", gate_state_bits(ks), gate_state_bits(ps))
        return ks, kv, kb

    scan_lengths = (1, 2, 33, 502, 4097, 20000)
    for t_ in scan_lengths:
        h_np, b_np, s0 = gate_stress_sequence(t_, seed=t_)
        has = torch.from_numpy(h_np).to(dev)
        raw = torch.from_numpy(b_np).to(dev)
        for st in (gate_mod.gate_init(), gate_mod.GateState(*s0)):
            hold_gate(has, raw, st)
        hold_gate(unaligned(has, 3), unaligned(raw, 1), gate_mod.GateState(*s0))
        th0, cur, npx, act = (torch.from_numpy(np.asarray(x)).to(dev)
                              for x in thresh_stress_sequence(t_, seed=t_))
        for beta, args in ((0.7, (cur, npx, act)), (0.35, (cur, npx, act)),
                           (0.7, (unaligned(cur, 1), unaligned(npx, 3),
                                  unaligned(act, 5)))):
            k = tracker_mod._thresh_chain(th0, *args, beta)
            p = tracker_mod._thresh_chain(th0, *args, beta, use_plain=True)
            hold("thresh_chain", k.view(torch.int32), p.view(torch.int32))
    # other gate parameters: no drift clamp and odd padding, no hold at all
    h_np, b_np, s0 = gate_stress_sequence(502, seed=7)
    for params in (gate_mod.GateParams(1e6, 3, 1),
                   gate_mod.GateParams(30.0, 7, 0)):
        hold_gate(torch.from_numpy(h_np).to(dev), torch.from_numpy(b_np).to(dev),
                  gate_mod.GateState(*s0), params)
    # one segment in three calls, cut at the one call's tile boundary (4096)
    # and inside its second tile (5596), the carry passed on as the kernel
    # left it: equal to the one call
    h_np, b_np, s0 = gate_stress_sequence(20000, seed=1)
    has = torch.from_numpy(h_np).to(dev)
    raw = torch.from_numpy(b_np).to(dev)
    whole_st, whole_v, whole_b = hold_gate(has, raw, gate_mod.GateState(*s0))
    st, vs, bs = gate_mod.GateState(*s0), [], []
    for a, b in ((0, 4096), (4096, 5596), (5596, 20000)):
        st, (v, bx) = gate_mod.gate_scan_carry(st, has[a:b], raw[a:b], 256, 256)
        vs.append(v)
        bs.append(bx)
    hold("gate_scan", torch.cat(vs), whole_v)
    hold("gate_scan", torch.cat(bs), whole_b)
    hold("gate_scan", gate_state_bits(st), gate_state_bits(whole_st))

    # the in-box count: boxes inside, across and outside the window, at its
    # edges and empty; all, none and some frames valid; the decoder's
    # window (128 and a ragged 37 frames), whole 256x256 frames and a
    # ragged 17x300 window; bf16 and f32; thresholds 0 and 0.5; the origin
    # on the device and as launch arguments: each case alone (a table of
    # one chunk), then the cases of one (shape, dtype, threshold) as tables
    # of 3 and of 8 chunks (cycled), and from unaligned buffers
    box_classes = {}
    for seed, (n, hw, ww, oyv, oxv) in enumerate((
            (128, 160, 160, 46, 50), (37, 160, 160, 6, 90),
            (5, 256, 256, 0, 0), (9, 17, 300, 3, 11))):
        r = np.random.default_rng(100 + seed)
        x = torch.from_numpy(r.normal(0, 1, (n, hw, ww)).astype(np.float32)
                             ).to(dev)
        x[:, ::5] = 0.0                    # exactly at threshold 0
        x[:, 1::7] = 0.5                   # exactly at threshold 0.5
        xy = r.integers(-60, max(hw, ww) + 60, (n, 2)) + [oxv, oyv]
        bx = np.concatenate([xy, xy + r.integers(0, 220, (n, 2))], 1)
        bx[0] = [oxv, oyv, oxv + ww, oyv + hw]             # the window
        bx[1] = [oxv + 1, oyv + 1, oxv + ww - 1, oyv + hw - 1]
        bx[2] = [oxv - 40, oyv - 30, oxv, oyv]             # ends at it
        bx[3] = [oxv + 5, oyv + 5, oxv + 5, oyv + 50]      # empty
        bx = torch.from_numpy(bx.astype(np.int32)).to(dev)
        for vd in (torch.ones(n, dtype=torch.bool, device=dev),
                   torch.zeros(n, dtype=torch.bool, device=dev),
                   torch.from_numpy(r.random(n) < 0.7).to(dev)):
            for dt in (torch.float32, torch.bfloat16):
                xd = x.to(dt)
                for thr in (0.0, 0.5):
                    for oy, ox in ((torch.tensor(oyv, device=dev),
                                    torch.tensor(oxv, device=dev)),
                                   (oyv, oxv)):
                        box_classes.setdefault((seed, dt, thr), []).append(
                            areas_cuda.CountChunk(xd, vd, bx, oy, ox))

    def hold_table(chunks, thr):
        got = areas_cuda.box_count_table(chunks, thr)
        want = areas_cuda.box_count_table(chunks, thr, use_plain=True)
        hold("box_count", torch.cat(got), torch.cat(want))

    box_stress = 0
    box_tables = {1: 0, 3: 0, 8: 0}
    for (_, _, thr), cases in box_classes.items():
        for c in cases:
            hold("box_count", areas_cuda.box_count(c.x, thr, *c[1:5]),
                 areas_cuda.box_count(c.x, thr, *c[1:5], use_plain=True))
            box_stress += 1
            box_tables[1] += 1
        cyc = cases + cases
        for size in (3, 8):
            for i in range(0, len(cases), size):
                hold_table(cyc[i:i + size], thr)
                box_tables[size] += 1
        hold_table([c._replace(x=unaligned(c.x, by))
                    for c, by in zip(cases[:3], (1, 3, 5))], thr)

    # the batched scans (one block per sequence): K = 1 ... 64 sequences of
    # ragged lengths (0, 1, 2, 127, 128, 129, 4097, 20000 and others), the
    # stress sequences, from the initial state and from carried-in states,
    # from unaligned buffers, and resumed across three launches through the
    # (K, 6) carry buffer; equal to the plain version (a loop of the
    # per-video plain version), carries included
    def batch_inputs(lengths, seed):
        gs = [gate_stress_sequence(t, seed=seed + i) if t else
              (np.zeros(0, bool), np.zeros((0, 4), np.float32),
               gate_mod.gate_init()) for i, t in enumerate(lengths)]
        ts = [thresh_stress_sequence(t, seed=seed + i) if t else
              (np.float32(60.0), np.zeros(0, np.float32),
               np.zeros(0, np.float32), np.zeros(0, bool))
              for i, t in enumerate(lengths)]
        cat = lambda xs: torch.from_numpy(np.concatenate(xs)).to(dev)  # noqa: E731
        states = torch.stack([gate_mod._state_buffer(
            gate_mod.GateState(*g[2]), "cpu") for g in gs]).to(dev)
        return ((cat([g[0] for g in gs]), cat([g[1] for g in gs]), states),
                (torch.tensor([float(t[0]) for t in ts], device=dev),
                 *(cat([np.asarray(t[j]) for t in ts]) for j in (1, 2, 3))))

    def hold_gate_batch(has, raw, off, state):
        kst, pst = (None, None) if state is None else (state.clone(),
                                                       state.clone())
        kv, kb = gate_mod.gate_scan_batch(has, raw, off, 256, 256, state=kst)
        pv, pb = gate_mod.gate_scan_batch(has, raw, off, 256, 256, state=pst,
                                          use_plain=True)
        hold("gate_scan_batch", kv, pv)
        hold("gate_scan_batch", kb, pb)
        if state is not None:
            hold("gate_scan_batch", kst, pst)
        return kv, kb, kst

    served_mix = (0, 1, 2, 127, 128, 129, 4097, 20000)
    batch_sets = [(1, (502,)), (2, (0, 1)), (3, (5, 0, 33)),
                  (8, served_mix), (16, served_mix[:6] * 2 + (502, 380, 1000,
                                                                31)),
                  (64, tuple((0, 1, 2, 3, 17, 31, 32, 33, 127, 128, 129, 130,
                              250, 380, 502, 1000) * 4))]
    batch_cases = 0
    for k_, lengths in batch_sets:
        assert len(lengths) == k_
        off = [0, *np.cumsum(lengths).tolist()]
        (has, raw, states), (th0, cur, npx, act) = batch_inputs(lengths, k_)
        for st in (None, states):
            hold_gate_batch(has, raw, off, st)
        hold_gate_batch(unaligned(has, 3), unaligned(raw, 1), off, states)
        for beta, args in ((0.7, (cur, npx, act)),
                           (0.35, (unaligned(cur, 1), unaligned(npx, 3),
                                   unaligned(act, 5)))):
            hold("thresh_chain_batch",
                 tracker_mod.thresh_chain_batch(th0, *args, off, beta
                                                ).view(torch.int32),
                 tracker_mod.thresh_chain_batch(th0, *args, off, beta,
                                                use_plain=True
                                                ).view(torch.int32))
        # three launches, each sequence cut at 1/3 and 2/3 of its length
        # (a 20000-frame sequence at its tile boundaries' sides), the carry
        # passed on in the buffer as the kernel left it
        whole_v, whole_b, whole_st = hold_gate_batch(has, raw, off, states)
        carry = states.clone()
        cuts = [(a, a + (b - a) // 3, a + 2 * (b - a) // 3, b)
                for a, b in zip(off[:-1], off[1:])]
        vs, bs = [], []
        for j in range(3):
            spans = [(c[j], c[j + 1]) for c in cuts]
            so_ = [0, *np.cumsum([b - a for a, b in spans]).tolist()]
            v_, b_ = gate_mod.gate_scan_batch(
                torch.cat([has[a:b] for a, b in spans]),
                torch.cat([raw[a:b] for a, b in spans]), so_, 256, 256,
                state=carry)
            vs.append([v_[so_[i]:so_[i + 1]] for i in range(k_)])
            bs.append([b_[so_[i]:so_[i + 1]] for i in range(k_)])
        hold("gate_scan_batch",
             torch.cat([torch.cat([vs[j][i] for j in range(3)])
                        for i in range(k_)]), whole_v)
        hold("gate_scan_batch",
             torch.cat([torch.cat([bs[j][i] for j in range(3)])
                        for i in range(k_)]), whole_b)
        hold("gate_scan_batch", carry, whole_st)
        batch_cases += 1

    # the union-find at cohort size: a 4000-frame 128x128 stack (a cohort's
    # guided-vft windows), and the largest stack the cohort rule allows on
    # this card (502-frame videos, their tracked frames), each launch equal
    # to the same kernel over the stack's 128-frame pieces and, on its first
    # and last 64 frames, to the plain version (the plain fixpoint takes
    # hundreds of passes over a spiral: the whole stack would take minutes)
    from openglottal_tpu_torch.pipelines import cohort_k

    k_max = cohort_k("guided-vft", [502] * 10_000,
                     torch.cuda.mem_get_info()[0], 2)
    pool128 = blob_stress_masks(128, 128, seed=21)
    cohort_stacks = {}
    for n_frames in (4000, k_max * 500):
        m = torch.from_numpy(pool128[np.arange(n_frames) % len(pool128)]
                             ).to(dev)
        code = 2 - m.to(torch.uint8)
        init = torch.from_numpy(rng.integers(
            0, 128 * 128 + 1, (n_frames, 128, 128)).astype(np.int32)).to(dev)
        uf_ops = {
            "dual_cc_batch": (lambda c, i, r: blobs_cuda.dual_cc_batch(c),
                              lambda c, i, r: blobs_cuda.dual_cc_plain(c)),
            "dual_min_prop_batch": (
                lambda c, i, r: blobs_cuda.dual_min_prop_batch(c, i),
                lambda c, i, r: blobs_cuda.dual_min_prop_plain(c, i)),
            "min_prop_batch": (
                lambda c, i, r: blobs_cuda.min_prop_batch(r, i, 4),
                lambda c, i, r: blobs_cuda.min_prop_plain(r, i, 4))}
        cohort_stacks[n_frames] = {}
        both_ends = lambda x: torch.cat([x[:64], x[-64:]])  # noqa: E731
        for name, (kf, pf) in uf_ops.items():
            got = kf(code, init, m)
            hold(name, got, torch.cat([
                kf(code[a:a + 128], init[a:a + 128], m[a:a + 128])
                for a in range(0, n_frames, 128)]))
            hold(name, both_ends(got), pf(both_ends(code), both_ends(init),
                                          both_ends(m)))
            cohort_stacks[n_frames][name] = {
                "kernel_ms": time_cuda(lambda: kf(code, init, m), 5),
                "bound_ms": n_frames * 128 * 128 * (5 if name == "dual_cc_batch"
                                                     else 9)
                / HBM_BYTES_PER_S * 1e3}
        del m, code, init
    torch.cuda.empty_cache()

    # the labelling entry points on tools/blob_stress.py's families
    t_bs = time.perf_counter()
    blob_stress_line = blob_stress(dev, hold, unaligned)
    say("blob_stress", compared="exact equality with the plain version",
        seconds=time.perf_counter() - t_bs, **blob_stress_line)

    # kernel and plain times on one stress batch per shape (the 256x256 rows
    # are the only timing of the device-memory path: served videos whose gate
    # boxes fit the 128x128 window never take it)
    def stress_runners(m_np):
        """(kernel, kernel fn, plain fn) of the five blob entry points on one
        stress batch (init = the flat index, as plain labelling)."""
        t, h, w = m_np.shape
        masks = torch.from_numpy(m_np).to(dev)
        code = 2 - masks.to(torch.uint8)
        init = torch.arange(h * w, dtype=torch.int32, device=dev
                            ).view(1, h, w).expand(t, -1, -1).contiguous()
        return (("dual_cc_batch", lambda: blobs_cuda.dual_cc_batch(code),
                 lambda: blobs_cuda.dual_cc_plain(code)),
                ("dual_min_prop_batch",
                 lambda: blobs_cuda.dual_min_prop_batch(code, init),
                 lambda: blobs_cuda.dual_min_prop_plain(code, init)),
                ("min_prop_batch",
                 lambda: blobs_cuda.min_prop_batch(masks, init, 8),
                 lambda: blobs_cuda.min_prop_plain(masks, init, 8)),
                ("cc_batch", lambda: blobs_cuda.cc_batch(masks, 8),
                 lambda: blobs_cuda.cc_plain(masks, 8)),
                ("cc", lambda: blobs_cuda.cc(masks[0], 8),
                 lambda: blobs_cuda.cc_plain(masks[:1], 8)[0]))

    stress_ms = []
    for i in first_batch:
        t, h, w = stress[i].shape
        for name, kfn, pfn in stress_runners(stress[i]):
            stress_ms.append({"kernel": name,
                              "shape": [h, w] if name == "cc" else [t, h, w],
                              "kernel_ms": time_cuda(kfn, 20),
                              "plain_ms": time_cuda(pfn, 1)})
    for tl, hl, wl in ((500, 48, 40), (500, 128, 128), (4, 256, 256)):
        args = (*map_inputs(tl, hl, wl, 7), 0.98, 13)
        stress_ms.append({
            "kernel": "motion_map", "shape": [tl, hl, wl],
            "kernel_ms": time_cuda(lambda: tracker_mod.motion_map(*args), 20),
            "plain_ms": time_cuda(
                lambda: tracker_mod.motion_map(*args, use_plain=True), 1)})

    # ── in turns against other checkouts' kernels (--against) ───────────
    def in_turns(items, walls=None):
        """The kernels of this checkout and of every --against checkout on
        the same inputs, through this checkout's wrappers: each held exactly
        equal to the plain version (where ``items`` gives its output), then
        timed in turns (this, a, b, b, a, this; each ``ms`` is the mean of a
        checkout's two turns).  items: (label, kernel fn, plain output or
        None).  walls: {label: fn returning wall ms per video}, served with
        each checkout's kernels in the same turns, twice over."""
        libs, built = against_libraries()
        order = [*libs, *reversed(libs)]
        each = {label: {tag: [] for tag in libs} for label, _, _ in items}
        wall = {label: {tag: [] for tag in libs} for label in walls or {}}
        for tag in order + order:
            with kernel_libraries(libs[tag]):
                for label, fn in (walls or {}).items():
                    wall[label][tag] += fn()
        for tag in order:
            with kernel_libraries(libs[tag]):
                for label, kfn, want in items:
                    if want is not None and not each[label][tag]:
                        got = kfn()
                        torch.cuda.synchronize()
                        if not identical(got, want):
                            raise AssertionError(f"{tag}: {label} differs from "
                                                 f"its plain version")
                    each[label][tag].append(time_cuda(kfn, 20))
        # mean over a kernel's launches at one place (label up to " #")
        groups = {}
        for label, by_tag in each.items():
            g = groups.setdefault(label.split(" #")[0], {t: [] for t in libs})
            for tag, v in by_tag.items():
                g[tag].append(sum(v) / len(v))
        say("against", order=order, timing=TIMING,
            compared="exact equality with the plain version, every library",
            ptxas={d: {src: ptxas_summary(built[f"{src}_against{i}"][1])
                       for src in _build.SOURCES
                       if f"{src}_against{i}" in built}
                   for i, d in enumerate(against)},
            ms={k: {t: sum(v) / len(v) for t, v in g.items()}
                for k, g in groups.items()},
            wall_ms_per_video_median={
                k: {t: float(np.median(v)) for t, v in by_tag.items()}
                for k, by_tag in wall.items()},
            wall_ms_per_video=wall, ms_each_turn=each)

    def stress_items():
        items = []
        for i in first_batch:
            t, h, w = stress[i].shape
            for name, kfn, pfn in stress_runners(stress[i]):
                shape = [h, w] if name == "cc" else [t, h, w]
                items.append((f"{name} stress {'x'.join(map(str, shape))}",
                              kfn, pfn()))
        return items

    # the two one-block scans: the C launch alone, and the wrapper call
    def bare_gate(has, raw, frame_h=256, frame_w=256,
                  params=gate_mod.GateParams(), cycles=None):
        """og_gate_scan launched alone on buffers made here once (each launch
        starts from the carry the one before left); with ``cycles`` (an int64
        tensor of 1) og_gate_scan_walk_cycles, which stores the walk's SM
        cycles there."""
        t_ = has.numel()
        keep = (has.contiguous(), raw.to(torch.float32).contiguous(),
                torch.empty((t_,), dtype=torch.bool, device=dev),
                torch.empty((t_, 4), dtype=torch.int32, device=dev),
                torch.zeros(6, dtype=torch.int32, device=dev))
        h_, r_, ov, ob, buf = keep
        args = (h_.data_ptr(), r_.data_ptr(), ov.data_ptr(), ob.data_ptr(),
                buf[4:].data_ptr(), buf.data_ptr(), t_, float(frame_h),
                float(frame_w), float(params.max_shift_px),
                int(params.padding), int(params.max_hold_frames))

        fn = "og_gate_scan" if cycles is None else "og_gate_scan_walk_cycles"
        extra = () if cycles is None else (cycles.data_ptr(),)

        def run():
            _build.check(getattr(scan_cuda.lib(), fn)(*args, *extra,
                                                      scan_cuda.stream()), fn)
            return keep
        return run

    def bare_thresh(th0, cur, npx, act, beta, cycles=None):
        """og_thresh_chain launched alone on buffers made here once (with
        ``cycles``: og_thresh_chain_walk_cycles, as bare_gate)."""
        keep = (th0.to(torch.float32).reshape(1).contiguous(),
                cur.to(torch.float32).contiguous(),
                npx.to(torch.float32).contiguous(), act.contiguous(),
                torch.empty(cur.shape, dtype=torch.float32, device=dev))
        args = (*(x.data_ptr() for x in keep), keep[1].numel(),
                float(np.float32(beta)), float(np.float32(1.0 - beta)))

        fn = ("og_thresh_chain" if cycles is None
              else "og_thresh_chain_walk_cycles")
        extra = () if cycles is None else (cycles.data_ptr(),)

        def run():
            _build.check(getattr(scan_cuda.lib(), fn)(*args, *extra,
                                                      scan_cuda.stream()), fn)
            return keep
        return run

    def scan_cases(gate_in, thresh_in):
        """(kernel, T, wrapper fn, bare fn, plain output) of the two scans on
        the given inputs, whole and cut to their first frame.  gate_in: (has,
        raw, frame_h, frame_w, params); thresh_in: (th0, cur, n_px, active,
        beta)."""
        has, raw, fh, fw, params = gate_in
        th0, cur, npx, act, beta = thresh_in
        cases = []
        for t_ in (has.numel(), 1):
            h_, r_ = has[:t_], raw[:t_]
            cases.append((
                "gate_scan", t_,
                lambda h_=h_, r_=r_: gate_mod.gate_scan(h_, r_, fh, fw, params),
                bare_gate(h_, r_, fh, fw, params),
                gate_mod.gate_scan(h_, r_, fh, fw, params, use_plain=True)))
        for t_ in (cur.numel(), 1):
            c_, n_, a_ = cur[:t_], npx[:t_], act[:t_]
            cases.append((
                "thresh_chain", t_,
                lambda c_=c_, n_=n_, a_=a_: tracker_mod._thresh_chain(
                    th0, c_, n_, a_, beta),
                bare_thresh(th0, c_, n_, a_, beta),
                tracker_mod._thresh_chain(th0, c_, n_, a_, beta,
                                          use_plain=True)))
        return cases

    def scan_items(cases, where):
        """In-turn items of scan_cases: the wrapper held against the plain
        output, the bare launch timed beside it."""
        items = []
        for name, t_, wfn, bfn, want in cases:
            items.append((f"{name} wrapper {where} T={t_}", wfn, want))
            items.append((f"{name} bare {where} T={t_}", bfn, None))
        return items

    def stress_scan_cases():
        h_np, b_np, _ = gate_stress_sequence(T_FRAMES, seed=0)
        th = thresh_stress_sequence(T_FRAMES, seed=0)
        return scan_cases(
            (torch.from_numpy(h_np).to(dev), torch.from_numpy(b_np).to(dev),
             256, 256, gate_mod.GateParams()),
            (*(torch.from_numpy(np.asarray(x)).to(dev) for x in th), 0.7))

    if blobs_only:
        # the union-find alone: every launch guided-vft and vft make on a
        # served video (demo weights, bf16) held equal to its plain version,
        # and with --against timed in turns with the other checkouts'
        # kernels, beside both pipelines' walls
        vids = [np.ascontiguousarray(synthetic_video(
            t=T_FRAMES, size=256, seed=s_, realistic=False)[0][..., 0])
            for s_ in range(3)]
        pipe = GlottalPipelines(dtype=torch.bfloat16,
                                unet_variables="weights/demo_unet.npz",
                                yolo_variables="weights/demo_yolo.npz",
                                conf=0.25)
        items, walls = [], {}
        for pipeline in ("guided-vft", "vft"):
            pipe.extract_features(vids[1], pipeline)        # warm-up
            record = []
            counted(lambda: pipe.extract_features(vids[0], pipeline), record)
            hold_record(pipeline, record)
            for k, (name, inputs, kw) in enumerate(record):
                if name in blobs_cuda.LAUNCHES:
                    kfn, pfn, _, _ = runners(name, inputs, kw)
                    shape = max(inputs, key=torch.numel).shape
                    items.append((f"{name} {pipeline} "
                                  f"{'x'.join(map(str, shape))} #{k}",
                                  kfn, pfn()))

            def wall(pipeline=pipeline):
                ms = []
                for v in vids[1:]:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    pipe.extract_features(v, pipeline)
                    ms.append((time.perf_counter() - t0) * 1e3)
                return ms
            walls[f"{pipeline}/bf16"] = wall
        say("blob_paths", compared="every recorded launch exactly equal to "
            "its plain version", launches_held=held)
        if against:
            in_turns(items + stress_items(), walls)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # og_qconv on every int8 layer shape, each epilogue and the edge cases
    # (qconv_stress_cases): int8 outputs and float32 bits exactly equal
    qconv_labels, qconv_silu_cpu = qconv_stress(dev, hold)
    # og_frame_counts and og_otsu_counts on their stress inputs
    eval_labels = eval_stress(dev, hold, unaligned)
    # og_jpeg_entropy and og_jpeg_idct_bgr on their stress streams
    mjpg_stress_line = mjpg_stress(dev, hold)

    say("kernels", ok=True, compared="exact equality with the plain version",
        qconv_stress_cases=qconv_labels, eval_stress_cases=len(eval_labels),
        jpeg_stress_cases=mjpg_stress_line["cases"],
        qconv_silu_equal_to_plain_on_cpu=qconv_silu_cpu,
        shapes=[list(stress[i].shape) for i in first_batch],
        stress_batches=len(stress), box_count_stress_cases=box_stress,
        box_count_tables_by_size=box_tables,
        scan_batch_sets={str(k_): list(lengths) for k_, lengths in batch_sets},
        union_find_cohort_stacks={
            "k_rule_guided_vft_502_frames": k_max,
            "frames_128x128": cohort_stacks},
        max_abs_err=max_err, stress_times=stress_ms)
    reset_counts()

    if kernels_only:
        if against:
            in_turns(stress_items() + scan_items(stress_scan_cases(), "stress"))
        return 0

    # ── the main paths ──────────────────────────────────────────────────
    def video(seed: int):
        frames, _ = synthetic_video(t=T_FRAMES, size=256, seed=seed,
                                    realistic=False)
        return np.ascontiguousarray(frames[..., 0])

    videos = [video(s) for s in range(4)]
    # the demo U-Net also serves as the crop U-Net's weights
    weights = dict(unet_variables="weights/demo_unet.npz",
                   crop_unet_variables="weights/demo_unet.npz",
                   yolo_variables="weights/demo_yolo.npz", conf=0.25)
    pipes = {"bf16": GlottalPipelines(dtype=torch.bfloat16, **weights),
             "f32": GlottalPipelines(dtype=torch.float32, **weights)}

    def check_features(name, feats, expect_f0=0.05, frames=T_FRAMES):
        if feats is None:
            raise AssertionError(f"{name}: extract_features returned None")
        area = feats["_area"]
        if area.shape != (frames,) or not np.isfinite(area).all():
            raise AssertionError(f"{name}: bad waveform {area.shape}")
        for k in ("area_mean", "area_std", "area_range", "open_quotient",
                  "periodicity", "cv"):
            if not np.isfinite(feats[k]):
                raise AssertionError(f"{name}: {k} = {feats[k]}")
        if expect_f0 is not None and (
                feats["f0"] is None or abs(feats["f0"] - expect_f0) > 0.005):
            raise AssertionError(f"{name}: f0 = {feats['f0']}, expected "
                                 f"{expect_f0} cycles/frame")
        return {k: v for k, v in feats.items() if k != "_area"}

    def serve(pipe, pipeline):
        """Wall ms per video over distinct videos, each ending in a host
        read of the waveform (extract_features returns host values)."""
        ms = []
        for v in videos[1:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.extract_features(v, pipeline)
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms

    def expect_counts(where, got, expected):
        for k, n in expected.items():
            if got[k] != n:
                raise AssertionError(f"{where}: {k} launched {got[k]} times, "
                                     f"expected {n}")

    path_launches = {}
    recorded = {}
    waves = {}
    for pipeline, expected in (
            ("guided-vft", {"dual_cc_batch": 1, "dual_min_prop_batch": 1,
                            "min_prop_batch": 2, "gate_scan": 1,
                            "thresh_chain": 1, "cc": 0, "cc_batch": 0,
                            "motion_map": 0, "box_count": 0}),
            # unet (the windowed decoder): the gate carried across the four
            # 128-frame chunks and one in-box count per chunk
            ("unet", {"gate_scan": N_CHUNKS, "box_count": N_CHUNKS}),
            # vft: the tracker's init blurs its seed map (a T = 1 motion map)
            # and labels one ROI mask (2 single-frame CC launches); the ROI
            # filter and the output filter are one top_n_blobs_batch each,
            # by the split route (2 single-region CC launches + 2 + 2
            # single-region broadcasts apiece)
            ("vft", {"gate_scan": 1, "cc": 2, "motion_map": 2,
                     "cc_batch": 4, "min_prop_batch": 8, "thresh_chain": 1,
                     "dual_cc_batch": 0, "dual_min_prop_batch": 0,
                     "box_count": 0})):
        for tag, pipe in pipes.items():
            pipe.extract_features(videos[1], pipeline)     # warm-up (cuDNN)
            record = []
            feats, got = counted(
                lambda: pipe.extract_features(videos[0], pipeline), record)
            expect_counts(f"{pipeline}/{tag} main path", got, expected)
            path_launches[f"{pipeline}/{tag}"] = got
            if tag == "bf16":
                recorded[pipeline] = record
            summary = check_features(f"{pipeline}/{tag}", feats)
            waves[(pipeline, tag)] = feats["_area"]
            ms = serve(pipe, pipeline)
            # gate facts of this video, and the plain-kernel run
            gray = pipe._to_gray(videos[0])
            valid, boxes = pipe._gated(None, gray)
            side = (boxes[:, 2:] - boxes[:, :2]).max().item()
            extra = {"gate_valid_share": float(valid.float().mean()),
                     "max_box_side": side}
            if pipeline == "guided-vft":
                extra["all_boxes_fit_128_window"] = bool(side <= 126)
            elif pipeline == "vft":
                _, _, idx, hw0 = pipe._vft_compute(gray, valid, boxes,
                                                   T_FRAMES)
                extra["locked_crop_size_h_w"] = list(hw0)
                extra["tracked_frames"] = int(len(idx))
            else:
                extra["windowed_ok"] = bool(
                    pipe.yolo_unet_areas_deferred(videos[0])[1])
                if not extra["windowed_ok"]:
                    raise AssertionError(f"unet/{tag}: the windowed decoder "
                                         f"did not fit the served video")
            plain = GlottalPipelines(dtype=pipe.dtype, use_plain_kernels=True,
                                     **weights)
            pf, pc = counted(lambda: plain.extract_features(videos[0],
                                                            pipeline))
            if any(pc.values()):
                raise AssertionError("plain-kernel run launched a kernel")
            if not np.array_equal(pf["_area"], feats["_area"]):
                raise AssertionError(
                    f"{pipeline}/{tag}: waveform differs between the CUDA "
                    f"kernels and their plain versions")
            extra["equals_plain_kernel_run"] = True
            say(pipeline.replace("-", "_"), dtype=tag, features=summary,
                launches=got, wall_ms_per_video=ms,
                frames_per_s=T_FRAMES / (float(np.median(ms)) / 1e3), **extra)

    rel_l1 = float(np.abs(waves[("unet", "bf16")] - waves[("unet", "f32")]).sum()
                   / waves[("unet", "f32")].sum())
    if rel_l1 >= 0.05:
        raise AssertionError(f"unet: bf16 vs f32 waveform relative L1 {rel_l1}")

    # ── the blob filter's two routes against each other ─────────────────
    # on the very masks the served videos gave the blob filters: vft's ROI
    # filter (n = 1) and output filter (n = 2) at the locked crop size, where
    # the tracker takes the split route, and guided-vft's output filter on
    # 128x128 windows, where it takes the dual route; both routes timed
    vft_masks = [inp[0] for name, inp, kw in recorded["vft"]
                 if name == "cc_batch" and kw["connectivity"] == 8]
    guided_masks = [inp[0] == 1 for name, inp, _ in recorded["guided-vft"]
                    if name == "dual_cc_batch"]
    n_out = pipes["bf16"].vft_params.max_glottal_components
    n_out_guided = pipes["bf16"].ygvft_params.max_glottal_components
    routes = []
    for m, n in (*zip(vft_masks, (1, n_out)), (guided_masks[0], n_out_guided)):
        dual, got = counted(lambda: blobs.top_n_blobs_batch(m, n))
        expect_counts("top_n_blobs_batch, dual route", got,
                      {"dual_cc_batch": 1, "dual_min_prop_batch": 1,
                       "min_prop_batch": 2, "cc_batch": 0})
        spl, got = counted(lambda: blobs.top_n_blobs_batch(m, n, _split=True))
        expect_counts("top_n_blobs_batch(_split=True)", got,
                      {"cc_batch": 2, "min_prop_batch": 4, "dual_cc_batch": 0,
                       "dual_min_prop_batch": 0})
        if not torch.equal(dual, spl):
            raise AssertionError("top_n_blobs_batch: routes differ")
        routes.append({
            "shape": list(m.shape), "n": n,
            "dual_route_ms": time_cuda(
                lambda: blobs.top_n_blobs_batch(m, n), 10),
            "split_route_ms": time_cuda(
                lambda: blobs.top_n_blobs_batch(m, n, _split=True), 10)})
    say("blob_routes", equal=True, top_n_blobs_batch=routes)

    # ── the sequential tracker forms on a 32-frame clip ─────────────────
    seq_pipe = GlottalPipelines(dtype=torch.bfloat16, parallel_trackers=False,
                                **weights)
    clip = videos[0][:32]
    gray = seq_pipe._to_gray(clip)
    n_valid = int(seq_pipe._gated(None, gray)[0].sum())
    sequential = {}
    seq_recorded = {}
    for pipeline, n_cc, n_steps in (
            # init: 2 launches and the seed map's blur (a motion map); a vft
            # step labels the ROI mask and the output mask (4 launches) and
            # runs for every gated crop, the inactive init crops included; a
            # guided step labels the output mask (2)
            ("vft", 2 + 4 * n_valid, n_valid),
            ("guided-vft", 2 * (len(clip) - 2), len(clip) - 2)):
        a_par = pipes["bf16"].extract_features(clip, pipeline)["_area"]
        seq_pipe.extract_features(clip, pipeline)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        record = []
        feats, got = counted(lambda: seq_pipe.extract_features(clip, pipeline),
                             record)
        wall = (time.perf_counter() - t0) * 1e3
        seq_recorded[pipeline] = record
        expect_counts(f"{pipeline}, sequential", got,
                      {"cc": n_cc, "motion_map": n_steps + 1,
                       "thresh_chain": n_steps, "gate_scan": 1, "cc_batch": 0,
                       "dual_cc_batch": 0})
        check_features(f"{pipeline}, sequential", feats, expect_f0=None,
                       frames=len(clip))
        diff = float(np.abs(feats["_area"] - a_par).max())
        if diff > 2.0:
            raise AssertionError(f"{pipeline}: sequential vs parallel areas "
                                 f"differ by {diff} px (limit 2.0)")
        sequential[pipeline] = {
            "max_abs_area_diff_vs_parallel": diff, "launches": got,
            "frames_differing": int((feats["_area"] != a_par).sum()),
            "wall_ms": wall}
    say("sequential_trackers", frames=len(clip), gated_frames=n_valid,
        **{k.replace("-", "_"): v for k, v in sequential.items()})
    reset_counts()

    # host synchronisations per video, counted by PyTorch's sync debug mode
    syncs, sync_sites = {}, {}
    for pipeline in ("guided-vft", "unet", "vft"):
        syncs[pipeline], sync_sites[pipeline] = host_syncs(
            lambda: pipes["bf16"].extract_features(videos[2], pipeline))

    # agreement with a reference on a small input: the same 12 frames on the
    # CPU (plain kernels) and on the card (CUDA kernels), float32
    small = videos[0][:12]
    cpu_pipe = GlottalPipelines(dtype=torch.float32, device="cpu", **weights)
    agree = {}
    for pipeline in ("guided-vft", "unet", "vft"):
        a = cpu_pipe.extract_features(small, pipeline)["_area"]
        b = pipes["f32"].extract_features(small, pipeline)["_area"]
        agree[pipeline] = float(np.abs(a - b).sum() / max(a.sum(), 1.0))
        if agree[pipeline] >= 0.05:
            raise AssertionError(f"{pipeline}: card vs CPU relative L1 "
                                 f"{agree[pipeline]} on 12 frames")
    say("checks", unet_bf16_vs_f32_rel_l1=rel_l1, host_syncs_per_video=syncs,
        host_sync_sites=sync_sites, card_vs_cpu_rel_l1_12_frames=agree)

    # ── each kernel at its path's shapes, on the recorded inputs ────────
    # kernel -> (what it replaces, the served path whose run gives its
    # launch count and its inputs)
    kernel_table = {
        "dual_cc_batch": ("openglottal_tpu/ops/blobs_pallas.py:357",
                          "guided-vft"),
        "dual_min_prop_batch": ("openglottal_tpu/ops/blobs_pallas.py:380",
                                "guided-vft"),
        "min_prop_batch": ("openglottal_tpu/ops/blobs_pallas.py:434",
                           "guided-vft"),
        "cc_batch": ("openglottal_tpu/ops/blobs_pallas.py:411", "vft"),
        "cc": ("openglottal_tpu/ops/blobs_pallas.py:460", "vft"),
        "gate_scan": ("openglottal_tpu/models/gate.py:98", "guided-vft"),
        "thresh_chain": ("openglottal_tpu/models/tracker.py:216",
                         "guided-vft"),
        "motion_map": ("openglottal_tpu/models/tracker.py:204", "vft"),
        "box_count": ("openglottal_tpu/pipelines.py:297", "unet"),
        # the cohort's batched scans (guided-vft's cohort path)
        "gate_scan_batch": ("openglottal_tpu/pipelines.py:927",
                            "cohort-guided-vft"),
        "thresh_chain_batch": ("openglottal_tpu/models/tracker.py:377",
                               "cohort-guided-vft"),
        # the int8 convolutions (unet's windowed int8 main path): XLA's
        # lowering of quant.py's _qconv, no Pallas kernel
        "qconv": ("openglottal_tpu/models/quant.py:304", "quant-unet"),
        # evaluate_patient's counts: XLA's fusions of eval.py's
        # frame_metrics_batch (+ box_masked) and otsu_in_box_masks
        "frame_counts": ("openglottal_tpu/eval.py:29", "eval"),
        "otsu_counts": ("openglottal_tpu/eval.py:44", "eval"),
    }
    source = {k: "openglottal_tpu_torch/csrc/blobs.cu" for k in blobs_cuda.LAUNCHES}
    source.update({k: "openglottal_tpu_torch/csrc/scan.cu" for k in scan_cuda.LAUNCHES})
    source["box_count"] = "openglottal_tpu_torch/csrc/areas.cu"
    source["qconv"] = "openglottal_tpu_torch/csrc/qconv.cu"
    source.update({k: "openglottal_tpu_torch/csrc/eval.cu"
                   for k in eval_cuda.LAUNCHES})
    # the C entry point each wrapper launches
    c_entry = {"dual_cc_batch": "og_dual_cc",
               "dual_min_prop_batch": "og_dual_min_prop",
               "min_prop_batch": "og_min_prop", "cc_batch": "og_cc_batch",
               "cc": "og_cc", "gate_scan": "og_gate_scan",
               "thresh_chain": "og_thresh_chain",
               "motion_map": "og_motion_map", "box_count": "og_box_count",
               "gate_scan_batch": "og_gate_scan_batch",
               "thresh_chain_batch": "og_thresh_chain_batch",
               "qconv": "og_qconv", "frame_counts": "og_frame_counts",
               "otsu_counts": "og_otsu_counts"}

    per_kernel = {}
    elsewhere = {}     # kernel -> path -> ms of each launch on another path

    def measure(path, record):
        """Every launch of a path's record held equal to its plain version
        and timed; the kernels this path reports get their plain times,
        bytes and operations too."""
        for name, inputs, kw in record:
            kfn, pfn, nbytes, ops = runners(name, inputs, kw)
            # every launch of every path equals its plain version on the
            # path's own inputs
            got, want = kfn(), pfn()
            if isinstance(got, tuple):
                for g, w_ in zip(got, want):
                    hold(name, g, w_)
            elif got.dtype.is_floating_point:
                hold(name, got.view(torch.int32), want.view(torch.int32))
            else:
                hold(name, got, want)
            held[path] = held.get(path, 0) + 1
            ms = time_cuda(kfn, 20)
            if kernel_table[name][1] != path:
                # not the path this kernel reports: the kernel's time only
                elsewhere.setdefault(name, {}).setdefault(path, []).append(ms)
                continue
            on_host = name in scan_cuda.LAUNCHES
            plain_ms = time_host(pfn, 2) if on_host else time_cuda(pfn, 2)
            e = per_kernel.setdefault(name, {"ms": [], "plain_ms": [],
                                             "bytes": [], "ops": [],
                                             "shapes": []})
            e["ms"].append(ms)
            e["plain_ms"].append(plain_ms)
            e["bytes"].append(nbytes)
            e["ops"].append(ops)
            big = max((c.x for c in inputs) if name == "box_count"
                      else inputs[0] if name == "qconv"
                      else [x for x in inputs if x is not None],
                      key=torch.numel)
            e["shapes"].append(list(big.shape))

    for path, record in recorded.items():
        measure(path, record)
    reset_counts()
    for path, record in recorded.items():
        if held.get(path, 0) != len(record) or not record:
            raise AssertionError(f"{path}: {held.get(path, 0)} of "
                                 f"{len(record)} launches were held")

    # and every launch of the sequential trackers (one motion map per frame)
    for pipeline, record in seq_recorded.items():
        if not record:
            raise AssertionError(f"{pipeline} sequential: no launch recorded")
        hold_record(f"{pipeline} sequential", record)
    reset_counts()

    # ── every pipeline on colour and any-size video (the entry points) ──
    entry_line = entry_points(pipes, cpu_pipe, counted, expect_counts,
                              check_features, hold_record, host_syncs,
                              device_kernels, layout_of)
    reset_counts()
    for key, got in entry_line["launches"].items():
        path_launches[key] = got
    say("entry_points", **entry_line)

    # ── unet's windowed decoder against its full-frame route ────────────
    window_line = windowed_phase(pipes, weights, videos, counted,
                                 expect_counts, hold_record, host_syncs,
                                 device_kernels)
    reset_counts()
    say("windowed", compared="every recorded launch exactly equal to its "
        "plain version", nvidia_smi=smi, **window_line)

    # ── cohort serving: the three cohort entries against per-video calls ─
    cohort_line, cohort_record, cohort_counts = cohort_phase(
        pipes, videos, counted, expect_counts, hold_record, host_syncs,
        device_kernels, runners,
        (lambda: against_libraries()[0]) if against else None)
    reset_counts()
    recorded["cohort-guided-vft"] = cohort_record
    path_launches["cohort-guided-vft/bf16"] = cohort_counts
    measure("cohort-guided-vft", cohort_record)
    reset_counts()
    say("cohort", nvidia_smi=smi, **cohort_line)

    # ── streaming: all five pipelines chunk by chunk vs whole videos ────
    stream_line, stream_counts = stream_phase(
        pipes, weights, videos, counted, hold_record, host_syncs, smi)
    reset_counts()
    path_launches.update(stream_counts)
    say("stream", **stream_line)

    # ── int8 serving: both modes, both routes, og_qconv on the card ─────
    quant_line, quant_record, quant_counts = quant_phase(
        pipes, weights, videos, counted, expect_counts, hold_record,
        host_syncs, device_kernels, smi)
    reset_counts()
    path_launches["quant-unet/bf16"] = quant_counts
    measure("quant-unet", quant_record)     # (not kept: ~6 GB of inputs)
    del quant_record
    reset_counts()
    say("quant", compared="every recorded launch exactly equal to its plain "
        "version", silu_stress_cases_equal_to_plain_on_cpu=qconv_silu_cpu,
        **quant_line)

    # ── evaluation: evaluate_patient over the five pipelines ────────────
    t_eval = time.perf_counter()
    eval_line, eval_record, eval_counts = eval_phase(
        pipes, cpu_pipe, counted, expect_counts, hold_record, host_syncs,
        device_kernels, smi)
    reset_counts()
    path_launches["eval/bf16"] = eval_counts
    measure("eval", eval_record)
    reset_counts()
    say("eval", compared="every recorded launch exactly equal to its plain "
        "version", stress_cases=len(eval_labels),
        phase_seconds=time.perf_counter() - t_eval, **eval_line)

    # ── MJPG: the clip read on the card, served through unet ────────────
    mjpg_line, mjpg_entries = mjpg_phase(dev, pipes["bf16"], hold, counted,
                                         host_syncs, device_kernels, smi,
                                         logs, mjpg_stress_line)
    reset_counts()
    held["mjpg"] = mjpg_line["launches_held_equal_to_plain"]
    say("mjpg", compared="exact equality with the plain version, every "
        "stress stream and every recorded launch", **mjpg_line)

    # ── training: the kernels of csrc/train.cu, both trainers, the CLI ──
    train_line, train_entries = train_phase(dev, smi, counted, logs,
                                            train_turns)
    reset_counts()
    held["train"] = train_line["launches_held_equal_to_plain"]
    say("train", compared="masks, best_gt and assigned exact; floats "
        "within TRAIN_TOL of the plain version; og_tal_assign bit-equal "
        "to it", **train_line)
    # ── the self-test with trained weights; the evaluation commands ─────
    t_st = time.perf_counter()
    selftests(dev, smi, counted, hold_any)
    reset_counts()
    say("selftests", phase_seconds=time.perf_counter() - t_st)
    say("path_launches_vs_plain", compared="every recorded launch of every "
        "path against its plain version: exact, but the training kernels' "
        "floats within TRAIN_TOL; of the self-tests' training launches one "
        f"in {TRAIN_HOLD_EVERY} of each kernel's", launches_held=held,
        selftest_training_max_err=train_err)

    # ── the two scans at the served inputs: bare, wrapper, T = 1 ────────
    def time_enqueue(fn, reps: int) -> float:
        """Mean host milliseconds to enqueue fn() while the device is kept
        busy (what a host-bound path pays for the call)."""
        fn()
        torch.cuda.synchronize()
        keep_device_busy()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        ms = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
        return ms

    def fresh_walk(t_):
        """A gate input that is fresh on every frame: a detection on every
        frame, each centre within 1 px of the one before."""
        i = np.arange(t_)
        cx = 128 + 60 * np.sin(i / 97.0)
        cy = 128 + 60 * np.cos(i / 89.0)
        b = np.stack([cx - 20, cy - 15, cx + 20, cy + 15], 1)
        return (torch.ones(t_, dtype=torch.bool, device=dev),
                torch.from_numpy(b.astype(np.float32)).to(dev))

    served = {name: (inputs, kw) for name, inputs, kw in recorded["guided-vft"]
              if name in ("gate_scan", "thresh_chain")}
    (g_has, g_raw), g_kw = served["gate_scan"]
    (t_th0, t_cur, t_npx, t_act), t_kw = served["thresh_chain"]
    served_scans = scan_cases(
        (g_has, g_raw, g_kw["frame_h"], g_kw["frame_w"], g_kw["params"]),
        (t_th0, t_cur, t_npx, t_act, t_kw["beta"]))
    scan_times = {}
    for name, t_, wfn, bfn, want in served_scans:
        got = wfn()
        torch.cuda.synchronize()
        if not identical(got, want):
            raise AssertionError(f"{name}, T={t_}: kernel and plain version "
                                 f"differ")
        scan_times[f"{name} T={t_}"] = {
            "bare_ms": time_cuda(bfn, 50), "wrapper_ms": time_cuda(wfn, 50),
            "wrapper_host_ms": time_enqueue(wfn, 50),
            "wrapper_device_kernels": device_kernels(wfn)}
    # the serial floor: the clock64() cycles of the walk (thread 0's serial
    # part) at the served inputs, on the stress sequences and on long inputs
    # that are fresh on every frame / active with no fallback on every step
    # (with the bare launch's time there)
    so = scan_cuda.lib()
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.og_gate_scan_walk_cycles.argtypes = [vp] * 6 + [ci, cf, cf, cf, ci, ci,
                                                       vp, vp]
    so.og_thresh_chain_walk_cycles.argtypes = [vp] * 5 + [ci, cf, cf, vp, vp]

    def walk_cycles(make_bare, *inputs):
        c = torch.zeros(1, dtype=torch.int64, device=dev)
        make_bare(*inputs, cycles=c)()
        torch.cuda.synchronize()
        return int(c.item())

    long_ms = {"gate_scan": {}, "thresh_chain": {}}
    cycles = {"gate_scan": {f"served T={g_has.numel()}": walk_cycles(
                  bare_gate, g_has, g_raw, g_kw["frame_h"], g_kw["frame_w"],
                  g_kw["params"])},
              "thresh_chain": {f"served T={t_cur.numel()}": walk_cycles(
                  bare_thresh, t_th0, t_cur, t_npx, t_act, t_kw["beta"])}}
    h_np, b_np, _ = gate_stress_sequence(T_FRAMES, seed=0)
    cycles["gate_scan"][f"stress T={T_FRAMES}"] = walk_cycles(
        bare_gate, torch.from_numpy(h_np).to(dev), torch.from_numpy(b_np).to(dev))
    cycles["thresh_chain"][f"stress T={T_FRAMES}"] = walk_cycles(
        bare_thresh, *(torch.from_numpy(np.asarray(x)).to(dev)
                       for x in thresh_stress_sequence(T_FRAMES, seed=0)), 0.7)
    for t_ in (4097, 20000):
        h_, r_ = fresh_walk(t_)
        th_in = (torch.tensor(100.0, device=dev),
                 torch.rand(t_, device=dev) * 255,
                 torch.full((t_,), 900.0, device=dev),
                 torch.ones(t_, dtype=torch.bool, device=dev), 0.7)
        long_ms["gate_scan"][f"T={t_}"] = time_cuda(bare_gate(h_, r_), 10)
        long_ms["thresh_chain"][f"T={t_}"] = time_cuda(bare_thresh(*th_in),
                                                       10)
        cycles["gate_scan"][f"fresh T={t_}"] = walk_cycles(bare_gate, h_, r_)
        cycles["thresh_chain"][f"active T={t_}"] = walk_cycles(bare_thresh,
                                                              *th_in)
    torch.cuda._sleep(300 * BUSY_CYCLES)     # ~3 s: read the clock under load
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.cuda.synchronize()
    sm_mhz = float(clocks.split(",")[0])
    serial = {}
    for name, c in cycles.items():
        key = next(k for k in c if k.startswith("served"))
        serial[name] = {
            "walk_cycles": c,
            "walk_cycles_per_frame": {k: n / int(k.split("T=")[1])
                                      for k, n in c.items()},
            "serial_floor_ms_served": c[key] / (sm_mhz * 1e3),
            "bare_ms_long": long_ms[name]}
    path_kernels = {p: sum(device_kernels(
        lambda p=p: pipes["bf16"].extract_features(videos[2], p)).values())
        for p in ("guided-vft", "unet", "vft")}
    say("scans", compared="exact equality with the plain version",
        served_path="guided-vft", timing=TIMING, times=scan_times,
        serial_floor=serial, sm_clock_mhz_now_max=clocks,
        n_device_kernels_per_video_bf16=path_kernels)

    # ── the motion map at vft's served inputs: bare, wrapper, T = 1 ─────
    # og_motion_map_as takes the band rows and cluster ranks explicitly; the
    # first three are the one-block-per-band design (every band's frames
    # through one SM), the others split each band's frames over a cluster
    so.og_motion_map_as.argtypes = [vp] * 5 + [ci, ci, ci, vp, ci, cf, cf,
                                               ci, ci, vp, vp]
    so.og_motion_map_layout.argtypes = [ci] * 6 + [vp]
    layout_keys = ("rows", "ranks", "chunk", "slice", "staging_buffers",
                   "smem_bytes", "blocks", "blocks_per_sm",
                   "clusters_at_once")
    phase_keys = ("prologue", "wait_for_copies", "absdiff_h_blur",
                  "w_blur_and_push", "barriers", "maps_out", "walk")

    def map_layout(t_, h_, w_, ksize, rows=0, ranks=0):
        info = (ctypes.c_longlong * 9)()
        _build.check(so.og_motion_map_layout(t_, h_, w_, ksize, rows, ranks,
                                             info), "og_motion_map_layout")
        return dict(zip(layout_keys, info))

    def bare_map(p0, fr, l0, act, alpha, ksize, rows=0, ranks=0,
                 cycles=None):
        """og_motion_map_as launched alone on buffers made here once (with
        ``cycles``, an int64 tensor of 7: block 0's phase cycles)."""
        t_, h_, w_ = fr.shape
        keep = (fr.contiguous(), p0.contiguous(), l0.contiguous(),
                act.contiguous(), torch.empty_like(fr))
        taps = scan_cuda.taps(ksize)
        args = (*(x.data_ptr() for x in keep), t_, h_, w_, taps, ksize,
                float(np.float32(alpha)), float(np.float32(1.0 - alpha)),
                rows, ranks, None if cycles is None else cycles.data_ptr())

        def run():
            _build.check(so.og_motion_map_as(*args, scan_cuda.stream()),
                         "og_motion_map_as")
            return keep[4]
        return run

    # the served launch (the other one on the path is the init's T = 1 blur)
    (m_p0, m_fr, m_l0, m_act), m_kw = max(
        ((inp, kw) for name, inp, kw in recorded["vft"]
         if name == "motion_map"), key=lambda x: x[0][1].shape[0])
    m_alpha, m_ks = m_kw["alpha"], m_kw["ksize"]
    m_want = tracker_mod.motion_map(m_p0, m_fr, m_l0, m_act, m_alpha, m_ks,
                                    use_plain=True)
    m_first = (m_p0, m_fr[:1], m_l0, m_act[:1], m_alpha, m_ks)
    m_args = (m_p0, m_fr, m_l0, m_act, m_alpha, m_ks)
    shapes = {"rows=1 ranks=1": (1, 1), "rows=2 ranks=1": (2, 1),
              "rows=4 ranks=1": (4, 1), "rows=1 ranks=2": (1, 2),
              "rows=2 ranks=2": (2, 2), "rows=2 ranks=4": (2, 4),
              "rows=2 ranks=5": (2, 5), "rows=2 ranks=6": (2, 6),
              "rows=4 ranks=8": (4, 8), "default": (0, 0)}
    runs = {k: bare_map(*m_args, rows=r_, ranks=k_)
            for k, (r_, k_) in shapes.items()}
    for k, fn in runs.items():
        if not identical(fn(), m_want):
            raise AssertionError(f"motion_map {k}: differs from its plain "
                                 f"version")
    sweep = {k: [] for k in runs}
    for k in [*runs, *reversed(runs)]:
        sweep[k].append(time_cuda(runs[k], 50))
    t_sh = tuple(m_fr.shape)
    m_cycles = torch.zeros(7, dtype=torch.int64, device=dev)
    bare_map(*m_args, cycles=m_cycles)()
    torch.cuda.synchronize()
    one_cycles = torch.zeros(7, dtype=torch.int64, device=dev)
    bare_map(*m_first, cycles=one_cycles)()
    # the same frames through a 1-tap blur: what the phases cost without
    # the blur's arithmetic
    k1_cycles = torch.zeros(7, dtype=torch.int64, device=dev)
    d_lay = map_layout(*t_sh, m_ks)
    bare_map(*m_args[:5], 1, rows=d_lay["rows"], ranks=d_lay["ranks"],
             cycles=k1_cycles)()
    torch.cuda.synchronize()
    m_wrapper = lambda: tracker_mod.motion_map(*m_args)     # noqa: E731
    m_bytes = m_fr.numel() * 8 + m_p0.numel() * 8 + m_act.numel()
    m_ops = m_fr.numel() * (4 * m_ks + 2)
    # the eager stage this kernel replaces: absdiff and blur as eager
    # PyTorch (the plain version's own), queued
    eager_blur = lambda: gaussian_blur(                     # noqa: E731
        (m_fr - tracker_mod._prev_chain(m_p0, m_fr)).abs(), m_ks)
    default_layout = d_lay
    kname = (f"motion_map_kernel<{default_layout['rows']},"
             f"{6 if m_ks == 13 else -1}>")
    motion_map_line = {
        "served_shape": list(t_sh), "ksize": m_ks, "alpha": m_alpha,
        "timing": TIMING,
        "bare_ms": time_cuda(runs["default"], 50),
        "wrapper_ms": time_cuda(m_wrapper, 50),
        "bare_ms_t1": time_cuda(bare_map(*m_first), 50),
        "wrapper_ms_t1": time_cuda(
            lambda: tracker_mod.motion_map(*m_first), 50),
        "bound_ms": max(m_bytes / HBM_BYTES_PER_S, m_ops / FP32_OPS_PER_S)
        * 1e3,
        "bound_by": ("bytes" if m_bytes / HBM_BYTES_PER_S
                     >= m_ops / FP32_OPS_PER_S else "operations"),
        "eager_absdiff_blur_ms": time_cuda(eager_blur, 20),
        "eager_absdiff_blur_device_kernels": sum(
            device_kernels(eager_blur).values()),
        "wrapper_device_kernels": device_kernels(m_wrapper),
        "layout": default_layout,
        "layout_t1": map_layout(1, *t_sh[1:], m_ks),
        "ptxas": {k: v for k, v in ptxas_summary(logs["scan"]).items()
                  if k.startswith("motion_map_kernel")},
        "served_kernel": kname,
        "phase_cycles": dict(zip(phase_keys, m_cycles.tolist())),
        "phase_cycles_t1": dict(zip(phase_keys, one_cycles.tolist())),
        "phase_cycles_ksize1": dict(zip(phase_keys, k1_cycles.tolist())),
        "sm_clock_mhz_now_max": clocks,
        "rows_ranks_in_turns_ms": {k: sum(v) / len(v)
                                   for k, v in sweep.items()},
        "rows_ranks_layouts": {k: map_layout(*t_sh, m_ks, r_, k_)
                               for k, (r_, k_) in shapes.items()},
    }
    say("motion_map", compared="exact equality with the plain version, "
        "every layout", **motion_map_line)
    scan_times[f"motion_map T={t_sh[0]}"] = {
        "bare_ms": motion_map_line["bare_ms"]}

    if against:
        # the motion-map stage: this checkout's one launch in turns with an
        # older checkout's stage as it served it (the eager absdiff and blur,
        # then its og_lmap_ema through the old C interface), held equal
        libs, _ = against_libraries()
        stages = {"this": m_wrapper}
        for d in against:
            old = getattr(libs[d]["scan"], "og_lmap_ema", None)
            if old is None:
                continue
            old.argtypes = [vp] * 4 + [ci, ci, cf, cf, vp]
            old.restype = ctypes.c_int

            def old_stage(old=old):
                dd = eager_blur()
                a8 = m_act.to(torch.uint8).contiguous()
                o = torch.empty_like(dd)
                _build.check(old(m_l0.data_ptr(), dd.data_ptr(),
                                 a8.data_ptr(), o.data_ptr(), dd.shape[0],
                                 m_l0.numel(), float(np.float32(m_alpha)),
                                 float(np.float32(1.0 - m_alpha)),
                                 scan_cuda.stream()), "og_lmap_ema")
                return o
            stages[d] = old_stage
        for tag, fn in stages.items():
            if not identical(fn(), m_want):
                raise AssertionError(f"motion-map stage of {tag} differs "
                                     f"from the plain version")
        stage_ms = {tag: [] for tag in stages}
        for tag in [*stages, *reversed(stages)]:
            stage_ms[tag].append(time_cuda(stages[tag], 50))
        say("against_motion_map_stage", timing=TIMING,
            shape=list(t_sh), order=[*stages, *reversed(stages)],
            compared="exact equality with the plain version",
            ms={k: sum(v) / len(v) for k, v in stage_ms.items()},
            ms_each_turn=stage_ms,
            device_kernels={k: sum(device_kernels(fn).values())
                            for k, fn in stages.items()})
        # the og_motion_map of each older checkout that has one, through
        # this wrapper in turns with this one on the same inputs; not held
        # equal (an older kernel may round its blur otherwise): the values
        # that differ in bits from this plain version are counted
        maps = {tag: lib_ for tag, lib_ in libs.items()
                if hasattr(lib_["scan"], "og_motion_map")}
        map_ms = {tag: [] for tag in maps}
        bits_differing = {}
        for tag in [*maps, *reversed(maps)]:
            with kernel_libraries(maps[tag]):
                if tag not in bits_differing:
                    got = m_wrapper()
                    bits_differing[tag] = int((got.view(torch.int32)
                                               != m_want.view(torch.int32)
                                               ).sum())
                map_ms[tag].append(time_cuda(m_wrapper, 50))
        if bits_differing["this"] != 0:
            raise AssertionError("motion_map differs from its plain version")
        say("against_motion_map", timing=TIMING, shape=list(t_sh),
            order=[*maps, *reversed(maps)],
            ms={k: sum(v) / len(v) for k, v in map_ms.items()},
            ms_each_turn=map_ms, values_differing_from_plain=bits_differing)
        items = []
        for path, record in recorded.items():
            for k, (name, inputs, kw) in enumerate(record):
                if name in blobs_cuda.LAUNCHES:
                    kfn, pfn, _, _ = runners(name, inputs, kw)
                    shape = max(inputs, key=torch.numel).shape
                    items.append((f"{name} {path} "
                                  f"{'x'.join(map(str, shape))} #{k}",
                                  kfn, pfn()))
        in_turns(items + stress_items() + scan_items(served_scans, "served")
                 + scan_items(stress_scan_cases(), "stress"),
                 # (vft's motion map is one launch of this checkout's
                 # og_motion_map, which an older library may lack: its stage
                 # is compared on its own above)
                 {"guided-vft/bf16": lambda: serve(pipes["bf16"],
                                                   "guided-vft"),
                  "vft/bf16": lambda: serve(pipes["bf16"], "vft")})

    for name in ("gate_scan_batch", "thresh_chain_batch"):
        t_ = max(sh[0] for sh in per_kernel[name]["shapes"])
        scan_times[f"{name} T={t_}"] = {
            "bare_ms": cohort_line["kernel_times"][f"{name} bare"]}

    kernels = []
    for name, (replaces, path) in kernel_table.items():
        e = per_kernel.get(name)
        launches = path_launches[f"{path}/bf16"][name]
        if e is None or launches == 0:
            raise AssertionError(f"{name} was not launched on the {path} path")
        # a kernel launched more than once per video reports the mean over
        # its launches at the largest shape (the served one), bound included;
        # every launch stays in ms_each_launch
        big = max(math.prod(s) for s in e["shapes"])
        at = [i for i, s in enumerate(e["shapes"]) if math.prod(s) == big]
        n = len(at)
        t_bytes = sum(e["bytes"][i] for i in at) / n / HBM_BYTES_PER_S * 1e3
        rate = INT8_OPS_PER_S if name == "qconv" else FP32_OPS_PER_S
        t_ops = sum(e["ops"][i] for i in at) / n / rate * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": source[name],
            "c_entry": c_entry[name],
            "replaces": replaces, "path": path, "launches": launches,
            "launches_by_path": {k: v[name] for k, v in path_launches.items()
                                 if k.endswith("/bf16")},
            "max_abs_err": max_err[name],
            "ms": sum(e["ms"][i] for i in at) / n,
            "plain_ms": sum(e["plain_ms"][i] for i in at) / n,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "shapes": e["shapes"],
            "ms_each_launch": e["ms"],
            "ms_each_launch_on_other_paths": elsewhere.get(name, {}),
            # the scans of scan.cu: also the C launch alone (``ms`` is the
            # wrapper's device time, helper launches included)
            **({"bare_ms": scan_times[key]["bare_ms"]}
               if (key := f"{name} T={max(s[0] for s in e['shapes'])}")
               in scan_times
               else {}),
        })
    for e in mjpg_entries:
        e["max_abs_err"] = max_err[e["name"]]
    kernels += mjpg_entries + train_entries
    print(json.dumps({"kernels": kernels, "timing": TIMING}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
