#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # everything
    python3 chip_smoke.py --kernels-only  # build + kernel checks
    python3 chip_smoke.py --against DIR [DIR ...]
        # everything, then the blob kernels of this checkout and of each DIR
        # (the root of another checkout, e.g. a parent commit unpacked by
        # ``git archive`` into a git-ignored directory) timed in turns

Builds the CUDA kernels from ``openglottal_tpu_torch/csrc`` with nvcc, holds
each against its plain PyTorch version (exact equality), then serves 502-frame
256x256 synthetic videos through ``GlottalPipelines.extract_features`` with
the demo weights — ``guided-vft``, ``unet`` and ``vft``, bfloat16 and float32
— and checks that the kernels were launched on those paths, that every
launch equals its plain version on the path's own inputs and that the
results are right; then the blob filter's two routes against each other and
the sequential tracker forms.  Prints the registers and spills ptxas reports
for every kernel and the thread blocks per SM each blob entry point's launch
gets.  Needs a CUDA device and nvcc; fails (non-zero exit, no result
line) without them.  Every phase prints one JSON line; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

T_FRAMES = 502          # one high-speed clip
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
        # the last component of an Itanium-mangled (nested) name
        if not sym.startswith("_Z"):
            return sym
        pos, parts = (3 if sym.startswith("_ZN") else 2), []
        while pos < len(sym) and sym[pos].isdigit():
            n = re.match(r"\d+", sym[pos:]).group()
            pos += len(n)
            parts.append(sym[pos:pos + int(n)])
            pos += int(n)
        return parts[-1] if parts else sym

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


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from openglottal_tpu_torch.data.synthetic import (
        blob_stress_masks,
        synthetic_video,
    )
    from openglottal_tpu_torch.models import gate as gate_mod
    from openglottal_tpu_torch.models import tracker as tracker_mod
    from openglottal_tpu_torch.ops import _build, blobs, blobs_cuda, scan_cuda
    from openglottal_tpu_torch.pipelines import GlottalPipelines

    args = sys.argv[1:]
    kernels_only = "--kernels-only" in args
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

    # where the union-find keeps its grids, and how many of its blocks share
    # an SM, at each frame size a launch below takes (one rule in blobs.cu
    # decides the layout of every entry point)
    lib = _build.load("blobs")
    lib.og_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.og_smem_bytes.restype = ctypes.c_longlong
    lib.og_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.og_blocks_per_sm.restype = ctypes.c_int

    def layout_of(h, w):
        n = lib.og_blocks_per_sm(h, w)
        if n <= 0:
            raise AssertionError(f"og_blocks_per_sm({h}, {w}) = {n}")
        return {"smem_bytes": lib.og_smem_bytes(h, w), "blocks_per_sm": n}

    # the widest frame of 215 columns whose grids fit shared memory, and one
    # row more (the first that takes the device-memory layout)
    w_edge = 215
    h_fit = max(h for h in range(1, 1024) if lib.og_smem_bytes(h, w_edge) > 0)
    path_shapes = {"dual_cc_batch": [(128, 128)],
                   "dual_min_prop_batch": [(128, 128)],
                   "min_prop_batch": [(128, 128), (48, 40)],
                   "cc_batch": [(48, 40)], "cc": [(48, 40)]}
    stress_shapes = [(128, 128), (256, 256), (100, 140), (h_fit, w_edge),
                     (h_fit + 1, w_edge)]
    say("occupancy",
        path_shapes={k: {f"{h}x{w}": layout_of(h, w) for h, w in v}
                     for k, v in path_shapes.items()},
        stress_shapes={f"{h}x{w}": layout_of(h, w) for h, w in stress_shapes})

    def counts() -> dict:
        return {**blobs_cuda.LAUNCHES, **scan_cuda.LAUNCHES}

    def reset_counts() -> None:
        blobs_cuda.reset_launch_counts()
        scan_cuda.reset_launch_counts()

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
        # the motion-map recurrence: random maps, an inactive prefix and tail
        tl, hl, wl = 300, 61, 97
        d = torch.from_numpy(r.uniform(0, 60, (tl, hl, wl)).astype(np.float32)
                             ).to(dev)
        l0 = torch.from_numpy(r.uniform(0, 40, (hl, wl)).astype(np.float32)
                              ).to(dev)
        act = torch.from_numpy((np.arange(tl) >= 2) & (np.arange(tl) < tl - 9)
                               ).to(dev)
        for alpha in (0.98, 0.3):
            k = tracker_mod.lmap_ema(l0, d, act, alpha)
            p = tracker_mod.lmap_ema(l0, d, act, alpha, use_plain=True)
            hold("lmap_ema", k.view(torch.int32), p.view(torch.int32))
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
    for tl, hl, wl in ((500, 48, 40), (500, 128, 128)):
        d = torch.rand((tl, hl, wl), device=dev) * 60
        l0 = torch.rand((hl, wl), device=dev) * 40
        act = torch.arange(tl, device=dev) >= 2
        stress_ms.append({
            "kernel": "lmap_ema", "shape": [tl, hl, wl],
            "kernel_ms": time_cuda(
                lambda: tracker_mod.lmap_ema(l0, d, act, 0.98), 20),
            "plain_ms": time_cuda(
                lambda: tracker_mod.lmap_ema(l0, d, act, 0.98,
                                             use_plain=True), 1)})

    # ── in turns against other checkouts' blob kernels (--against) ──────
    @contextlib.contextmanager
    def blobs_library(other):
        """The blob wrappers launch the kernels of library ``other`` (same C
        interface) inside the block."""
        saved = _build._libs["blobs"]
        _build._libs["blobs"] = other
        blobs_cuda._configured = False
        try:
            yield
        finally:
            _build._libs["blobs"] = saved
            blobs_cuda._configured = False

    def in_turns(items, walls=None):
        """The blob kernels of this checkout and of every --against checkout
        on the same inputs: each held exactly equal to the plain version,
        then timed in turns (this, a, b, b, a, this; each ``ms`` is the mean
        of a library's two turns).  items: (label, kernel fn, plain output).
        walls: {label: fn returning wall ms per video}, served with each
        library in the same turns, twice over."""
        built = _build.build_others(
            {f"blobs_against{i}": Path(d) / "openglottal_tpu_torch/csrc/blobs.cu"
             for i, d in enumerate(against)}, ("-Xptxas", "-v"))
        libs = {"this": lib, **{d: built[f"blobs_against{i}"][0]
                                for i, d in enumerate(against)}}
        order = [*libs, *reversed(libs)]
        each = {label: {tag: [] for tag in libs} for label, _, _ in items}
        wall = {label: {tag: [] for tag in libs} for label in walls or {}}
        for tag in order + order:
            with blobs_library(libs[tag]):
                for label, fn in (walls or {}).items():
                    wall[label][tag] += fn()
        for tag in order:
            with blobs_library(libs[tag]):
                for label, kfn, want in items:
                    if not each[label][tag]:
                        got = kfn()
                        torch.cuda.synchronize()
                        if not torch.equal(got, want):
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
            ptxas={d: ptxas_summary(built[f"blobs_against{i}"][1])
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

    say("kernels", ok=True, compared="exact equality with the plain version",
        shapes=[list(stress[i].shape) for i in first_batch],
        stress_batches=len(stress),
        max_abs_err=max_err, stress_times=stress_ms)
    reset_counts()

    if kernels_only:
        if against:
            in_turns(stress_items())
        return 0

    # ── the main paths ──────────────────────────────────────────────────
    def video(seed: int):
        frames, _ = synthetic_video(t=T_FRAMES, size=256, seed=seed,
                                    realistic=False)
        return np.ascontiguousarray(frames[..., 0])

    videos = [video(s) for s in range(4)]
    weights = dict(unet_variables="weights/demo_unet.npz",
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

    def counted(fn, record=None):
        """fn() with every launch count set to 0 just before and read just
        after; launches are also recorded into ``record`` when given."""
        blobs_cuda.RECORD = scan_cuda.RECORD = record
        reset_counts()
        try:
            out = fn()
            return out, counts()
        finally:
            blobs_cuda.RECORD = scan_cuda.RECORD = None

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
                            "lmap_ema": 0}),
            ("unet", {"gate_scan": 1}),
            # vft: the tracker's init labels one ROI mask (2 single-frame CC
            # launches); the ROI filter and the output filter are one
            # top_n_blobs_batch each, by the split route (2 single-region CC
            # launches + 2 + 2 single-region broadcasts apiece)
            ("vft", {"gate_scan": 1, "cc": 2, "lmap_ema": 1,
                     "cc_batch": 4, "min_prop_batch": 8, "thresh_chain": 1,
                     "dual_cc_batch": 0, "dual_min_prop_batch": 0})):
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
            extra = {}
            if pipeline != "unet":
                # gate facts of this video, and the plain-kernel run
                gray = pipe._to_gray(videos[0])
                valid, boxes = pipe._detect_gate(gray)
                side = (boxes[:, 2:] - boxes[:, :2]).max().item()
                extra = {"gate_valid_share": float(valid.float().mean()),
                         "max_box_side": side}
                if pipeline == "guided-vft":
                    extra["all_boxes_fit_128_window"] = bool(side <= 126)
                else:
                    _, _, idx, hw0 = pipe._vft_compute(gray, valid, boxes,
                                                       T_FRAMES)
                    extra["locked_crop_size_h_w"] = list(hw0)
                    extra["tracked_frames"] = int(len(idx))
                plain = GlottalPipelines(dtype=pipe.dtype,
                                         use_plain_kernels=True, **weights)
                pf, pc = counted(
                    lambda: plain.extract_features(videos[0], pipeline))
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
    n_valid = int(seq_pipe._detect_gate(gray)[0].sum())
    sequential = {}
    for pipeline, n_cc, n_steps in (
            # init: 2 launches; a vft step labels the ROI mask and the output
            # mask (4 launches) and runs for every gated crop, the inactive
            # init crops included; a guided step labels the output mask (2)
            ("vft", 2 + 4 * n_valid, n_valid),
            ("guided-vft", 2 * (len(clip) - 2), len(clip) - 2)):
        a_par = pipes["bf16"].extract_features(clip, pipeline)["_area"]
        seq_pipe.extract_features(clip, pipeline)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats, got = counted(lambda: seq_pipe.extract_features(clip, pipeline))
        wall = (time.perf_counter() - t0) * 1e3
        expect_counts(f"{pipeline}, sequential", got,
                      {"cc": n_cc, "lmap_ema": n_steps, "thresh_chain": n_steps,
                       "gate_scan": 1, "cc_batch": 0, "dual_cc_batch": 0})
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
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                pipes["bf16"].extract_features(videos[2], pipeline)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        # (switching the debug mode on warns once itself, from torch/cuda)
        hits = [w for w in caught if "synchroniz" in str(w.message)
                and not w.filename.endswith("torch/cuda/__init__.py")]
        syncs[pipeline] = len(hits)
        sync_sites[pipeline] = sorted(
            {f"{'/'.join(w.filename.split('/')[-2:])}:{w.lineno}" for w in hits})

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
        "lmap_ema": ("openglottal_tpu/models/tracker.py:204", "vft"),
    }
    source = {k: "openglottal_tpu_torch/csrc/blobs.cu" for k in blobs_cuda.LAUNCHES}
    source.update({k: "openglottal_tpu_torch/csrc/scan.cu" for k in scan_cuda.LAUNCHES})

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
            return (lambda: gate_mod.gate_scan(has, raw, *args),
                    lambda: gate_mod.gate_scan(has, raw, *args, use_plain=True),
                    n * (1 + 16 + 1 + 16), n * 40)
        if name == "lmap_ema":
            l0, d, act = inputs
            return (lambda: tracker_mod.lmap_ema(l0, d, act, kw["alpha"]),
                    lambda: tracker_mod.lmap_ema(l0, d, act, kw["alpha"],
                                                 use_plain=True),
                    l0.numel() * 4 + d.numel() * 8 + act.numel(),
                    d.numel() * 2)
        th0, cur, npx, act = inputs
        n = cur.numel()
        return (lambda: tracker_mod._thresh_chain(th0, cur, npx, act, kw["beta"]),
                lambda: tracker_mod._thresh_chain(th0, cur, npx, act, kw["beta"],
                                                  use_plain=True),
                n * (4 + 4 + 1 + 4) + 4, n * 4)

    per_kernel = {}
    elsewhere = {}     # kernel -> path -> ms of each launch on another path
    held = {}          # path -> launches held against their plain versions
    for path, record in recorded.items():
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
            e["shapes"].append(list(max(inputs, key=torch.numel).shape))
    reset_counts()
    for path, record in recorded.items():
        if held.get(path, 0) != len(record) or not record:
            raise AssertionError(f"{path}: {held.get(path, 0)} of "
                                 f"{len(record)} launches were held")
    say("path_launches_vs_plain", compared="exact equality with the plain "
        "version, every recorded launch of every path", launches_held=held)

    if against:
        items = []
        for path, record in recorded.items():
            for k, (name, inputs, kw) in enumerate(record):
                if name in blobs_cuda.LAUNCHES:
                    kfn, pfn, _, _ = runners(name, inputs, kw)
                    shape = max(inputs, key=torch.numel).shape
                    items.append((f"{name} {path} "
                                  f"{'x'.join(map(str, shape))} #{k}",
                                  kfn, pfn()))
        in_turns(items + stress_items(),
                 {f"{p}/bf16": (lambda p=p: serve(pipes["bf16"], p))
                  for p in ("guided-vft", "vft")})

    kernels = []
    for name, (replaces, path) in kernel_table.items():
        e = per_kernel.get(name)
        launches = path_launches[f"{path}/bf16"][name]
        if e is None or launches == 0:
            raise AssertionError(f"{name} was not launched on the {path} path")
        # a kernel launched more than once per video reports the mean over
        # its launches, bound included
        n = len(e["ms"])
        t_bytes = sum(e["bytes"]) / n / HBM_BYTES_PER_S * 1e3
        t_ops = sum(e["ops"]) / n / FP32_OPS_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": source[name],
            "replaces": replaces, "path": path, "launches": launches,
            "launches_by_path": {k: v[name] for k, v in path_launches.items()
                                 if k.endswith("/bf16")},
            "max_abs_err": max_err[name], "ms": sum(e["ms"]) / n,
            "plain_ms": sum(e["plain_ms"]) / n,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "shapes": e["shapes"],
            "ms_each_launch": e["ms"],
            "ms_each_launch_on_other_paths": elsewhere.get(name, {}),
        })
    print(json.dumps({"kernels": kernels, "timing": TIMING}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
