#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # everything
    python3 chip_smoke.py --kernels-only  # build (ptxas -v) + kernel checks

Builds the CUDA kernels from ``openglottal_tpu_torch/csrc`` with nvcc, holds
each against its plain PyTorch version (exact equality), then serves 502-frame
256x256 synthetic videos through ``GlottalPipelines.extract_features`` with
the demo weights — ``guided-vft`` and ``unet``, bfloat16 and float32 — and
checks that the kernels were launched on that path and that the results are
right.  Needs a CUDA device and nvcc; fails (non-zero exit, no result line)
without them.  Every phase prints one JSON line; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings

T_FRAMES = 502          # one high-speed clip
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM, non-tensor-core rate (int32 has no
#                             row of its own in the data sheet; same order)


def say(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def time_cuda(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps launches, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
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
    from openglottal_tpu_torch.ops import _build, blobs_cuda, scan_cuda
    from openglottal_tpu_torch.pipelines import GlottalPipelines

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), nvidia_smi=smi)

    # ── build ───────────────────────────────────────────────────────────
    t0 = time.perf_counter()
    kernels_only = "--kernels-only" in sys.argv[1:]
    logs = _build.build_all(("-Xptxas", "-v") if kernels_only else ())
    say("build", seconds=round(time.perf_counter() - t0, 2),
        sources=[f"openglottal_tpu_torch/csrc/{n}.cu" for n in _build.SOURCES])
    if kernels_only:
        for name, log in logs.items():
            print(f"--- nvcc {name}.cu ---\n{log}", flush=True)

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
    # (8,128,128) shared-memory path, (4,256,256) device-memory path,
    # (3,100,140) ragged; all 14 stress masks are cycled through each shape
    for n, h, w in ((8, 128, 128), (4, 256, 256), (3, 100, 140)):
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
    # kernel and plain times on one stress batch per shape (the 256x256 rows
    # are the only timing of the device-memory path: served videos whose gate
    # boxes fit the 128x128 window never take it)
    stress_ms = []
    for m_np in (stress[0], stress[2], stress[6]):
        t, h, w = m_np.shape
        masks = torch.from_numpy(m_np).to(dev)
        code = 2 - masks.to(torch.uint8)
        init = torch.arange(h * w, dtype=torch.int32, device=dev
                            ).view(1, h, w).expand(t, -1, -1).contiguous()
        for name, kfn, pfn in (
                ("dual_cc_batch", lambda: blobs_cuda.dual_cc_batch(code),
                 lambda: blobs_cuda.dual_cc_plain(code)),
                ("dual_min_prop_batch",
                 lambda: blobs_cuda.dual_min_prop_batch(code, init),
                 lambda: blobs_cuda.dual_min_prop_plain(code, init)),
                ("min_prop_batch",
                 lambda: blobs_cuda.min_prop_batch(masks, init, 8),
                 lambda: blobs_cuda.min_prop_plain(masks, init, 8))):
            stress_ms.append({"kernel": name, "shape": [t, h, w],
                              "kernel_ms": time_cuda(kfn, 20),
                              "plain_ms": time_cuda(pfn, 1)})
    say("kernels", ok=True, compared="exact equality with the plain version",
        shapes=[list(m.shape) for m in stress[::4]], stress_batches=len(stress),
        max_abs_err=max_err, stress_times=stress_ms)
    reset_counts()

    if kernels_only:
        return 0

    # ── the main path ───────────────────────────────────────────────────
    def video(seed: int):
        frames, _ = synthetic_video(t=T_FRAMES, size=256, seed=seed,
                                    realistic=False)
        return np.ascontiguousarray(frames[..., 0])

    videos = [video(s) for s in range(4)]
    weights = dict(unet_variables="weights/demo_unet.npz",
                   yolo_variables="weights/demo_yolo.npz", conf=0.25)
    pipes = {"bf16": GlottalPipelines(dtype=torch.bfloat16, **weights),
             "f32": GlottalPipelines(dtype=torch.float32, **weights)}

    def check_features(name, feats, expect_f0=0.05):
        if feats is None:
            raise AssertionError(f"{name}: extract_features returned None")
        area = feats["_area"]
        if area.shape != (T_FRAMES,) or not np.isfinite(area).all():
            raise AssertionError(f"{name}: bad waveform {area.shape}")
        for k in ("area_mean", "area_std", "area_range", "open_quotient",
                  "periodicity", "cv"):
            if not np.isfinite(feats[k]):
                raise AssertionError(f"{name}: {k} = {feats[k]}")
        if feats["f0"] is None or abs(feats["f0"] - expect_f0) > 0.005:
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

    path_launches = {}
    recorded = []
    waves = {}
    for pipeline, expected in (
            ("guided-vft", {"dual_cc_batch": 1, "dual_min_prop_batch": 1,
                            "min_prop_batch": 2, "gate_scan": 1,
                            "thresh_chain": 1}),
            ("unet", {"gate_scan": 1})):
        for tag, pipe in pipes.items():
            pipe.extract_features(videos[1], pipeline)     # warm-up (cuDNN)
            record = []
            blobs_cuda.RECORD = scan_cuda.RECORD = record
            reset_counts()
            feats = pipe.extract_features(videos[0], pipeline)
            got = counts()
            blobs_cuda.RECORD = scan_cuda.RECORD = None
            for k, n in expected.items():
                if got[k] != n:
                    raise AssertionError(
                        f"{pipeline}/{tag}: {k} launched {got[k]} times on "
                        f"the main path, expected {n}")
            path_launches[f"{pipeline}/{tag}"] = got
            if pipeline == "guided-vft" and tag == "bf16":
                recorded = record
            summary = check_features(f"{pipeline}/{tag}", feats)
            waves[(pipeline, tag)] = feats["_area"]
            ms = serve(pipe, pipeline)
            extra = {}
            if pipeline == "guided-vft":
                # gate and window facts of this video, and the plain-kernel run
                gray = pipe._to_gray(videos[0])
                valid, boxes = pipe._detect_gate(gray)
                side = (boxes[:, 2:] - boxes[:, :2]).max().item()
                extra = {"gate_valid_share": float(valid.float().mean()),
                         "max_box_side": side,
                         "all_boxes_fit_128_window": bool(side <= 126)}
                plain = GlottalPipelines(dtype=pipe.dtype,
                                         use_plain_kernels=True, **weights)
                reset_counts()
                pa = plain.extract_features(videos[0], pipeline)["_area"]
                if any(counts().values()):
                    raise AssertionError("plain-kernel run launched a kernel")
                if not np.array_equal(pa, feats["_area"]):
                    raise AssertionError(
                        f"{pipeline}/{tag}: waveform differs between the CUDA "
                        f"kernels and their plain versions")
                extra["equals_plain_kernel_run"] = True
            say(pipeline.replace("-", "_"), dtype=tag, features=summary,
                launches=got, wall_ms_per_video=ms,
                frames_per_s=T_FRAMES / (float(np.median(ms)) / 1e3), **extra)
    reset_counts()

    rel_l1 = float(np.abs(waves[("unet", "bf16")] - waves[("unet", "f32")]).sum()
                   / waves[("unet", "f32")].sum())
    if rel_l1 >= 0.05:
        raise AssertionError(f"unet: bf16 vs f32 waveform relative L1 {rel_l1}")

    # host synchronisations per video, counted by PyTorch's sync debug mode
    syncs, sync_sites = {}, {}
    for pipeline in ("guided-vft", "unet"):
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
    for pipeline in ("guided-vft", "unet"):
        a = cpu_pipe.extract_features(small, pipeline)["_area"]
        b = pipes["f32"].extract_features(small, pipeline)["_area"]
        agree[pipeline] = float(np.abs(a - b).sum() / max(a.sum(), 1.0))
        if agree[pipeline] >= 0.05:
            raise AssertionError(f"{pipeline}: card vs CPU relative L1 "
                                 f"{agree[pipeline]} on 12 frames")
    say("checks", unet_bf16_vs_f32_rel_l1=rel_l1, host_syncs_per_video=syncs, host_sync_sites=sync_sites,
        card_vs_cpu_rel_l1_12_frames=agree)

    # ── each kernel at the main path's shapes, on the recorded inputs ───
    replaces = {
        "dual_cc_batch": "openglottal_tpu/ops/blobs_pallas.py:357",
        "dual_min_prop_batch": "openglottal_tpu/ops/blobs_pallas.py:380",
        "min_prop_batch": "openglottal_tpu/ops/blobs_pallas.py:434",
        "gate_scan": "openglottal_tpu/models/gate.py:98",
        "thresh_chain": "openglottal_tpu/models/tracker.py:216",
    }
    source = {k: "openglottal_tpu_torch/csrc/blobs.cu" for k in blobs_cuda.LAUNCHES}
    source.update({k: "openglottal_tpu_torch/csrc/scan.cu" for k in scan_cuda.LAUNCHES})

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
            code = region.to(torch.uint8) * (1 if conn == 8 else 2)
            return (lambda: blobs_cuda.min_prop_batch(region, init, conn),
                    lambda: blobs_cuda.min_prop_plain(region, init, conn),
                    px * 9, links(code) + px)
        if name == "gate_scan":
            has, raw = inputs
            n = has.numel()
            args = (kw["frame_h"], kw["frame_w"], kw["params"])
            return (lambda: gate_mod.gate_scan(has, raw, *args),
                    lambda: gate_mod.gate_scan(has, raw, *args, use_plain=True),
                    n * (1 + 16 + 1 + 16), n * 40)
        th0, cur, npx, act = inputs
        n = cur.numel()
        return (lambda: tracker_mod._thresh_chain(th0, cur, npx, act, kw["beta"]),
                lambda: tracker_mod._thresh_chain(th0, cur, npx, act, kw["beta"],
                                                  use_plain=True),
                n * (4 + 4 + 1 + 4) + 4, n * 4)

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

    per_kernel = {}
    for name, inputs, kw in recorded:
        kfn, pfn, nbytes, ops = runners(name, inputs, kw)
        on_host = name in scan_cuda.LAUNCHES
        got, want = kfn(), pfn()
        if isinstance(got, tuple):
            for g, w_ in zip(got, want):
                hold(name, g, w_)
        elif got.dtype.is_floating_point:
            hold(name, got.view(torch.int32), want.view(torch.int32))
        else:
            hold(name, got, want)
        ms = time_cuda(kfn, 20)
        plain_ms = time_host(pfn, 2) if on_host else time_cuda(pfn, 2)
        e = per_kernel.setdefault(name, {"ms": [], "plain_ms": [], "bytes": [],
                                         "ops": [], "shapes": []})
        e["ms"].append(ms)
        e["plain_ms"].append(plain_ms)
        e["bytes"].append(nbytes)
        e["ops"].append(ops)
        e["shapes"].append(list(inputs[-1].shape))
    reset_counts()

    kernels = []
    main_counts = path_launches["guided-vft/bf16"]
    for name in replaces:
        e = per_kernel.get(name)
        if e is None or main_counts[name] == 0:
            raise AssertionError(f"{name} was not launched on the main path")
        # a kernel launched more than once per video (min_prop_batch: the
        # 4-connected hole pass and the 8-connected owner pass) reports the
        # mean over its launches, bound included
        n = len(e["ms"])
        t_bytes = sum(e["bytes"]) / n / HBM_BYTES_PER_S * 1e3
        t_ops = sum(e["ops"]) / n / FP32_OPS_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": source[name],
            "replaces": replaces[name], "launches": main_counts[name],
            "max_abs_err": max_err[name], "ms": sum(e["ms"]) / n,
            "plain_ms": sum(e["plain_ms"]) / n,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "shapes": e["shapes"],
            "ms_each_launch": e["ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
