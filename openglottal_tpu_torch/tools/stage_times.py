"""Where a served video's time goes, on one CUDA device.

    python3 -m openglottal_tpu_torch.tools.stage_times [--frames 502] [--out DIR]
        [--pipelines guided-vft,unet,unet-full,vft] [--dtypes bf16,f32]
        [--cohort K] [--quant int8|int8-full]

Serves synthetic 256x256 videos through ``guided-vft``, ``unet`` (its
windowed decoder, the default on this input), ``unet-full`` (``unet`` with
``window_decoder=False``) and ``vft`` (demo weights, bfloat16 and float32)
and prints one JSON line per pipeline/dtype:

  * ``wall_ms``: host clock around ``extract_features`` (ends in a host read);
  * ``stages_ms``: device time of each stage by CUDA events, measured on a
    second pass in which every stage is followed by a synchronise (so stages
    cannot overlap; their sum exceeds the pipelined wall time's device part).
    The windowed U-Net's stages: ``unet_to_d3`` (encoder, bottleneck and the
    two deeper decoder levels), ``window_origin``, ``unet_mid_window``,
    ``unet_tail_window`` (the last level and the head), ``box_count``, and
    apart from them ``window_copies`` (the three window slices alone, also
    inside the two window stages);
  * ``profile``: ``torch.profiler`` over one video — device busy share of the
    wall time and the kernels with the most device time.

``--cohort K`` adds one line per dtype for ``guided-vft``'s cohort form
(``guided_vft_areas_gray_multi`` on K distinct videos, one sub-batch), by
the same rules, its stages as the cohort runs them: ``upload`` (K videos),
``detector`` (every video's chunks), ``gate_scan_batch`` (one launch),
``tracker_init`` (K seed thresholds at once), ``tracked_frames`` (the
tracked frames, valid flags and boxes flattened), ``window_fit_read`` (the
one host read of the window choice), ``window_gather``, ``percentile``,
``thresh_chain_batch``, ``threshold_compare``, ``blob_filter_total`` (and
its kernels apart), ``area_sum_and_read``; each also per video.

``--quant MODE`` serves ``unet`` / ``unet-full`` in the int8 mode
(``GlottalPipelines(quant=MODE)``, calibrated on the first video) and splits
the int8 U-Net into its stages: ``int8_stem`` (the bfloat16 stem and its
requantisation), ``int8_convs_to_d3`` (the og_qconv launches and max-pools
of the encoder, the bottleneck and the two deeper decoder levels),
``int8_upsamplers`` (the four bfloat16 transposed convs, dequantised in and
requantised out), ``int8_window_cuts`` (the window gathers; windowed route),
``int8_convs_levels_2_3`` (the og_qconv launches of the last two levels) and
``int8_head`` (the float32 1x1 head); ``int8-full`` times its int8 detector
as ``detector``.

Fails without a CUDA device.  With ``--out`` the lines are also written to
``DIR/stage_times.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=502)
    ap.add_argument("--out", default=None)
    ap.add_argument("--pipelines", default="guided-vft,unet,unet-full,vft")
    ap.add_argument("--dtypes", default="bf16,f32")
    ap.add_argument("--cohort", type=int, default=0,
                    help="K: also time guided-vft's cohort form on K videos")
    ap.add_argument("--quant", choices=["int8", "int8-full"], default=None,
                    help="serve unet / unet-full in this int8 mode, the int8 "
                         "U-Net stage by stage")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stage_times: no CUDA device available", file=sys.stderr)
        return 1

    from openglottal_tpu_torch import pipelines as P
    from openglottal_tpu_torch.data.synthetic import synthetic_video
    from openglottal_tpu_torch.models import quant as Q
    from openglottal_tpu_torch.models import tracker
    from openglottal_tpu_torch.models.gate import (
        GateCarry,
        gate_scan,
        gate_scan_batch,
    )
    from openglottal_tpu_torch.models.unet import _cut, chunk_window_origin
    from openglottal_tpu_torch.ops import _build, blobs, histogram
    from openglottal_tpu_torch.ops.areas_cuda import box_count

    _build.build_all()
    videos = [np.ascontiguousarray(
        synthetic_video(t=args.frames, size=256, seed=s)[0][..., 0])
        for s in range(3)]
    weights = dict(unet_variables="weights/demo_unet.npz",
                   yolo_variables="weights/demo_yolo.npz")
    lines = []

    def timed(stages, name, fn):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        stages[name] = stages.get(name, 0.0) + a.elapsed_time(b)
        return out

    def guided_stages(gp, video):
        st = {}
        gray = timed(st, "upload", lambda: gp._to_gray(video))
        with torch.no_grad(), P.full_float32(gp.dtype):
            dets = [timed(st, "detector", lambda g=gray[i:i + P.CHUNK]:
                          gp._yolo_chunk(g))
                    for i in range(0, gray.shape[0], P.CHUNK)]
        has, raw, _ = (torch.cat(c) for c in zip(*dets))
        valid, boxes = timed(st, "gate_scan", lambda: gate_scan(
            has, raw, 256, 256, gp.gate_params))
        p = gp.ygvft_params
        n0 = P.YGVFT_INIT
        fi = torch.argmax(valid[:n0].to(torch.uint8)).reshape(1)
        th0 = timed(st, "tracker_init", lambda: tracker._ygvft_thresh0(
            gray[:n0].to(torch.float32), valid[:n0].any(),
            boxes.index_select(0, fi)[0], p))
        frames, v, b = gray[n0:], valid[n0:], boxes[n0:]

        def windows():
            fits, oy, ox = blobs.roi_window_origin(b, 256, 256, 128)
            if not bool(fits):
                raise RuntimeError("a gate box exceeds the 128x128 window")
            ffw = blobs.gather_windows(frames, oy, ox, 128).to(torch.float32)
            ar = torch.arange(128, device=ffw.device)
            rows = oy[:, None, None] + ar[None, :, None]
            cols = ox[:, None, None] + ar[None, None, :]
            roi = ((rows >= b[:, 1, None, None]) & (rows < b[:, 3, None, None])
                   & (cols >= b[:, 0, None, None]) & (cols < b[:, 2, None, None])
                   & v[:, None, None])
            return ffw, roi
        ffw, roi = timed(st, "window_gather", windows)
        cur, n_px = timed(st, "percentile", lambda:
                          histogram.masked_percentile_u8_batch(
                              ffw, roi, p.glottal_percentile))
        act = torch.ones_like(v)
        th = timed(st, "thresh_chain", lambda: tracker._thresh_chain(
            th0, cur, n_px, act, p.beta))
        raw_m = timed(st, "threshold_compare", lambda:
                      (ffw < th[:, None, None]) & roi)
        # the blob filter, kernels and the tensor ops around them apart
        from openglottal_tpu_torch.ops import blobs_cuda
        rec = []
        blobs_cuda.RECORD = rec
        masks = timed(st, "blob_filter_total", lambda:
                      blobs.top_n_blobs_batch(raw_m, p.max_glottal_components))
        blobs_cuda.RECORD = None
        for name, inputs, kw in rec:
            fn = getattr(blobs_cuda, name)
            timed(st, f"kernel_{name}", lambda: fn(*inputs, **kw))
        timed(st, "area_sum_and_read", lambda:
              masks.sum((1, 2)).to(torch.float32).cpu())
        return st

    def cohort_stages(gp, vids):
        """guided_vft_areas_gray_multi's stages on one sub-batch."""
        st = {}
        n0 = P.YGVFT_INIT
        p = gp.ygvft_params
        grays = timed(st, "upload", lambda: [gp._to_gray(v) for v in vids])
        dets = []
        with torch.no_grad(), P.full_float32(gp.dtype):
            for g in grays:
                dets += [timed(st, "detector", lambda g=g[i:i + P.CHUNK]:
                               gp._detect_chunk(g))
                         for i in range(0, g.shape[0], P.CHUNK)]
        has, raw = (torch.cat(c) for c in zip(*dets))
        off = [0, *np.cumsum([g.shape[0] for g in grays]).tolist()]
        valid, boxes = timed(st, "gate_scan_batch", lambda: gate_scan_batch(
            has, raw, off, 256, 256, gp.gate_params))

        def init():
            vin = torch.stack([valid[a:a + n0] for a in off[:-1]])
            fi = torch.argmax(vin.to(torch.uint8), 1)
            fb = torch.stack([boxes[a:a + n0] for a in off[:-1]]).gather(
                1, fi[:, None, None].expand(-1, 1, 4))[:, 0]
            last = torch.stack([g[n0 - 1] for g in grays]).to(torch.float32)
            return tracker._ygvft_thresh0_batch(last, vin.any(1), fb, p)
        th0 = timed(st, "tracker_init", init)
        spans = [(a + n0, b) for a, b in zip(off[:-1], off[1:])]
        frames, v, b = timed(st, "tracked_frames", lambda: (
            torch.cat([g[n0:] for g in grays]),
            torch.cat([valid[a:c] for a, c in spans]),
            torch.cat([boxes[a:c] for a, c in spans]).to(torch.int32)))
        toff = [0, *np.cumsum([c - a for a, c in spans]).tolist()]

        def fit():
            f, oy, ox = blobs.roi_window_origin(b, 256, 256, 128)
            if not bool(f):
                raise RuntimeError("a gate box exceeds the 128x128 window")
            return oy, ox
        oy, ox = timed(st, "window_fit_read", fit)

        def windows():
            ffw = blobs.gather_windows(frames, oy, ox, 128).to(torch.float32)
            ar = torch.arange(128, device=ffw.device)
            rows = oy[:, None, None] + ar[None, :, None]
            cols = ox[:, None, None] + ar[None, None, :]
            roi = ((rows >= b[:, 1, None, None]) & (rows < b[:, 3, None, None])
                   & (cols >= b[:, 0, None, None]) & (cols < b[:, 2, None, None])
                   & v[:, None, None])
            return ffw, roi
        ffw, roi = timed(st, "window_gather", windows)
        cur, n_px = timed(st, "percentile", lambda:
                          histogram.masked_percentile_u8_batch(
                              ffw, roi, p.glottal_percentile))
        th = timed(st, "thresh_chain_batch", lambda: tracker.thresh_chain_batch(
            th0, cur, n_px, torch.ones_like(v), toff, p.beta))
        raw_m = timed(st, "threshold_compare", lambda:
                      (ffw < th[:, None, None]) & roi)
        from openglottal_tpu_torch.ops import blobs_cuda
        rec = []
        blobs_cuda.RECORD = rec
        masks = timed(st, "blob_filter_total", lambda:
                      blobs.top_n_blobs_batch(raw_m, p.max_glottal_components))
        blobs_cuda.RECORD = None
        for name, inputs, kw in rec:
            fn = getattr(blobs_cuda, name)
            timed(st, f"kernel_{name}", lambda: fn(*inputs, **kw))
        timed(st, "area_sum_and_read", lambda:
              masks.sum((1, 2)).to(torch.float32).cpu())
        return st

    def blob_filter(st, name, masks, n):
        """One top_n_blobs_batch call by the route vft_parallel takes, its
        kernels and the tensor ops around them apart."""
        from openglottal_tpu_torch.ops import blobs_cuda
        rec = []
        blobs_cuda.RECORD = rec
        out = timed(st, f"{name}_total", lambda:
                    blobs.top_n_blobs_batch(masks, n, _split=True))
        blobs_cuda.RECORD = None
        for kname, inputs, kw in rec:
            fn = getattr(blobs_cuda, kname)
            timed(st, f"{name}_kernels", lambda: fn(*inputs, **kw))
        return out

    def vft_stages(gp, video):
        st = {}
        gray = timed(st, "upload", lambda: gp._to_gray(video))
        with torch.no_grad(), P.full_float32(gp.dtype):
            dets = [timed(st, "detector", lambda g=gray[i:i + P.CHUNK]:
                          gp._yolo_chunk(g))
                    for i in range(0, gray.shape[0], P.CHUNK)]
        has, raw, _ = (torch.cat(c) for c in zip(*dets))
        valid, boxes = timed(st, "gate_scan", lambda: gate_scan(
            has, raw, 256, 256, gp.gate_params))
        vb = timed(st, "gate_read", lambda: torch.cat(
            [valid[:, None].to(torch.int32), boxes], 1).cpu().numpy())
        idx = np.nonzero(vb[:, 0])[0]
        b0 = vb[idx[0], 1:]
        w0, h0 = int(b0[2] - b0[0]), int(b0[3] - b0[1])
        p = gp.vft_params
        n0 = P.VFT_INIT

        def crops_fn():
            sel = torch.argsort((~valid).to(torch.uint8), stable=True
                                )[:len(idx)]
            return P._gather_crops(gray[sel], boxes[sel], h0, w0)
        crops = timed(st, "crops", crops_fn)
        act = torch.arange(len(idx), device=crops.device) >= n0
        prev0, lmap0, th0 = timed(st, "tracker_init", lambda:
                                  tracker.vft_initialize(crops[:n0], p))
        lmaps = timed(st, "motion_map", lambda: tracker.motion_map(
            prev0, crops, lmap0, act, p.alpha, p.gaussian_ksize))
        roi_raw = timed(st, "roi_threshold", lambda: lmaps > (
            tracker._roi_threshold(lmaps, p.roi_threshold_ratio)
            [:, None, None]))
        roi = blob_filter(st, "roi_filter", roi_raw, 1)
        cur, n_px = timed(st, "percentile", lambda:
                          histogram.masked_percentile_u8_batch(
                              crops, roi, p.glottal_percentile))
        th = timed(st, "thresh_chain", lambda: tracker._thresh_chain(
            th0, cur, n_px, act, p.beta))
        raw_m = timed(st, "threshold_compare", lambda:
                      (crops < th[:, None, None]) & roi & act[:, None, None])
        masks = blob_filter(st, "blob_filter", raw_m,
                            p.max_glottal_components)
        timed(st, "area_sum_and_read", lambda:
              masks.sum((1, 2)).to(torch.float32).cpu())
        st["crop_h_w"] = [h0, w0]
        return st

    def qunet_stages(st, qp, g, window, oy=None, ox=None):
        """The int8 U-Net (``models/quant.qunet_to_d3`` and a tail) on one
        chunk, stage by stage -> logits."""
        s = qp["act_scales"]
        enc, bneck, dec, _ = Q._names()
        x8 = timed(st, "int8_stem", lambda: Q._stem(qp, g))

        def conv(st_name, x, layer, sx, sn, pad=1):
            return timed(st, st_name, lambda: Q._qc(x, layer, sx, sn, pad))

        skips, sx = [], s["enc0_mid"]
        for i, name in enumerate(enc):
            if i > 0:
                x8 = conv("int8_convs_to_d3", x8, qp[name]["Conv_0"], sx,
                          s[f"enc{i}_mid"])
                sx = s[f"enc{i}_mid"]
            x8 = conv("int8_convs_to_d3", x8, qp[name]["Conv_1"], sx,
                      s[f"enc{i}_out"])
            sx = s[f"enc{i}_out"]
            skips.append(x8)
            x8 = timed(st, "int8_convs_to_d3", lambda x=x8: Q._pool2(x))
        x8 = conv("int8_convs_to_d3", x8, qp[bneck]["Conv_0"], sx,
                  s["bneck_mid"])
        x8 = conv("int8_convs_to_d3", x8, qp[bneck]["Conv_1"], s["bneck_mid"],
                  s["bneck_out"])
        sx = s["bneck_out"]
        mw, wh = P.WIN // 2 + 6, P.WIN + 4
        for i in range(4):
            deep = i < 2
            src = x8
            if not deep and window:
                m0y, m0x = oy // 2 - 3, ox // 2 - 3
                src = (timed(st, "int8_window_cuts", lambda: Q._cut(
                    x8, m0y // 2, m0x // 2, mw // 2, mw // 2)) if i == 2
                    else x8)
            u8 = timed(st, "int8_upsamplers",
                       lambda: Q._qup(qp, src, sx, i))
            s8 = skips.pop()
            if not deep and window:
                s8 = timed(st, "int8_window_cuts", lambda: (
                    Q._cut(s8, m0y, m0x, mw, mw) if i == 2
                    else Q._cut(s8, oy - 2, ox - 2, wh, wh)))
            where = "int8_convs_to_d3" if deep else "int8_convs_levels_2_3"
            pad = 0 if (window and not deep) else 1
            x8 = conv(where, (s8, u8), qp[dec[i]]["Conv_0"], s[f"up{i}"],
                      s[f"dec{i}_mid"], pad)
            x8 = conv(where, x8, qp[dec[i]]["Conv_1"], s[f"dec{i}_mid"],
                      s[f"dec{i}_out"], pad)
            sx = s[f"dec{i}_out"]
        return timed(st, "int8_head", lambda: Q._head(qp, x8, sx))

    def qunet_unet_stages(gp, video):
        """Pipeline 3's loop in the int8 mode, the int8 U-Net by
        :func:`qunet_stages`; the detector int8 in ``int8-full``."""
        st = {}
        gray = timed(st, "upload", lambda: gp._to_gray(video))
        window = gp._windowed(None, gray)
        qp = gp._q(gray)
        gate = GateCarry(256, 256, gp.gate_params)
        areas, fits = [], []
        with torch.no_grad():
            for i in range(0, gray.shape[0], P.CHUNK):
                g = gray[i:i + P.CHUNK]
                if "yolo" in qp:
                    has, raw = timed(st, "detector", lambda:
                                     gp._qdetect_chunk(qp["yolo"], g))
                else:
                    has, raw, _ = timed(st, "detector",
                                        lambda: gp._yolo_chunk(g))
                v, b = timed(st, "gate_scan", lambda: gate(has, raw))
                oy = ox = None
                if window:
                    f, oy, ox = timed(st, "window_origin", lambda:
                                      chunk_window_origin(b, v, 256, 256,
                                                          P.WIN, lattice=4,
                                                          margin=6))
                    fits.append(f)
                logits = qunet_stages(st, qp["unet"], g, window, oy, ox)
                areas.append(timed(st, "box_count", lambda: box_count(
                    logits, 0.0, v, b, 0 if oy is None else oy,
                    0 if ox is None else ox)))
        out = torch.cat(areas)
        if window:
            out = torch.cat([out, torch.stack(fits).all()[None].float()])
        timed(st, "read", lambda: out.cpu())
        return st

    def unet_stages(gp, video):
        """Pipeline 3's loop (``GlottalPipelines._unet_gated``) stage by
        stage: the windowed decoder where ``gp`` takes it, else the
        full-frame U-Net."""
        st = {}
        gray = timed(st, "upload", lambda: gp._to_gray(video))
        window = gp._windowed(None, gray)
        gate = GateCarry(256, 256, gp.gate_params)
        areas, fits = [], []
        with torch.no_grad(), P.full_float32(gp.dtype):
            for i in range(0, gray.shape[0], P.CHUNK):
                g = gray[i:i + P.CHUNK]
                x = gp._unet_input(g)
                if window:
                    d3, s2, s1 = timed(st, "unet_to_d3",
                                       lambda: gp.unet.apply_to_d3(x))
                else:
                    scores, thr = timed(st, "unet",
                                        lambda: gp._scores_chunk(g))
                has, raw, _ = timed(st, "detector", lambda: gp._yolo_chunk(g))
                v, b = timed(st, "gate_scan", lambda: gate(has, raw))
                if not window:
                    areas.append(timed(st, "box_count", lambda: box_count(
                        scores, thr, v, b)))
                    continue
                f, oy, ox = timed(st, "window_origin", lambda:
                                  chunk_window_origin(b, v, 256, 256, P.WIN,
                                                      lattice=4, margin=6))
                ymw = timed(st, "unet_mid_window", lambda: gp.unet.mid_window(
                    d3, s2, oy, ox, P.WIN))
                logits = timed(st, "unet_tail_window", lambda:
                               gp.unet.tail_from_ymw(ymw, s1, oy, ox,
                                                     P.WIN)[:, 0])
                areas.append(timed(st, "box_count", lambda: box_count(
                    logits, 0.0, v, b, oy, ox)))
                fits.append(f)
                # the slices of the two window stages, timed apart
                mw = P.WIN // 2 + 6
                m0y, m0x = oy // 2 - 3, ox // 2 - 3
                timed(st, "window_copies", lambda: (
                    _cut(d3, m0y // 2, m0x // 2, mw // 2, mw // 2),
                    _cut(s2, m0y, m0x, mw, mw),
                    _cut(s1, oy - 2, ox - 2, P.WIN + 4, P.WIN + 4)))
        out = torch.cat(areas)
        if window:
            out = torch.cat([out, torch.stack(fits).all()[None].float()])
        timed(st, "read", lambda: out.cpu())
        return st

    from torch.profiler import ProfilerActivity, profile

    for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        if tag not in args.dtypes.split(","):
            continue
        pipes = {"windowed": P.GlottalPipelines(dtype=dtype, **weights),
                 "full": P.GlottalPipelines(dtype=dtype, window_decoder=False,
                                            **weights)}
        if args.quant:
            pipes.update(
                {f"q{k}": P.GlottalPipelines(dtype=dtype, quant=args.quant,
                                             window_decoder=k == "windowed",
                                             **weights)
                 for k in ("windowed", "full")})
            pipes["qwindowed"].calibrate(videos[0])
            pipes["qfull"]._qparams = pipes["qwindowed"]._qparams
        for pipeline, stage_fn in (("guided-vft", guided_stages),
                                   ("unet", unet_stages),
                                   ("unet-full", unet_stages),
                                   ("vft", vft_stages)):
            if pipeline not in args.pipelines.split(","):
                continue
            gp = pipes["full" if pipeline == "unet-full" else "windowed"]
            served = "unet" if pipeline == "unet-full" else pipeline
            if args.quant and served == "unet":
                gp = pipes["q" + ("full" if pipeline == "unet-full"
                                  else "windowed")]
                stage_fn = qunet_unet_stages
            gp.extract_features(videos[0], served)            # warm-up
            wall = []
            for v in videos:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                gp.extract_features(v, served)
                wall.append((time.perf_counter() - t0) * 1e3)
            stage_fn(gp, videos[0])
            stages = stage_fn(gp, videos[1])
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                gp.extract_features(videos[2], served)
                torch.cuda.synchronize()
                prof_wall = (time.perf_counter() - t0) * 1e3
            evs = [e for e in prof.key_averages()
                   if getattr(e, "device_time_total", 0) > 0
                   and e.device_type == torch.autograd.DeviceType.CUDA]
            dev_ms = sum(e.device_time_total for e in evs) / 1e3
            top = sorted(evs, key=lambda e: -e.device_time_total)[:12]
            line = {
                "pipeline": pipeline, "dtype": tag, "frames": args.frames,
                "quant": args.quant if served == "unet" else None,
                "device": torch.cuda.get_device_name(0),
                "wall_ms": wall, "stages_ms": stages,
                "profile": {
                    "wall_ms_under_profiler": prof_wall,
                    "device_kernel_ms": dev_ms,
                    "device_busy_share": dev_ms / prof_wall if evs else None,
                    "n_device_kernels": int(sum(e.count for e in evs)),
                    # og_qconv's launches, both of its forms (the gathering
                    # qconv_kernel and qconv_halo_kernel, every tile width)
                    "og_qconv_ms": sum(e.device_time_total for e in evs
                                       if "qconv" in e.key) / 1e3,
                    "top_kernels_ms": {e.key[:80]: e.device_time_total / 1e3
                                       for e in top}},
            }
            print(json.dumps(line), flush=True)
            lines.append(line)
        if args.cohort:
            # K distinct videos: the three served ones, moved by a few pixels
            k = args.cohort
            vids = [np.ascontiguousarray(np.roll(videos[i % 3], 3 * (i // 3),
                                                 axis=2)) for i in range(k)]
            gp = pipes["windowed"]
            gp.guided_vft_areas_gray_multi(vids, max_k=k)      # warm-up
            wall = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                gp.guided_vft_areas_gray_multi(vids, max_k=k)
                wall.append((time.perf_counter() - t0) * 1e3 / k)
            cohort_stages(gp, vids)
            stages = cohort_stages(gp, vids)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                gp.guided_vft_areas_gray_multi(vids, max_k=k)
                torch.cuda.synchronize()
                prof_wall = (time.perf_counter() - t0) * 1e3
            evs = [e for e in prof.key_averages()
                   if getattr(e, "device_time_total", 0) > 0
                   and e.device_type == torch.autograd.DeviceType.CUDA]
            dev_ms = sum(e.device_time_total for e in evs) / 1e3
            line = {
                "pipeline": "guided-vft cohort", "k": k, "dtype": tag,
                "frames": args.frames, "device": torch.cuda.get_device_name(0),
                "wall_ms_per_video": wall, "stages_ms": stages,
                "stages_ms_per_video": {n: v / k for n, v in stages.items()},
                "profile": {
                    "wall_ms_under_profiler": prof_wall,
                    "device_kernel_ms": dev_ms,
                    "device_busy_share": dev_ms / prof_wall if evs else None,
                    "n_device_kernels_per_video":
                        int(sum(e.count for e in evs)) / k},
            }
            print(json.dumps(line), flush=True)
            lines.append(line)
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "stage_times.jsonl").write_text(
            "".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
