"""End-to-end self-test without datasets: train the U-Net, a crop-mode
U-Net and YOLOv8n on synthetic glottis videos, then run the GIRAFE-style
evaluation, the int8 serving modes and the windowed decoder with the
TRAINED weights, and gate every result.

Counterpart of ``scripts/selftest_e2e.py``: the same data (10×24 train
frames from seed 100, 2×16 val from seed 900, 2×40 test from seed 990,
``data/synthetic.py``), the same stages, the same report keys and the same
gates with the same thresholds:

- ``unet_only>0.85``, ``yolo+unet>0.8``, ``recall>0.9`` (the last epoch's
  ``recall/val``), ``int8_delta<0.01`` (the int8 U-Net's direct masks
  against the folded bf16 U-Net's), ``crop_recovery`` (the crop U-Net
  trained on GT-box crops beats the full-frame weights used as crop weights
  by 0.1 Dice), ``int8full_rel_l1<0.05`` (the "int8-full" waveform against
  bf16) and ``windowed_rel_l1<0.05`` (the windowed decoder against
  ``window_decoder=False``);
- with ``--realistic`` (endoscopy-like frames, adversarial to thresholding)
  also ``otsu<0.5``, ``motion<0.6`` and ``ordering_margin>0.15``: the
  learned pipelines well above the Otsu and motion baselines.

It writes ``OUTPUT_DIR/report.json`` (and the checkpoints under
``OUTPUT_DIR/{unet,unet_crop,yolo}``), prints each gate and ``SELFTEST
PASS|FAIL``, and exits 0 only if every gate passes.  Each stage runs once;
a stage that raises fails the run.  Everything runs on the card unless
``--device cpu`` is given.  :func:`run_selftest` is the work behind the
command line, with keyword arguments for the sizes, epochs and the U-Net's
width (the command line keeps the reference's); it trains and serves in
bfloat16, as the reference does.

    python -m openglottal_tpu_torch.scripts.selftest_e2e [--realistic] \\
        [--epochs-unet 60] [--patience-unet 15] [--epochs-crop 40] \\
        [--epochs-yolo 20] [--output-dir outputs/selftest] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def _dice(report: dict, pipeline: str, default: float) -> float:
    return report.get(pipeline, {}).get("dice", default)


# gate name -> (the number it reads from the report, the test it passes);
# the last three gate only the --realistic domain (the JAX script's
# scripts/selftest_e2e.py:236-257, same thresholds)
GATES = {
    "unet_only>0.85": (lambda r: r["unet-only"]["dice"],
                       lambda v: v > 0.85),
    "yolo+unet>0.8": (lambda r: _dice(r, "yolo+unet", 0.0),
                      lambda v: v > 0.8),
    "recall>0.9": (lambda r: r["yolo_final_recall"] or 0,
                   lambda v: v > 0.9),
    "int8_delta<0.01": (lambda r: abs(r["unet_only_dice_int8"]
                                      - r["unet_only_dice_bf16_direct"]),
                        lambda v: v < 0.01),
    "crop_recovery": (lambda r: (r["crop_dice_trained"]
                                 - r["crop_dice_zeroshot"]),
                      lambda v: v > 0.1),
    "int8full_rel_l1<0.05": (lambda r: r["int8full_waveform_rel_l1"],
                             lambda v: v < 0.05),
    "windowed_rel_l1<0.05": (lambda r: r["windowed_waveform_rel_l1"],
                             lambda v: v < 0.05),
    "otsu<0.5": (lambda r: _dice(r, "yolo+otsu", 1.0), lambda v: v < 0.5),
    "motion<0.6": (lambda r: _dice(r, "yolo+motion", 1.0),
                   lambda v: v < 0.6),
    "ordering_margin>0.15": (lambda r: r["unet-only"]["dice"] - max(
        _dice(r, "yolo+otsu", 1.0), _dice(r, "yolo+motion", 1.0)),
        lambda v: v > 0.15),
}
REALISTIC_ONLY = ("otsu<0.5", "motion<0.6", "ordering_margin>0.15")


def make_dataset(n_videos: int, t: int, seed0: int, realistic: bool = False):
    """(frames (N, 256, 256, 3) BGR uint8, masks (N, 256, 256) bool, boxes
    (N, 4) float32 with a 10-px dilation) of ``n_videos`` synthetic videos
    of ``t`` frames, video ``s`` from seed ``seed0 + s``."""
    from openglottal_tpu_torch.data.synthetic import (
        synthetic_gt_boxes,
        synthetic_video,
    )

    frames, masks, boxes = [], [], []
    for s in range(n_videos):
        rng = np.random.default_rng(seed0 + s)
        cy, cx = rng.uniform(70, 186, 2)
        f, m = synthetic_video(t=t, size=256, center=(cy, cx), seed=seed0 + s,
                               drift_px=0.6, realistic=realistic)
        frames.append(f)
        masks.append(m)
        boxes.append(synthetic_gt_boxes(m, dilate=10))
    return (np.concatenate(frames), np.concatenate(masks),
            np.concatenate(boxes))


def rel_l1(a, b) -> float:
    """sum |a - b| / max(sum |b|, 1e-9)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sum(np.abs(a - b)) / max(np.sum(np.abs(b)), 1e-9))


def gate_value(report: dict, gate: str) -> float:
    return GATES[gate][0](report)


def evaluate_gates(report: dict, realistic: bool) -> dict:
    """gate name -> passed, from a report; the realistic gates only with
    ``realistic``."""
    return {name: test(value(report)) for name, (value, test) in GATES.items()
            if realistic or name not in REALISTIC_ONLY}


def run_selftest(output_dir="outputs/selftest", realistic: bool = False,
                 epochs_unet: int = 60, patience_unet: int = 15,
                 epochs_crop: int = 40, epochs_yolo: int = 20, device=None,
                 train=(10, 24), val=(2, 16), test=(2, 40),
                 features=(32, 64, 128, 256),
                 verbose: bool = True) -> dict:
    """Train, evaluate and gate (the module docstring).  ``train`` / ``val``
    / ``test``: (videos, frames a video); ``features``: the U-Nets' encoder
    widths.
    Returns {"report", "gates", "ok", "stage_seconds", "epochs_run",
    "seconds", "per_patient", "waveforms"}: ``report`` has the JAX script's
    keys, ``per_patient`` each test patient's ``evaluate_patient`` rows and
    ``waveforms`` the first test video's areas on the three ``unet``
    routes ("bf16", "int8full", "fullframe")."""
    from openglottal_tpu_torch.data.crop_dataset import (
        materialize_gt_crops_arrays,
    )
    from openglottal_tpu_torch.data.video import bgr_to_gray_u8
    from openglottal_tpu_torch.eval import (
        aggregate,
        evaluate_patient,
        frame_metrics_batch,
    )
    from openglottal_tpu_torch.models.fold import fold_unet
    from openglottal_tpu_torch.models.quant import qunet_masks, quantize_unet
    from openglottal_tpu_torch.pipelines import (
        GlottalPipelines,
        resolve_device,
    )
    from openglottal_tpu_torch.train.unet_trainer import UNetTrainer
    from openglottal_tpu_torch.train.yolo_trainer import YoloTrainer
    from openglottal_tpu_torch.utils.convert import unet_state_dict_from_jax

    dev = resolve_device(device)
    stage_seconds: dict = {}

    def stage(name: str, fn):
        """fn() once, its wall seconds (the device drained) recorded."""
        t = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stage_seconds[name] = time.perf_counter() - t
        return out

    def host(x) -> np.ndarray:
        return x.float().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    t0 = time.perf_counter()
    tr_f, tr_m, tr_b = make_dataset(*train, seed0=100, realistic=realistic)
    va_f, va_m, va_b = make_dataset(*val, seed0=900, realistic=realistic)
    te_f, te_m, te_b = make_dataset(*test, seed0=990, realistic=realistic)
    gray_tr = bgr_to_gray_u8(tr_f)
    gray_va = bgr_to_gray_u8(va_f)
    stage_seconds["dataset"] = time.perf_counter() - t0
    if verbose:
        print(f"dataset: train {len(tr_f)} / val {len(va_f)} / test "
              f"{len(te_f)} frames ({stage_seconds['dataset']:.0f}s)",
              flush=True)

    # ── train the U-Net (full frame) ─────────────────────────────────────
    ut = UNetTrainer(features=features, batch_size=16, lr=1e-3, device=dev)
    ustate, ubest, uhist = stage("train_unet", lambda: ut.fit(
        gray_tr, tr_m.astype(np.uint8), gray_va, va_m.astype(np.uint8),
        epochs=epochs_unet, patience=patience_unet,
        ckpt_dir=f"{output_dir}/unet", verbose=verbose))
    uvars = ubest if ubest is not None else ut.load_variables(
        f"{output_dir}/unet", "latest")

    # ── train the crop-mode U-Net on GT-box crops (train_unet_crop.py) ───
    ci_tr, cm_tr = materialize_gt_crops_arrays(gray_tr, tr_m.astype(np.uint8))
    ci_va, cm_va = materialize_gt_crops_arrays(gray_va, va_m.astype(np.uint8))
    ct = UNetTrainer(features=features, batch_size=16, lr=1e-3, device=dev)
    _, cbest, chist = stage("train_unet_crop", lambda: ct.fit(
        ci_tr, cm_tr, ci_va, cm_va, epochs=epochs_crop,
        patience=patience_unet, ckpt_dir=f"{output_dir}/unet_crop",
        verbose=verbose))
    cvars = cbest if cbest is not None else ct.load_variables(
        f"{output_dir}/unet_crop", "latest")

    # ── train YOLOv8n (mosaic off: scripts/selftest_e2e.py:131-135) ──────
    yt = YoloTrainer(batch_size=16, lr=2e-3, device=dev)
    _, ybest, yhist = stage("train_yolo", lambda: yt.fit(
        np.ascontiguousarray(tr_f[..., ::-1]), tr_b,
        np.ascontiguousarray(va_f[..., ::-1]), va_b, epochs=epochs_yolo,
        mosaic=False, ckpt_dir=f"{output_dir}/yolo", verbose=verbose))
    yvars = ybest if ybest is not None else yt.load_variables(
        f"{output_dir}/yolo", "latest")
    final_recall = yhist[-1].get("recall/val")

    # ── evaluate (GIRAFE protocol, the synthetic test patients) ──────────
    n_te, t_te = test
    pipe = GlottalPipelines(unet_variables=uvars, crop_unet_variables=cvars,
                            yolo_variables=yvars, conf=0.25, device=dev)
    per_patient = {}
    for k in range(n_te):
        sl = slice(k * t_te, (k + 1) * t_te)
        per_patient[f"synth{k}"] = stage(
            f"eval_patient_{k}", lambda sl=sl: evaluate_patient(
                pipe, te_f[sl], te_m[sl], sequential=True))
    agg = aggregate(per_patient)

    # the crop path with the FULL-FRAME weights as crop weights: the
    # zero-shot baseline the trained crop U-Net must beat
    pipe_zs = GlottalPipelines(unet_variables=uvars, crop_unet_variables=uvars,
                               yolo_variables=yvars, conf=0.25, device=dev)

    def crop_zeroshot_pass():
        dices = []
        for k in range(n_te):
            sl = slice(k * t_te, (k + 1) * t_te)
            fr = torch.from_numpy(np.ascontiguousarray(te_f[sl])).to(dev)
            gray = bgr_to_gray_u8(fr)
            valid, boxes = pipe_zs.gated_boxes(fr, sequential=True)
            cm, _, _ = pipe_zs.crop_unet_masks(fr, gray_u8=gray, valid=valid,
                                               boxes=boxes)
            d, _ = frame_metrics_batch(cm, torch.from_numpy(te_m[sl]).to(dev))
            dices.extend(host(d).tolist())
        return float(np.mean(dices))

    crop_zeroshot = stage("crop_zeroshot", crop_zeroshot_pass)
    crop_trained = agg.get("yolo-crop+unet", {}).get("dice", 0.0)

    # ── int8: the quantized U-Net's direct masks against the folded bf16
    # U-Net's, both on the test frames (scripts/selftest_e2e.py:179-197) ─
    gray_te = torch.from_numpy(bgr_to_gray_u8(te_f)).to(dev)
    gt = torch.from_numpy(te_m).to(dev)
    folded = {k: v.to(dev) for k, v in
              fold_unet(unet_state_dict_from_jax(uvars)).items()}
    qp = stage("quantize_unet", lambda: quantize_unet(
        folded, torch.from_numpy(gray_tr[:64]).to(dev)))
    m8 = stage("int8_masks", lambda: qunet_masks(qp, gray_te))
    m16 = stage("bf16_masks", lambda: pipe.segment_video(gray_te))
    dice_int8 = float(np.mean(host(frame_metrics_batch(m8, gt)[0])))
    dice_bf16 = float(np.mean(host(frame_metrics_batch(m16, gt)[0])))

    # ── int8-full: the quantized detector + segmenter waveform against
    # bf16's (rel L1 < 5 %) ──────────────────────────────────────────────
    pipe_q = GlottalPipelines(unet_variables=uvars, yolo_variables=yvars,
                              conf=0.25, quant="int8-full", device=dev)
    stage("calibrate_int8full", lambda: pipe_q.calibrate(gray_tr[:64]))
    wave16 = host(stage("wave_bf16", lambda: pipe.yolo_unet_areas_gray(
        gray_te[:t_te])))
    wave8 = host(stage("wave_int8full", lambda: pipe_q.yolo_unet_areas_gray(
        gray_te[:t_te])))
    int8full_rel_l1 = rel_l1(wave8, wave16)

    # ── the windowed decoder (the default bf16 route) against the
    # full-frame graph, same budget ──────────────────────────────────────
    pipe_nw = GlottalPipelines(unet_variables=uvars, yolo_variables=yvars,
                               conf=0.25, window_decoder=False, device=dev)
    wave_full = host(stage("wave_bf16_fullframe",
                           lambda: pipe_nw.yolo_unet_areas_gray(
                               gray_te[:t_te])))
    window_rel_l1 = rel_l1(wave16, wave_full)

    report = {p_: {k: v for k, v in row.items() if k not in ("dices", "ious")}
              for p_, row in agg.items()}
    report["yolo_final_recall"] = final_recall
    report["crop_dice_trained"] = crop_trained
    report["crop_dice_zeroshot"] = crop_zeroshot
    report["unet_only_dice_int8"] = dice_int8
    report["unet_only_dice_bf16_direct"] = dice_bf16
    report["int8full_waveform_rel_l1"] = int8full_rel_l1
    report["windowed_waveform_rel_l1"] = window_rel_l1
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "report.json"), "w") as fh:
        json.dump(report, fh, indent=2)
    gates = evaluate_gates(report, realistic)
    return {"report": report, "gates": gates, "ok": all(gates.values()),
            "stage_seconds": stage_seconds,
            "epochs_run": {"unet": len(uhist), "unet_crop": len(chist),
                           "yolo": len(yhist)},
            "seconds": time.perf_counter() - t0, "per_patient": per_patient,
            "waveforms": {"bf16": wave16, "int8full": wave8,
                          "fullframe": wave_full}}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="selftest-e2e",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    # 60 epochs + patience 15: the adversarial --realistic domain needs real
    # training (a few epochs collapse the U-Net to all-background)
    p.add_argument("--epochs-unet", type=int, default=60)
    p.add_argument("--patience-unet", type=int, default=15)
    p.add_argument("--epochs-crop", type=int, default=40)
    p.add_argument("--epochs-yolo", type=int, default=20)
    p.add_argument("--realistic", action="store_true",
                   help="Endoscopy-like synthetic data, ADVERSARIAL to "
                        "thresholding (band shadows at glottal intensity, "
                        "axial gradient, glottis-crossing speculars, "
                        "illumination drift) — gates the reference's "
                        "pipeline ordering.")
    p.add_argument("--output-dir", default="outputs/selftest")
    p.add_argument("--device", default=None,
                   help="Torch device (default: the CUDA device).")
    return p


def run_args(args, verbose: bool = True) -> dict:
    """:func:`run_selftest` as the parsed command line asks."""
    return run_selftest(args.output_dir, realistic=args.realistic,
                        epochs_unet=args.epochs_unet,
                        patience_unet=args.patience_unet,
                        epochs_crop=args.epochs_crop,
                        epochs_yolo=args.epochs_yolo, device=args.device,
                        verbose=verbose)


def main(argv: list[str] | None = None) -> dict:
    out = run_args(build_parser().parse_args(argv))
    print(json.dumps(out["report"], indent=2))
    for name, passed in out["gates"].items():
        print(f"  gate {name}: {'PASS' if passed else 'FAIL'} "
              f"({gate_value(out['report'], name)})")
    print("SELFTEST", "PASS" if out["ok"] else "FAIL",
          f"({out['seconds']:.0f}s total)", flush=True)
    if not out["ok"]:
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
