"""YOLOv8n detector training (owning what the reference delegated to
ultralytics, scripts/train_yolo.py:107-121).

Counterpart of ``openglottal_tpu/train/yolo_trainer.py``.  Data: images + one
gt box per image from the segmentation mask with the reference's 10-px
dilation (openglottal/data.py:28-68).  Augmentation reproduces the
ultralytics v8 defaults the reference trains with (``train/yolo_aug.py``),
with the close_mosaic = 10 switch-off schedule; the close-mosaic phase (and
``mosaic=False``) runs the single-image affine + photometric
``augment_det_batch``.  Optimizer: AdamW + cosine with a short warm-up.  The
loss is ``train/yolo_loss.py`` (its assignment one launch of
``og_tal_assign``).  Checkpoints are ``torch.save`` files of the
ultralytics-layout ``state_dict`` (``best.pt``, ``latest.pt``), which
``utils/io.load_yolo_weights`` reads; recall is measured through the port's
detector path (``models/yolo.YoloDetector``).
"""

from __future__ import annotations

import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from openglottal_tpu_torch.models.yolo import YOLOv8, YoloDetector, init_flax_
from openglottal_tpu_torch.pipelines import resolve_device
from openglottal_tpu_torch.train.unet_trainer import (
    TrainState,
    compute_context,
    make_adamw,
    reset_running_stats,
    save_checkpoint,
    set_lr,
    state_dict_cpu,
)
from openglottal_tpu_torch.train.yolo_loss import yolo_loss
from openglottal_tpu_torch.utils.convert import yolo_state_dict_from_jax
from openglottal_tpu_torch.utils.yolo_import import yolo_from_torch


def boxes_from_masks(masks: np.ndarray, dilate: int = 10) -> np.ndarray:
    """Tight mask bbox + dilate px each side (reference mask_to_yolo,
    data.py:59-63).  Returns (N, 4) xyxy pixels; -1 rows for empty masks."""
    n, h, w = masks.shape
    out = np.full((n, 4), -1.0, np.float32)
    for i in range(n):
        ys, xs = np.nonzero(masks[i])
        if len(ys):
            out[i] = [max(0, xs.min() - dilate), max(0, ys.min() - dilate),
                      min(w, xs.max() + dilate), min(h, ys.max() + dilate)]
    return out


def augment_det_batch(generator, imgs, boxes, valid):
    """Detection augmentation: flip-lr/ud, scale + translate affine
    (box-aware), brightness jitter.  imgs: (B, S, S, 3) float [0,1]; boxes:
    (B, 4) xyxy px; valid (B,) bool -> (imgs, boxes, valid)."""
    b, s = imgs.shape[0], imgs.shape[1]
    dev = imgs.device
    gen = generator

    def uni(lo, hi):
        return torch.rand((b,), generator=gen, device=dev) * (hi - lo) + lo

    hflip = torch.rand((b,), generator=gen, device=dev) > 0.5
    vflip = torch.rand((b,), generator=gen, device=dev) > 0.5
    scale = uni(0.6, 1.4)
    tx = uni(-0.1, 0.1) * s
    ty = uni(-0.1, 0.1) * s
    bright = uni(0.7, 1.3)
    c = (s - 1) / 2.0
    ar = torch.arange(s, dtype=torch.float32, device=dev)
    col = lambda v: v[:, None, None]   # noqa: E731
    # inverse map: src = c + (dst - c - t)/s, then flip
    sx = (ar[None, None, :] - c - col(tx)) / col(scale) + c
    sy = (ar[None, :, None] - c - col(ty)) / col(scale) + c
    sx, sy = torch.broadcast_tensors(sx, sy)
    sx = torch.where(col(hflip), (s - 1) - sx, sx)
    sy = torch.where(col(vflip), (s - 1) - sy, sy)
    x0 = torch.floor(sx).clamp(0, s - 1).to(torch.int64)
    y0 = torch.floor(sy).clamp(0, s - 1).to(torch.int64)
    x1 = (x0 + 1).clamp(0, s - 1)
    y1 = (y0 + 1).clamp(0, s - 1)
    wx = (sx - x0).clamp(0, 1)[..., None]
    wy = (sy - y0).clamp(0, 1)[..., None]
    inb = ((sx >= 0) & (sx <= s - 1) & (sy >= 0) & (sy <= s - 1))[..., None]
    bi = torch.arange(b, device=dev)[:, None, None]
    v = ((1 - wy) * (1 - wx) * imgs[bi, y0, x0]
         + (1 - wy) * wx * imgs[bi, y0, x1]
         + wy * (1 - wx) * imgs[bi, y1, x0] + wy * wx * imgs[bi, y1, x1])
    v = torch.where(inb, v, 0.0)
    # forward-map the box: dst = c + t + s*(src - c), flips mirror coords
    fx1 = torch.where(hflip, (s - 1) - boxes[:, 2], boxes[:, 0])
    fx2 = torch.where(hflip, (s - 1) - boxes[:, 0], boxes[:, 2])
    fy1 = torch.where(vflip, (s - 1) - boxes[:, 3], boxes[:, 1])
    fy2 = torch.where(vflip, (s - 1) - boxes[:, 1], boxes[:, 3])
    nb = torch.stack([c + tx + scale * (fx1 - c), c + ty + scale * (fy1 - c),
                      c + tx + scale * (fx2 - c), c + ty + scale * (fy2 - c)],
                     1).clamp(0, s)
    out = (v * bright[:, None, None, None]).clamp(0, 1)
    # degenerate (clipped-away) boxes become invalid
    valid = valid & ((nb[:, 2] - nb[:, 0]) > 2) & ((nb[:, 3] - nb[:, 1]) > 2)
    return out, nb, valid


def yolo_train_step(state: TrainState, imgs_u8, boxes, valid, generator,
                    mosaic: bool = False, dtype=torch.bfloat16):
    """One AdamW step.  ``mosaic=False``: imgs (B, S, S, 3) uint8 RGB, one
    gt per image (the close-mosaic phase: ``augment_det_batch``).
    ``mosaic=True``: imgs (B, 4, S, S, 3), each sample and 3 partners,
    through mosaic4 + affine + HSV + flip (``train/yolo_aug.py``), up to 4
    gt boxes per image into the multi-gt TAL loss.  Returns (loss, parts),
    0-d tensors not read back."""
    if mosaic:
        from openglottal_tpu_torch.train.yolo_aug import mosaic_affine_hsv

        x, bx, vd = mosaic_affine_hsv(generator, imgs_u8, boxes, valid)
    else:
        x = imgs_u8.to(torch.float32) / 255.0
        x, bx1, vd1 = augment_det_batch(generator, x, boxes, valid)
        bx, vd = bx1[:, None, :], vd1[:, None]
    model = state.model.train()
    with compute_context(dtype, x.device):
        outs = model(x.permute(0, 3, 1, 2))
    total, parts = yolo_loss(outs, bx, vd, x.shape[1], x.shape[2])
    state.opt.zero_grad(set_to_none=True)
    total.backward()
    state.opt.step()
    state.step += 1
    return total.detach(), {k: v.detach() for k, v in parts.items()}


class YoloTrainer:
    def __init__(self, nc: int = 1, lr: float = 1e-3,
                 weight_decay: float = 0.01, batch_size: int = 16,
                 dtype=torch.bfloat16, seed: int = 0, device=None):
        self.nc = nc
        self.lr0 = lr
        self.weight_decay = weight_decay
        self.batch_size = batch_size
        self.dtype = dtype
        self.device = resolve_device(device)
        self.seed = seed
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def init_state(self, resume_variables=None,
                   keep_stats: bool = True) -> TrainState:
        """A fresh YOLOv8 (flax's initialisers, drawn from ``seed``) or the
        weights of ``resume_variables`` (a JAX-layout tree; its BatchNorm
        statistics too unless ``keep_stats=False``), with a fresh optimizer
        either way."""
        model = YOLOv8(nc=self.nc)
        if resume_variables is not None:
            model.load_state_dict(yolo_state_dict_from_jax(resume_variables),
                                  strict=True)
            if not keep_stats:
                reset_running_stats(model)
        else:
            init_flax_(model, torch.Generator().manual_seed(self.seed))
        model = model.to(self.device)
        return TrainState(model, make_adamw(model, self.lr0,
                                           self.weight_decay))

    def variables(self, state) -> dict:
        """The JAX-layout tree of the state's network."""
        return yolo_from_torch({k: v.numpy() for k, v in
                                state_dict_cpu(state.model).items()})

    def fit(self, imgs_rgb_u8, boxes, val_imgs=None, val_boxes=None,
            epochs: int = 100, patience: int | None = None, ckpt_dir=None,
            verbose=True, state: TrainState | None = None,
            mosaic: bool = True, close_mosaic: int = 10):
        """imgs_rgb_u8: (N, 256, 256, 3) uint8 RGB; boxes: (N, 4) xyxy px
        (-1 rows = no object).  Returns ``(state, best, history)`` where
        ``best`` is the JAX-layout variables tree of the best epoch: highest
        ``recall/val`` when a val set is given (lowest train loss
        otherwise); each epoch's ``history`` record is its log line plus
        ``loss/steps``, the loss of every step.  ``patience`` stops after
        that many epochs without improvement.  Mosaic4 runs on every epoch except the final
        ``close_mosaic`` ones (ultralytics semantics: with epochs <
        close_mosaic the switch-off never fires)."""
        if state is None:
            state = self.init_state()
        dev = self.device
        n = len(imgs_rgb_u8)
        bs = self.batch_size
        boxes = np.asarray(boxes, np.float32)
        imgs = torch.as_tensor(np.asarray(imgs_rgb_u8)).to(dev)
        bx = torch.as_tensor(np.where(boxes[:, :1] >= 0, boxes, 0).astype(
            np.float32)).to(dev)
        vd = torch.as_tensor(boxes[:, 0] >= 0).to(dev)
        order_rng = np.random.default_rng(42)  # seed 42 like the reference
        history = []
        warmup = min(3, max(1, epochs // 10))  # ultralytics-style warm-up
        mosaic_off_at = epochs - close_mosaic
        best_metric = -math.inf
        best = None
        bad_epochs = 0
        for epoch in range(epochs):
            lr = self.lr0 * (1 + math.cos(math.pi * epoch / epochs)) / 2
            if epoch < warmup:
                lr = self.lr0 * (epoch + 1) / (warmup + 1)
            set_lr(state, lr)
            use_mosaic = mosaic and not (0 <= mosaic_off_at <= epoch)
            perm = order_rng.permutation(n)
            losses = []
            t0 = time.time()
            # natural-size tail batch (DataLoader drop_last=False)
            for i in range(0, n, bs):
                idx = perm[i:i + bs]
                if use_mosaic:
                    # 3 dataset-uniform partners per sample
                    partners = order_rng.integers(0, n, (len(idx), 3))
                    quad = torch.as_tensor(np.concatenate(
                        [idx[:, None], partners], 1), device=dev)
                    loss, _ = yolo_train_step(state, imgs[quad], bx[quad],
                                              vd[quad], self.gen, True,
                                              self.dtype)
                else:
                    j = torch.as_tensor(idx, device=dev)
                    loss, _ = yolo_train_step(state, imgs[j], bx[j], vd[j],
                                              self.gen, False, self.dtype)
                losses.append((loss, len(idx)))
            rec = {"epoch": epoch + 1,
                   "loss/train": (float(sum(float(v) * t for v, t in losses)
                                        / sum(t for _, t in losses))
                                  if losses else None),
                   "lr": lr, "mosaic": use_mosaic,
                   "sec": round(time.time() - t0, 2)}
            if val_imgs is not None:
                rec["recall/val"] = self.eval_recall(state, val_imgs,
                                                     val_boxes)
            # the per-step losses stay in the history (not in the log lines)
            history.append({**rec, "loss/steps": [float(v)
                                                  for v, _ in losses]})
            if verbose:
                print(json.dumps(rec), flush=True)
            if ckpt_dir is not None:
                save_checkpoint(ckpt_dir, state, "latest")
                with (Path(ckpt_dir) / "metrics.jsonl").open("a") as f:
                    f.write(json.dumps(rec) + "\n")
            # improvement metric: recall/val when available, else -train loss
            metric = (rec["recall/val"] if val_imgs is not None
                      else -(rec["loss/train"]
                             if rec["loss/train"] is not None else math.inf))
            if metric > best_metric:
                best_metric = metric
                best = self.variables(state)
                bad_epochs = 0
                if ckpt_dir is not None:
                    save_checkpoint(ckpt_dir, state, "best")
            else:
                bad_epochs += 1
                if patience is not None and bad_epochs >= patience:
                    if verbose:
                        print(f"early stop at epoch {epoch + 1} "
                              f"(no val improvement for {patience})",
                              flush=True)
                    break
        return state, best, history

    def eval_recall(self, state, imgs_rgb_u8, boxes, conf: float = 0.25,
                    iou_thresh: float = 0.5) -> float:
        """Fraction of gt boxes recovered by the max-conf detection at IoU
        >= iou_thresh (the detection gate's usage), through the port's
        detector path on the state's weights (BatchNorm folded, the
        trainer's dtype)."""
        det = YoloDetector(self.variables(state), conf=conf, dtype=self.dtype,
                           device=self.device)
        frames_bgr = np.ascontiguousarray(np.asarray(imgs_rgb_u8)[..., ::-1])
        has, box, _ = det.detect_frames(frames_bgr)
        has, box = has.cpu().numpy(), box.float().cpu().numpy()
        boxes = np.asarray(boxes)
        hits = total = 0
        for j in range(len(boxes)):
            g = boxes[j]
            if g[0] < 0:
                continue
            total += 1
            if not has[j]:
                continue
            ix1, iy1 = max(g[0], box[j][0]), max(g[1], box[j][1])
            ix2, iy2 = min(g[2], box[j][2]), min(g[3], box[j][3])
            inter = max(0, ix2 - ix1) * max(0, iy2 - iy1)
            ag = (g[2] - g[0]) * (g[3] - g[1])
            ap = max(0, box[j][2] - box[j][0]) * max(0, box[j][3] - box[j][1])
            if inter / (ag + ap - inter + 1e-9) >= iou_thresh:
                hits += 1
        return hits / max(total, 1)

    @staticmethod
    def load_variables(ckpt_dir, name: str = "best"):
        from openglottal_tpu_torch.utils.io import load_yolo_weights

        return load_yolo_weights(Path(ckpt_dir) / f"{name}.pt")
