"""YOLOv8 detection loss: task-aligned assignment + CIoU + DFL + BCE.

Counterpart of ``openglottal_tpu/train/yolo_loss.py``.  Standard v8 recipe:

  * TAL: align metric = cls_prob^0.5 · IoU^6.0; per-gt top-10 candidate
    anchors whose centre lies inside the gt box; conflicts resolved by the
    highest metric; cls targets are soft (metric normalised per gt so its
    peak equals the gt's best IoU).  One launch of ``og_tal_assign``
    (``ops/train_cuda.py``); everything it reads is detached, as it is under
    ``stop_gradient`` in the reference.
  * box: CIoU loss on assigned anchors, weighted by the soft target score.
  * DFL: cross-entropy against the two integer bins bracketing each target
    ltrb distance (in stride units, clipped to REG_MAX - 1).
  * weights: box 7.5, cls 0.5, dfl 1.5; normalised by the summed target
    scores.

The CIoU and DFL gathers stay torch ops under autograd.  gt boxes arrive
padded to a fixed M per image with a validity mask.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from openglottal_tpu_torch.models.yolo import REG_MAX, STRIDES, anchors_for
from openglottal_tpu_torch.ops.train_cuda import tal_assign

W_BOX, W_CLS, W_DFL = 7.5, 0.5, 1.5


def pairwise_ciou(gt, pred):
    """CIoU between gt (..., M, 1, 4) and pred (..., 1, A, 4) xyxy ->
    (ciou, iou), each (..., M, A); the aspect term's α is detached."""
    gx1, gy1, gx2, gy2 = gt.unbind(-1)
    px1, py1, px2, py2 = pred.unbind(-1)
    ix1 = torch.maximum(gx1, px1)
    iy1 = torch.maximum(gy1, py1)
    ix2 = torch.minimum(gx2, px2)
    iy2 = torch.minimum(gy2, py2)
    inter = (ix2 - ix1).clamp_min(0) * (iy2 - iy1).clamp_min(0)
    ag = (gx2 - gx1).clamp_min(0) * (gy2 - gy1).clamp_min(0)
    ap = (px2 - px1).clamp_min(0) * (py2 - py1).clamp_min(0)
    union = ag + ap - inter + 1e-7
    iou = inter / union
    # enclosing box diagonal
    cx1 = torch.minimum(gx1, px1)
    cy1 = torch.minimum(gy1, py1)
    cx2 = torch.maximum(gx2, px2)
    cy2 = torch.maximum(gy2, py2)
    c2 = (cx2 - cx1) ** 2 + (cy2 - cy1) ** 2 + 1e-7
    # centre distance
    rho2 = ((gx1 + gx2 - px1 - px2) ** 2 + (gy1 + gy2 - py1 - py2) ** 2) / 4.0
    # aspect-ratio term
    gw, gh = gx2 - gx1, (gy2 - gy1).clamp_min(1e-7)
    pw, ph = px2 - px1, (py2 - py1).clamp_min(1e-7)
    v = (4 / math.pi ** 2) * (torch.atan(gw / gh) - torch.atan(pw / ph)) ** 2
    alpha = v / (1.0 - iou + v + 1e-7)
    return iou - rho2 / c2 - alpha.detach() * v, iou


def decode_pred(level_outputs, size_h: int, size_w: int):
    """Flatten head outputs: boxes (B, A, 4) xyxy px, dist logits (B, A, 4,
    R), cls logits (B, A, nc), anchors (A, 2), strides (A,)."""
    boxes, dists, clss = [], [], []
    dev = level_outputs[0][0].device
    bins = torch.arange(REG_MAX, dtype=torch.float32, device=dev)
    for (b, c), _ in zip(level_outputs, STRIDES):
        n, h, w, _ = b.shape
        d = b.reshape(n, h * w, 4, REG_MAX)
        dists.append(d)
        boxes.append(torch.softmax(d, -1) @ bins)
        clss.append(c.reshape(n, h * w, -1))
    pts, strides = anchors_for(size_h, size_w, dev)
    dist = torch.cat(boxes, 1)
    x1y1 = pts[None] - dist[..., :2] * strides[None, :, None]
    x2y2 = pts[None] + dist[..., 2:] * strides[None, :, None]
    return (torch.cat([x1y1, x2y2], -1), torch.cat(dists, 1),
            torch.cat(clss, 1), pts, strides)


def gather_boxes(gt_boxes, best_gt):
    """(B, M, 4), (B, A) -> (B, A, 4)."""
    return torch.gather(gt_boxes, 1,
                        best_gt.to(torch.int64)[..., None].expand(-1, -1, 4))


def sigmoid_bce(logits, targets):
    """optax ``sigmoid_binary_cross_entropy``."""
    return -targets * F.logsigmoid(logits) - (1 - targets) * F.logsigmoid(
        -logits)


def yolo_loss(level_outputs, gt_boxes, gt_valid, size_h: int = 256,
              size_w: int = 256):
    """gt_boxes: (B, M, 4) xyxy pixels; gt_valid: (B, M) bool.  Returns
    (total, dict of parts); ``assigned`` is the count of assigned anchors (a
    0-d tensor, not read back)."""
    pred_boxes, dist_logits, cls_logits, pts, strides = decode_pred(
        level_outputs, size_h, size_w)
    gt_boxes = gt_boxes.to(torch.float32)
    best_gt, assigned, t_score = tal_assign(
        cls_logits[..., 0].detach().float().contiguous(),
        pred_boxes.detach().float().contiguous(), gt_boxes.contiguous(),
        gt_valid.to(torch.bool).contiguous(), pts.contiguous())

    # ── cls: BCE over ALL anchors against soft targets ────────────────────
    denom = t_score.sum().clamp_min(1.0)
    loss_cls = sigmoid_bce(cls_logits[..., 0], t_score).sum() / denom

    # ── box: CIoU on assigned anchors ─────────────────────────────────────
    tb = gather_boxes(gt_boxes, best_gt)               # (B, A, 4)
    ciou_a, _ = pairwise_ciou(tb[:, :, None, :], pred_boxes[:, :, None, :])
    loss_box = torch.where(assigned, (1.0 - ciou_a[..., 0]) * t_score,
                           0.0).sum() / denom

    # ── DFL on assigned anchors ───────────────────────────────────────────
    lt = torch.stack([pts[None, :, 0] - tb[..., 0],
                      pts[None, :, 1] - tb[..., 1]], -1)
    rb = torch.stack([tb[..., 2] - pts[None, :, 0],
                      tb[..., 3] - pts[None, :, 1]], -1)
    target_d = torch.cat([lt, rb], -1) / strides[None, :, None]
    target_d = target_d.clamp(0, REG_MAX - 1 - 0.01)
    tl = torch.floor(target_d)
    wr = target_d - tl
    logp = torch.log_softmax(dist_logits, -1)          # (B, A, 4, R)
    tl_i = tl.to(torch.int64)
    lp_l = torch.gather(logp, -1, tl_i[..., None])[..., 0]
    lp_r = torch.gather(logp, -1, (tl_i + 1)[..., None])[..., 0]
    dfl = -(lp_l * (1 - wr) + lp_r * wr).mean(-1)      # (B, A)
    loss_dfl = torch.where(assigned, dfl * t_score, 0.0).sum() / denom

    total = W_BOX * loss_box + W_CLS * loss_cls + W_DFL * loss_dfl
    return total, {"box": loss_box, "cls": loss_cls, "dfl": loss_dfl,
                   "assigned": assigned.sum()}
