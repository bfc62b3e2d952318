"""U-Net trainer: the reference's loss and optimizer recipe, on the card.

Counterpart of ``openglottal_tpu/train/unet_trainer.py``.  Reference recipe
(scripts/train_unet.py): loss = 0.5·BCEWithLogits + 0.5·dice (:178), AdamW
lr = 1e-3 (weight decay 0.01) + CosineAnnealingLR stepped per epoch with
T_max = epochs (:156-157), batch 16, 50 epochs, best-val checkpoint
(:204-208), ``--patience`` early stopping (:209-213), ``--resume`` loads
weights with a FRESH optimizer (:147-151).

Execution: the whole dataset lives on the device as uint8; every step is
augment (``og_unet_augment``) -> forward (bfloat16 under autocast over
float32 parameters, or float32) -> loss (``og_bce_dice``, whose backward is
a kernel too) -> backward -> ``torch.optim.AdamW(weight_decay=0.01,
eps=1e-8)``, which is optax ``adamw``'s update; the learning rate is set per
epoch.  BatchNorm trains with flax's semantics (``models/yolo.BatchNorm``).
The final partial batch of each epoch trains at its natural size (torch
DataLoader drop_last=False); a short validation tail is padded to the batch
and masked out of the loss.  Checkpoints are ``torch.save`` files of the
U-Net's ``state_dict`` (``best.pt``, ``latest.pt``), which
``utils/io.load_unet_weights`` reads.  ``mesh`` is refused (data
parallelism is a later slice).
"""

from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from openglottal_tpu_torch.data.augment import augment_batch
from openglottal_tpu_torch.models.unet import UNet
from openglottal_tpu_torch.models.yolo import init_flax_
from openglottal_tpu_torch.ops.train_cuda import INV255, bce_dice
from openglottal_tpu_torch.pipelines import full_float32, resolve_device
from openglottal_tpu_torch.utils.convert import unet_state_dict_from_jax
from openglottal_tpu_torch.utils.torch_import import unet_from_torch


@dataclass
class TrainState:
    """The trained network (float32 parameters, BatchNorm statistics as
    buffers), its optimizer and the count of steps taken."""
    model: torch.nn.Module
    opt: torch.optim.Optimizer
    step: int = 0


def compute_context(dtype, device):
    """bfloat16 compute under autocast over float32 parameters, or float32
    (without TF32 on the card)."""
    if dtype == torch.bfloat16:
        return torch.autocast(device.type, dtype=torch.bfloat16)
    return full_float32(torch.float32)


def unet_train_step(state: TrainState, imgs_u8, msks_u8, generator,
                    dtype=torch.bfloat16):
    """One augment + forward + loss + backward + AdamW step on (B, 256, 256)
    uint8 frames and {0,1} uint8 masks on the model's device -> the loss
    (0-d float32 tensor, not read back)."""
    x, y = augment_batch(imgs_u8, msks_u8, generator)
    return unet_step(state, x, y, dtype)


def unet_step(state: TrainState, x, y, dtype=torch.bfloat16):
    """Forward + loss + backward + AdamW step on (B, H, W) float32 images in
    [0, 1] and {0, 1} masks -> the loss (0-d float32 tensor)."""
    model = state.model.train()
    with compute_context(dtype, x.device):
        logits = model(x[:, None])
    loss = bce_dice(logits, y[:, None])
    state.opt.zero_grad(set_to_none=True)
    loss.backward()
    state.opt.step()
    state.step += 1
    return loss.detach()


@torch.no_grad()
def unet_eval_loss_masked(state: TrainState, imgs_u8, msks_u8, valid,
                          dtype=torch.bfloat16):
    """Eval-mode loss over a batch whose trailing entries may be padding:
    ``valid`` (B,) bool; padded rows count in neither the BCE mean nor the
    Dice sums (with all rows valid it is the plain eval loss)."""
    model = state.model.eval()
    x = imgs_u8.to(torch.float32) * INV255.to(imgs_u8.device)
    with compute_context(dtype, x.device):
        logits = model(x[:, None])
    return bce_dice(logits, msks_u8.to(torch.float32)[:, None], valid)


def unet_eval_loss(state: TrainState, imgs_u8, msks_u8,
                   dtype=torch.bfloat16):
    return unet_eval_loss_masked(state, imgs_u8, msks_u8, None, dtype)


def cosine_lr(epoch: int, epochs: int, lr0: float) -> float:
    """torch CosineAnnealingLR(T_max=epochs) stepped per epoch, eta_min=0."""
    return lr0 * (1 + math.cos(math.pi * epoch / epochs)) / 2


def make_adamw(model, lr: float, weight_decay: float):
    """optax ``adamw``'s update (b1 0.9, b2 0.999, eps 1e-8, decay on every
    parameter) over the model's trainable parameters."""
    return torch.optim.AdamW([p for p in model.parameters()
                              if p.requires_grad],
                             lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def set_lr(state, lr: float) -> None:
    for group in state.opt.param_groups:
        group["lr"] = lr


@torch.no_grad()
def reset_running_stats(model) -> None:
    """BatchNorm running statistics back to flax's initial mean 0, var 1."""
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.zero_()
        elif name.endswith("running_var"):
            buf.fill_(1.0)


def state_dict_cpu(model) -> dict:
    return {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}


def save_checkpoint(ckpt_dir, state: TrainState, name: str) -> None:
    """CKPT_DIR/NAME.pt: ``torch.save`` of the network's ``state_dict`` and
    the step count, written whole or not at all (``utils/io``'s
    ``load_unet_weights`` / ``load_yolo_weights`` read it)."""
    path = Path(ckpt_dir) / f"{name}.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".pt.tmp")
    torch.save({"state_dict": state_dict_cpu(state.model),
                "step": state.step}, tmp)
    tmp.replace(path)


class UNetTrainer:
    def __init__(self, features=(32, 64, 128, 256), lr: float = 1e-3,
                 weight_decay: float = 0.01, batch_size: int = 16,
                 dtype=torch.bfloat16, seed: int = 0, mesh=None, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh (data-parallel) training is ported in a later slice")
        self.features = tuple(features)
        self.lr0 = lr
        self.weight_decay = weight_decay
        self.batch_size = batch_size
        self.dtype = dtype
        self.device = resolve_device(device)
        self.seed = seed
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    # ── state management ──────────────────────────────────────────────────

    def init_state(self, resume_variables=None,
                   keep_stats: bool = True) -> TrainState:
        """A fresh network (flax's initialisers, drawn from ``seed``), or
        the weights and BatchNorm statistics of ``resume_variables`` (a
        JAX-layout tree, as ``utils/io.load_unet_weights`` returns; with
        ``keep_stats=False`` the statistics start fresh, as a resume of the
        crop script does), with a fresh optimizer either way
        (train_unet.py:147-151)."""
        model = UNet(features=self.features)
        if resume_variables is not None:
            model.load_state_dict(unet_state_dict_from_jax(resume_variables),
                                  strict=True)
            if not keep_stats:
                reset_running_stats(model)
        else:
            init_flax_(model, torch.Generator().manual_seed(self.seed))
        model = model.to(self.device)
        return TrainState(model, make_adamw(model, self.lr0,
                                           self.weight_decay))

    # ── fit loop (reference train_unet.py:160-213 semantics) ─────────────

    def fit(self, train_imgs, train_msks, val_imgs, val_msks,
            epochs: int = 50, patience: int | None = None,
            ckpt_dir=None, verbose: bool = True,
            state: TrainState | None = None, tensorboard_dir=None):
        """Returns ``(state, best, history)``: ``best`` is the JAX-layout
        variables tree of the best epoch (lowest val loss, or train loss
        without val data)."""
        tb = None
        if tensorboard_dir is not None:
            # same scalar tags as the reference (train_unet.py:198-200)
            from torch.utils.tensorboard import SummaryWriter

            tb = SummaryWriter(tensorboard_dir)
        if state is None:
            state = self.init_state()
        dev = self.device
        n = len(train_imgs)
        bs = self.batch_size
        train_imgs = torch.as_tensor(np.asarray(train_imgs)).to(dev)
        train_msks = torch.as_tensor(np.asarray(train_msks)).to(dev)
        val_imgs = torch.as_tensor(np.asarray(val_imgs)).to(dev)
        val_msks = torch.as_tensor(np.asarray(val_msks)).to(dev)
        best_val = float("inf")
        best = None
        bad_epochs = 0
        history = []
        order_rng = np.random.default_rng(0)

        for epoch in range(epochs):
            lr = cosine_lr(epoch, epochs, self.lr0)
            set_lr(state, lr)
            perm = order_rng.permutation(n)
            t0 = time.time()
            losses = []
            for i in range(0, n, bs):
                idx = torch.as_tensor(perm[i:i + bs], device=dev)
                loss = unet_train_step(state, train_imgs[idx],
                                       train_msks[idx], self.gen, self.dtype)
                losses.append((loss, len(idx)))
            train_loss = (float(sum(float(v) * t for v, t in losses)
                                / sum(t for _, t in losses))
                          if losses else float("nan"))
            vlosses = []
            for i in range(0, len(val_imgs), bs):
                vi, vm = val_imgs[i:i + bs], val_msks[i:i + bs]
                n_real = len(vi)
                if n_real < bs:     # pad the tail batch, masked out below
                    vi = torch.cat([vi, vi.new_zeros((bs - n_real,)
                                                     + vi.shape[1:])])
                    vm = torch.cat([vm, vm.new_zeros((bs - n_real,)
                                                     + vm.shape[1:])])
                valid = torch.arange(bs, device=dev) < n_real
                vlosses.append((unet_eval_loss_masked(
                    state, vi, vm, valid, self.dtype), n_real))
            if vlosses:
                tot = sum(k for _, k in vlosses)
                val_loss = float(sum(float(v) * k for v, k in vlosses) / tot)
            else:
                val_loss = float("nan")
            # no val data: track improvement on the train loss so best /
            # patience still function (the reference crashes on an empty
            # val loader)
            metric = val_loss if vlosses else train_loss

            rec = {"epoch": epoch + 1, "loss/train": train_loss,
                   "loss/val": val_loss, "lr": lr,
                   "sec": round(time.time() - t0, 2)}
            history.append(rec)
            if verbose:
                print(json.dumps(rec), flush=True)
            if tb is not None:
                tb.add_scalar("loss/train", train_loss, epoch + 1)
                tb.add_scalar("loss/val", val_loss, epoch + 1)
                tb.add_scalar("lr", lr, epoch + 1)
            if ckpt_dir is not None:
                save_checkpoint(ckpt_dir, state, "latest")
                with (Path(ckpt_dir) / "metrics.jsonl").open("a") as f:
                    f.write(json.dumps(rec) + "\n")

            if metric < best_val:
                best_val = metric
                best = unet_from_torch(state_dict_cpu(state.model),
                                       n_levels=len(self.features))
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
        if tb is not None:
            tb.close()
        return state, best, history

    @staticmethod
    def load_variables(ckpt_dir, name: str = "best"):
        from openglottal_tpu_torch.utils.io import load_unet_weights

        return load_unet_weights(Path(ckpt_dir) / f"{name}.pt")
