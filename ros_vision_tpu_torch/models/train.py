"""Game-piece detector training (fine-tuning) loop.

The port of ros_vision_tpu/models/train.py. The reference trains its
models externally (ultralytics, then a TensorRT engine); here training runs
in the framework: a train step (forward, loss, backward, AdamW update) over
the port's YOLOv11 on the engine's device.

The loss is the JAX package's simplified anchor-assignment objective, term
for term: each ground-truth box is assigned to the anchors whose cell
centers it contains (center sampling, the nearest gt by center distance
winning, the first on ties), IoU box regression on assigned anchors and
focal BCE classification everywhere, both divided by the positive count.
Where the JAX loss takes jnp.maximum / jnp.minimum / jnp.clip, this one
takes torch.maximum / torch.minimum, which split the gradient at ties as
JAX does (clamp would not).

The step trains `engine.model`, the f32 weights, directly: the JAX step
feeds f32 images to an f32 model, and ModelInference.forward (inference
mode, the compute-dtype copy) cannot carry gradients. BatchNorm stays
frozen as in flax (`use_running_average=True`): ConvBN normalises with its
running statistics whatever the module's train/eval mode, so the running
buffers come out of training unchanged while BN scale and bias train.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 5e-4
    box_weight: float = 5.0
    cls_weight: float = 1.0


def _anchor_grid(img_size: int):
    """(A, 2) anchor cell centers in pixels + (A,) strides, matching the
    model's detect head layout (models/yolo.py)."""
    centers, strides = [], []
    for s in (8, 16, 32):
        n = img_size // s
        yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        centers.append(np.stack([(xx.ravel() + 0.5) * s,
                                 (yy.ravel() + 0.5) * s], -1))
        strides.append(np.full(n * n, s, np.float32))
    return (np.concatenate(centers).astype(np.float32),
            np.concatenate(strides))


def loss_fn(out: torch.Tensor, centers: torch.Tensor, boxes: torch.Tensor,
            labels: torch.Tensor, box_mask: torch.Tensor, num_classes: int,
            cfg: TrainConfig = TrainConfig()):
    """(loss, metrics) of the raw (B, 4+nc, A) model output `out` against
    boxes (B, M, 4) cx,cy,w,h pixels, labels (B, M) int, box_mask (B, M)
    bool; centers (A, 2) from _anchor_grid, on out's device."""
    pred_box = out[:, 0:4, :].transpose(1, 2)       # (B, A, 4) cx,cy,w,h
    pred_cls = out[:, 4:, :].transpose(1, 2)        # (B, A, nc) sigmoid
    zero = out.new_zeros(())

    # center-sampling assignment: anchor a <- gt m if the anchor center
    # lies inside the gt box (nearest gt wins by center distance)
    cx = centers[None, None, :, 0]                  # (1, 1, A)
    cy = centers[None, None, :, 1]
    bx = boxes[..., 0:1]                            # (B, M, 1)
    by = boxes[..., 1:2]
    bw = boxes[..., 2:3]
    bh = boxes[..., 3:4]
    inside = (((cx - bx).abs() < bw / 2) & ((cy - by).abs() < bh / 2)
              & box_mask[..., None])                # (B, M, A)
    d2 = (cx - bx) ** 2 + (cy - by) ** 2
    d2 = torch.where(inside, d2, torch.inf)
    best_gt = torch.argmin(d2, dim=1)               # (B, A), first on ties
    assigned = torch.isfinite(d2.min(dim=1).values)  # (B, A)

    gt_box = torch.take_along_dim(boxes, best_gt[..., None], dim=1)
    gt_lab = torch.take_along_dim(labels, best_gt, dim=1)

    # box loss: IoU-based on assigned anchors
    def corners(b):
        return (b[..., 0] - b[..., 2] / 2, b[..., 1] - b[..., 3] / 2,
                b[..., 0] + b[..., 2] / 2, b[..., 1] + b[..., 3] / 2)

    px1, py1, px2, py2 = corners(pred_box)
    gx1, gy1, gx2, gy2 = corners(gt_box)
    iw = torch.maximum(zero, torch.minimum(px2, gx2) - torch.maximum(px1, gx1))
    ih = torch.maximum(zero, torch.minimum(py2, gy2) - torch.maximum(py1, gy1))
    inter = iw * ih
    union = (pred_box[..., 2] * pred_box[..., 3]
             + gt_box[..., 2] * gt_box[..., 3] - inter)
    iou = inter / torch.maximum(union, zero + 1e-6)
    n_pos = torch.maximum(assigned.sum().to(out.dtype), zero + 1.0)
    box_loss = torch.where(assigned, 1.0 - iou, zero).sum() / n_pos

    # classification: focal BCE, target = assigned one-hot
    tgt = (F.one_hot(gt_lab.long(), num_classes).to(out.dtype)
           * assigned[..., None])
    p = torch.minimum(zero + (1 - 1e-6), torch.maximum(zero + 1e-6, pred_cls))
    bce = -(tgt * torch.log(p) + (1 - tgt) * torch.log(1 - p))
    focal = bce * torch.where(tgt > 0.5, (1 - p) ** 2, p ** 2)
    cls_loss = focal.sum() / n_pos

    loss = cfg.box_weight * box_loss + cfg.cls_weight * cls_loss
    mean_iou = torch.where(assigned, iou, zero).sum() / n_pos
    return loss, {"loss": loss, "box_loss": box_loss, "cls_loss": cls_loss,
                  "mean_iou": mean_iou}


def make_train_step(model, tx, img_size: int, num_classes: int,
                    cfg: TrainConfig = TrainConfig()):
    """Returns train_step(imgs, boxes, labels, box_mask) -> metrics: one
    forward, loss, backward and `tx.step()` over `model` in place (the
    step's gradients stay in each parameter's .grad until the next step).

    imgs (B, S, S, 3) f32 NHWC; boxes (B, M, 4) cx,cy,w,h pixels; labels
    (B, M) int; box_mask (B, M) bool (padding); all on the model's device.
    The metrics are detached 0-dim device tensors: reading them is the
    caller's host sync."""
    centers = torch.as_tensor(_anchor_grid(img_size)[0],
                              device=next(model.parameters()).device)

    def train_step(imgs, boxes, labels, box_mask):
        tx.zero_grad(set_to_none=True)
        out = model(imgs.permute(0, 3, 1, 2))
        loss, metrics = loss_fn(out, centers, boxes, labels, box_mask,
                                num_classes, cfg)
        loss.backward()
        tx.step()
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_optimizer(model, cfg: TrainConfig = TrainConfig()):
    """optax.adamw(lr, weight_decay) as torch AdamW: the same betas and
    eps, decoupled decay of every parameter (optax applies it with no
    mask, so conv biases and BatchNorm scale and bias decay too)."""
    return torch.optim.AdamW(model.parameters(), lr=cfg.learning_rate,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)


def train(engine, dataset: Iterable, steps: int,
          cfg: TrainConfig = TrainConfig(), log_every: int = 50):
    """Fine-tune a ModelInference engine in place, on engine.device.

    dataset yields (imgs (B,H,W,3) float[0,1], boxes (B,M,4), labels (B,M),
    box_mask (B,M)) as numpy. Returns the metrics history: the host reads
    the metrics only at every `log_every`-th step and at the last one."""
    model = engine.model
    dev = engine.device
    step_fn = make_train_step(model, make_optimizer(model, cfg),
                              engine.img_size, engine.num_classes, cfg)
    history = []
    it = iter(dataset)
    for i in range(steps):
        imgs, boxes, labels, box_mask = next(it)
        metrics = step_fn(
            torch.as_tensor(imgs, dtype=torch.float32, device=dev),
            torch.as_tensor(boxes, dtype=torch.float32, device=dev),
            torch.as_tensor(labels, device=dev),
            torch.as_tensor(box_mask, dtype=torch.bool, device=dev))
        if i % log_every == 0 or i == steps - 1:
            history.append({k: float(v) for k, v in metrics.items()})
    model.zero_grad(set_to_none=True)
    engine._refresh()
    return history
