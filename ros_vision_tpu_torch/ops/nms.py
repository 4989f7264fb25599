"""Fixed-shape on-device NMS + YOLO output parsing.

The port of ros_vision_tpu/ops/nms.py. Same postprocess semantics as the
reference (yolo_detection.h:53-182): confidence filter at 0.25, per-class
greedy NMS at IoU 0.45 over confidence-descending candidates, as
static-shape device ops: top-K candidate selection, then the exact
sequential greedy pass over the K slots, each step a K-wide vector op
with no host read.
"""
from __future__ import annotations

import torch

CONF_THRESHOLD = 0.25   # game_piece_detection_node.cu:22
IOU_THRESHOLD = 0.45    # game_piece_detection_node.cu:23


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """boxes (..., K, 4) as cx,cy,w,h -> IoU (..., K, K)."""
    x1 = boxes[..., 0] - boxes[..., 2] / 2
    y1 = boxes[..., 1] - boxes[..., 3] / 2
    x2 = boxes[..., 0] + boxes[..., 2] / 2
    y2 = boxes[..., 1] + boxes[..., 3] / 2
    xx1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    yy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    xx2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    yy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = (xx2 - xx1).clamp_min(0.0) * (yy2 - yy1).clamp_min(0.0)
    area = boxes[..., 2] * boxes[..., 3]
    union = area[..., :, None] + area[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def parse_and_nms(raw: torch.Tensor, max_detections: int = 100,
                  conf_threshold: float = CONF_THRESHOLD,
                  iou_threshold: float = IOU_THRESHOLD) -> dict:
    """raw (B, 4+nc, P) f32 -> dict of fixed-shape detections.

    Returns boxes (B, K, 4) cx,cy,w,h in model-input pixels, scores (B, K),
    classes (B, K) int32, valid (B, K) bool; slots sorted by confidence,
    the lower anchor index first among equal scores (lax.top_k's order:
    a stable descending sort, where torch.topk orders ties otherwise).
    """
    k = max_detections
    if k > raw.shape[-1]:
        # lax.top_k refuses it too
        raise ValueError(f"max_detections {k} exceeds the {raw.shape[-1]} "
                         "anchors")
    boxes_all = raw[:, 0:4, :].transpose(1, 2)              # (B, P, 4)
    scores_all = raw[:, 4:, :]                              # (B, nc, P)
    score, cls = scores_all.max(dim=1)                      # (B, P)
    cls = cls.to(torch.int32)
    score = torch.where(score >= conf_threshold, score, 0.0)

    top_scores, top_idx = torch.sort(score, dim=-1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]  # (B, K)
    top_boxes = torch.gather(boxes_all, 1,
                             top_idx[..., None].expand(-1, -1, 4))
    top_cls = torch.gather(cls, 1, top_idx)
    cand_valid = top_scores > 0

    iou = _iou_matrix(top_boxes)
    same_class = top_cls[..., :, None] == top_cls[..., None, :]
    slot = torch.arange(k, device=raw.device)
    # overlap[b, i, j]: a kept slot i suppresses the later slot j
    overlap = ((iou > iou_threshold) & same_class
               & (slot[None, :] > slot[:, None]))

    # exact greedy NMS over confidence-sorted slots: slot i survives iff it
    # is not suppressed by any surviving earlier slot
    suppressed = torch.zeros_like(cand_valid)
    for i in range(k):
        is_kept = cand_valid[:, i] & ~suppressed[:, i]
        suppressed |= is_kept[:, None] & overlap[:, i, :]
    valid = cand_valid & ~suppressed
    return {"boxes": top_boxes, "scores": top_scores,
            "classes": top_cls, "valid": valid}


def scale_boxes(boxes: torch.Tensor, model_wh, orig_wh) -> torch.Tensor:
    """scale_detections (yolo_detection.h:194-216)."""
    sx = orig_wh[0] / model_wh[0]
    sy = orig_wh[1] / model_wh[1]
    return boxes * torch.tensor([sx, sy, sx, sy], dtype=boxes.dtype,
                                device=boxes.device)
