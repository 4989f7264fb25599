"""The card's peaks, each kernel stage's least time, and a network's
share of the tensor cores' peak (mfu).

A stage's least time is the larger of its bytes over the HBM rate and its
f32 operations over the core rate. Bytes are the stage's inputs and
outputs, each counted once, never per kernel, so the share reads the same
work whatever implements the stage. Where the stage reads only part of an
input (refine reads pixels along the edges, not the frame), only what can
be counted without a guess is counted, which errs low. Operation counts
are those of chip_smoke.py (commit
5b978635277ede7c3d2dd15eeb95ccc7be8ca268): POSE_OPS, REFINE_EDGE_OPS,
REFINE_SAMPLE_OPS, REFINE_CORNER_OPS.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at 700 W: HBM3 bytes a second,
# float32 operations a second outside the tensor cores, and BF16
# operations a second on the tensor cores (FP32 accumulate)
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
BF16_TENSOR_OPS_S = 989.4e12

# f32 operations of one pose slot that P1 iterates (chip_smoke.POSE_OPS)
POSE_POLAR_OPS = 29 + 8 * 59 + 14
POSE_STEP_OPS = 330 + POSE_POLAR_OPS
POSE_OPS = (72 + 163 + 54 + POSE_POLAR_OPS + 160
            + 2 * (50 * POSE_STEP_OPS + 168))
# refine_edges: per finite edge, per live sample (at least 16 an edge) and
# per corner of a valid slot (chip_smoke.REFINE_*_OPS); the 25 terms of a
# sample are left out, since how many weigh more than 0 depends on the
# pixels
REFINE_EDGE_OPS = 15 + 66 + 19
REFINE_SAMPLE_OPS = 8 + 66
REFINE_MIN_SAMPLES = 16
REFINE_CORNER_OPS = 13

# the stages that hand-written kernels (csrc/) carry
KERNEL_STAGES = ("threshold", "frontend", "refine", "pose")


def least_ms(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_S, ops / F32_OPS_S) * 1e3


def mfu(flops: float, ms: float) -> float:
    """The share, in %, of the BF16 tensor-core peak that `flops` done in
    `ms` milliseconds reach."""
    return flops / (ms * 1e-3) / BF16_TENSOR_OPS_S * 100.0


def pose_ops(H) -> int:
    """P1 iterates the slots whose four corners project to finite points
    through H (chip_smoke.pose_slots_run): a zero or NaN slot is not."""
    import torch
    x = torch.tensor([-1.0, 1.0, 1.0, -1.0], dtype=H.dtype, device=H.device)
    y = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=H.dtype, device=H.device)
    h = H[..., None, :, :]
    w = h[..., 2, 0] * x + h[..., 2, 1] * y + h[..., 2, 2]
    px = (h[..., 0, 0] * x + h[..., 0, 1] * y + h[..., 0, 2]) / w
    py = (h[..., 1, 0] * x + h[..., 1, 1] * y + h[..., 1, 2]) / w
    live = (torch.isfinite(px) & torch.isfinite(py)).all(-1)
    return int(live.sum()) * POSE_OPS


def refine_ops(corners, valid) -> int:
    import torch
    live = valid & torch.isfinite(corners.flatten(-2)).all(-1)
    n = int(live.sum())
    return n * (4 * (REFINE_EDGE_OPS + REFINE_MIN_SAMPLES * REFINE_SAMPLE_OPS)
                + 4 * REFINE_CORNER_OPS)


def stage_least_ms(calls: list) -> dict:
    """Mean least time a call, by kernel stage, over the profiled calls."""
    calls = [c for c in calls if c["profiled"]]
    if not calls:
        return {}
    out = {}
    for stage in KERNEL_STAGES:
        tot = 0.0
        seen = False
        for c in calls:
            if stage not in c["bytes"]:
                continue
            seen = True
            ops = 0
            if stage == "pose" and "pose" in c["keep"]:
                ops = pose_ops(c["keep"]["pose"])
            elif stage == "refine" and "refine" in c["keep"]:
                ops = refine_ops(*c["keep"]["refine"])
            tot += least_ms(c["bytes"][stage], ops)
        if seen:
            out[stage] = tot / len(calls)
    return out
