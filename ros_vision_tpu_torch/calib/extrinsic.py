"""Extrinsic calibration: multi-camera pose solve with torch Adam.

The port of ros_vision_tpu/calib/extrinsic.py. Parity with the reference's
extrinsic_calibration package:
  - data collection (data_collector.py): synchronized frame sets from all
    cameras at 1 Hz for a fixed duration, frames written as
    frame_<n>_<camid>.png.
  - solver (solver.py:219-317): detect 36h11 tags per image, estimate each
    tag's camera-frame position, then optimize per-camera (roll, pitch, yaw,
    translation) with Adam, minimizing the MSE of pairwise same-tag
    robot-frame position differences for tags seen by exactly two cameras
    (compute_loss solver.py:219-260), batched over all tag pairs on the
    device, in f32.
Output: per-camera rotation matrix + offset in the system_config extrinsics
schema.
"""
from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from ros_vision_tpu_torch.device import require_cuda
from ros_vision_tpu_torch.utils import rotation_utils

log = logging.getLogger(__name__)


@dataclasses.dataclass
class CameraGuess:
    rotations_deg: tuple = (0.0, 0.0, 0.0)   # roll(x), pitch(y), yaw(z)
    translation: tuple = (0.0, 0.0, 0.0)
    adjustable: bool = True


def collect_pairs(frameset: dict, cam_ids: list) -> tuple:
    """frameset: {frame: {tag_id: [{cam_id, translation}, ...]}} ->
    (cam_idx_a, cam_idx_b, pos_a, pos_b) arrays over all tags seen by
    exactly two cameras (solver.py pairing rule)."""
    ia, ib, pa, pb = [], [], [], []
    index = {c: i for i, c in enumerate(cam_ids)}
    for frame in frameset.values():
        for recs in frame.values():
            if len(recs) != 2:
                continue
            a, b = recs
            ia.append(index[a["cam_id"]])
            ib.append(index[b["cam_id"]])
            pa.append(np.asarray(a["translation"], np.float64))
            pb.append(np.asarray(b["translation"], np.float64))
    if not ia:
        raise ValueError("no tags observed by exactly two cameras")
    return (np.asarray(ia), np.asarray(ib),
            np.asarray(pa, np.float32), np.asarray(pb, np.float32))


def _rot_xyz(angles_deg: torch.Tensor) -> torch.Tensor:
    """Differentiable Rz @ Ry @ Rx from degrees (compose_rotations_xyz),
    batched: (..., 3) roll, pitch, yaw -> (..., 3, 3)."""
    r = torch.deg2rad(angles_deg)
    (cx, cy, cz), (sx, sy, sz) = r.cos().unbind(-1), r.sin().unbind(-1)
    one, zero = torch.ones_like(cx), torch.zeros_like(cx)

    def mat(*rows):
        return torch.stack(rows, -1).reshape(*cx.shape, 3, 3)

    rx = mat(one, zero, zero, zero, cx, -sx, zero, sx, cx)
    ry = mat(cy, zero, sy, zero, one, zero, -sy, zero, cy)
    rz = mat(cz, -sz, zero, sz, cz, zero, zero, zero, one)
    return rz @ ry @ rx


_CAM2ROBOT = np.asarray(rotation_utils.camera_to_robot(), np.float32)


def solve_extrinsics(frameset: dict, guesses: dict,
                     num_iterations: int = 500,
                     learning_rate: float = 1e-2, device=None) -> dict:
    """Optimize camera extrinsics on `device` (None: the first CUDA card,
    raising without one; the CPU only when asked for); returns {cam_id:
    {"rotation": 3x3 list, "offset": [3]}} in the system_config schema.
    The host reads the loss once before the solve and once after it."""
    dev = require_cuda() if device is None else torch.device(device)
    cam_ids = sorted(guesses)
    ia, ib, pa, pb = (torch.as_tensor(a, device=dev)
                      for a in collect_pairs(frameset, cam_ids))

    angles = torch.tensor([guesses[c].rotations_deg for c in cam_ids],
                          dtype=torch.float32, device=dev, requires_grad=True)
    trans = torch.tensor([guesses[c].translation for c in cam_ids],
                         dtype=torch.float32, device=dev, requires_grad=True)
    frozen = torch.tensor([not guesses[c].adjustable for c in cam_ids],
                          device=dev)[:, None]
    cam2robot = torch.as_tensor(_CAM2ROBOT, device=dev)

    def cam_rotations():
        return _rot_xyz(angles) @ cam2robot                # (C, 3, 3)

    def loss_fn():
        R = cam_rotations()
        xa = torch.einsum("nij,nj->ni", R[ia], pa) + trans[ia]
        xb = torch.einsum("nij,nj->ni", R[ib], pb) + trans[ib]
        d = xa - xb
        return (d * d).sum(1).mean()                       # solver.py MSE

    tx = torch.optim.Adam([angles, trans], lr=learning_rate,
                          betas=(0.9, 0.999), eps=1e-8)
    with torch.no_grad():
        loss0 = loss_fn()
    loss = loss0
    for _ in range(num_iterations):
        tx.zero_grad()
        loss = loss_fn()
        loss.backward()
        # freeze non-adjustable cameras (solver_config adjustable flags)
        angles.grad.masked_fill_(frozen, 0.0)
        trans.grad.masked_fill_(frozen, 0.0)
        tx.step()
    loss0, loss = float(loss0), float(loss.detach())
    log.info("extrinsic solve: loss %.6f -> %.6f (rmse %.4f m)",
             loss0, loss, loss ** 0.5)

    with torch.no_grad():
        R = cam_rotations().cpu().numpy()
    t = trans.detach().cpu().numpy()
    return {cam: {"rotation": R[i].tolist(), "offset": t[i].tolist()}
            for i, cam in enumerate(cam_ids)}


def build_frameset_from_images(images_by_frame: dict, detector_factory,
                               tag_size: float = 0.1651) -> dict:
    """Phase-A output -> frameset: {frame: {tag_id: [{cam_id, translation}]}}.
    images_by_frame: {frame_num: {cam_id: gray image}}; detector_factory:
    cam_id -> detector with estimate_pose (generate_frameset,
    solver.py:167-216)."""
    frameset = {}
    for frame_num, cams in images_by_frame.items():
        entry = {}
        for cam_id, gray in cams.items():
            det = detector_factory(cam_id)
            res = det.detect(gray)
            dets = res.detections if hasattr(res, "detections") else res
            for d in dets:
                if d.pose_t is None:
                    continue
                entry.setdefault(d.tag_id, []).append(
                    {"cam_id": cam_id,
                     "translation": np.asarray(d.pose_t, np.float64)})
        frameset[frame_num] = entry
    return frameset
