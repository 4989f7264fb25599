"""Multi-card scale-out: camera-batch sharding over a list of devices.

Counterpart of ros_vision_tpu/parallel/mesh.py. The reference scales by
spawning one process pair per camera on one machine
(launch_vision.py:231-308); the JAX package shards the camera axis of its
jitted pipeline over a mesh with shard_map. Here a "mesh" is an ordered
list of torch devices: the camera batch splits into contiguous equal
slices, one per device, and each slice runs on a TorchDetector of its own
(its own code matrix on its device) in a worker thread of its own, so the
cards' work overlaps. The batch is embarrassingly parallel (no
cross-camera math), so the gathered result is the unsharded call's.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ros_vision_tpu_torch.device import require_cuda


def camera_axis(n_devices: int, n_cameras: int) -> int:
    """The mesh size for `n_cameras` over `n_devices`: the largest divisor
    of the camera count that does not exceed the device count, so every
    shard gets the same rows (1: no mesh)."""
    return max(d for d in range(1, max(1, min(n_devices, n_cameras)) + 1)
               if n_cameras % d == 0)


def mesh_devices(device) -> list:
    """The devices a mesh for a detector on `device` may span: every
    visible CUDA card, `device` first, for a CUDA device; `device` alone
    otherwise (torch has one CPU device)."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device]
    first = device.index if device.index is not None \
        else torch.cuda.current_device()
    n = torch.cuda.device_count()
    return [torch.device("cuda", (first + i) % n) for i in range(n)]


def make_camera_mesh(n_cameras: int | None = None, devices=None) -> list:
    """The first `n_cameras` of `devices` (default: every visible CUDA
    card; raises without one) as torch devices. A list of CPU devices is
    allowed when the caller passes it."""
    if devices is None:
        devices = [require_cuda(i)
                   for i in range(max(1, torch.cuda.device_count()))]
    devs = [torch.device(d) for d in devices]
    if n_cameras is None:
        n_cameras = len(devs)
    if not 1 <= n_cameras <= len(devs):
        raise ValueError(f"{n_cameras} camera shards for {len(devs)} "
                         "devices")
    return devs[:n_cameras]


class _Sharded:
    """One TorchDetector and one worker thread per mesh device."""

    def __init__(self, detector, mesh: list, packed: bool):
        from ros_vision_tpu_torch.apriltag.detector import TorchDetector
        self.mesh = list(mesh)
        self.packed = packed
        self.detectors = [TorchDetector(detector.config, device=d)
                          for d in self.mesh]
        self.pool = ThreadPoolExecutor(len(self.mesh),
                                       thread_name_prefix="camera_shard")

    def _run(self, det, frames, intrinsics):
        if det.device.type == "cuda":
            torch.cuda.set_device(det.device)
        out = det._detect_device(frames.to(det.device),
                                 intrinsics.to(det.device))
        if self.packed:
            from ros_vision_tpu_torch.apriltag.detector import pack_outputs
            return pack_outputs(out)
        return out

    def __call__(self, frames: torch.Tensor, intrinsics: torch.Tensor):
        b = frames.shape[0]
        n = len(self.mesh)
        if b % n:
            raise ValueError(f"batch of {b} cameras does not split over "
                             f"{n} devices")
        step = b // n
        futures = [self.pool.submit(self._run, det,
                                    frames[i * step:(i + 1) * step],
                                    intrinsics[i * step:(i + 1) * step])
                   for i, det in enumerate(self.detectors)]
        parts = [f.result() for f in futures]
        first = self.mesh[0]
        if self.packed:
            return torch.cat([p.to(first) for p in parts])
        return {k: torch.cat([p[k].to(first) for p in parts])
                for k in parts[0]}


def shard_detector(detector, mesh: list):
    """A callable (frames (B, H, W) uint8, intrinsics (B, 9)) -> the output
    dict of detector._detect_device, computed as B / len(mesh) contiguous
    rows on each device and gathered on mesh[0]."""
    return _Sharded(detector, mesh, packed=False)


def shard_detector_packed(detector, mesh: list):
    """shard_detector for the packed-output hot path (VisionNode.submit):
    each device runs detect + pack_outputs on its rows; the (B, NQ, C)
    result is gathered on mesh[0]."""
    return _Sharded(detector, mesh, packed=True)


def gather_detections(out: dict) -> dict:
    """Host-side gather of the (gathered-on-the-first-device) outputs."""
    return {k: np.asarray(v.cpu()) for k, v in out.items()}
