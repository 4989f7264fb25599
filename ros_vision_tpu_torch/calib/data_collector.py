"""Extrinsic calibration phase A: synchronized multi-camera frame capture.

The port's own copy of ros_vision_tpu/calib/data_collector.py, discovering
cameras through the port's launch.scan_for_cameras.

Parity with the reference's data_collector.py (288 LoC): opens every
discovered camera directly (no pipeline nodes), captures synchronized frame
sets at a fixed rate for a fixed duration, writes frame_<n>_<camid>.png for
the solver (calib/extrinsic.py).
"""
from __future__ import annotations

import logging
import os
import time

log = logging.getLogger(__name__)


def collect_framesets(out_dir: str, camera_map: dict | None = None,
                      rate_hz: float = 1.0, duration_s: float = 30.0,
                      camera_factory=None) -> int:
    """camera_map: {cam_id: device index}; camera_factory(cam_id, device)
    -> object with read() -> frame or None (DI seam for tests).
    Returns number of framesets captured."""
    from ros_vision_tpu_torch.launch import scan_for_cameras

    cams = camera_map or scan_for_cameras()
    os.makedirs(out_dir, exist_ok=True)

    if camera_factory is None:
        import cv2

        def camera_factory(cam_id, device):
            cap = cv2.VideoCapture(device)

            class _C:
                def read(self):
                    ok, f = cap.read()
                    return f if ok else None

                def release(self):
                    cap.release()
            return _C()

    handles = {cid: camera_factory(cid, dev) for cid, dev in cams.items()}
    n_sets = 0
    t_end = time.monotonic() + duration_s
    try:
        frame_num = 0
        while time.monotonic() < t_end:
            t0 = time.monotonic()
            frames = {}
            for cid, cam in handles.items():
                f = cam.read()
                if f is not None:
                    frames[cid] = f
            if len(frames) == len(handles):
                import cv2
                for cid, f in frames.items():
                    cv2.imwrite(os.path.join(
                        out_dir, f"frame_{frame_num}_{cid}.png"), f)
                n_sets += 1
                frame_num += 1
            else:
                log.warning("incomplete frameset (%d/%d cameras); skipped",
                            len(frames), len(handles))
            sleep = 1.0 / rate_hz - (time.monotonic() - t0)
            if sleep > 0:
                time.sleep(sleep)
    finally:
        for cam in handles.values():
            if hasattr(cam, "release"):
                cam.release()
    return n_sets


def load_framesets(directory: str) -> dict:
    """frame_<n>_<camid>.png files -> {frame_num: {cam_id: gray image}}."""
    import cv2
    out = {}
    for fn in sorted(os.listdir(directory)):
        if not fn.startswith("frame_") or not fn.endswith(".png"):
            continue
        stem = fn[len("frame_"):-len(".png")]
        num, cam_id = stem.split("_", 1)
        img = cv2.imread(os.path.join(directory, fn), cv2.IMREAD_GRAYSCALE)
        out.setdefault(int(num), {})[cam_id] = img
    return out
