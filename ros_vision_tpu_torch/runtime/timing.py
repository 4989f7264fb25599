"""Per-frame timing CSV logger (measurement mode).

Same column contract as the reference's measurement mode
(apriltags_cuda_detector.cu:526-593 writes latency_us, det_time_us,
publish_*_us, networktables_us, processing_time_us per frame) so the
timing-report tooling (tools/timing_report.py, parity with
vision_utils/timing_report.py) consumes either system's CSVs.
"""
from __future__ import annotations

import io
import os
import threading
import time

COLUMNS = ["latency_us", "det_time_us", "publish_image_us",
           "publish_pose_us", "publish_pose_camera_us", "networktables_us",
           "processing_time_us"]


class TimingLogger:
    def __init__(self, path: str | None = None):
        self.path = path or f"/tmp/ros_vision_tpu_timing_{os.getpid()}.csv"
        self._lock = threading.Lock()
        self._f = open(self.path, "w", buffering=1)
        self._f.write(",".join(["timestamp"] + COLUMNS) + "\n")
        self.rows = 0

    def record(self, **kw) -> None:
        vals = [f"{time.time():.6f}"] + [
            f"{kw.get(c, 0.0):.1f}" for c in COLUMNS]
        with self._lock:
            self._f.write(",".join(vals) + "\n")
            self.rows += 1

    def close(self) -> None:
        with self._lock:
            self._f.close()
