"""ImageProcessorNode — the reference's demo image subscriber.

The port's copy of ros_vision_tpu/runtime/image_processor.py, on the
port's FrameRing.

Parity with src/usb_camera/src/image_processor_node.cpp: subscribes to a
camera image stream, computes the frame's mean intensity, and logs
"Mean Intensity: %.2f, Processing Time: %ld ms" per frame. The DDS
subscription becomes a FrameRing consumer (the repo's topic-shaped frame
transport, runtime/frame_pipe.py) — same drop-oldest depth semantics as
the reference's queue-10 subscription under load.
"""
from __future__ import annotations

import logging
import threading
import time

import numpy as np

from ros_vision_tpu_torch.runtime.frame_pipe import FrameRing

log = logging.getLogger("image_processor")


class ImageProcessorNode:
    """Demo frame consumer: per-frame mean intensity + processing time.

    Drive it either by calling process(frame) directly, or attach() it to
    a FrameRing and start()/stop() the subscription thread.
    """

    def __init__(self, ring: FrameRing | None = None):
        self._ring = ring
        self._thread: threading.Thread | None = None
        self._running = False
        self.frames_processed = 0
        self.last_mean_intensity: float | None = None

    def process(self, frame: np.ndarray) -> float:
        """imageCallback equivalent: mean over all channels + timing log
        (image_processor_node.cpp:15-31)."""
        t0 = time.perf_counter()
        mean_intensity = float(np.asarray(frame, np.float64).mean())
        dt_ms = (time.perf_counter() - t0) * 1e3
        self.frames_processed += 1
        self.last_mean_intensity = mean_intensity
        log.info("Mean Intensity: %.2f, Processing Time: %d ms",
                 mean_intensity, int(dt_ms))
        return mean_intensity

    # ---- FrameRing subscription ------------------------------------------
    def attach(self, ring: FrameRing):
        self._ring = ring

    def start(self):
        assert self._ring is not None, "attach() a FrameRing first"
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        last_id = -1
        while self._running:
            got = self._ring.latest(last_id)
            if got is None:
                time.sleep(0.001)
                continue
            frame, frame_id, _ts = got
            last_id = frame_id
            self.process(frame)

    def stop(self):
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
