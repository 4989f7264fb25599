"""Camera capture: interface abstraction, OpenCV backend, mock, publisher.

Parity with the reference's usb_camera package:
  - CameraInterface (camera_interface.hpp:27-71): open/read/get/set/release.
  - OpenCVCamera (opencv_camera.cpp): cv2.VideoCapture wrapper.
  - MockCamera (test/mock_camera.hpp:16-53): synthetic frames, failure
    injection, property tracking — the DI seam the reference's node tests
    use.
  - CameraPublisher (camera_publisher.cpp): config-driven fourcc/size/fps/
    buffersize=1, a dedicated blocking capture loop thread that timestamps
    at capture, publishes into a FrameRing, logs FPS every 100 frames, and
    tolerates read failures with rate-limited warnings + 1 ms backoff
    (camera_publisher.cpp:174-223).
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import numpy as np

from ros_vision_tpu_torch.config.loader import (
    CameraConfig, api_preference_from_string, fourcc_from_string)
from ros_vision_tpu_torch.runtime.frame_pipe import FrameRing

log = logging.getLogger(__name__)


class CameraInterface:
    def open(self, device, api_preference: int = 0) -> bool:
        raise NotImplementedError

    def is_opened(self) -> bool:
        raise NotImplementedError

    def read(self) -> Optional[np.ndarray]:
        raise NotImplementedError

    def set(self, prop: int, value: float) -> bool:
        raise NotImplementedError

    def get(self, prop: int) -> float:
        raise NotImplementedError

    def release(self) -> None:
        raise NotImplementedError


class OpenCVCamera(CameraInterface):
    def __init__(self):
        self._cap = None

    def open(self, device, api_preference: int = 0) -> bool:
        import cv2
        self._cap = cv2.VideoCapture(device, api_preference)
        return self._cap.isOpened()

    def is_opened(self) -> bool:
        return self._cap is not None and self._cap.isOpened()

    def read(self):
        ok, frame = self._cap.read()
        return frame if ok else None

    def set(self, prop, value):
        return self._cap.set(prop, value)

    def get(self, prop):
        return self._cap.get(prop)

    def release(self):
        if self._cap is not None:
            self._cap.release()
            self._cap = None


class MockCamera(CameraInterface):
    """Synthetic-frame camera with failure injection (mock_camera.hpp)."""

    def __init__(self, width: int = 640, height: int = 400,
                 frame_factory=None):
        self.width = width
        self.height = height
        self._open = False
        self._fail_read = False
        self.read_count = 0
        self.props = {}
        self._factory = frame_factory

    def open(self, device, api_preference: int = 0) -> bool:
        self._open = True
        return True

    def is_opened(self) -> bool:
        return self._open

    def set_read_failure(self, fail: bool) -> None:
        self._fail_read = fail

    def read(self):
        self.read_count += 1
        if not self._open or self._fail_read:
            return None
        if self._factory is not None:
            return self._factory(self.read_count)
        return np.full((self.height, self.width), 128, np.uint8)

    def set(self, prop, value):
        self.props[prop] = value
        return True

    def get(self, prop):
        return self.props.get(prop, 0.0)

    def release(self):
        self._open = False


# cv2 property ids (kept as constants so MockCamera tests don't need cv2)
CAP_PROP_FOURCC = 6
CAP_PROP_FRAME_WIDTH = 3
CAP_PROP_FRAME_HEIGHT = 4
CAP_PROP_FPS = 5
CAP_PROP_BUFFERSIZE = 38


class CameraPublisher:
    """Dedicated capture-loop thread -> FrameRing, with the reference's
    failure-tolerance behavior."""

    def __init__(self, camera: CameraInterface, config: CameraConfig,
                 device=None, ring: FrameRing | None = None,
                 to_gray=None):
        self.camera = camera
        self.config = config
        self.device = device
        self.ring = ring
        self.to_gray = to_gray
        self.frames_captured = 0
        self.read_failures = 0
        self.consecutive_failures = 0
        self.last_latency_s = 0.0
        self._running = False
        self._thread = None

    def init(self) -> bool:
        api = api_preference_from_string(self.config.api_preference)
        if not self.camera.open(self.device, api):
            log.error("failed to open camera %s", self.device)
            return False
        self.camera.set(CAP_PROP_FOURCC,
                        float(fourcc_from_string(self.config.format)))
        self.camera.set(CAP_PROP_FRAME_WIDTH, float(self.config.width))
        self.camera.set(CAP_PROP_FRAME_HEIGHT, float(self.config.height))
        self.camera.set(CAP_PROP_FPS, float(self.config.frame_rate))
        self.camera.set(CAP_PROP_BUFFERSIZE, 1.0)  # bounded latency
        return True

    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(target=self._capture_loop,
                                        name=f"capture_{self.config.location}",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread:
            self._thread.join(timeout=5)
        self.camera.release()

    def _capture_loop(self) -> None:
        t_window = time.monotonic()
        n_window = 0
        while self._running:
            frame = self.camera.read()
            # capture-time stamping in EPOCH ns: stamps flow to NT
            # collect_time and to capture->pose latency measurement
            # against time.time() (the reference stamps with node now())
            stamp = time.time_ns()
            if frame is None:
                self.read_failures += 1
                self.consecutive_failures += 1
                if self.consecutive_failures in (1, 10, 100) or \
                        self.consecutive_failures % 1000 == 0:
                    log.warning("camera %s read failure x%d",
                                self.config.location,
                                self.consecutive_failures)
                time.sleep(0.001)            # 1 ms backoff, then retry
                continue
            if self.consecutive_failures:
                log.info("camera %s recovered after %d failures",
                         self.config.location, self.consecutive_failures)
            self.consecutive_failures = 0
            if frame.ndim == 3 and self.to_gray is not None:
                frame = self.to_gray(frame)
            if self.ring is not None:
                self.ring.push(frame, stamp)
            self.frames_captured += 1
            self.last_latency_s = (time.time_ns() - stamp) / 1e9
            n_window += 1
            if n_window == 100:              # FPS log every 100 frames
                dt = time.monotonic() - t_window
                log.info("camera %s: %.1f fps, capture->publish %.2f ms",
                         self.config.location, 100 / dt,
                         self.last_latency_s * 1e3)
                t_window = time.monotonic()
                n_window = 0
