"""The stream cell's camera: the interface of the port's
runtime/camera.MockCamera (at commit
5b978635277ede7c3d2dd15eeb95ccc7be8ca268: open, is_opened, read, set, get,
release), written here so that the yardstick does not move when the port
does, and paced as a real camera is.

It hands out (H, W, 3) uint8 BGR frames, as cv2.VideoCapture does for the
deployment's MJPG cameras, so the port's capture path converts each frame
to gray as it does on a robot. The frames are the scene's gray images in
all three channels, which every BGR-to-gray weighting (cv2's, the port's)
maps back to the same gray bit for bit. The MJPG decoding itself, which
cv2 does inside read() with the interpreter lock released, is not done.

A camera exposes frame k at its due time t0 + k / fps, whether or not
anyone reads it (an open loop). read() returns the newest exposed frame
that has not been returned yet, waiting for the next one where none is
ready, as a V4L2 camera with one buffer does: a reader that falls behind
gets the newest frame, and the frames it missed are dropped at the
camera. Each read is logged (its frame number k, its due time and the
time read() returned), so that a capture stamp taken after read() can be
traced back to its frame and its due time.
"""
from __future__ import annotations

import bisect
import threading
import time

import numpy as np


class PacedCamera:
    def __init__(self, frames: list, pool_index: list, fps: float,
                 t0_ns: int):
        """frames: the camera's frames, shown in turn (frame k is
        frames[k % len(frames)]); pool_index: each one's index in the run's
        pool of distinct frames; t0_ns: time.time_ns() of frame 0."""
        self.frames = [np.ascontiguousarray(
            np.repeat(f[:, :, None], 3, axis=2)) for f in frames]
        self.pool_index = list(pool_index)
        self.period_ns = int(round(1e9 / fps))
        self.t0_ns = int(t0_ns)
        self.height, self.width = self.frames[0].shape[:2]
        self._open = False
        self._next = 0
        self._lock = threading.Lock()
        self.returned_ns = []     # time.time_ns() as read() returned
        self.due_ns = []          # due time of the frame returned
        self.frame_k = []         # its frame number
        self.props = {}

    # -- the port's CameraInterface ----------------------------------------
    def open(self, device, api_preference: int = 0) -> bool:
        self._open = True
        return True

    def is_opened(self) -> bool:
        return self._open

    def read(self):
        if not self._open:
            return None
        now = time.time_ns()
        newest = (now - self.t0_ns) // self.period_ns
        k = max(self._next, newest)
        due = self.t0_ns + k * self.period_ns
        while due > now:
            time.sleep((due - now) / 1e9)
            now = time.time_ns()
        self._next = k + 1
        frame = self.frames[k % len(self.frames)]
        with self._lock:
            self.frame_k.append(k)
            self.due_ns.append(due)
            self.returned_ns.append(time.time_ns())
        return frame

    def set(self, prop, value):
        self.props[prop] = value
        return True

    def get(self, prop):
        return self.props.get(prop, 0.0)

    def release(self):
        self._open = False

    # -- the harness's side --------------------------------------------------
    def lookup(self, stamp_s: float):
        """(pool index, due time s) of the frame whose capture stamp (taken
        after read() returned, before the next read) is stamp_s; None if no
        read came before it."""
        with self._lock:
            i = bisect.bisect_right(self.returned_ns,
                                    int(stamp_s * 1e9) + 1000) - 1
            if i < 0:
                return None
            k = self.frame_k[i]
            return (self.pool_index[k % len(self.frames)],
                    self.due_ns[i] / 1e9)
