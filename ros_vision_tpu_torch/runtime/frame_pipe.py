"""FramePipe: zero-copy host frame transport + double-buffered device feed.

The port's copy of ros_vision_tpu/runtime/frame_pipe.py. Replaces the
reference's DDS image topic hot path (depth-1 best-effort QoS,
camera_publisher.cpp:112-118) with the native SPSC ring
(native/frame_ring.cpp) — capture thread pushes, the detector's feeder
pulls the newest frame, and the vision node overlaps the upload of frame
N+1 with detection of frame N (the role CUDA pinned memory + MemcpyAsync
plays in the reference, cuda_frc971.h:107-145).

Falls back to a pure-Python ring (threading) when the native library isn't
built — same API, same drop-oldest semantics.
"""
from __future__ import annotations

import ctypes
import os
import threading
import time

import numpy as np

_LIB_PATHS = (
    os.path.join(os.path.dirname(__file__), "..", "..", "native",
                 "libframe_ring.so"),
    os.path.join(os.path.dirname(__file__), "libframe_ring.so"),
)


def _load_native():
    for p in _LIB_PATHS:
        p = os.path.abspath(p)
        if os.path.exists(p):
            lib = ctypes.CDLL(p)
            lib.frame_ring_create.restype = ctypes.c_void_p
            lib.frame_ring_create.argtypes = [ctypes.c_uint32,
                                              ctypes.c_uint32]
            lib.frame_ring_destroy.argtypes = [ctypes.c_void_p]
            lib.frame_ring_push.restype = ctypes.c_uint64
            lib.frame_ring_push.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
                ctypes.c_int64]
            try:  # stale .so built before the BGR fast path is fine
                lib.frame_ring_push_bgr.restype = ctypes.c_uint64
                lib.frame_ring_push_bgr.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
                    ctypes.c_int64]
            except AttributeError:
                lib.frame_ring_push_bgr = None
            lib.frame_ring_latest.restype = ctypes.c_uint32
            lib.frame_ring_latest.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_int64)]
            lib.frame_ring_head.restype = ctypes.c_uint64
            lib.frame_ring_head.argtypes = [ctypes.c_void_p]
            return lib
    return None


_NATIVE = _load_native()

try:
    import cv2 as _cv2_probe          # noqa: F401  (presence probe only)
    _HAVE_CV2 = True
except ImportError:
    _HAVE_CV2 = False


def bgr_to_gray(bgr: np.ndarray) -> np.ndarray:
    """BGR8 -> gray, matching cv2.cvtColor(COLOR_BGR2GRAY). Prefers cv2
    itself (SIMD + releases the GIL — the pure-numpy math holds the GIL
    for milliseconds per 1280x800 frame, which at 4 cameras x 100 fps
    starves every other thread); the numpy fallback implements OpenCV
    >= 5's fixed-point form ((B*3735 + G*19235 + R*9798 + 2^14) >> 15;
    OpenCV <= 4.x used a 14-bit variant differing by 1 LSB on ~0.26% of
    triples)."""
    try:
        import cv2
        return cv2.cvtColor(np.ascontiguousarray(bgr), cv2.COLOR_BGR2GRAY)
    except ImportError:
        pass
    b = bgr[..., 0].astype(np.uint32)
    g = bgr[..., 1].astype(np.uint32)
    r = bgr[..., 2].astype(np.uint32)
    return ((b * 3735 + g * 19235 + r * 9798 + 16384) >> 15).astype(np.uint8)


class FrameRing:
    """SPSC drop-oldest frame ring. One per camera.

    With zero_copy=True the ring degenerates to a LATEST-SLOT handoff:
    push() publishes a REFERENCE to the producer's frame (no copy, no
    conversion — a tuple swap, atomic under the GIL) and latest() does
    the copy/BGR->gray conversion on the CONSUMER side, only for frames
    actually consumed. On a CPU-starved host (the 1-core relay VM) the
    copying ring is the wrong trade: 4 capture threads copying/converting
    EVERY captured frame (~0.6-0.8 ms each at 4x100 fps) burn ~0.3 cores
    while the pipeline consumes ~12 of every 100 frames, and that load
    stretches the GIL-holding spin-loop phases (upload measured 24 ms
    in-loop vs 3.3 ms on an idle host). Ownership contract: the producer
    must hand over the frame and never mutate it afterwards
    (cv2.VideoCapture.read() allocates a fresh buffer per frame; mock
    factories return immutable scene arrays). push() enforces it: the
    pushed array is made read-only, so a producer that writes to it
    afterwards raises instead of tearing a frame the consumer reads."""

    def __init__(self, frame_bytes: int, n_slots: int = 4,
                 force_python: bool = False, zero_copy: bool = False):
        self.frame_bytes = frame_bytes
        self.zero_copy = zero_copy
        self._native = None
        self._n_slots = n_slots
        if zero_copy:
            self._ref = None             # (frame, fid, timestamp_ns)
            self._zc_head = 0
            return
        if _NATIVE is not None and not force_python:
            h = _NATIVE.frame_ring_create(n_slots, frame_bytes)
            if h:
                self._native = ctypes.c_void_p(h)
        if self._native is None:
            self._slots = [None] * n_slots
            self._meta = [None] * n_slots
            self._head = 0
            self._lock = threading.Lock()

    @property
    def is_native(self) -> bool:
        return self._native is not None

    def push(self, frame: np.ndarray, timestamp_ns: int = 0) -> int:
        """Publish a frame. Accepts (H, W) gray or (H, W, 3) BGR8 — BGR is
        converted to gray in the ring (natively, off-GIL and straight into
        the slot; cv2-bit-exact either way). The buffer is handed to the
        native side by pointer: ctypes releases the GIL for the call, so
        the copy/convert runs concurrently with other capture threads."""
        if self.zero_copy:
            frame.setflags(write=False)
            fid = self._zc_head
            # single tuple store: readers grab the whole triple atomically
            self._ref = (frame, fid, timestamp_ns or time.monotonic_ns())
            self._zc_head = fid + 1
            return fid
        buf = np.ascontiguousarray(frame)
        is_bgr = buf.ndim == 3 and buf.shape[-1] == 3
        if self._native is not None:
            # the native BGR path reads raw bytes 3-at-a-time — only
            # valid for uint8 input (other dtypes fall through to the
            # Python conversion below)
            if is_bgr and buf.dtype == np.uint8 \
                    and _NATIVE.frame_ring_push_bgr is not None:
                return int(_NATIVE.frame_ring_push_bgr(
                    self._native, buf.ctypes.data_as(ctypes.c_void_p),
                    buf.nbytes // 3, int(timestamp_ns)))
            if is_bgr:
                buf = bgr_to_gray(buf)
            return int(_NATIVE.frame_ring_push(
                self._native, buf.ctypes.data_as(ctypes.c_void_p),
                buf.nbytes, int(timestamp_ns)))
        if is_bgr:
            buf = bgr_to_gray(buf)
        with self._lock:
            fid = self._head
            self._slots[fid % self._n_slots] = buf.copy()
            self._meta[fid % self._n_slots] = (
                fid, timestamp_ns or time.monotonic_ns())
            self._head += 1
            return fid

    def latest(self, last_seen_id: int = -1, out: np.ndarray | None = None):
        """Newest frame newer than last_seen_id, or None.
        Returns (frame bytes-1D uint8, frame_id, timestamp_ns).

        Pass `out` (C-contiguous uint8, >= frame_bytes elements) to have
        the frame written in place (skips one allocation + copy per pull —
        pull_batch hands the batch-tensor row straight in). NOTE on a
        None return with the native ring, `out` may hold a partial frame
        (a torn seqlock read aborts after the copy) — callers must treat
        `out` as garbage unless a frame was returned."""
        if self.zero_copy:
            ref = self._ref
            if ref is None:
                return None
            frame, fid, ts = ref
            if fid == last_seen_id:
                return None
            if frame.ndim == 3 and frame.shape[-1] == 3:
                # straight into the caller's batch row when shapes line
                # up and cvtColor can write there (a uint8, C-contiguous
                # out; for any other it would write a buffer of its own)
                if out is not None and out.ndim == 2 and \
                        out.shape == frame.shape[:2] and \
                        out.dtype == np.uint8 and out.flags.c_contiguous \
                        and frame.dtype == np.uint8 and _HAVE_CV2:
                    import cv2
                    cv2.cvtColor(np.ascontiguousarray(frame),
                                 cv2.COLOR_BGR2GRAY, dst=out)
                    return out.reshape(-1), fid, ts
                g = bgr_to_gray(frame)
            else:
                g = frame
            g = np.ascontiguousarray(g, np.uint8).reshape(-1)
            n = min(g.size, self.frame_bytes)
            if out is None:
                return g[:n], fid, ts
            flat = out.reshape(-1)
            flat[:n] = g[:n]
            return flat[:n], fid, ts
        if self._native is not None:
            if out is None:
                out = np.empty(self.frame_bytes, np.uint8)
            fid = ctypes.c_uint64()
            ts = ctypes.c_int64()
            n = _NATIVE.frame_ring_latest(
                self._native, out.ctypes.data_as(ctypes.c_void_p),
                self.frame_bytes, last_seen_id, ctypes.byref(fid),
                ctypes.byref(ts))
            if n == 0:
                return None
            return out.reshape(-1)[:n], int(fid.value), int(ts.value)
        with self._lock:
            if self._head == 0:
                return None
            fid = self._head - 1
            if fid == last_seen_id:
                return None
            buf = self._slots[fid % self._n_slots]
            meta = self._meta[fid % self._n_slots]
            if out is not None:
                flat = out.reshape(-1)
                flat[:buf.size] = buf.reshape(-1)
                return flat[:buf.size], meta[0], meta[1]
            return buf.reshape(-1), meta[0], meta[1]

    @property
    def head(self) -> int:
        if self.zero_copy:
            return self._zc_head
        if self._native is not None:
            return int(_NATIVE.frame_ring_head(self._native))
        return self._head

    def close(self):
        if self._native is not None:
            _NATIVE.frame_ring_destroy(self._native)
            self._native = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class FramePipe:
    """Multi-camera frame assembly: one ring per camera, batched pull.

    pull_batch() gathers the newest frame of every camera into the (B, H, W)
    batch tensor the detector consumes — the point where the reference's
    per-camera processes become one batched device program."""

    def __init__(self, n_cameras: int, height: int, width: int,
                 n_slots: int = 4, zero_copy: bool | None = None):
        # auto: on a host too small to give every capture thread its own
        # core (the 1-core relay VM), per-capture copies/conversions at
        # full camera rate starve the spin loop — hand frames over by
        # reference and convert only what the pipeline consumes. On
        # multicore hosts the copying ring keeps pull_batch marginally
        # cheaper (memcpy vs cvtColor) and the conversion runs for free
        # on the capture cores, so it stays the default there.
        if zero_copy is None:
            zero_copy = (os.cpu_count() or 1) <= 2
        self.zero_copy = zero_copy
        self.shape = (height, width)
        self.rings = [FrameRing(height * width, n_slots,
                                zero_copy=zero_copy)
                      for _ in range(n_cameras)]
        self._last = [-1] * n_cameras
        self._stamps = [0] * n_cameras

    def push(self, cam: int, frame: np.ndarray, timestamp_ns: int = 0):
        return self.rings[cam].push(frame, timestamp_ns)

    def pull_batch(self, wait_new: bool = False, timeout_s: float = 0.1):
        """(B, H, W) uint8 batch of the newest frames + per-camera
        (frame_id, timestamp) lists. Cameras with no frame yet give zeros.

        With wait_new, waits (up to timeout_s) for EVERY camera to have a
        frame newer than the previous pull — not just any one: an
        any-camera return hands downstream a batch whose laggard rows are
        zeroed with STALE capture stamps, which both drops that camera's
        detections for the cycle and corrupts the capture->pose latency
        accounting whenever one capture thread runs behind (at 100 fps
        cameras the extra wait is <= one frame interval). On deadline the
        partial batch is returned as before."""
        h, w = self.shape
        batch = np.zeros((len(self.rings), h, w), np.uint8)
        ids = [-1] * len(self.rings)
        deadline = time.monotonic() + timeout_s
        while True:
            for i, ring in enumerate(self.rings):
                if ids[i] >= 0:
                    continue     # this camera already delivered this pull
                # frames land straight in the batch row (no temp buffer)
                r = ring.latest(self._last[i] if wait_new else -1,
                                out=batch[i])
                if r is not None:
                    _, fid, ts = r
                    ids[i] = fid
                    self._last[i] = fid
                    self._stamps[i] = ts
            fresh = sum(1 for x in ids if x >= 0)
            if fresh == len(self.rings) or not wait_new \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.0005)
        for i in range(len(self.rings)):
            if ids[i] < 0:
                batch[i] = 0     # torn/absent reads must not leak garbage
        return batch, ids, list(self._stamps)
