"""The vision node: frames -> detection -> robot-frame poses -> outputs.

The port's copy of ros_vision_tpu/runtime/vision_node.py, over a
TorchDetector on its device. Equivalent of the reference's
ApriltagsDetector node (apriltags_cuda_detector.cu:382-557 imageCallback)
— but ONE node serving ALL cameras: the per-camera processes of the
reference become rows of the batched detector. Per frame batch it:
  - runs the detector (detect + decode + pose on the device),
  - transforms each camera's detections to the robot frame with that
    camera's extrinsics (R @ p + t, apriltags_cuda_detector.cu:595-599),
  - sorts detections closest-first (:459-462),
  - publishes: NT4 double-array [t, id, x, y, z]* + protobuf (:465-502),
    robot-frame and camera-frame TagDetectionArray messages, annotated
    images via the publisher queue,
  - optionally logs a per-frame timing CSV in the reference's measurement
    format (:526-593).

Frame staging on a CUDA detector:
  - upload: the frame batch is staged in pinned host memory and sent with
    a non_blocking H2D copy, so the transfer overlaps host work;
  - submit: detection is enqueued and the packed (B, NQ, 36) output is
    copied D2H into pinned memory with a torch.cuda.Event recorded after
    the copy; the returned PendingOutput is waited on only by
    TorchDetector.unpack.
Pinned buffers come from PyTorch's caching host allocator, which does not
hand a block out again until the copies recorded on it have finished.
On a CPU detector the same calls run synchronously with no pinning.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from ros_vision_tpu_torch.apriltag.detector import PendingOutput
from ros_vision_tpu_torch.msg.types import (TagDetectionArrayMsg,
                                            encode_apriltag_list_proto)
from ros_vision_tpu_torch.runtime.publisher_queue import PublisherQueue
from ros_vision_tpu_torch.runtime.timing import TimingLogger

log = logging.getLogger(__name__)


@dataclasses.dataclass
class CameraChannel:
    location: str
    extrinsic_rotation: np.ndarray     # (3, 3) camera->robot
    extrinsic_offset: np.ndarray       # (3,)
    image_publisher: Optional[Callable] = None       # annotated frames
    pose_publisher: Optional[Callable] = None        # robot-frame array
    pose_camera_publisher: Optional[Callable] = None # camera-frame array


class VisionNode:
    """The vision node over a TorchDetector, on the detector's device."""

    def __init__(self, detector, channels: list,
                 tag_sender=None, measurement_mode: bool = False,
                 timing_csv_path: str | None = None,
                 intrinsics=None):
        """detector: TorchDetector; channels: list[CameraChannel] — channel
        i consumes batch row i. intrinsics: optional (B, 9) per-camera
        calibration rows (each camera gets its own
        calibrationmatrix_<serial>.json in the reference)."""
        self.detector = detector
        self.device = detector.device
        self.channels = channels
        self.intrinsics = intrinsics
        # one NT sender per camera (the reference keys senders by camera
        # serial, apriltags_cuda_detector.cu:155): a dict {location:
        # sender}. A bare sender is accepted for single-camera use and is
        # shared across channels.
        if tag_sender is None or isinstance(tag_sender, dict):
            self.tag_senders = tag_sender or {}
        else:
            self.tag_senders = {ch.location: tag_sender for ch in channels}
        self.timing = TimingLogger(timing_csv_path) if measurement_mode \
            else None
        self._queues = {}
        for ch in channels:
            if ch.image_publisher is not None:
                self._queues[ch.location] = PublisherQueue(
                    ch.image_publisher, max_queue_size=1,
                    name=f"imgpub_{ch.location}")
        self._intr_dev = None       # lazily device-staged intrinsics
        self._intr_src = None       # host object the staged copy came from
        self._pub_q = None          # deferred-publish drop-oldest deque
        self._pub_cv = None
        self._pub_stop = False
        self._pub_worker = None
        self.publish_dropped = 0    # batches dropped by the bounded
        # deferred-publish queue (a lagging publisher sheds OLD batches —
        # the newest data still goes out, latency stays bounded, and the
        # spin loop is never backpressured by a wedged sender)
        self.publish_count = 0

    def transform_camera_to_robot(self, ch: CameraChannel,
                                  p_cam: np.ndarray) -> np.ndarray:
        return ch.extrinsic_rotation @ np.asarray(p_cam) + \
            ch.extrinsic_offset

    def upload(self, frames: np.ndarray) -> torch.Tensor:
        """Enqueue the H2D copy of a (B, H, W) uint8 batch; returns the
        device tensor."""
        host = torch.from_numpy(np.ascontiguousarray(frames))
        if self.device.type != "cuda":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def _intrinsics_for_submit(self):
        """Intrinsics rows staged on the device once, re-staged when
        self.intrinsics is reassigned (runtime recalibration)."""
        if self.intrinsics is None:
            return None
        if self._intr_dev is None or self._intr_src is not self.intrinsics:
            self._intr_dev = torch.as_tensor(
                np.asarray(self.intrinsics, np.float32), device=self.device)
            self._intr_src = self.intrinsics
        return self._intr_dev

    def submit(self, frames) -> PendingOutput:
        """Enqueue detection of a batch (host array or the tensor from
        upload()) and the D2H copy of its packed result; returns a
        PendingOutput for process_batch(pending=...)."""
        out = self.detector.detect_raw_packed(
            frames, self._intrinsics_for_submit())
        if self.device.type != "cuda":
            return PendingOutput(out, None)
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return PendingOutput(host, event)

    #: deferred-publish queue depth. 2 bounds the capture->publish latency
    #: a lagging publisher can add to ~2 batch periods; beyond that OLD
    #: batches are dropped (the robot wants the newest poses — stale tag
    #: data is cleared by the next publish either way, matching the
    #: drop-oldest PublisherQueue / depth-1 QoS semantics of the reference,
    #: camera_publisher.cpp:112-118).
    publish_queue_depth = 2

    def _ensure_pub_worker(self):
        """Single worker draining a bounded DROP-OLDEST deque: enqueue
        never blocks the spin loop, a wedged sender sheds old batches
        (counted in publish_dropped) instead of backpressuring capture,
        and stop() never hangs on a full queue."""
        if self._pub_worker is None:
            self._pub_q = collections.deque()
            self._pub_cv = threading.Condition()
            self._pub_stop = False

            def run():
                while True:
                    with self._pub_cv:
                        self._pub_cv.wait_for(
                            lambda: self._pub_q or self._pub_stop)
                        if not self._pub_q:
                            return          # stop requested, queue drained
                        item = self._pub_q.popleft()
                    try:
                        self._publish_batch(*item)
                        self.publish_count += 1
                    except Exception:
                        log.exception("deferred publish failed")

            self._pub_worker = threading.Thread(
                target=run, daemon=True, name="vision_pub")
            self._pub_worker.start()

    def process_batch(self, frames: np.ndarray, capture_stamps=None,
                      pending=None, defer_publish: bool = False):
        """frames (B, H, W) uint8 -> per-camera detection lists (robot
        frame), publishing side effects included. Returns list of
        (detections, robot_positions). Pass `pending` (from submit()) to
        consume a previously dispatched batch instead of detecting inline.
        With defer_publish=True the per-camera publish work (transforms,
        NT4, protobuf, CSV) runs on a dedicated worker thread and None is
        returned."""
        t_recv = time.monotonic()
        stamps = capture_stamps or [time.time()] * len(self.channels)

        t0 = time.monotonic()
        if pending is None:
            pending = self.detector.detect_raw_packed(frames, self.intrinsics)
        batch_dets = self.detector.unpack(pending)
        det_time = time.monotonic() - t0
        if frames.ndim == 2:
            batch_dets = [batch_dets]

        if defer_publish:
            self._ensure_pub_worker()
            with self._pub_cv:
                while len(self._pub_q) >= self.publish_queue_depth:
                    self._pub_q.popleft()          # drop oldest
                    self.publish_dropped += 1
                self._pub_q.append(
                    (batch_dets, frames, stamps, t_recv, det_time))
                self._pub_cv.notify()
            return None
        return self._publish_batch(batch_dets, frames, stamps, t_recv,
                                   det_time)

    def _publish_batch(self, batch_dets, frames, stamps, t_recv, det_time):
        results = []
        for i, (ch, dets) in enumerate(zip(self.channels, batch_dets)):
            robot_pos = []
            for d in dets:
                if d.pose_t is not None:
                    robot_pos.append(self.transform_camera_to_robot(
                        ch, d.pose_t))
                else:
                    robot_pos.append(np.zeros(3))
            # closest-first ordering by CAMERA-frame distance — the
            # reference computes the sort key from the camera-frame pose,
            # not the robot frame (apriltags_cuda_detector.cu:443-447),
            # which differs whenever the extrinsic offset is nonzero
            order = np.argsort(
                [np.linalg.norm(np.asarray(d.pose_t))
                 if d.pose_t is not None else np.inf for d in dets]) \
                if dets else []
            dets = [dets[j] for j in order]
            robot_pos = [robot_pos[j] for j in order]

            t_nt0 = time.monotonic()
            sender = self.tag_senders.get(ch.location)
            if sender is not None:
                # send EVERY frame, including empty lists: the robot must
                # see stale tag data cleared when tags leave view (the
                # reference publishes networktables_pose_data each frame,
                # apriltags_cuda_detector.cu:501)
                flat = []
                for d, p in zip(dets, robot_pos):
                    flat += [float(stamps[i]), float(d.tag_id),
                             float(p[0]), float(p[1]), float(p[2])]
                sender.send_value(flat)
                # robot-frame positions in the proto, like the double array
                # (apriltags_cuda_detector.cu:483-487)
                sender.send_protobuf(
                    encode_apriltag_list_proto(dets, stamps[i],
                                               positions=robot_pos))
            nt_time = time.monotonic() - t_nt0

            t_p0 = time.monotonic()
            if ch.pose_publisher is not None:
                ch.pose_publisher(TagDetectionArrayMsg.from_poses(
                    [d.tag_id for d in dets], robot_pos,
                    stamps[i], ch.location))
            if ch.pose_camera_publisher is not None:
                ch.pose_camera_publisher(TagDetectionArrayMsg.from_poses(
                    [d.tag_id for d in dets],
                    [d.pose_t if d.pose_t is not None else np.zeros(3)
                     for d in dets], stamps[i], ch.location))
            pub_time = time.monotonic() - t_p0

            t_i0 = time.monotonic()
            q = self._queues.get(ch.location)
            if q is not None:
                q.enqueue(self.annotate(frames[i] if frames.ndim == 3
                                        else frames, dets))
            img_time = time.monotonic() - t_i0

            if self.timing is not None:
                now = time.time()
                latency = now - stamps[i] if stamps[i] < now else 0.0
                self.timing.record(
                    latency_us=latency * 1e6, det_time_us=det_time * 1e6,
                    publish_image_us=img_time * 1e6,
                    publish_pose_us=pub_time * 1e6,
                    networktables_us=nt_time * 1e6,
                    processing_time_us=(time.monotonic() - t_recv) * 1e6)
            results.append((dets, robot_pos))
        return results

    @staticmethod
    def annotate(gray: np.ndarray, dets) -> np.ndarray:
        """Draw detection outlines + ids (the reference publishes annotated
        frames for Foxglove/web viewing)."""
        try:
            import cv2
        except ImportError:
            return gray
        img = cv2.cvtColor(np.asarray(gray), cv2.COLOR_GRAY2BGR)
        for d in dets:
            pts = np.asarray(d.corners, np.int32).reshape(-1, 1, 2)
            cv2.polylines(img, [pts], True, (0, 255, 0), 2)
            c = tuple(np.asarray(d.center, np.int32))
            cv2.putText(img, str(d.tag_id), c, cv2.FONT_HERSHEY_SIMPLEX,
                        0.8, (0, 0, 255), 2)
        return img

    def stop(self):
        if self._pub_worker is not None:
            with self._pub_cv:
                self._pub_stop = True      # drain then exit; never blocks
                self._pub_cv.notify_all()
            self._pub_worker.join(timeout=10)
            self._pub_worker = None
        for q in self._queues.values():
            q.stop()
        if self.timing is not None:
            self.timing.close()
