"""Message types (TagDetection / TagDetectionArray equivalents).

Mirrors the reference's custom ROS messages (msg/TagDetection.msg: int32 id;
float64 x, y, z; msg/TagDetectionArray.msg) as plain dataclasses — the
framework's in-process bus carries Python objects/numpy arrays instead of
DDS-serialized messages.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np


@dataclasses.dataclass
class TagDetectionMsg:
    id: int
    x: float
    y: float
    z: float


@dataclasses.dataclass
class TagDetectionArrayMsg:
    detections: List[TagDetectionMsg] = dataclasses.field(default_factory=list)
    stamp: float = 0.0
    frame_id: str = ""

    @classmethod
    def from_poses(cls, ids, positions, stamp=None, frame_id=""):
        return cls(
            detections=[TagDetectionMsg(int(i), float(p[0]), float(p[1]),
                                        float(p[2]))
                        for i, p in zip(ids, positions)],
            stamp=stamp if stamp is not None else time.time(),
            frame_id=frame_id)


@dataclasses.dataclass
class ImageMsg:
    data: np.ndarray          # (H, W) gray or (H, W, 3) bgr
    stamp: float = 0.0
    frame_id: str = ""


def encode_apriltag_list_proto(detections, collect_time: float,
                               positions=None) -> bytes:
    """Serialize to the ApriltagListProto wire format (apriltag.proto).

    positions: per-detection (x, y, z) overriding each detection's
    camera-frame pose_t — the reference fills the proto with ROBOT-frame
    positions (apriltags_cuda_detector.cu:483-487), so callers publishing
    to NT must pass the transformed positions."""
    from ros_vision_tpu_torch.msg import apriltag_pb2 as pb
    m = pb.ApriltagListProto()
    for i, d in enumerate(detections):
        t = m.tags.add()
        t.collect_time = float(collect_time)
        t.tag_id = int(d.tag_id)
        if positions is not None:
            p = positions[i]
        else:
            p = d.pose_t if d.pose_t is not None else (0.0, 0.0, 0.0)
        t.x = float(p[0])
        t.y = float(p[1])
        t.z = float(p[2])
    return m.SerializeToString()
