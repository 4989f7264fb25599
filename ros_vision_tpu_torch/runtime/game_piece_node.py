"""Game-piece detection node.

The port of ros_vision_tpu/runtime/game_piece_node.py on the port's
ModelInference (a GamePieceNode with no engine builds one on the first
CUDA card). Equivalent of the reference's GamePieceDetector node
(game_piece_detection_node.cu:28-332) — with one improvement: the
reference's node-level inference call is an unimplemented TODO
(game_piece_detection_node.cu:285, only its standalone tools run); this node
runs the full path: frames -> preprocess -> YOLO forward + on-device
NMS -> scaled detections -> publishers.

Config comes from system_config's game_piece_detection section (engine_file
-> weights .npz path, class_names) via ConfigLoader, same as the reference.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import numpy as np

from ros_vision_tpu_torch.config.loader import ConfigLoader
from ros_vision_tpu_torch.models.infer import ModelInference
from ros_vision_tpu_torch.ops import nms
from ros_vision_tpu_torch.runtime.publisher_queue import PublisherQueue

log = logging.getLogger(__name__)


@dataclasses.dataclass
class GamePieceMsg:
    detections: list                 # list[GamePieceDetection]
    stamp: float = 0.0
    frame_id: str = ""


class GamePieceNode:
    def __init__(self, engine: ModelInference | None = None,
                 detection_publisher: Optional[Callable] = None,
                 image_publisher: Optional[Callable] = None,
                 conf_threshold: float = nms.CONF_THRESHOLD):
        if engine is None:
            cfg = ConfigLoader.get_game_piece_config()
            engine = ModelInference(
                num_classes=max(1, len(cfg.class_names)),
                class_names=cfg.class_names,
                params_path=cfg.engine_file if cfg.engine_file and
                cfg.engine_file.endswith(".npz") else None)
            if cfg.engine_file and not cfg.engine_file.endswith(".npz"):
                log.warning(
                    "game_piece engine_file %r is not an .npz weights file; "
                    "running with random-init weights (convert with "
                    "scripts/convert_yolo_weights.py)", cfg.engine_file)
        self.engine = engine
        self.detection_publisher = detection_publisher
        self._img_queue = PublisherQueue(image_publisher, 1,
                                         "gamepiece_img") \
            if image_publisher else None
        self.conf_threshold = conf_threshold
        self.frames_processed = 0

    def process_frame(self, bgr: np.ndarray, stamp: float | None = None,
                      frame_id: str = "") -> list:
        dets = self.engine.detect(bgr, self.conf_threshold)
        self.frames_processed += 1
        if self.detection_publisher is not None:
            self.detection_publisher(GamePieceMsg(
                dets, stamp or time.time(), frame_id))
        if self._img_queue is not None:
            self._img_queue.enqueue(self.annotate(bgr, dets))
        return dets

    @staticmethod
    def annotate(bgr: np.ndarray, dets) -> np.ndarray:
        try:
            import cv2
        except ImportError:
            return bgr
        img = bgr.copy()
        for d in dets:
            x1 = int(d.x - d.w / 2)
            y1 = int(d.y - d.h / 2)
            x2 = int(d.x + d.w / 2)
            y2 = int(d.y + d.h / 2)
            cv2.rectangle(img, (x1, y1), (x2, y2), (255, 128, 0), 2)
            cv2.putText(img, f"{d.class_name} {d.conf:.2f}", (x1, y1 - 4),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.6, (255, 128, 0), 2)
        return img

    def stop(self):
        if self._img_queue is not None:
            self._img_queue.stop()
