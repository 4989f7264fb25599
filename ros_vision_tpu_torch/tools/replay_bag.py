#!/usr/bin/env python
"""Replay a recorded bag through the detector (offline reprocessing).

The reference records camera topics with `ros2 bag record` and replays them
for offline analysis (launch_vision.py:86-153 + README bag workflow). This
tool reads either a real ROS2 bag (rosbag2 sqlite3 directory or .db3 file,
via runtime/rosbag2.py — the team's existing recordings) or a framework bag
(runtime/bags.py), runs the port's TorchDetector over every recorded frame
of an image topic on --device (cuda, the first card, by default; cpu only
when asked for), and writes a detections JSONL (and optionally annotated
images). The port of ros_vision_tpu/tools/replay_bag.py.
"""
from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("bag_dir")
    ap.add_argument("--topic", help="image topic (default: first image topic)")
    ap.add_argument("--out", default="detections.jsonl")
    ap.add_argument("--annotate-dir")
    ap.add_argument("--fx", type=float, default=900.0)
    ap.add_argument("--fy", type=float, default=900.0)
    ap.add_argument("--cx", type=float)
    ap.add_argument("--cy", type=float)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda: the first card)")
    args = ap.parse_args(argv)

    import glob

    import cv2
    import numpy as np
    import torch
    from ros_vision_tpu_torch.apriltag.detector import (DetectorConfig,
                                                        TorchDetector)
    from ros_vision_tpu_torch.device import require_cuda
    from ros_vision_tpu_torch.runtime.vision_node import VisionNode

    device = require_cuda() if args.device == "cuda" \
        else torch.device(args.device)

    def iter_frames():
        """Yield (header, image) from either bag flavor."""
        is_ros2 = args.bag_dir.endswith(".db3") or (
            os.path.isdir(args.bag_dir)
            and glob.glob(os.path.join(args.bag_dir, "*.db3")))
        if is_ros2:
            from ros_vision_tpu_torch.runtime.rosbag2 import Rosbag2Reader
            reader = Rosbag2Reader(args.bag_dir)
            topic = args.topic or next(iter(reader.image_topics()))
            for seq, (ts, img) in enumerate(reader.read_images(topic)):
                yield {"seq": seq, "t": ts / 1e9}, img, topic
        else:
            from ros_vision_tpu_torch.runtime.bags import BagReader
            reader = BagReader(args.bag_dir)
            topic = args.topic or next(
                t for t in reader.topics() if "image" in t)
            for header, img in reader.read_images(topic):
                yield header, img, topic

    det = None
    n = 0
    topic = None
    with open(args.out, "w") as f:
        for header, img, topic in iter_frames():
            if img is None:
                continue
            gray = img if img.ndim == 2 else cv2.cvtColor(
                img, cv2.COLOR_BGR2GRAY)
            h, w = gray.shape
            gray = gray[: h - h % 8, : w - w % 8]
            if det is None:
                det = TorchDetector(DetectorConfig(
                    width=gray.shape[1], height=gray.shape[0],
                    fx=args.fx, fy=args.fy,
                    cx=args.cx if args.cx is not None else gray.shape[1] / 2,
                    cy=args.cy if args.cy is not None else gray.shape[0] / 2,
                    estimate_pose=True), device=device)
            dets = det.detect(gray)
            f.write(json.dumps({
                "seq": header.get("seq"), "t": header.get("t"),
                "detections": [
                    {"id": d.tag_id, "hamming": d.hamming,
                     "margin": round(d.decision_margin, 2),
                     "center": np.asarray(d.center).round(3).tolist(),
                     "pose_t": None if d.pose_t is None else
                     np.asarray(d.pose_t).round(4).tolist()}
                    for d in dets]}) + "\n")
            if args.annotate_dir:
                os.makedirs(args.annotate_dir, exist_ok=True)
                cv2.imwrite(os.path.join(
                    args.annotate_dir, f"frame_{header.get('seq', n):06d}.png"),
                    VisionNode.annotate(gray, dets))
            n += 1
    print(f"replayed {n} frames from {topic} -> {args.out}")


if __name__ == "__main__":
    main()
