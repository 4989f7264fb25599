#!/usr/bin/env python
"""Generate initial extrinsic rotation matrices for camera mounts.

Parity with the reference's robot_rotations.py (P6): given per-camera mount
pitch/yaw presets, emit the rotation matrices (camera optical frame -> robot
frame) as JSON ready to paste into system_config.json extrinsics. The
port's own copy of ros_vision_tpu/tools/robot_rotations.py.
"""
from __future__ import annotations

import argparse
import json

from ros_vision_tpu_torch.utils.rotation_utils import camera_mount_rotation

PRESETS = {
    "center_front": {"pitch": 0.0, "yaw": 0.0},
    "left_front": {"pitch": 0.0, "yaw": 60.0},
    "right_front": {"pitch": 0.0, "yaw": -60.0},
    "left_back": {"pitch": 20.0, "yaw": 150.0},
    "right_back": {"pitch": 20.0, "yaw": -150.0},
}


def generate(presets: dict | None = None) -> dict:
    out = {}
    for loc, cfg in (presets or PRESETS).items():
        r = camera_mount_rotation(cfg.get("pitch", 0.0), cfg.get("yaw", 0.0))
        out[loc] = {"rotation": [[round(float(v), 9) for v in row]
                                 for row in r],
                    "offset": cfg.get("offset", [0.0, 0.0, 0.0])}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--presets", help="JSON file {location: {pitch, yaw}}")
    args = ap.parse_args(argv)
    presets = None
    if args.presets:
        with open(args.presets) as f:
            presets = json.load(f)
    print(json.dumps(generate(presets), indent=4))


if __name__ == "__main__":
    main()
