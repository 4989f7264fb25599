#!/usr/bin/env python
"""Intrinsic calibration CLI (charuco_calibrate.launch.py /
checkerboard_calibrate.launch.py equivalents). The port's own copy of
ros_vision_tpu/tools/calibrate_camera.py.

Opens the camera, feeds frames to the selected calibrator (charuco default,
checkerboard with --checkerboard), shows progress, and writes
calibrationmatrix_<serial>.json where the launch layer picks it up.
"""
from __future__ import annotations

import argparse
import logging

log = logging.getLogger(__name__)


def run(camera, calibrator, serial: str, out_dir: str,
        max_seconds: float = 300.0) -> str | None:
    import time
    from ros_vision_tpu_torch.calib.intrinsic import write_calibration
    t_end = time.monotonic() + max_seconds
    while not calibrator.ready and time.monotonic() < t_end:
        frame = camera.read()
        if frame is None:
            time.sleep(0.01)
            continue
        if frame.ndim == 3:
            import cv2
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        if calibrator.process_frame(frame):
            print(f"captured {calibrator.n_captures}/"
                  f"{calibrator.max_frames}")
    if not calibrator.ready:
        print("timed out before collecting enough frames")
        return None
    result = calibrator.calibrate()
    path = write_calibration(result, serial, out_dir)
    print(f"rms {result['rms']:.4f} -> {path}")
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("serial", help="camera serial (artifact name)")
    ap.add_argument("--device", type=int, help="video index (else "
                                               "discovered by serial)")
    ap.add_argument("--checkerboard", action="store_true")
    ap.add_argument("--out-dir",
                    default="ros_vision_tpu_torch/config/data/calibration")
    ap.add_argument("--squares-x", type=int, default=11)
    ap.add_argument("--squares-y", type=int, default=8)
    args = ap.parse_args(argv)

    from ros_vision_tpu_torch.calib.intrinsic import (CharucoCalibrator,
                                                CheckerboardCalibrator)
    from ros_vision_tpu_torch.runtime.camera import OpenCVCamera

    device = args.device
    if device is None:
        from ros_vision_tpu_torch.launch import scan_for_cameras
        device = scan_for_cameras()[args.serial]
    cam = OpenCVCamera()
    if not cam.open(device):
        raise SystemExit(f"cannot open /dev/video{device}")
    cal = CheckerboardCalibrator() if args.checkerboard else \
        CharucoCalibrator(args.squares_x, args.squares_y)
    try:
        run(cam, cal, args.serial, args.out_dir)
    finally:
        cam.release()


if __name__ == "__main__":
    main()
