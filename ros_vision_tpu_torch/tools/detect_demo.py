#!/usr/bin/env python
"""Detection demo CLI: run the port's TorchDetector on an image and
visualize.

The port of ros_vision_tpu/tools/detect_demo.py. Role of the reference's
opencv_cuda_demo / visualize tools: load an image (or render a synthetic
scene), detect on --device (cuda, the first card, by default; cpu only
when asked for), print results, write an annotated image. Also serves the
image_processor demo role (prints mean intensity, image_processor_node.cpp).
"""
from __future__ import annotations

import argparse


def _device(args):
    """--device as a torch device: "cuda" is the first card (raising
    without one)."""
    import torch

    from ros_vision_tpu_torch.device import require_cuda
    name = getattr(args, "device", "cuda")
    return require_cuda() if name == "cuda" else torch.device(name)


def run_camera_loop(args, camera=None, max_frames=None, on_frame=None):
    """Live camera -> detect -> annotate loop (the reference's
    VideoProcessor / opencv_cuda_demo workflow, video_processor.h:13-38:
    capture, detect, draw, show). Annotated frames go to the web viewer
    (and a window when a display is available); `camera`/`max_frames`/
    `on_frame` are test seams (MockCamera injection)."""
    import time

    import cv2

    from ros_vision_tpu_torch.apriltag.detector import (DetectorConfig,
                                                        TorchDetector)
    from ros_vision_tpu_torch.runtime.camera import OpenCVCamera
    from ros_vision_tpu_torch.runtime.vision_node import VisionNode

    cam = camera
    if cam is None:
        cam = OpenCVCamera()
        if not cam.open(args.camera):
            raise SystemExit(f"cannot open camera {args.camera}")
    frame = cam.read()
    if frame is None:
        raise SystemExit("camera produced no frame")
    gray0 = (cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
             if frame.ndim == 3 else frame)
    h, w = gray0.shape[0] - gray0.shape[0] % 8, \
        gray0.shape[1] - gray0.shape[1] % 8
    det = TorchDetector(DetectorConfig(
        width=w, height=h, fx=args.fx, fy=args.fy, cx=args.cx, cy=args.cy,
        tag_size=args.tag_size, estimate_pose=True), device=_device(args))
    viewer = None
    if getattr(args, "viewer_port", 0):
        from ros_vision_tpu_torch.runtime.viewer import ImageStreamServer
        viewer = ImageStreamServer(port=args.viewer_port)
        print(f"viewer at http://localhost:{args.viewer_port}/")
    gui = hasattr(cv2, "imshow") and bool(
        __import__("os").environ.get("DISPLAY"))
    n = 0
    t0 = time.monotonic()
    try:
        while max_frames is None or n < max_frames:
            if n:
                frame = cam.read()
                if frame is None:
                    break
            gray = (cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
                    if frame.ndim == 3 else frame)[:h, :w]
            dets = det.detect(gray)
            ann = VisionNode.annotate(gray, dets)
            n += 1
            if viewer is not None:
                viewer.publish(ann)
            if on_frame is not None:
                on_frame(ann, dets)
            if gui:
                cv2.imshow("ros_vision_tpu_torch detect_demo", ann)
                if cv2.waitKey(1) & 0xFF == ord("q"):
                    break
            if n % 30 == 1:
                el = time.monotonic() - t0
                ids = [d.tag_id for d in dets]
                print(f"frame {n}: {len(dets)} detections {ids} "
                      f"({n / el:.1f} fps)", flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        if viewer is not None:
            viewer.close()
        if camera is None:
            cam.release()
        if gui:
            cv2.destroyAllWindows()
    el = time.monotonic() - t0
    print(f"{n} frames in {el:.1f}s ({n / max(el, 1e-9):.1f} fps)")
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--image", help="input image (else synthetic scene)")
    ap.add_argument("--camera", type=int, default=None, metavar="N",
                    help="live mode: capture from /dev/videoN, detect, "
                    "annotate, stream to the web viewer / a window "
                    "(the reference's opencv_cuda_demo loop)")
    ap.add_argument("--viewer-port", type=int, default=8011,
                    help="web viewer port for --camera mode (0 disables)")
    ap.add_argument("--max-frames", type=int, default=None,
                    help="stop --camera mode after N frames")
    ap.add_argument("--out", default="detections.png")
    ap.add_argument("--fx", type=float, default=905.495617)
    ap.add_argument("--fy", type=float, default=907.909470)
    ap.add_argument("--cx", type=float, default=609.916016)
    ap.add_argument("--cy", type=float, default=352.682645)
    ap.add_argument("--tag-size", type=float, default=0.1651)
    ap.add_argument("--profile-dir", help="write a torch.profiler Chrome "
                    "trace of the (warm) detector call here "
                    "(detect_demo_trace.json) — the op-level tier of the "
                    "reference's per-stage CUDA-event timing "
                    "(apriltag_gpu.cu:1118-1165); open with Perfetto or "
                    "chrome://tracing")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda: the first card)")
    args = ap.parse_args(argv)

    import cv2
    from ros_vision_tpu_torch.apriltag.detector import (DetectorConfig,
                                                        TorchDetector)
    from ros_vision_tpu_torch.runtime.vision_node import VisionNode

    if args.camera is not None:
        run_camera_loop(args, max_frames=args.max_frames)
        return

    if args.image:
        bgr = cv2.imread(args.image)
        gray = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
        h, w = gray.shape
        gray = gray[: h - h % 8, : w - w % 8]
    else:
        from ros_vision_tpu_torch.apriltag.render import (render_scene,
                                                    simple_square_corners)
        gray, _ = render_scene(
            [0, 42], [simple_square_corners(400, 300, 100),
                      simple_square_corners(900, 450, 80, angle_deg=25)],
            1280, 800)

    print(f"image {gray.shape[1]}x{gray.shape[0]}, "
          f"mean intensity {gray.mean():.1f}")
    device = _device(args)
    det = TorchDetector(DetectorConfig(
        width=gray.shape[1], height=gray.shape[0],
        fx=args.fx, fy=args.fy, cx=args.cx, cy=args.cy,
        tag_size=args.tag_size, estimate_pose=True), device=device)
    dets = det.detect(gray)
    if args.profile_dir:
        import os

        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            dets = det.detect(gray)        # warm call: no build in trace
        os.makedirs(args.profile_dir, exist_ok=True)
        path = os.path.join(args.profile_dir, "detect_demo_trace.json")
        prof.export_chrome_trace(path)
        print(f"profiler trace -> {path}")
    print(f"{len(dets)} detections:")
    for d in dets:
        t = d.pose_t if d.pose_t is not None else (0, 0, 0)
        print(f"  id {d.tag_id}  hamming {d.hamming}  "
              f"margin {d.decision_margin:.1f}  "
              f"t = ({t[0]:+.3f}, {t[1]:+.3f}, {t[2]:+.3f}) m")
    cv2.imwrite(args.out, VisionNode.annotate(gray, dets))
    print(f"annotated image -> {args.out}")


if __name__ == "__main__":
    main()
