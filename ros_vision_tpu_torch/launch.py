"""System launch on the PyTorch port: cameras -> frame pipe -> TorchDetector.

VisionSystem subclasses ros_vision_tpu.launch.VisionSystem and keeps its
start / spin_once / spin / stop loop, which only drives `self.node`. Its
__init__ repeats the parent's camera / FramePipe / channel / NT4 / viewer /
bag wiring with TorchDetector and TorchVisionNode on an explicit device,
and without the jax device mesh (one card serves the whole camera batch).
"""
from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np

from ros_vision_tpu import launch as jax_launch
from ros_vision_tpu.config.loader import ConfigLoader
from ros_vision_tpu.launch import (get_config_data, load_calibration,
                                   scan_for_cameras)
from ros_vision_tpu.utils import rotation_utils

log = logging.getLogger(__name__)


class VisionSystem(jax_launch.VisionSystem):
    """Capture threads + frame pipe + TorchVisionNode + outputs."""

    def __init__(self, *, device,
                 measurement_mode: bool = False,
                 timing_csv_path: str | None = None,
                 enable_bag_recording: bool = False,
                 enable_viewer: bool = True,
                 enable_foxglove: bool = False,
                 enable_nt: bool = True,
                 camera_map: dict | None = None,
                 calibration_dir: str | None = None,
                 camera_factory=None,
                 detector_overrides: dict | None = None,
                 pipe_zero_copy: bool | None = None,
                 tag_sender=None):
        """device: the torch device the detector runs on. tag_sender: an
        optional {location: sender} dict (or one shared sender) used
        instead of NT4 senders — the DI seam for recording publishes."""
        from ros_vision_tpu.runtime.camera import CameraPublisher, OpenCVCamera
        from ros_vision_tpu.runtime.frame_pipe import FramePipe
        from ros_vision_tpu.runtime.scheduler import apply_performance_config
        from ros_vision_tpu.runtime.vision_node import CameraChannel
        from ros_vision_tpu_torch.apriltag.detector import (DetectorConfig,
                                                            TorchDetector)
        from ros_vision_tpu_torch.runtime.vision_node import TorchVisionNode

        cameras = camera_map or scan_for_cameras()
        cfgs = get_config_data(cameras)
        if not cfgs:
            raise RuntimeError("no configured cameras found")

        idents = sorted(cfgs)
        first = cfgs[idents[0]][1]
        mixed = {(cfgs[i][1].width, cfgs[i][1].height) for i in idents}
        if len(mixed) > 1:
            raise RuntimeError(
                f"cameras have mixed resolutions {sorted(mixed)}; run one "
                "VisionSystem per resolution group (camera_map lets you "
                "split the set)")
        self.pipe = FramePipe(len(idents), first.height, first.width,
                              zero_copy=pipe_zero_copy)

        perf = ConfigLoader.get_performance_config()
        self.publishers = []
        channels = []
        intrinsics = None
        per_camera_calibs = []
        for i, ident in enumerate(idents):
            idx, cam, ext = cfgs[ident]
            calib = load_calibration(ident, calibration_dir)
            per_camera_calibs.append(calib)
            if calib is not None and intrinsics is None:
                intrinsics = calib
            camera = camera_factory(ident, idx) if camera_factory \
                else OpenCVCamera()
            pub = CameraPublisher(camera, cam, device=idx,
                                  ring=self.pipe.rings[i])
            self.publishers.append(pub)
            if perf.enable_optimizations:
                apply_performance_config(perf, core_index=i)
            rot = np.asarray(ext.rotation) if ext else \
                rotation_utils.camera_to_robot()
            off = np.asarray(ext.offset) if ext else np.zeros(3)
            channels.append(CameraChannel(
                location=cam.location, extrinsic_rotation=rot,
                extrinsic_offset=off))

        fx, fy, cx, cy, dist = intrinsics or (
            600.0, 600.0, first.width / 2, first.height / 2, (0.0,) * 5)
        # the undistortion-aware refine path is gated on the STATIC dist;
        # derive it from all loaded calibrations, not just the first
        if not any(dist):
            for calib in per_camera_calibs:
                if calib is not None and any(calib[4]):
                    dist = calib[4]
                    break
        det_kw = dict(width=first.width, height=first.height,
                      fx=fx, fy=fy, cx=cx, cy=cy, dist=tuple(dist),
                      estimate_pose=True)
        det_kw.update(detector_overrides or {})
        self.detector = TorchDetector(DetectorConfig(**det_kw), device=device)
        self.mesh = None

        intr_rows = self.detector.default_intrinsics(len(idents))
        for i, calib in enumerate(per_camera_calibs):
            if calib is not None:
                cfx, cfy, ccx, ccy, cdist = calib
                intr_rows[i] = [cfx, cfy, ccx, ccy, *cdist]
        self.intrinsics = intr_rows

        if tag_sender is None and enable_nt:
            nt_cfg = ConfigLoader.get_network_tables_config()
            try:
                from ros_vision_tpu.runtime.nt4 import AprilTagDataSender
                tag_sender = {
                    ch.location: AprilTagDataSender(
                        ident, nt_cfg.table_address, nt_cfg.table_name,
                        port=nt_cfg.port)
                    for ident, ch in zip(idents, channels)}
            except Exception as e:
                log.warning("NT4 connection failed (%s); continuing", e)

        self.viewer = None
        if enable_viewer:
            from ros_vision_tpu.runtime.viewer import ImageStreamServer
            self.viewer = ImageStreamServer()
            for ch in channels:
                ch.image_publisher = self.viewer.publish

        self.foxglove = None
        if enable_foxglove:
            from ros_vision_tpu.runtime.foxglove import FoxgloveBridge
            self.foxglove = FoxgloveBridge()

            def compose(loc, prev):
                def pub(img, _fg=self.foxglove, _loc=loc, _prev=prev):
                    if _prev is not None:
                        _prev(img)
                    _fg.publish_image(f"/{_loc}/annotated", img)
                return pub

            def fg_poses(msg, _fg=self.foxglove):
                class _P:
                    pass
                ds = []
                for det in msg.detections:
                    p = _P()
                    p.pose_t = np.array([det.x, det.y, det.z])
                    p.pose_R = np.eye(3)
                    ds.append(p)
                _fg.publish_poses(f"/{msg.frame_id}/april_tags", ds,
                                  frame_id="robot",
                                  timestamp_ns=int(msg.stamp * 1e9))

            for ch in channels:
                ch.image_publisher = compose(ch.location,
                                             ch.image_publisher)
                ch.pose_publisher = fg_poses

        self.bag = None
        if enable_bag_recording:
            bcfg = ConfigLoader.get_bag_recording_config()
            out = os.path.join(bcfg.output_directory,
                               time.strftime("bag_%Y%m%d_%H%M%S"))
            if bcfg.format == "ros2":
                self.bag = jax_launch._Ros2BagRecorder(
                    out, max_bytes=int(bcfg.max_bag_size),
                    max_duration_s=bcfg.max_duration,
                    auto_split=bcfg.auto_split)
            else:
                from ros_vision_tpu.runtime.bags import BagWriter
                self.bag = BagWriter(out, max_bytes=int(bcfg.max_bag_size),
                                     max_duration_s=bcfg.max_duration)

        self.node = TorchVisionNode(self.detector, channels,
                                    tag_sender=tag_sender,
                                    measurement_mode=measurement_mode,
                                    timing_csv_path=timing_csv_path,
                                    intrinsics=self.intrinsics)
        self.channels = channels
        self.spin_stats = None
        self._running = False


def main(argv=None):
    from ros_vision_tpu_torch.device import require_cuda
    ap = argparse.ArgumentParser(
        description="Launch the vision system on the PyTorch/CUDA port")
    ap.add_argument("--log-level", default="info")
    ap.add_argument("--measurement-mode", action="store_true")
    ap.add_argument("--timing-csv-path")
    ap.add_argument("--enable-bag-recording", action="store_true")
    ap.add_argument("--no-viewer", action="store_true")
    ap.add_argument("--foxglove", action="store_true",
                    help="start the Foxglove Studio ws-protocol bridge")
    ap.add_argument("--no-nt", action="store_true")
    ap.add_argument("--config")
    args = ap.parse_args(argv)
    logging.basicConfig(level=args.log_level.upper())
    if args.config:
        ConfigLoader.set_config_file_path(args.config)
    system = VisionSystem(
        device=require_cuda(),
        measurement_mode=args.measurement_mode,
        timing_csv_path=args.timing_csv_path,
        enable_bag_recording=args.enable_bag_recording,
        enable_viewer=not args.no_viewer,
        enable_foxglove=args.foxglove,
        enable_nt=not args.no_nt)
    system.start()
    try:
        system.spin()
    except KeyboardInterrupt:
        pass
    finally:
        system.stop()


if __name__ == "__main__":
    main()
