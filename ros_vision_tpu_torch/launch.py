"""System launch on the PyTorch port: camera discovery, cameras -> frame
pipe -> TorchDetector -> vision node -> outputs.

The port's copy of ros_vision_tpu/launch.py. Behavioral parity with the
reference's launch layer (ros_vision_launch):
  - scan_for_cameras (utils.py:198-284): /dev/v4l/by-id serial discovery,
    /dev/v4l/by-path port mapping, system_config usb_port overrides with
    fail-fast on missing ports, HBVCAMxx fallback names for duplicate-serial
    cameras, actionable errors when nothing is found.
  - launch (launch_vision.py:156-343): per-camera config resolution, camera
    capture threads pinned to sequential cores when performance
    optimizations are enabled, measurement mode + timing CSV, optional bag
    recording with {location}-templated topics, web viewer.

All cameras feed ONE batched detector through the native frame ring, so
"launch" builds threads + one VisionNode instead of the reference's
process pair per camera. With VisionSystem(enable_mesh=True), more than
one device and more than one camera, the camera batch is sharded over the
devices (parallel/mesh.py); otherwise one detector on one device serves
the whole batch.
"""
from __future__ import annotations

import argparse
import logging
import os
import re
import time

import numpy as np

from ros_vision_tpu_torch.config.loader import ConfigLoader
from ros_vision_tpu_torch.utils import rotation_utils

log = logging.getLogger(__name__)

BY_ID_PATH = "/dev/v4l/by-id"
BY_PATH_PATH = "/dev/v4l/by-path"


def scan_by_id(by_id_path: str = BY_ID_PATH) -> dict:
    """serial -> video index, from by-id symlinks containing 'camera'."""
    out = {}
    if not os.path.isdir(by_id_path):
        return out
    for name in sorted(os.listdir(by_id_path)):
        if "amera" not in name or not name.endswith("index0"):
            continue
        m = re.search(r"_([A-Za-z0-9]+)-video-index0$", name)
        if not m:
            continue
        serial = m.group(1)
        target = os.path.realpath(os.path.join(by_id_path, name))
        vm = re.search(r"video(\d+)$", target)
        if vm:
            out[serial] = int(vm.group(1))
    return out


def scan_by_path(by_path_path: str = BY_PATH_PATH):
    """(set of video indices, usb_port -> video index)."""
    indices = set()
    port_map = {}
    if not os.path.isdir(by_path_path):
        return indices, port_map
    for name in sorted(os.listdir(by_path_path)):
        if "video-index0" not in name:
            continue
        target = os.path.realpath(os.path.join(by_path_path, name))
        vm = re.search(r"video(\d+)$", target)
        if not vm:
            continue
        idx = int(vm.group(1))
        indices.add(idx)
        # by-path name ...usb-<bus>:<port.chain>:<config>... ; the config
        # usb_port field is "<bus>:<port.chain>" (e.g. "0:3.1")
        pm = re.search(r"usb-(\d+):([\d.]+):", name)
        if pm:
            port_map[f"{pm.group(1)}:{pm.group(2)}"] = idx
    return indices, port_map


def load_usb_port_overrides() -> dict:
    """usb_port -> camera id from system_config (fail-fast on duplicates)."""
    overrides = {}
    for serial in ConfigLoader.get_all_camera_serials():
        cam = ConfigLoader.get_camera_config(serial)
        if cam and cam.usb_port:
            if cam.usb_port in overrides:
                raise RuntimeError(
                    f"duplicate usb_port {cam.usb_port!r} for cameras "
                    f"{overrides[cam.usb_port]!r} and {serial!r}")
            overrides[cam.usb_port] = serial
    return overrides


def scan_for_cameras(by_id_path: str = BY_ID_PATH,
                     by_path_path: str = BY_PATH_PATH) -> dict:
    """identifier -> video index; same three-pass resolution as the
    reference (overrides, by-id, HBVCAMxx fallback), fail-fast messages."""
    by_id = scan_by_id(by_id_path)
    indices, port_map = scan_by_path(by_path_path)
    overrides = load_usb_port_overrides()

    result = {}
    covered = set()
    for usb_port, cam_id in overrides.items():
        if usb_port not in port_map:
            raise RuntimeError(
                f"FATAL: usb_port override for {cam_id!r} specifies port "
                f"{usb_port!r} but no device found there. Available: "
                f"{sorted(port_map)}")
        result[cam_id] = port_map[usb_port]
        covered.add(port_map[usb_port])
    for serial, idx in by_id.items():
        if idx not in covered:
            result[serial] = idx
            covered.add(idx)
    for i, idx in enumerate(sorted(indices - covered), start=1):
        result[f"HBVCAM{i:02d}"] = idx
    if not result:
        raise RuntimeError(
            "No camera devices found! Scanned both /dev/v4l/by-id and "
            "/dev/v4l/by-path. For by-id detection the device filename "
            "must contain 'Camera'/'camera'.")
    return result


def get_config_data(cameras: dict) -> dict:
    """identifier -> (video index, CameraConfig, ExtrinsicConfig); skips
    cameras without config entries, warning like the reference."""
    out = {}
    for ident, idx in cameras.items():
        cam = ConfigLoader.get_camera_config(ident)
        if cam is None:
            log.warning("camera %s has no system_config entry; skipping",
                        ident)
            continue
        ext = ConfigLoader.get_extrinsic_config(cam.location)
        out[ident] = (idx, cam, ext)
    return out


class _Ros2BagRecorder:
    """BagWriter-shaped adapter over runtime/rosbag2.Rosbag2Writer so the
    spin loop records real rosbag2 output (bag_recording.format = 'ros2',
    the reference's `ros2 bag record` equivalent). Honors the
    bag_recording caps: when max_bytes/max_duration_s is exceeded it
    rotates to a new <name>_N.db3 segment (auto_split=True, `ros2 bag
    record --max-bag-size/--max-bag-duration` behavior) or stops recording
    (auto_split=False)."""

    def __init__(self, directory: str, max_bytes: int | None = None,
                 max_duration_s: float | None = None,
                 auto_split: bool = True):
        from ros_vision_tpu_torch.runtime.rosbag2 import Rosbag2Writer
        self._dir = directory
        self._factory = Rosbag2Writer
        self._max_bytes = max_bytes
        self._max_duration_s = max_duration_s
        self._auto_split = auto_split
        self._segment = 0
        self._t0 = time.time()
        self._stopped = False
        self._w = Rosbag2Writer(directory)

    def _over_limit(self) -> bool:
        return ((self._max_bytes is not None
                 and self._w.bytes_written >= self._max_bytes)
                or (self._max_duration_s is not None
                    and time.time() - self._t0 >= self._max_duration_s))

    def write_image(self, topic: str, image, t: float | None = None) -> bool:
        if self._stopped:
            return False
        if self._over_limit():
            if not self._auto_split:
                self._stopped = True
                log.warning("bag recording limit reached; stopping "
                            "(auto_split=false)")
                return False
            self._w.close()
            self._segment += 1
            self._t0 = time.time()
            self._w = self._factory(self._dir, segment=self._segment)
        ts = int((t if t is not None else time.time()) * 1e9)
        self._w.write_compressed("/" + topic.strip("/"), image, ts)
        return True

    def close(self) -> None:
        self._w.close()


class VisionSystem:
    """The running system: capture threads + frame pipe + vision node +
    outputs. The single-process equivalent of launch_vision.py's node
    graph."""

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
                 tag_sender=None,
                 enable_mesh: bool = False):
        """device: the torch device the detector runs on (the first of the
        mesh's). tag_sender: an optional {location: sender} dict (or one
        shared sender) used instead of NT4 senders — the DI seam for
        recording publishes. enable_mesh: shard the camera batch over
        the devices of the detector's type (parallel/mesh.mesh_devices)
        when there are several, by the JAX package's rule. Off by
        default, unlike the JAX package: the detector call is host-bound,
        and the mesh's worker threads share one interpreter lock, so on
        four H100s a sharded B=4 call measured 14x the unsharded call's
        time (PERF.md, scripts/mb_torch_mesh.py)."""
        from ros_vision_tpu_torch.apriltag.detector import (DetectorConfig,
                                                            TorchDetector)
        from ros_vision_tpu_torch.runtime.camera import (CameraPublisher,
                                                         OpenCVCamera)
        from ros_vision_tpu_torch.runtime.frame_pipe import FramePipe
        from ros_vision_tpu_torch.runtime.scheduler import (
            apply_performance_config)
        from ros_vision_tpu_torch.runtime.vision_node import (CameraChannel,
                                                              VisionNode)

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

        # multi-device: shard the camera batch when more than one device
        # and more than one camera are present (the replacement for the
        # reference's one-process-pair-per-camera scale-out,
        # launch_vision.py:231-308). The axis is the largest divisor of
        # the camera count that fits the device count.
        self.mesh = None
        if enable_mesh:
            from ros_vision_tpu_torch.parallel import mesh as pm
            devices = pm.mesh_devices(self.detector.device)
            axis = pm.camera_axis(len(devices), len(idents))
            if axis > 1:
                self.mesh = pm.make_camera_mesh(n_cameras=axis,
                                                devices=devices)
                self.detector.use_mesh(self.mesh)
                log.info("camera batch sharded over %d devices", axis)

        intr_rows = self.detector.default_intrinsics(len(idents))
        for i, calib in enumerate(per_camera_calibs):
            if calib is not None:
                cfx, cfy, ccx, ccy, cdist = calib
                intr_rows[i] = [cfx, cfy, ccx, ccy, *cdist]
        self.intrinsics = intr_rows

        if tag_sender is None and enable_nt:
            nt_cfg = ConfigLoader.get_network_tables_config()
            try:
                from ros_vision_tpu_torch.runtime.nt4 import (
                    AprilTagDataSender)
                tag_sender = {
                    ch.location: AprilTagDataSender(
                        ident, nt_cfg.table_address, nt_cfg.table_name,
                        port=nt_cfg.port)
                    for ident, ch in zip(idents, channels)}
            except Exception as e:
                log.warning("NT4 connection failed (%s); continuing", e)

        self.viewer = None
        if enable_viewer:
            from ros_vision_tpu_torch.runtime.viewer import ImageStreamServer
            self.viewer = ImageStreamServer()
            for ch in channels:
                ch.image_publisher = self.viewer.publish

        self.foxglove = None
        if enable_foxglove:
            from ros_vision_tpu_torch.runtime.foxglove import FoxgloveBridge
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
                self.bag = _Ros2BagRecorder(
                    out, max_bytes=int(bcfg.max_bag_size),
                    max_duration_s=bcfg.max_duration,
                    auto_split=bcfg.auto_split)
            else:
                from ros_vision_tpu_torch.runtime.bags import BagWriter
                self.bag = BagWriter(out, max_bytes=int(bcfg.max_bag_size),
                                     max_duration_s=bcfg.max_duration)

        self.node = VisionNode(self.detector, channels,
                               tag_sender=tag_sender,
                               measurement_mode=measurement_mode,
                               timing_csv_path=timing_csv_path,
                               intrinsics=self.intrinsics)
        self.channels = channels
        self.spin_stats = None
        self._running = False

    def start(self) -> None:
        for pub in self.publishers:
            if pub.init():
                pub.start()
        self._running = True

    def spin_once(self):
        frames, ids, stamps = self.pipe.pull_batch(wait_new=True)
        results = self.node.process_batch(
            frames, [s / 1e9 for s in stamps])
        if self.bag is not None:
            for ch, frame in zip(self.channels, frames):
                self.bag.write_image(
                    f"cameras/{ch.location}/image_raw/compressed", frame)
        return results

    #: MAX in-flight batches carried by spin() before the oldest is
    #: consumed, and the capture->consume latency budget (seconds) under
    #: which the depth adapts: the loop sheds depth while its latency EMA
    #: is over budget (to 0 past 2x budget) and probes one step back up
    #: when comfortably under. Both values are the JAX package's
    #: (ros_vision_tpu/launch.py:424-449), calibrated there on a TPU; they
    #: are kept unchanged and have not been re-tuned on a GPU.
    pipeline_depth = 2
    latency_budget_s = 0.25

    def spin(self) -> None:
        """Pipelined loop: keep up to `pipeline_depth` detection batches
        in flight; consume (unpack) the oldest while the device works on
        the newer ones. Depth adapts under latency_budget_s. Phase order:
        pull fresh frames, upload, submit, THEN consume the oldest — a
        frame is submitted in the same iteration it was captured.
        Per-camera publish work runs on the node's deferred worker
        thread, and per-phase timing accumulates in self.spin_stats so a
        latency regression is attributable."""
        from collections import deque
        stats = self.spin_stats = {
            "batches": 0, "pull_ms": 0.0, "upload_ms": 0.0,
            "submit_ms": 0.0,
            "consume_ms": 0.0, "latency_ema_ms": 0.0, "depth": 0,
            "depth_downshifts": 0, "depth_upshifts": 0,
            "zero_copy_pipe": bool(self.pipe.zero_copy),
        }
        ema = None
        depth = self.pipeline_depth
        last_upshift = -(1 << 30)     # batch index of last depth change
        pend = deque()
        while self._running:
            t0 = time.monotonic()
            frames, ids, stamps = self.pipe.pull_batch(wait_new=True)
            t0b = time.monotonic()
            dev = self.node.upload(frames)
            t1 = time.monotonic()
            pend.append((self.node.submit(dev), frames, stamps))
            t2 = time.monotonic()
            while len(pend) > depth:
                pending, pending_frames, pending_stamps = pend.popleft()
                self.node.process_batch(pending_frames,
                                        [s / 1e9 for s in pending_stamps],
                                        pending=pending,
                                        defer_publish=True)
                # capture->consumed latency of the freshest camera row;
                # the publish worker adds at most publish_queue_depth
                # batches on top (bounded drop-oldest)
                lat = time.time() - max(pending_stamps) / 1e9
                # skip the first batches: compile/warmup latency spikes
                # would shed depth before steady state is even reached
                if stats["batches"] >= 3:
                    ema = lat if ema is None else 0.8 * ema + 0.2 * lat
                if self.bag is not None:
                    for ch, frame in zip(self.channels, pending_frames):
                        self.bag.write_image(
                            f"cameras/{ch.location}/image_raw/compressed",
                            frame)
            t3 = time.monotonic()
            stats["batches"] += 1
            stats["pull_ms"] += (t0b - t0) * 1e3
            stats["upload_ms"] += (t1 - t0b) * 1e3
            stats["submit_ms"] += (t2 - t1) * 1e3
            stats["consume_ms"] += (t3 - t2) * 1e3
            if ema is not None:
                stats["latency_ema_ms"] = round(ema * 1e3, 1)
                # hysteresis: shed depth when over budget (each step
                # past 1 removes ~1 loop period of queue wait), restore
                # only when comfortably under so the depth doesn't
                # oscillate. Depth floors at 1 short of 2x budget; 0 is
                # reserved for genuine overload.
                floor = 0 if ema > 2 * self.latency_budget_s else 1
                if ema > self.latency_budget_s and depth > floor:
                    depth -= 1
                    stats["depth_downshifts"] += 1
                    last_upshift = stats["batches"]
                elif ema < 0.85 * self.latency_budget_s and \
                        depth < self.pipeline_depth and \
                        stats["batches"] - last_upshift >= 16:
                    # probing upshift: when latency is transport-bound
                    # (not queue-bound) a downshift does not lower ema, so
                    # try depth+1 whenever ema sits inside budget; if the
                    # extra in-flight batch pushes ema over, the downshift
                    # rule reverts it and the 16-batch cooldown bounds
                    # oscillation.
                    depth += 1
                    stats["depth_upshifts"] += 1
                    last_upshift = stats["batches"]
                depth = max(depth, floor)
            stats["depth"] = depth

    def stop(self) -> None:
        self._running = False
        for pub in self.publishers:
            pub.stop()
        self.node.stop()
        if self.bag is not None:
            self.bag.close()
        if self.viewer is not None:
            self.viewer.close()
        if self.foxglove is not None:
            self.foxglove.close()


def load_calibration(serial: str, calibration_dir: str | None = None):
    """Load calibrationmatrix_<serial>.json (P2 output schema:
    camera_matrix/distortion_coefficients/rms)."""
    import json
    dirs = [calibration_dir] if calibration_dir else []
    dirs.append(os.path.join(os.path.dirname(__file__), "config", "data",
                             "calibration"))
    for d in dirs:
        if d is None:
            continue
        path = os.path.join(d, f"calibrationmatrix_{serial}.json")
        if os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
            m = np.asarray(data["camera_matrix"], np.float64)
            dist = np.asarray(
                data.get("distortion_coefficients",
                         data.get("disto", [[0] * 5]))).ravel()[:5]
            return (float(m[0, 0]), float(m[1, 1]), float(m[0, 2]),
                    float(m[1, 2]), tuple(dist))
    return None


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
