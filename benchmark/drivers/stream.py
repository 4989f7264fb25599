"""Traffic driver "stream": the served loop, launch.VisionSystem.spin as
shipped (its pipeline depth and adaptive depth), fed by the benchmark's
own paced cameras and publishing to the benchmark's own NT4 server, which
runs in a process of its own, as the robot's runs on another machine.

Parameters (the mix's file): `cameras` (the configuration's first n
mounts), `fps`, `frames_per_camera` (camera i shows pool frames i,
i + n, ... in turn) and `warmup_batches`, how many batches the loop
completes before the window opens (past the adaptive depth's 16-batch
cooldown, so the window starts in the loop's steady state).

Each camera exposes frames on its own clock whether or not they are read
(an open loop); the port's capture threads read them into its
drop-oldest rings. A frame's latency runs from its due time at the
camera to the arrival of its double array [t, id, x, y, z]* at the NT4
server; the capture stamp t in the array traces it back to its frame.
frames_per_s counts each camera frame once, at its first arrival. The
detections the node published with each stamp (ids, hamming, corners,
pose) are recorded from the node's publish step, and the robot-frame
positions as the server received them, both for `correct`.

The system's config file and its timing CSV go to a directory under
TMPDIR, removed at the end; no bag is written. The notes carry the
window second by second (benchmark/harness/telemetry.py): frames
delivered, the loop's phases, CPU time by thread, garbage collection.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
import threading
import time

from benchmark.harness.camera import PacedCamera
from benchmark.judges.tags import Answer, as_tuples
from benchmark.harness.nt4_server import ServerProcess
from benchmark.harness.telemetry import Sampler

TABLE = "/SmartDashboard"


def system_config(cfg: dict, cams: list, port: int) -> dict:
    return {
        "camera_mounted_positions": {
            c["ident"]: {"location": c["location"], "format": cfg["format"],
                         "height": cfg["height"], "width": cfg["width"],
                         "frame_rate": cfg["frame_rate"],
                         "api_preference": "ANY"} for c in cams},
        "extrinsics": {c["location"]: {"rotation": c["rotation"],
                                       "offset": c["offset"]}
                       for c in cams},
        "network_tables_config": {"table_address": "127.0.0.1",
                                  "table_name": TABLE, "port": port},
    }


def _spin_snapshot(system) -> dict:
    s = dict(system.spin_stats or {})
    return {"batches": s.get("batches", 0), "depth": s.get("depth"),
            "downshifts": s.get("depth_downshifts"),
            "upshifts": s.get("depth_upshifts"),
            "loop_ms": sum(s.get(k, 0.0) for k in ("pull_ms", "upload_ms",
                                                   "submit_ms",
                                                   "consume_ms")),
            "publish_count": system.node.publish_count,
            "publish_dropped": system.node.publish_dropped}


def _spin_counters(system) -> dict:
    s = system.spin_stats or {}
    return {k: s.get(k, 0) for k in ("batches", "pull_ms", "upload_ms",
                                     "submit_ms", "consume_ms")}


def _per_second(delivered, t0, t1) -> list:
    """Frames that arrived in each second of the window."""
    n = [0] * max(1, int(t1 - t0 + 0.999))
    for _, arrival in delivered:
        if t0 <= arrival <= t1:
            n[min(int(arrival - t0), len(n) - 1)] += 1
    return n


def run(ctx):
    import torch
    from ros_vision_tpu_torch.config.loader import ConfigLoader
    from ros_vision_tpu_torch.launch import VisionSystem
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dev = ctx.device
    ncam = int(tr["cameras"])
    mounts = cfg["cameras"][:ncam]
    npool = len(ctx.pool.frames)
    per = int(tr["frames_per_camera"])
    t_cam0 = time.time_ns()
    cams = []
    for i in range(ncam):
        ix = [(i + ncam * k) % npool for k in range(per)]
        cams.append(PacedCamera([ctx.pool.frames[j] for j in ix], ix,
                                float(tr["fps"]), t_cam0))
    server = ServerProcess()
    tmp = tempfile.mkdtemp(prefix="rvbench-stream-")
    captured = []          # (camera, stamp s, dets, time published)
    cap_lock = threading.Lock()
    system = spin = sampler = None
    try:
        path = os.path.join(tmp, "system_config.json")
        with open(path, "w") as f:
            json.dump(system_config(cfg, mounts, server.port), f)
        ConfigLoader.set_config_file_path(path)
        calib = os.path.join(tmp, "calibration")
        os.makedirs(calib)
        system = VisionSystem(
            device=dev, measurement_mode=True,
            timing_csv_path=os.path.join(tmp, "timing.csv"),
            enable_viewer=False, enable_nt=True,
            camera_map={c["ident"]: i for i, c in enumerate(mounts)},
            calibration_dir=calib,
            camera_factory=lambda ident, idx: cams[idx],
            detector_overrides=dict(
                fx=cfg["fx"], fy=cfg["fy"], cx=cfg["cx"], cy=cfg["cy"],
                dist=tuple(cfg["dist"]), family=cfg["family"],
                tag_size=cfg["tag_size"], estimate_pose=True))
        ctx.mark("system")
        node = system.node
        locs = [ch.location for ch in system.channels]
        cam_of_row = [next(i for i, m in enumerate(mounts)
                           if m["location"] == loc) for loc in locs]
        publish = node._publish_batch

        def recording_publish(batch_dets, frames, stamps, t_recv, det_time):
            now = time.time()
            with cap_lock:
                captured.append((list(stamps), batch_dets, now))
            return publish(batch_dets, frames, stamps, t_recv, det_time)
        node._publish_batch = recording_publish
        if ctx.tracer is not None:
            submit = node.submit

            def traced_submit(frames):
                with ctx.tracer.call():
                    return submit(frames)
            node.submit = traced_submit

        system.start()
        deadline = time.time() + 600
        while time.time() < deadline:
            if any(r[0] for r in system.spin_once()):
                break
        ctx.mark("first_detections")
        spin = threading.Thread(target=system.spin, name="spin")
        spin.start()
        warm = int(tr["warmup_batches"])
        while (system.spin_stats or {}).get("batches", 0) < warm:
            if not spin.is_alive():
                raise RuntimeError("the loop ended during its warm-up")
            time.sleep(0.005)
        ctx.mark("warm")
        sampler = Sampler(lambda: _spin_counters(system))
        sampler.start()
        t0 = time.time()
        ctx.window_started(t0)
        s0 = _spin_snapshot(system)
        time.sleep(max(0.0, ctx.t_spans - time.time()))
        s1 = _spin_snapshot(system)
        time.sleep(max(0.0, t0 + ctx.seconds - time.time()))
        t1 = time.time()
        system._running = False
        spin.join(timeout=60)
        sampler.stop()
        if ctx.tracer is not None:
            ctx.tracer.finish()
        peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
    finally:
        if sampler is not None:
            sampler.stop()
        if system is not None:
            system._running = False
            if spin is not None:
                spin.join(timeout=60)
            system.stop()
            for sender in system.node.tag_senders.values():
                with contextlib.suppress(Exception):
                    sender.close()
        server.stop()
        ConfigLoader.set_config_file_path(None)
        ConfigLoader.reload_config()
        shutil.rmtree(tmp, ignore_errors=True)

    # the node's publishes, by (camera, stamp)
    by_stamp, empty = {}, []
    seen = set()
    for stamps, batch_dets, t_pub in captured:
        for row, dets in enumerate(batch_dets):
            cam = cam_of_row[row]
            key = (cam, stamps[row])
            if key in seen:
                continue          # a row repeated with a stale stamp
            seen.add(key)
            by_stamp[key] = dets
            if not dets and t0 <= t_pub <= t1:
                empty.append(key)
    names = {f"{TABLE}/{m['ident']}": i for i, m in enumerate(mounts)}
    delivered, answers, firsts = [], [], set()
    for name, _ts, val, arrival in server.received:
        cam = names.get(name)
        if cam is None or not val or not t0 <= arrival <= t1:
            continue
        stamp = float(val[0])
        if (cam, stamp) in firsts:
            continue
        firsts.add((cam, stamp))
        hit = cams[cam].lookup(stamp)
        dets = by_stamp.get((cam, stamp))
        if hit is None or dets is None:
            raise RuntimeError(f"camera {cam}: a value stamped {stamp} that "
                               "no frame or publish accounts for")
        frame, due = hit
        delivered.append((due, arrival))
        robot = [(int(val[k + 1]), val[k + 2], val[k + 3], val[k + 4])
                 for k in range(0, len(val), 5)]
        answers.append(Answer(frame, as_tuples(dets), robot, cam))
    for cam, stamp in empty:
        hit = cams[cam].lookup(stamp)
        if hit is not None:
            answers.append(Answer(hit[0], [], [], cam))
    lag = [r - d / 1e9 for c in cams
           for d, r in zip(c.due_ns, [x / 1e9 for x in c.returned_ns])]
    batches = s1["batches"] - s0["batches"]
    consumed = (s1["publish_count"] + s1["publish_dropped"]
                - s0["publish_count"] - s0["publish_dropped"])
    layers = {
        "spin_loop_ms": (s1["loop_ms"] - s0["loop_ms"]) / batches
        if batches else None,
        "publish_dropped_share": 100.0 * (s1["publish_dropped"]
                                          - s0["publish_dropped"]) / consumed
        if consumed else None,
    }
    return dict(t0=t0, t1=t1, delivered=delivered, answers=answers,
                memory_peak_bytes=peak, layers=layers, notes={
                    "batches": batches, "empty_answers": len(empty),
                    "spin_loop_ms": layers["spin_loop_ms"],
                    "depth": [s0["depth"], s1["depth"]],
                    "depth_shifts": [s1["downshifts"] - s0["downshifts"],
                                     s1["upshifts"] - s0["upshifts"]],
                    "frames_a_second": _per_second(delivered, t0, t1),
                    "per_second": sampler.series(t0, t1),
                    "camera_read_lag_ms_max": max(lag) * 1e3 if lag else None,
                    "frames_read": sum(len(c.frame_k) for c in cams)})
