#!/usr/bin/env python
"""Headline benchmark of the port: 1280x800 36h11 AprilTag detection.

    python -m ros_vision_tpu_torch.bench [--device cuda|cpu]

The counterpart of bench.py (the JAX package's) on TorchDetector, with
bench.py's JSON keys, scene and gate: the 4-tag bench scene (ids
[0, 42, 100, 311], noise sigma 1) must decode (`tags_ok`); a sweep over
BENCH_BATCHES (default 1,4,8,16) of BENCH_ITERS (default 30) detect_raw
calls each, every call's `ok` tensor copied to pinned host memory without
blocking and every copy read after the loop (a pipelined consumer's
pattern); the best batch as the headline fps; `p50_latency_ms` (the B=1
point) and `b1_sync_roundtrip_ms` (a synchronous read per call); the
golden 1080p photo's phase when BENCH_GOLDEN_PHOTO names the reference's
colorimage.jpg (otherwise its keys are null and `golden_1080p_skipped`
says why); and four 1280x800 mock cameras streamed through the port's
VisionSystem to an in-process NT4TestServer for BENCH_STREAM_S seconds
(default 12; BENCH_STREAMING=0 skips it).

Added keys: `backend` ("torch-cuda" or "torch-cpu"), `device` (the
card's name and power limit from nvidia-smi) and `stage_ms` (host ms a
detect_raw call of each span utils/tracing.RECORDER records, at B=1 and
B=4; no synchronize between calls).

The record cannot be lost: every key is present from the start (null
until its phase runs); a complete line prints as soon as the B=8 point
lands and again at the end, so the last line is always the most complete;
SIGTERM and the BENCH_TOTAL_TIMEOUT_S watchdog print the record so far
with `bench_error`; each line serialises a snapshot, never the live
record. The device is the first card unless --device cpu asks for the
CPU; without a card the bench raises.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import torch

CAMERA_TARGET_FPS = 100.0  # 1280x800@100fps MJPG target (system_config.json)
METRIC = "apriltag_1280x800_36h11_detect_fps_per_chip"
BENCH_IDS = [0, 42, 100, 311]
# bench.py's keys, each null until its phase has run
KEYS = ("metric", "value", "unit", "vs_baseline", "tags_ok", "best_batch",
        "best_batch_call_ms", "sweep", "active_config", "p50_latency_ms",
        "b1_sync_roundtrip_ms", "golden_1080p_ms_per_frame",
        "golden_1080p_tags_ok", "streaming_cameras",
        "streaming_fps_per_camera", "e2e_p50_ms", "e2e_p95_ms",
        "streaming_phases", "e2e_note")


class Record:
    """The bench record. Phases update it; emit() prints one JSON line of a
    deep copy taken under the lock, so a line never shows a phase's
    half-written state and no later phase changes a printed line."""

    def __init__(self, **fields):
        self._d = dict.fromkeys(KEYS)
        self._d.update(fields)
        self._lock = threading.Lock()

    def update(self, **fields) -> None:
        with self._lock:
            self._d.update(copy.deepcopy(fields))

    def snapshot(self) -> dict:
        with self._lock:
            return copy.deepcopy(self._d)

    def emit(self, **extra) -> None:
        line = json.dumps({**self.snapshot(), **extra})
        sys.stdout.write(line + "\n")
        sys.stdout.flush()


def card_info(dev: torch.device) -> dict:
    """The card's name and power limit as nvidia-smi reports them."""
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={dev.index or 0}"],
        capture_output=True, text=True, check=True).stdout.strip()
    name, limit = (s.strip() for s in smi.split(","))
    return {"name": name, "power_limit": limit}


def bench_scene(width: int = 1280, height: int = 800):
    from ros_vision_tpu_torch.apriltag.render import (render_scene,
                                                      simple_square_corners)
    img, _ = render_scene(
        [0, 42, 311, 100],
        [simple_square_corners(300, 250, 90),
         simple_square_corners(800, 400, 110, angle_deg=20),
         simple_square_corners(450, 600, 70, angle_deg=-35),
         simple_square_corners(1000, 600, 60, angle_deg=50)],
        width, height, noise_sigma=1.0)
    return img


def _log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _read_async(t: torch.Tensor):
    """Enqueue the D2H copy of `t` into pinned memory; returns a callable
    that waits for it and gives the host tensor."""
    if t.device.type != "cuda":
        return lambda: t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))

    def wait():
        ev.synchronize()
        return host
    return wait


def sweep(det, img, batches, iters: int, rec: Record) -> dict:
    """fps and ms per call at each batch size; the record's headline is
    the best point so far, and a complete line prints after B=8."""
    dev = det.device
    points = {}
    best = None
    for batch in batches:
        _log(f"sweep B={batch}")
        g = torch.from_numpy(np.broadcast_to(img, (batch,) + img.shape)
                             .copy()).to(dev)
        intr = torch.as_tensor(det.default_intrinsics(batch), device=dev)
        _read_async(det.detect_raw(g, intr)["ok"])().sum()    # warm
        t0 = time.perf_counter()
        reads = [_read_async(det.detect_raw(g, intr)["ok"])
                 for _ in range(iters)]
        for read in reads:
            read().sum()
        dt = (time.perf_counter() - t0) / iters
        fps = batch / dt
        points[batch] = {"fps": round(fps, 2),
                         "latency_ms": round(dt * 1e3, 2)}
        if best is None or fps > best[1]:
            best = (batch, fps, dt)
        rec.update(value=round(best[1], 2),
                   vs_baseline=round(best[1] / CAMERA_TARGET_FPS, 3),
                   best_batch=best[0],
                   best_batch_call_ms=round(best[2] * 1e3, 2),
                   sweep=points)
        _log(f"B={batch}: {fps:.2f} fps, {dt * 1e3:.2f} ms/call")
        if batch == 8:
            rec.emit()
    return points


def active_config(det) -> dict:
    """The port's resolved paths for the detector."""
    from ros_vision_tpu_torch.ops.frontend_kernel import frontend_route
    cfg = det.config
    route = frontend_route(cfg.height // 2, cfg.width // 2)
    return {
        "device": str(det.device),
        "threshold": "K1 adaptive_threshold_fused",
        "frontend": route,
        "ccl": "K6+K7 flood" if route == "flood" else "K2 rank_image",
        "boundary": "K3 boundary_compact",
        "pallas_sort": bool(det._qcfg.use_pallas_sort),
        "max_points": cfg.max_points,
        "active_points": det._active_points,
        "kernels": "cuda" if det.device.type == "cuda" else "plain (cpu)",
    }


def sync_roundtrip_ms(det, img, iters: int) -> float:
    """Median ms of B=1 calls each read back before the next starts."""
    g1 = torch.from_numpy(img[None].copy()).to(det.device)
    i1 = torch.as_tensor(det.default_intrinsics(1), device=det.device)
    det.detect_raw(g1, i1)["ok"].cpu().sum()
    lat = []
    for _ in range(iters):
        ts = time.perf_counter()
        det.detect_raw(g1, i1)["ok"].cpu().sum()
        lat.append(time.perf_counter() - ts)
    return round(float(np.percentile(lat, 50)) * 1e3, 2)


def stage_ms(det, img, reps: int) -> dict:
    """Host ms a call of each recorded span (utils/tracing.SPANS) over
    `reps` detect_raw calls at B=1 and B=4, after one warm-up call."""
    from ros_vision_tpu_torch.utils.tracing import RECORDER, span_ms
    out = {}
    for b in (1, 4):
        g = torch.from_numpy(np.broadcast_to(img, (b,) + img.shape).copy()) \
            .to(det.device)
        intr = torch.as_tensor(det.default_intrinsics(b), device=det.device)
        det.detect_raw(g, intr)
        since = time.time_ns()
        for _ in range(reps):
            det.detect_raw(g, intr)
        if det.device.type == "cuda":
            torch.cuda.synchronize(det.device)
        out[str(b)] = {k: round(v, 4) for k, v in
                       span_ms(RECORDER.calls(since)).items()}
        _log(f"stage ms B={b}: {out[str(b)]}")
    return out


def golden_1080p(dev, iters: int, rec: Record) -> None:
    """The reference's 1920x1080 golden photo through a 1080p detector:
    exactly tag 554 must decode (gpu_detector_test.cu:85-120)."""
    from ros_vision_tpu_torch.apriltag.detector import TorchDetector
    path = os.environ.get("BENCH_GOLDEN_PHOTO", "")
    if not path or not os.path.exists(path):
        rec.update(golden_1080p_skipped="photo absent (BENCH_GOLDEN_PHOTO "
                   "names the reference's colorimage.jpg)")
        return
    import cv2
    gray = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2GRAY)
    det = TorchDetector(device=dev, width=1920, height=1080, fx=905.495617,
                        fy=907.909470, cx=609.916016, cy=352.682645,
                        estimate_pose=True)
    found = det.detect(gray)
    g1 = torch.from_numpy(gray[None].copy()).to(dev)
    i1 = torch.as_tensor(det.default_intrinsics(1), device=dev)
    det.detect_raw(g1, i1)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        det.detect_raw(g1, i1)
    _sync(dev)
    rec.update(golden_1080p_ms_per_frame=round(
        (time.perf_counter() - t0) / iters * 1e3, 2),
        golden_1080p_tags_ok=[d.tag_id for d in found] == [554])


def streaming_bench(img, dev, duration_s: float) -> tuple:
    """Four concurrent 1280x800 camera streams through VisionSystem.spin
    end to end — capture thread -> frame ring -> H2D -> detector -> unpack
    -> NT4 publish to an in-process NT server — with the pipelined
    submit/unpack overlap under the adaptive pipeline depth. Each camera
    serves its own scene; mock cameras pace at the 100 fps camera target
    and feed 2-D gray frames. Returns (per-camera fps, capture->publish
    p50 ms, p95 ms, the spin loop's per-batch phase means)."""
    import csv
    import tempfile

    from ros_vision_tpu_torch.apriltag.render import (render_scene,
                                                      simple_square_corners)
    from ros_vision_tpu_torch.config.loader import ConfigLoader
    from ros_vision_tpu_torch.launch import VisionSystem
    from ros_vision_tpu_torch.runtime.camera import MockCamera
    from ros_vision_tpu_torch.runtime.nt4 import NT4TestServer

    nt_server = NT4TestServer()
    rot = [[0, 0, 1], [-1, 0, 0], [0, -1, 0]]
    cams = {f"mock{i}": {"location": loc, "format": "MJPG", "height": 800,
                         "width": 1280, "frame_rate": 100,
                         "api_preference": "ANY"}
            for i, loc in enumerate(["center_front", "left_front",
                                     "right_front", "back"])}
    cfg = {
        "camera_mounted_positions": cams,
        "extrinsics": {c["location"]: {"rotation": rot,
                                       "offset": [0.0, 0.0, 0.0]}
                       for c in cams.values()},
        "network_tables_config": {"table_address": "127.0.0.1",
                                  "table_name": "/SmartDashboard",
                                  "port": nt_server.port},
    }
    scenes = [img]
    for ids, specs in [
            ([7, 19], [(350, 300, 95, 10), (900, 450, 80, -25)]),
            ([63, 200, 471], [(260, 220, 100, 0), (760, 380, 70, 40),
                              (1050, 620, 85, -15)]),
            ([3], [(640, 400, 120, 30)])]:
        g, _ = render_scene(
            ids, [simple_square_corners(x, y, s, angle_deg=a)
                  for x, y, s, a in specs], 1280, 800, noise_sigma=1.0)
        scenes.append(g)

    def factory(ident, idx):
        frame = scenes[idx % len(scenes)]

        def frames(n):
            time.sleep(0.01)          # 100 fps camera pacing
            return frame
        return MockCamera(width=1280, height=800, frame_factory=frames)

    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = os.path.join(tmp, "system_config.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        csv_path = os.path.join(tmp, "timing.csv")
        ConfigLoader.set_config_file_path(cfg_path)
        try:
            system = VisionSystem(
                device=dev, measurement_mode=True, timing_csv_path=csv_path,
                enable_viewer=False, enable_nt=True,
                camera_map={k: i for i, k in enumerate(cams)},
                camera_factory=factory,
                detector_overrides=dict(fx=900.0, fy=900.0, cx=640.0,
                                        cy=400.0, estimate_pose=True))
            system.start()
            # warm: inline batches until one has detections
            deadline = time.time() + 600
            while time.time() < deadline:
                if any(r[0] for r in system.spin_once()):
                    break
            t = threading.Thread(target=system.spin, daemon=True)
            t0 = time.time()
            t.start()
            time.sleep(duration_s)
            system._running = False
            t.join(timeout=30)
            elapsed = time.time() - t0
            system.stop()
            with open(csv_path) as f:
                rows = list(csv.DictReader(f))
        finally:
            ConfigLoader.set_config_file_path(None)
            ConfigLoader.reload_config()
            nt_server.close()
    # steady state: skip the first quarter of rows, scale the batch rate
    # to the matching 3/4 of the run
    rows = rows[len(rows) // 4:]
    lat_us = [float(r["latency_us"]) for r in rows]
    lat_ms = np.percentile(lat_us, [50, 95]) / 1e3 if lat_us else [0, 0]
    fps = (len(rows) / len(cams)) / (elapsed * 0.75)
    phases = dict(system.spin_stats or {})
    n = max(1, phases.get("batches", 1))
    for k in ("pull_ms", "upload_ms", "submit_ms", "consume_ms"):
        if k in phases:          # totals -> per-batch means
            phases[k] = round(phases[k] / n, 2)
    phases["publish_dropped"] = system.node.publish_dropped
    phases["publish_count"] = system.node.publish_count
    return (round(fps, 2), round(float(lat_ms[0]), 1),
            round(float(lat_ms[1]), 1), phases)


def measure(dev, rec: Record) -> None:
    """Every phase in order, each writing its keys into `rec`."""
    from ros_vision_tpu_torch.apriltag.detector import TorchDetector

    batches = [int(x) for x in
               os.environ.get("BENCH_BATCHES", "1,4,8,16").split(",")]
    iters = int(os.environ.get("BENCH_ITERS", "30"))
    img = bench_scene()
    det = TorchDetector(device=dev, width=1280, height=800, fx=900.0,
                        fy=900.0, cx=640.0, cy=400.0, estimate_pose=True)
    rec.update(active_config=active_config(det))

    # correctness gate: all 4 tags must decode; the outcome goes into the
    # record rather than stopping the bench
    ids = sorted(d.tag_id for d in det.detect(img))
    rec.update(tags_ok=ids == BENCH_IDS)
    if ids != BENCH_IDS:
        _log(f"WARNING: detection regression: {ids}")

    points = sweep(det, img, batches, iters, rec)
    # the latency operating point is B=1 (one camera frame end to end)
    if 1 in points:
        rec.update(p50_latency_ms=points[1]["latency_ms"],
                   b1_sync_roundtrip_ms=sync_roundtrip_ms(det, img, iters))
    rec.update(stage_ms=stage_ms(det, img, reps=max(1, iters // 6)))
    golden_1080p(dev, iters, rec)

    if os.environ.get("BENCH_STREAMING", "1") == "0":
        rec.update(streaming_skipped="BENCH_STREAMING=0")
        return
    duration = float(os.environ.get("BENCH_STREAM_S", "12"))
    result = []
    th = threading.Thread(
        target=lambda: result.append(streaming_bench(img, dev, duration)),
        daemon=True)
    th.start()
    th.join(timeout=float(os.environ.get("BENCH_STREAM_TIMEOUT_S", "900")))
    if not result:
        raise RuntimeError("streaming phase did not finish" if th.is_alive()
                           else "streaming phase failed")
    sfps, p50, p95, phases = result[0]
    rec.update(streaming_cameras=4, streaming_fps_per_camera=sfps,
               e2e_p50_ms=p50, e2e_p95_ms=p95, streaming_phases=phases,
               e2e_note="capture->publish in one process on one host: "
                        "mock cameras, the detector's device, an "
                        "in-process NT4 server")


def main(argv=None) -> int:
    from ros_vision_tpu_torch.device import require_cuda
    ap = argparse.ArgumentParser(
        description="Headline AprilTag benchmark of the PyTorch port")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda is the first card (raises without one); cpu "
                         "only when asked for")
    args = ap.parse_args(argv)
    dev = require_cuda() if args.device == "cuda" else torch.device("cpu")
    rec = Record(metric=METRIC, value=0.0, unit="fps", vs_baseline=0.0,
                 backend=f"torch-{dev.type}", device=card_info(dev),
                 golden_1080p_skipped=None, streaming_skipped=None)

    def on_term(signum, frame):
        rec.emit(bench_error="terminated by SIGTERM; partial record")
        os._exit(128 + signum)

    signal.signal(signal.SIGTERM, on_term)
    failed = []

    def run():
        try:
            measure(dev, rec)
        except Exception as e:  # reported in the record, then exit 1
            import traceback
            traceback.print_exc()
            failed.append(f"{type(e).__name__}: {e}")

    # the measurement runs in a worker so that the main thread stays free
    # for SIGTERM and the global watchdog
    th = threading.Thread(target=run, daemon=True, name="bench")
    th.start()
    th.join(timeout=float(os.environ.get("BENCH_TOTAL_TIMEOUT_S", "5400")))
    if th.is_alive():
        rec.emit(bench_error="global timeout; partial record")
        os._exit(3)
    if failed:
        rec.emit(bench_error=failed[0] + "; partial record")
        return 1
    rec.emit()
    return 0


if __name__ == "__main__":
    sys.exit(main())
