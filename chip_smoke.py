#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ros_vision_tpu_torch) on one card.

    python3 chip_smoke.py

Needs one CUDA card; without one it exits nonzero and prints no result.
Phases, each of which raises (and so exits nonzero) on failure:
  1. build the four kernels (csrc/*.cu, nvcc, sm_90a) from the checkout;
  2. kernel checks: each kernel against its plain PyTorch version on the
     card, at the 1280x800 tag36h11 path's shapes (the 4-tag bench scene
     at B=4 with four noise seeds, plus one cluttered frame that
     overflows both boundary caps), bit-exact, with the median of 20 CUDA
     event timings of each;
  3. detector: TorchDetector at B=1 and B=4 on the bench scene — ids
     [0, 42, 100, 311] in every row, corners within 0.1 px of the same
     detector's plain path on the CPU and within 1 px of the rendered
     corners, every kernel's launch counter raised;
  4. system: the port's VisionSystem with 4 mock cameras at 1280x800, each
     showing its own tags, spun for >= 20 batches; each camera publishes
     its own ids with finite robot-frame poses.
The line before the last is a JSON object of per-kernel results; the last
line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
BENCH_IDS = [0, 42, 100, 311]
W, H = 1280, 800
REPS = 20


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def bench_scene(seed: int):
    """The bench.py scene (4 tags at 1280x800, noise sigma 1)."""
    from ros_vision_tpu.apriltag.render import (render_scene,
                                                simple_square_corners)
    return render_scene(
        [0, 42, 311, 100],
        [simple_square_corners(300, 250, 90),
         simple_square_corners(800, 400, 110, angle_deg=20),
         simple_square_corners(450, 600, 70, angle_deg=-35),
         simple_square_corners(1000, 600, 60, angle_deg=50)],
        W, H, noise_sigma=1.0, seed=seed)


def clutter_frame(seed: int = 7) -> np.ndarray:
    """A 12x12-px black/white checkerboard with 10% of its blocks flipped:
    thousands of 4-connected black blobs above the 25-px minimum and
    boundary everywhere, so the 2048-blob rank space and both boundary
    caps overflow."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H // 12 + 1, :W // 12 + 1]
    blocks = ((yy + xx) % 2) ^ (rng.random(yy.shape) < 0.1)
    img = np.kron(blocks * 200 + 20, np.ones((12, 12)))[:H, :W]
    return (img + rng.normal(0, 2.0, img.shape)).clip(0, 255).astype(np.uint8)


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median device time of fn() over `reps` runs (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs_err(name: str, got, want) -> float:
    """Max abs difference of each output from its plain version; raises
    unless every output is bit-exact (same shape and dtype, zero
    difference)."""
    import torch
    err = 0.0
    for g, w in zip(got, want, strict=True):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{name}: {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} "
              f"{w.dtype}")
        d = (g.to(torch.int64) - w.to(torch.int64)).abs().max().item()
        check(d == 0 and torch.equal(g, w),
              f"{name} differs from its plain version (max abs err {d})")
        err = max(err, float(d))
    return err


def kernel_phase(dev, bench4, clutter):
    import torch
    from ros_vision_tpu_torch.ops import frontend_kernel as fk
    from ros_vision_tpu_torch.ops import gather_kernel as gk
    from ros_vision_tpu_torch.ops import quadfit as qf
    from ros_vision_tpu_torch.ops import segments as segs
    from ros_vision_tpu_torch.ops import ccl
    from ros_vision_tpu_torch.ops import threshold_kernel as tk

    results = []
    g4 = torch.from_numpy(bench4).to(dev)
    gc = torch.from_numpy(clutter[None]).to(dev)
    k_cap = 32768                          # auto max_points at 1280x800
    p_cap = qf.QuadFitConfig(max_points=k_cap).max_boundary_pixels

    def record(name, src, replaces, err, kernel, plain):
        results.append(dict(
            name=name, route="cuda", source=f"ros_vision_tpu_torch/csrc/{src}",
            replaces=replaces, max_abs_err=err, ms=cuda_ms(kernel),
            plain_ms=cuda_ms(plain)))

    # K1
    err = max(max_abs_err("adaptive_threshold", tk.adaptive_threshold_fused(g),
                          tk.adaptive_threshold_plain(g)) for g in (g4, gc))
    record("adaptive_threshold", "threshold.cu",
           "ros_vision_tpu/ops/threshold_pallas.py:122", err,
           lambda: tk.adaptive_threshold_fused(g4),
           lambda: tk.adaptive_threshold_plain(g4))
    _, t4 = tk.adaptive_threshold_plain(g4)
    _, tc = tk.adaptive_threshold_plain(gc)

    # K2 (labels, sizes and ranks; the clutter frame overflows the ranks)
    err = max(max_abs_err("rank_image", fk.label_components(t),
                          ccl.label_components(t)) for t in (t4, tc))
    nblobs = int(ccl.label_components(tc)[2].max().item())
    print(f"  clutter frame: max rank {nblobs} (rank space 2048)")
    record("rank_image", "ccl.cu",
           "ros_vision_tpu/ops/frontend_pallas.py:505", err,
           lambda: fk.rank_image(t4), lambda: ccl.label_components(t4))
    r4 = ccl.label_components(t4)[2].view(t4.shape)
    rc = ccl.label_components(tc)[2].view(tc.shape)

    # K3 (the bench scene and the clutter frame overflow the caps)
    err = 0.0
    for t, r in ((t4, r4), (tc, rc)):
        key, pack2, counts = fk.boundary_compact(t, r, p_cap, k_cap)
        pts, cref = qf.boundary_points_capped(
            t, r.reshape(r.shape[0], -1), p_cap, k_cap)
        err = max(err, max_abs_err("boundary_compact", (key, pack2, counts),
                                   (pts["key"], pts["pack2"], cref)))
        maskbits, _ = qf.boundary_masks(t, r)
        emitting = ((maskbits & 0xF) != 0).sum(dim=(1, 2)).tolist()
        print(f"  boundary: emitting px {emitting} (stage-A cap "
              f"{qf.boundary_block_rows(p_cap, t.shape[2]) * t.shape[2]}),"
              f" points {counts.tolist()} (cap {k_cap})")
    record("boundary_compact", "boundary.cu",
           "ros_vision_tpu/ops/frontend_pallas.py:749", err,
           lambda: fk.boundary_compact(t4, r4, p_cap, k_cap),
           lambda: qf.boundary_points_capped(t4, r4.reshape(4, -1), p_cap,
                                             k_cap))

    # K4: the segment ids cluster_and_fit feeds it, at the narrow (8192)
    # and full (32768) widths, plus out-of-range values
    key, pack2, _ = fk.boundary_compact(t4, r4, p_cap, k_cap)
    key_s, _ = qf._sort2(key, pack2)
    seg = segs.segment_ids_from_sorted_keys(
        key_s, valid=key_s < qf.KEY_INVALID, max_segments=1024)
    rng = np.random.default_rng(3)
    odd = torch.from_numpy(rng.integers(-5, 1100, (4, 8192),
                                        dtype=np.int32)).to(dev)
    seg_n = seg[:, :8192].contiguous()
    err = max(max_abs_err("value_histogram", (gk.histogram(v, 1025),),
                          (gk.value_histogram_plain(v, 1025),))
              for v in (seg_n, seg, odd))
    record("value_histogram", "histogram.cu",
           "ros_vision_tpu/ops/gather_pallas.py:168", err,
           lambda: gk.histogram(seg_n, 1025),
           lambda: gk.value_histogram_plain(seg_n, 1025))
    for r in results:
        print(f"  {r['name']}: max abs err {r['max_abs_err']} (bit-exact); "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms (B=4, "
              f"median of {REPS})")
    return results


def match_corners(dets, placed_list, tol: float, what: str) -> float:
    """Max distance from each detected corner to the nearest rendered
    corner of the same tag."""
    worst = 0.0
    placed = {p.tag_id: p.corners for p in placed_list}
    for d in dets:
        ref = placed[d.tag_id]
        dist = np.linalg.norm(d.corners[:, None, :] - ref[None], axis=-1)
        worst = max(worst, float(dist.min(axis=1).max()))
    check(worst < tol, f"{what}: corner error {worst:.4f} px >= {tol}")
    return worst


def detector_phase(dev, bench4, placed):
    import torch
    from ros_vision_tpu_torch import _build
    from ros_vision_tpu_torch.apriltag.detector import TorchDetector

    kw = dict(width=W, height=H, fx=900.0, fy=900.0, cx=640.0, cy=400.0,
              estimate_pose=True)
    det = TorchDetector(device=dev, **kw)
    cpu = TorchDetector(device="cpu", **kw)
    det.detect(bench4)                                    # warm-up
    torch.cuda.synchronize()
    _build.reset_counts()
    out = {}
    for b in (1, 4):
        frames = bench4[:b]
        s0 = det.host_syncs.count
        rows = det.detect(frames)
        syncs = det.host_syncs.count - s0
        rows_cpu = cpu.detect(frames)
        for i, (dets, dets_cpu) in enumerate(zip(rows, rows_cpu)):
            ids = [d.tag_id for d in dets]
            check(ids == BENCH_IDS, f"B={b} row {i}: ids {ids}")
            check([d.tag_id for d in dets_cpu] == ids,
                  f"B={b} row {i}: CPU plain path ids differ")
            dc = max(float(np.abs(x.corners - y.corners).max())
                     for x, y in zip(dets, dets_cpu))
            dp = max(float(np.abs(x.pose_t - y.pose_t).max())
                     for x, y in zip(dets, dets_cpu))
            check(dc < 0.1, f"B={b} row {i}: {dc:.4f} px from CPU plain")
            dr = match_corners(dets, placed, 1.0, f"B={b} row {i}")
            print(f"  B={b} row {i}: ids {ids}; corners vs CPU plain "
                  f"{dc:.5f} px, vs rendered {dr:.4f} px; pose_t vs CPU "
                  f"{dp * 1e3:.4f} mm")
        g = torch.from_numpy(np.ascontiguousarray(frames)).to(dev)
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            det.detect_raw_packed(g)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        out[b] = dict(ms_per_frame=ms / b, host_syncs_per_call=syncs)
        print(f"  B={b}: {ms / b:.3f} ms/frame ({ms:.3f} ms/call, median of "
              f"{REPS}, host clock incl. sync), {syncs} host syncs/call")
    counts = _build.counts()
    print(f"  launches in the detector phase: {counts}")
    check(all(c > 0 for c in counts.values()) and len(counts) == 4,
          f"a kernel was not launched: {counts}")
    return out


class RecordingSender:
    """Stands in for the NT4 AprilTagDataSender: records each publish."""

    def __init__(self):
        self.values = []
        self.lock = threading.Lock()

    def send_value(self, flat):
        with self.lock:
            self.values.append((time.time(), list(flat)))

    def send_protobuf(self, data):
        pass


def system_phase(dev, min_batches: int = 20):
    import torch
    from ros_vision_tpu.apriltag.render import (render_scene,
                                                simple_square_corners)
    from ros_vision_tpu.config.loader import ConfigLoader
    from ros_vision_tpu.runtime.camera import MockCamera
    from ros_vision_tpu_torch import _build
    from ros_vision_tpu_torch.launch import VisionSystem

    scenes_ids = {"mock0": [0, 42], "mock1": [100, 311], "mock2": [7, 23],
                  "mock3": [55, 210, 400]}
    layouts = [(300, 250, 90, 0), (800, 400, 110, 20), (450, 600, 70, -35)]
    scenes = {}
    for ident, ids in scenes_ids.items():
        scenes[ident] = render_scene(
            ids, [simple_square_corners(x, y, s, a)
                  for x, y, s, a in layouts[:len(ids)]],
            W, H, noise_sigma=1.0, seed=len(scenes))[0]
    locs = ["center_front", "left_front", "right_front", "back"]
    rot = [[0, 0, 1], [-1, 0, 0], [0, -1, 0]]
    cfg = {"camera_mounted_positions": {
               ident: {"location": loc, "format": "MJPG", "height": H,
                       "width": W, "frame_rate": 100,
                       "api_preference": "ANY"}
               for ident, loc in zip(scenes_ids, locs)},
           "extrinsics": {loc: {"rotation": rot, "offset": [0.0, 0.0, 0.0]}
                          for loc in locs}}
    cfg_dir = ROOT / "build" / "chip_smoke"
    cfg_dir.mkdir(parents=True, exist_ok=True)
    cfg_path = cfg_dir / "system_config.json"
    cfg_path.write_text(json.dumps(cfg))
    ConfigLoader.set_config_file_path(str(cfg_path))

    def factory(ident, idx):
        frame = scenes[ident]

        def read(n):
            time.sleep(0.01)                 # a 100 fps camera
            return frame
        return MockCamera(width=W, height=H, frame_factory=read)

    senders = {loc: RecordingSender() for loc in locs}
    system = VisionSystem(
        device=dev, enable_viewer=False, enable_nt=False,
        camera_map={ident: i for i, ident in enumerate(scenes_ids)},
        camera_factory=factory, tag_sender=senders,
        detector_overrides=dict(fx=900.0, fy=900.0, cx=640.0, cy=400.0))
    try:
        # warm-up batches outside the measured run
        system.start()
        for _ in range(3):
            system.spin_once()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        for s in senders.values():
            s.values.clear()
        _build.reset_counts()
        spinner = threading.Thread(target=system.spin, name="spin")
        t0 = time.monotonic()
        spinner.start()
        deadline = t0 + 300
        while time.monotonic() < deadline and (
                system.spin_stats is None
                or system.spin_stats["batches"] < min_batches):
            time.sleep(0.05)
        batches = system.spin_stats["batches"] if system.spin_stats else 0
        elapsed = time.monotonic() - t0
    finally:
        system._running = False
        if "spinner" in locals():
            spinner.join(timeout=60)
        system.stop()
        ConfigLoader.set_config_file_path(None)
        ConfigLoader.reload_config()
    counts = _build.counts()
    check(batches >= min_batches, f"only {batches} batches spun")
    print(f"  launches in the system phase: {counts}")
    check(all(c > 0 for c in counts.values()) and len(counts) == 4,
          f"a kernel was not launched in the system run: {counts}")
    lat = []
    for ident, loc in zip(scenes_ids, locs):
        vals = senders[loc].values
        full = 0
        for t_recv, flat in vals:
            rows = np.asarray(flat, np.float64).reshape(-1, 5)
            ids = sorted(int(v) for v in rows[:, 1])
            check(set(ids) <= set(scenes_ids[ident]),
                  f"{ident}: published foreign ids {ids}")
            check(np.isfinite(rows).all(), f"{ident}: non-finite pose")
            if ids == sorted(scenes_ids[ident]):
                full += 1
                lat.append((t_recv - rows[0, 0]) * 1e3)
        check(full >= min_batches // 2,
              f"{ident}: its ids {scenes_ids[ident]} published in only "
              f"{full} of {len(vals)} batches")
        print(f"  {ident} ({loc}): ids {scenes_ids[ident]} in {full} of "
              f"{len(vals)} publishes")
    fps = batches / elapsed
    p50 = statistics.median(lat)
    print(f"  {batches} batches in {elapsed:.2f} s: {fps:.2f} fps per "
          f"camera, capture->publish p50 {p50:.1f} ms, spin stats "
          f"{system.spin_stats}")
    return counts, dict(fps_per_camera=fps, p50_latency_ms=p50)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    from ros_vision_tpu_torch import _build
    from ros_vision_tpu_torch.device import require_cuda

    dev = require_cuda()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi)

    t0 = time.monotonic()
    _build.LIBRARY.get()
    built = _build.LIBRARY.build_seconds
    print(f"[build] kernels ready in {time.monotonic() - t0:.2f} s "
          f"(nvcc {'%.2f s' % built if built is not None else 'cached'})")
    for line in _build.LIBRARY.build_log.splitlines():
        if "Used" in line or "spill" in line:
            print("  " + line.strip())

    bench = [bench_scene(seed) for seed in range(4)]
    bench4 = np.stack([img for img, _ in bench])
    placed = bench[0][1]
    clutter = clutter_frame()

    print("[kernels]")
    kernels = kernel_phase(dev, bench4, clutter)
    print("[detector]")
    det = detector_phase(dev, bench4, placed)
    print("[system]")
    launches, system = system_phase(dev)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"detector": {str(b): v for b, v in det.items()},
                      "system": system}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
