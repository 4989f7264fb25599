#!/usr/bin/env python3
"""Launches, device time and host time of one TorchDetector call, and their
split over the call's stages.

    python3 scripts/mb_torch_detector_profile.py [--root DIR] [--label NAME]
        [--reps N] [--sizes 1280x800,1920x1080] [--batches 1,4]
        [--dist none|lens] [--device cuda]

Imports ros_vision_tpu_torch from --root (default: this checkout; give an
unpacked copy of another commit to compare two trees on one card, calling
the script for each in turn). On chip_smoke.py's bench scenes (1280x800,
noise 1; the layout x1.5 at 1920x1080, noise 0.75), at each batch, it
measures detect_raw_packed of a detector with fx = fy = 900 centred on the
frame. With --dist lens the scenes' tags are rendered through
chip_smoke.py's lens (lens_for the frame size, LENS_DIST) and the detector
is calibrated with that lens, so refine_edges fits in undistorted
coordinates: the calibrated camera's call.

- call_ms: the median of --reps calls on the host clock, each ended by a
  synchronize;
- launches and device_ms a call: the device operations (kernels, copies,
  memsets) torch.profiler records over 3 calls;
- per stage: the same call with each stage's function wrapped in a
  record_function range ended by a synchronize, timed over 5 calls and
  profiled over 3 more (threshold = K1,
  frontend = K2 or the flood CCL + K3, quadfit = cluster_and_fit,
  decode = both decode_quads calls (screen and tail), refine =
  refine_edges, pose = estimate_poses, other = the rest: tier choice,
  gathers, duplicate reconcile, packing). A stage's host_ms is its range
  on the host clock (unprofiled), its launches and device_ms the device
  operations that start inside it; the stages add up to the wrapped
  call.

Prints one JSON line per size and batch, then the card's name and power
limit. Checks the bench ids in every row at the default sizes; exits
nonzero without a card (unless --device cpu) or on a wrong detection.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
STAGES = ("threshold", "frontend", "quadfit", "refine", "decode", "pose")


def load_chip_smoke():
    """This checkout's chip_smoke.py (its scenes), whatever --root is."""
    spec = importlib.util.spec_from_file_location("chip_smoke_scenes",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_ops(prof):
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith("stage:")]


def op_us(e) -> float:
    return e.time_range.end - e.time_range.start


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--sizes", default="1280x800,1920x1080")
    ap.add_argument("--batches", default="1,4")
    ap.add_argument("--dist", choices=("none", "lens"), default="none")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    import ros_vision_tpu_torch
    from ros_vision_tpu_torch.apriltag import detector as det_mod
    from ros_vision_tpu_torch.device import require_cuda
    from ros_vision_tpu_torch.ops import decode, pose, quadfit
    assert Path(ros_vision_tpu_torch.__file__).resolve().is_relative_to(root)
    cs = load_chip_smoke()

    dev = require_cuda() if args.device == "cuda" else \
        torch.device(args.device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    activities = [ProfilerActivity.CPU] + \
        ([ProfilerActivity.CUDA] if cuda else [])
    targets = {"threshold": (det_mod, "adaptive_threshold_fused"),
               "frontend": (det_mod, "frontend"),
               "quadfit": (quadfit, "cluster_and_fit"),
               "refine": (decode, "refine_edges"),
               "decode": (decode, "decode_quads"),
               "pose": (pose, "estimate_poses")}
    originals = {k: getattr(m, n) for k, (m, n) in targets.items()}
    stage_ms = {k: 0.0 for k in STAGES}

    def wrapped(name, fn):
        def run(*a, **kw):
            sync()
            t0 = time.perf_counter()
            with record_function("stage:" + name):
                out = fn(*a, **kw)
                sync()
            stage_ms[name] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    def set_wrapped(on: bool):
        for k, (m, n) in targets.items():
            setattr(m, n, wrapped(k, originals[k]) if on else originals[k])

    batches = [int(b) for b in args.batches.split(",")]
    for size in args.sizes.split(","):
        w, h = (int(v) for v in size.split("x"))
        default = (w, h) in ((cs.W, cs.H), (cs.W2, cs.H2))
        noise = cs.NOISE_1080 if (w, h) == (cs.W2, cs.H2) else 1.0
        if args.dist == "lens":
            frames, _ = cs.lens_frames(cs.bench_scene(0, w, h, noise)[1], w,
                                       h, max(batches), noise)
            lens = dict(**cs.lens_for(w, h), dist=cs.LENS_DIST)
        else:
            frames = np.stack([cs.bench_scene(seed, w, h, noise)[0]
                               for seed in range(max(batches))])
            lens = dict(fx=900.0, fy=900.0, cx=w / 2, cy=h / 2)
        det = det_mod.TorchDetector(device=dev, width=w, height=h,
                                    estimate_pose=True, **lens)
        for b in batches:
            g = torch.from_numpy(np.ascontiguousarray(frames[:b])).to(dev)
            intr = torch.as_tensor(det.default_intrinsics(b), device=dev)

            def call():
                return det.detect_raw_packed(g, intr)

            for _ in range(2):
                out = call()
            sync()
            if default:
                for i, dets in enumerate(det.unpack(out)):
                    ids = sorted(d.tag_id for d in dets)
                    if ids != sorted(cs.BENCH_IDS):
                        print(f"FAIL {size} B={b} row {i}: ids {ids}")
                        return 1
            times = []
            syncs0 = det.host_syncs.count
            for _ in range(args.reps):
                t0 = time.perf_counter()
                call()
                sync()
                times.append((time.perf_counter() - t0) * 1e3)
            host_syncs = (det.host_syncs.count - syncs0) / args.reps
            n_prof = 3
            with profile(activities=activities) as prof:
                for _ in range(n_prof):
                    call()
                sync()
            ops = device_ops(prof)
            # the same call, each stage in a range ended by a synchronize
            # (host times unprofiled, device operations profiled)
            set_wrapped(True)
            try:
                call()
                sync()
                for k in stage_ms:
                    stage_ms[k] = 0.0
                n_wrapped = 5
                t0 = time.perf_counter()
                for _ in range(n_wrapped):
                    call()
                    sync()
                wrapped_ms = (time.perf_counter() - t0) * 1e3 / n_wrapped
                host_stage_ms = {k: v / n_wrapped
                                 for k, v in stage_ms.items()}
                with profile(activities=activities) as sprof:
                    for _ in range(n_prof):
                        call()
                    sync()
            finally:
                set_wrapped(False)
            ranges = [(e.time_range.start, e.time_range.end, e.name[6:])
                      for e in sprof.events()
                      if e.name.startswith("stage:")
                      and e.device_type == DeviceType.CPU]
            stages = {k: {"host_ms": host_stage_ms.get(k, 0.0),
                          "launches": 0.0, "device_ms": 0.0}
                      for k in STAGES + ("other",)}
            for e in device_ops(sprof):
                name = next((n for s, t, n in ranges
                             if s <= e.time_range.start <= t), "other")
                stages[name]["launches"] += 1 / n_prof
                stages[name]["device_ms"] += op_us(e) / 1e3 / n_prof
            stages["other"]["host_ms"] = wrapped_ms - sum(
                host_stage_ms.values())
            rec = {"label": args.label, "root": str(root), "size": size,
                   "B": b, "dist": args.dist,
                   "call_ms": statistics.median(times),
                   "call_ms_all": times,
                   "launches": len(ops) / n_prof,
                   "device_ms": sum(op_us(e) for e in ops) / 1e3 / n_prof,
                   "host_syncs": host_syncs,
                   "wrapped_call_ms": wrapped_ms, "stages": stages}
            rec["device_busy_share"] = rec["device_ms"] / rec["call_ms"]
            print(json.dumps(rec), flush=True)
    if cuda:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        print(card.stdout.strip().splitlines()[0] if card.returncode == 0
              else "nvidia-smi: not available")
    return 0


if __name__ == "__main__":
    sys.exit(main())
