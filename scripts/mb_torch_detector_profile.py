#!/usr/bin/env python3
"""Launches, device time and host time of one TorchDetector call, and their
split over the spans the port records (utils/tracing.RECORDER).

    python3 scripts/mb_torch_detector_profile.py [--root DIR] [--label NAME]
        [--reps N] [--sizes 1280x800,1920x1080] [--batches 1,4]
        [--dist none|lens] [--cell NAME --seed N] [--device cuda]

Imports ros_vision_tpu_torch from --root (default: this checkout; give an
unpacked copy of another commit to compare two trees on one card, calling
the script for each in turn). On chip_smoke.py's bench scenes (1280x800,
noise 1; the layout x1.5 at 1920x1080, noise 0.75), at each batch, it
measures detect_raw_packed of a detector with fx = fy = 900 centred on the
frame. With --dist lens the scenes' tags are rendered through
chip_smoke.py's lens (lens_for the frame size, LENS_DIST) and the detector
is calibrated with that lens, so refine_edges fits in undistorted
coordinates: the calibrated camera's call. With --cell the frames and the
detector are a benchmark cell's (BENCHMARK.json; its scene generator at
--seed, its configuration; --sizes and --dist are then unused).

- call_ms: the median of --reps calls on the host clock, each ended by a
  synchronize;
- launches and device_ms a call: the device operations (kernels, copies,
  memsets) torch.profiler records over --prof calls made back to back,
  with no synchronize between them (device and runtime activity only);
- per span: host_ms, the span's own host time a call (less the spans
  nested in it) over --prof calls made back to back unprofiled, and over
  the profiled calls launches, device_ms and idle_ms a call: the device
  operations whose runtime call was made while the span was the innermost
  one open, and the gaps in the device's busy union whose middle falls
  there (the profiler's own host time included), each on the clock the
  spans and the profiler share (time.time_ns). `detector` is the rest of
  the call (threshold, front end, tier choice, reconcile, pose, packing),
  `quadfit` the part of cluster_and_fit outside its three parts (before
  the sort, and its return), "outside" the time between calls. No
  synchronize ends a span.

A --root tree without the recorder prints the call-level numbers only.
Prints one JSON line per size and batch, then the card's name and power
limit. Checks the bench ids in every row at the default sizes; exits
nonzero without a card (unless --device cpu) or on a wrong detection.
"""
from __future__ import annotations

import argparse
import bisect
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def load_chip_smoke():
    """This checkout's chip_smoke.py (its scenes), whatever --root is."""
    spec = importlib.util.spec_from_file_location("chip_smoke_scenes",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_frames(name: str, seed: int, device):
    """A benchmark cell's detector (as its driver builds it) and its
    scene generator's frames at `seed`."""
    sys.path.insert(0, str(REPO))
    from benchmark.harness import cell as cellmod
    cell = cellmod.find_cell(name, REPO)
    scenes = cellmod.load_module("scenes", cell.traffic["scene"]["generator"],
                                 REPO)
    pool = scenes.make(seed, cell.config, cell.traffic["scene"])
    driver = cellmod.load_module("drivers", cell.traffic["driver"], REPO)
    return driver.detector_for(cell.config, device), np.stack(pool.frames)


def parse_events(events):
    """Device operations [(start, end, start of their runtime call or
    None)] from kineto events, epoch ns."""
    from torch.autograd import DeviceType
    dev, runtime = [], {}
    for e in events:
        s = e.start_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((s, s + e.duration_ns(), e.correlation_id()))
        elif e.name().startswith("cu"):
            runtime[e.correlation_id()] = s
    return [(s, end, runtime.get(c)) for s, end, c in dev]


class Innermost:
    """The innermost recorded span open at a time: spans of one call
    nest, so of the open spans the one that started last."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s[0] for s in self.spans]

    def at(self, t, skip=None) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        for s, e, name in reversed(self.spans[:i + 1]):
            if e >= t and (s, e, name) != skip:
                return name
        return "outside"


def _spans(calls) -> list:
    return [(t0, t1, name) for c in calls
            for name, ivs in c["spans"].items() for t0, t1 in ivs]


def split(host_calls, calls, ops, w0: int, w1: int, n: int) -> dict:
    """Per span: own host ms a call over `host_calls`; launches, device ms
    and idle ms a call over the n profiled `calls` in [w0, w1]."""
    out = {}

    def row(name):
        return out.setdefault(name, {"host_ms": 0.0, "launches": 0.0,
                                     "device_ms": 0.0, "idle_ms": 0.0})
    # own host time: a span's length, less it in the span it nests in
    spans = _spans(host_calls)
    where = Innermost(spans)
    for sp in spans:
        ms = (sp[1] - sp[0]) / 1e6 / len(host_calls)
        row(sp[2])["host_ms"] += ms
        parent = where.at(sp[0], skip=sp)
        if parent != "outside":
            row(parent)["host_ms"] -= ms
    where = Innermost(_spans(calls))
    for s, e, t in ops:
        r = row(where.at(t) if t is not None else "unattributed")
        r["launches"] += 1 / n
        r["device_ms"] += (e - s) / 1e6 / n
    union = []
    for s, e in sorted((max(s, w0), min(e, w1)) for s, e, _ in ops
                       if e > w0 and s < w1):
        if union and s <= union[-1][1]:
            union[-1][1] = max(union[-1][1], e)
        else:
            union.append([s, e])
    edges = [w0] + [x for s, e in union for x in (s, e)] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 > g0:
            row(where.at((g0 + g1) // 2))["idle_ms"] += (g1 - g0) / 1e6 / n
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--prof", type=int, default=10)
    ap.add_argument("--sizes", default="1280x800,1920x1080")
    ap.add_argument("--batches", default="1,4")
    ap.add_argument("--dist", choices=("none", "lens"), default="none")
    ap.add_argument("--cell", default="")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 7)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch
    from torch.profiler import ProfilerActivity, profile

    import ros_vision_tpu_torch
    from ros_vision_tpu_torch.apriltag import detector as det_mod
    from ros_vision_tpu_torch.device import require_cuda
    from ros_vision_tpu_torch.utils import tracing
    assert Path(ros_vision_tpu_torch.__file__).resolve().is_relative_to(root)
    recorder = getattr(tracing, "RECORDER", None)
    cs = load_chip_smoke()

    dev = require_cuda() if args.device == "cuda" else \
        torch.device(args.device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    activities = [ProfilerActivity.CUDA] if cuda else \
        [ProfilerActivity.CPU]
    batches = [int(b) for b in args.batches.split(",")]
    setups = []
    if args.cell:
        det, frames = cell_frames(args.cell, args.seed, dev)
        setups.append((args.cell, False, det, frames))
    for size in ([] if args.cell else args.sizes.split(",")):
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
        setups.append((size, default, det, frames))
    for size, default, det, frames in setups:
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
            n = args.prof
            since = time.time_ns()
            for _ in range(n):
                call()
            sync()
            until = time.time_ns()
            with profile(activities=activities) as prof:
                w0 = time.time_ns()
                for _ in range(n):
                    call()
                sync()
                w1 = time.time_ns()
            ops = parse_events(prof.profiler.kineto_results.events())
            rec = {"label": args.label, "root": str(root), "size": size,
                   "B": b, "dist": args.dist,
                   "call_ms": statistics.median(times),
                   "call_ms_all": times,
                   "launches": len(ops) / n,
                   "device_ms": sum(e - s for s, e, _ in ops) / 1e6 / n,
                   "host_syncs": host_syncs,
                   "profiled_ms": (w1 - w0) / 1e6 / n}
            rec["device_busy_share"] = rec["device_ms"] / rec["call_ms"]
            if recorder is not None:
                unprofiled = [c for c in recorder.calls(since)
                              if c["t1_ns"] <= until]
                calls = [c for c in recorder.calls(w0) if c["t1_ns"] <= w1]
                rec["syncs_recorded"] = sum(c["syncs"] for c in unprofiled) \
                    / len(unprofiled)
                rec["sync_wait_ms"] = sum(c["sync_ns"] for c in unprofiled) \
                    / 1e6 / len(unprofiled)
                rec["spans"] = split(unprofiled, calls, ops, w0, w1, n)
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
