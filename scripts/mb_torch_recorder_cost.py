#!/usr/bin/env python3
"""The host cost of the span recorder (utils/tracing.RECORDER) on a
benchmark cell's detector calls, with the recorder on against off in turns.

    python3 scripts/mb_torch_recorder_cost.py [--cells A,B] [--pairs N]
        [--null] [--seed N] [--device cuda]

For each cell of BENCHMARK.json named (default: both detector cells) it
builds the cell's detector and frames (its scene generator at --seed, as
benchmark/drivers/detector.py does), warms it, then makes --pairs pairs of
detect_raw_packed calls back to back, one with RECORDER.enabled and one
without, the order within a pair alternating, each call timed on the host
clock (no synchronize: the calls are host-bound, and their own reads wait
for the card). With --null both sides run with the recorder off: what the
pairing reads where there is no difference. Prints per cell the median
and mean host ms of each side, the mean of the pairs' differences (on -
off) and its standard error, and the recorder's bookkeeping timed alone
on this host: a Span, a Call and a counted `.item()` on and off, and from
them the cost of a call's 8 spans and its synchronising operations. Then
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
CELLS = "tag800-pipelined-4cam,tag1080-pipelined-4cam"


def per_op_ns(fn, n: int = 100_000) -> float:
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    return (time.perf_counter_ns() - t0) / n


def bookkeeping(tracing, HostSyncs, torch) -> dict:
    """ns an operation of the recorder's pieces, on minus off: a Span, a
    Call, a counted `.item()`; and from them a call's 7 spans, its record
    and 31 counted operations, in ms."""
    rec = tracing.RECORDER
    x = torch.tensor(1)
    s = HostSyncs()

    def span():
        with tracing.Span("quadfit"):
            pass

    def call():
        with tracing.Call(s):
            pass

    def syncs():
        for _ in range(31):
            s.item(x)
    out = {}
    for name, fn, n in (("span", span, 1), ("call", call, 1),
                        ("sync", syncs, 31)):
        rec.enabled = False
        off = per_op_ns(fn, 100_000 // n)
        rec.enabled = True
        on = per_op_ns(fn, 100_000 // n)
        out[f"{name}_ns"] = (on - off) / n
    out["call_estimate_ms"] = (7 * out["span_ns"] + out["call_ns"]
                               + 31 * out["sync_ns"]) / 1e6
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default=CELLS)
    ap.add_argument("--pairs", type=int, default=1000)
    ap.add_argument("--null", action="store_true")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 9)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch
    from benchmark.harness import cell as cellmod
    from ros_vision_tpu_torch.device import HostSyncs
    from ros_vision_tpu_torch.utils import tracing
    dev = torch.device(args.device)
    rec = tracing.RECORDER
    for name in args.cells.split(","):
        cell = cellmod.find_cell(name, REPO)
        scenes = cellmod.load_module("scenes",
                                     cell.traffic["scene"]["generator"], REPO)
        pool = scenes.make(args.seed, cell.config, cell.traffic["scene"])
        driver = cellmod.load_module("drivers", cell.traffic["driver"], REPO)
        det = driver.detector_for(cell.config, dev)
        b = int(cell.traffic["batch"])
        g = torch.from_numpy(np.stack(pool.frames[:b])).to(dev)
        intr = torch.as_tensor(det.default_intrinsics(b), device=dev)
        for _ in range(10):
            det.detect_raw_packed(g, intr)
        ms = {True: [], False: []}
        diffs = []
        for i in range(args.pairs):
            t = {}
            for on in ((True, False) if i % 2 == 0 else (False, True)):
                rec.enabled = on and not args.null
                t0 = time.perf_counter()
                det.detect_raw_packed(g, intr)
                t[on] = (time.perf_counter() - t0) * 1e3
                ms[on].append(t[on])
            diffs.append(t[True] - t[False])
        rec.enabled = True
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        print(json.dumps({
            "cell": name, "pairs": args.pairs, "null": args.null,
            "on_ms_median": statistics.median(ms[True]),
            "off_ms_median": statistics.median(ms[False]),
            "on_ms_mean": statistics.fmean(ms[True]),
            "off_ms_mean": statistics.fmean(ms[False]),
            "diff_ms_mean": statistics.fmean(diffs),
            "diff_ms_stderr": statistics.stdev(diffs) / len(diffs) ** 0.5,
            "diff_ms_median": statistics.median(diffs)}), flush=True)
    print(json.dumps({"bookkeeping": bookkeeping(tracing, HostSyncs,
                                                 torch)}))
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        print(card.stdout.strip().splitlines()[0] if card.returncode == 0
              else "nvidia-smi: not available")
    return 0


if __name__ == "__main__":
    sys.exit(main())
