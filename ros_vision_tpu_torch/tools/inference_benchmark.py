#!/usr/bin/env python
"""Game-piece inference benchmark CLI.

The port of ros_vision_tpu/tools/inference_benchmark.py, on the port's
ModelInference. Parity with the reference's inference_benchmark tool
(inference_benchmark.cpp:124-...; output format documented in
src/game_piece_detection/README.md:171-198): configurable warmup +
iterations, per-phase stats (inference / postprocess / total) with
mean/std/min/max/median/P95/P99 and FPS, optional CSV output. The model
is the YOLOv11 forward + on-device NMS (models/infer.py) on --device
(cuda by default), bf16 there and f32 on the CPU.

    python -m ros_vision_tpu_torch.tools.inference_benchmark --batch 4
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np


def pct(v, p):
    return float(np.percentile(np.asarray(v), p))


def stats_block(name, times_ms):
    t = sorted(times_ms)
    return {
        "name": name,
        "mean": statistics.fmean(t),
        "std": statistics.pstdev(t),
        "min": t[0],
        "max": t[-1],
        "median": pct(t, 50),
        "p95": pct(t, 95),
        "p99": pct(t, 99),
    }


def print_block(s):
    print(f"{s['name']} time statistics (ms):")
    print(f"  Mean:   {s['mean']:.3f}")
    print(f"  Std:    {s['std']:.3f}")
    print(f"  Min:    {s['min']:.3f}")
    print(f"  Max:    {s['max']:.3f}")
    print(f"  Median: {s['median']:.3f}")
    print(f"  P95:    {s['p95']:.3f}")
    print(f"  P99:    {s['p99']:.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--params", help="weights file (.npz); random init if "
                                     "omitted")
    ap.add_argument("--num-classes", type=int, default=1)
    ap.add_argument("--scale", default="n", choices=["n", "s", "m"])
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--warmup", type=int, default=50)
    ap.add_argument("--iterations", type=int, default=1000)
    ap.add_argument("--image", help="benchmark image (else random input)")
    ap.add_argument("--csv", help="write per-iteration CSV")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda: the first card; cpu runs f32)")
    ap.add_argument("--streaming", action="store_true",
                    help="queued-execution throughput (per-call sync off): "
                         "the deployment pattern for a continuous camera "
                         "stream; per-iteration latency stats are not "
                         "reported in this mode")
    args = ap.parse_args(argv)

    import torch
    from ros_vision_tpu_torch.device import require_cuda
    from ros_vision_tpu_torch.models.infer import ModelInference

    device = require_cuda() if args.device == "cuda" \
        else torch.device(args.device)
    m = ModelInference(num_classes=args.num_classes, scale=args.scale,
                       img_size=args.img_size, params_path=args.params,
                       device=device,
                       dtype=torch.bfloat16 if device.type == "cuda"
                       else torch.float32)
    if args.image:
        import cv2
        inp = m.preprocess(cv2.imread(args.image))
        inp = np.broadcast_to(inp, (args.batch,) + inp.shape[1:]).copy()
    else:
        inp = np.random.default_rng(0).uniform(
            0, 1, (args.batch, args.img_size, args.img_size, 3)
        ).astype(np.float32)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    dev_inp = torch.from_numpy(inp).to(device)

    for _ in range(args.warmup):
        out = m.infer(dev_inp)
    sync()
    _ = out["valid"].sum().item()

    if args.streaming:
        t0 = time.perf_counter()
        outs = [m.infer(dev_inp) for _ in range(args.iterations)]
        sync()
        _ = outs[-1]["valid"].sum().item()
        _ = outs[0]["valid"].sum().item()
        dt = (time.perf_counter() - t0) / args.iterations
        fps = args.batch / dt
        print(f"Streaming throughput: batch {args.batch}, "
              f"{dt * 1e3:.2f} ms/batch, {dt * 1e3 / args.batch:.3f} "
              f"ms/image -> {fps:.2f} FPS")
        return fps

    infer_ms, post_ms, total_ms = [], [], []
    for _ in range(args.iterations):
        t0 = time.perf_counter()
        out = m.infer(dev_inp)            # forward + on-device NMS
        sync()
        t1 = time.perf_counter()
        valid = out["valid"].cpu().numpy()  # device->host of the result
        n = int(valid.sum())
        t2 = time.perf_counter()
        infer_ms.append((t1 - t0) * 1e3)
        post_ms.append((t2 - t1) * 1e3)
        total_ms.append((t2 - t0) * 1e3)

    s_inf = stats_block("Inference", infer_ms)
    s_post = stats_block("Postprocess", post_ms)
    s_tot = stats_block("Total", total_ms)
    print(f"Benchmark: {args.iterations} iterations, "
          f"warmup {args.warmup}, input {args.img_size}x{args.img_size}, "
          f"scale {args.scale}, device {device}, {n} detections")
    print_block(s_inf)
    print_block(s_post)
    print_block(s_tot)
    fps = 1000.0 / s_tot["mean"]
    print(f"Throughput: {fps:.2f} FPS")

    if args.csv:
        with open(args.csv, "w") as f:
            f.write("iteration,inference_ms,postprocess_ms,total_ms\n")
            for i, (a, b, c) in enumerate(zip(infer_ms, post_ms, total_ms)):
                f.write(f"{i},{a:.4f},{b:.4f},{c:.4f}\n")
        print(f"CSV written to {args.csv}")
    return fps


if __name__ == "__main__":
    main()
