#!/usr/bin/env python3
"""The port's camera-batch mesh (ros_vision_tpu_torch/parallel/mesh.py)
against the unsharded detector, on every visible card.

    python3 scripts/mb_torch_mesh.py [--reps N]

On the 1280x800 bench batch of chip_smoke.py (four noise seeds, tiled
to B = 4 and 8), times detect_raw_packed on cuda:0 alone and
shard_detector_packed over [cuda:0, cuda:0] and over the first 2 and 4
cards where present, in turns, each the median of --reps calls on the
host clock with a synchronize of every card; checks each mesh's
detections against the unsharded call's (the ok mask in every slot,
every output in the accepted slots, bit for bit). Prints one JSON line
per batch and the cards' names and power limits; exits nonzero without a
card or if a mesh's detections differ.
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

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    import chip_smoke as cs
    from ros_vision_tpu_torch.apriltag.detector import TorchDetector
    from ros_vision_tpu_torch.device import require_cuda
    from ros_vision_tpu_torch.parallel import mesh as pm

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    dev = require_cuda()
    n_dev = torch.cuda.device_count()
    bench4 = np.stack([cs.bench_scene(seed)[0] for seed in range(4)])
    det = TorchDetector(device=dev, **cs.detector_kw(cs.W, cs.H))
    meshes = {"[0,0]": [dev, dev]}
    for n in (2, 4):
        if n_dev >= n:
            meshes[f"{n} cards"] = [require_cuda(i) for i in range(n)]
    fns = {"unsharded": det.detect_raw_packed}
    for name, mesh in meshes.items():
        fns[name] = pm.shard_detector_packed(det, mesh)

    def sync():
        for i in range(n_dev):
            torch.cuda.synchronize(i)

    for b in (4, 8):
        frames = np.concatenate([bench4] * (b // 4))
        g = torch.from_numpy(frames).to(dev)
        intr = torch.as_tensor(det.default_intrinsics(b), device=dev)
        want = cs.unpack_torch(det.detect_raw_packed(g, intr))
        ok = want["ok"]
        for name, fn in fns.items():
            got = cs.unpack_torch(fn(g, intr))              # warm-up
            cs.check_same_bits(f"{name} B={b} ok", got["ok"], ok)
            for k in want:
                cs.check_same_bits(f"{name} B={b} {k}", got[k][ok],
                                   want[k][ok])
        sync()
        times = {name: [] for name in fns}
        for _ in range(args.reps):
            for name, fn in fns.items():
                t0 = time.perf_counter()
                fn(g, intr)
                sync()
                times[name].append((time.perf_counter() - t0) * 1e3)
        print(json.dumps({"batch": b, "cards": n_dev, "ms_per_call": {
            k: statistics.median(v) for k, v in times.items()},
            "runs_ms": times}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
