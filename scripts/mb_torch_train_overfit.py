#!/usr/bin/env python3
"""The trajectory of chip_smoke.py's overfit run: models/train.train on
one repeated batch, several runs from the same seeded weights.

    python3 scripts/mb_torch_train_overfit.py [--steps N] [--runs N]
        [--every N] [--deterministic] [--device cuda]

Each run loads a fresh bf16 YOLOv11n engine (one class, 640) from
chip_smoke.seeded_game_piece_weights, trains it for --steps steps on
chip_smoke.train_batch(TRAIN_B) at chip_smoke's learning rate, and prints
loss, box loss, class loss and mean IoU every --every steps and at the
last. The runs differ only by the card's non-deterministic kernels (cuDNN's
backward convolutions); --deterministic sets
torch.backends.cudnn.deterministic for every run, so they repeat bit for
bit. Ends with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--every", type=int, default=10)
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch
    import chip_smoke as cs
    from ros_vision_tpu_torch.models import train as tr
    from ros_vision_tpu_torch.models.infer import ModelInference

    dev = torch.device(args.device)

    def engine(path=None):
        return ModelInference(num_classes=1, scale="n", img_size=cs.GP_SIZE,
                              class_names=["ball"], params_path=path,
                              dtype=torch.bfloat16, device=dev)

    npz = str(cs.seeded_game_piece_weights(engine()))
    batch = cs.train_batch(cs.TRAIN_B)

    def repeated():
        while True:
            yield batch

    torch.backends.cudnn.deterministic = args.deterministic
    for run in range(args.runs):
        t0 = time.perf_counter()
        hist = tr.train(engine(npz), repeated(), steps=args.steps,
                        cfg=tr.TrainConfig(learning_rate=cs.TRAIN_LR),
                        log_every=args.every)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        print(f"run {run} (deterministic={args.deterministic}, "
              f"{time.perf_counter() - t0:.2f} s)", flush=True)
        steps = list(range(0, args.steps, args.every))
        if steps[-1] != args.steps - 1:
            steps.append(args.steps - 1)
        for step, h in zip(steps, hist):
            print(f"  step {step:4d} loss {h['loss']:.4f} box "
                  f"{h['box_loss']:.4f} cls {h['cls_loss']:.4f} mean IoU "
                  f"{h['mean_iou']:.4f}", flush=True)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
