#!/usr/bin/env python3
"""Where K9's time goes: ros_vision_tpu_torch/csrc/sort.cu timed with each
kind of stride level switched off, on one CUDA card.

    python3 scripts/mb_torch_sort_levels.py

Builds csrc/sort.cu as it stands, with -DRVT_SORT_SKIP_LEVELS (its
device variable g_skip_levels then skips the register (1), warp-shuffle
(2), shared-memory (4) or cluster (8) levels), into
build/mb_torch_sort_levels/ together with a C harness that sorts
(4, 131072) int32 rows of 1, 2 and 3 planes (every plane a key, random
values below 2^22) on ops/sort_kernel.py sort_plan's launch plan and
times 20 back-to-back launches between CUDA events after 3 warm-up
launches. A level kind's cost is the full time less the
time without it; "load/store" is the time with every level skipped (the
planes' HBM read and write, the moves between registers and shared memory
and the barriers). The skipped runs give wrong orders: they time, they do
not sort. Prints one JSON line per plane count and the card's name and
power limit; exits nonzero without nvcc or a card.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "ros_vision_tpu_torch" / "csrc" / "sort.cu"
OUT = ROOT / "build" / "mb_torch_sort_levels"
VARIANTS = {"full": 0, "no_register": 1, "no_shuffle": 2,
            "no_shared": 4, "no_cluster": 8, "none": 15}

HARNESS = r"""
#include "@SORT_CU@"
#include <cstdio>
#include <vector>
int main() {
  const int b = 4, k = 131072;
  int *in[3], *out[3];
  std::vector<int> h(b * k);
  for (int q = 0; q < 3; ++q) {
    cudaMalloc(&in[q], sizeof(int) * b * k);
    cudaMalloc(&out[q], sizeof(int) * b * k);
    unsigned x = 12345 + q;
    for (auto& e : h) { x = x * 1664525u + 1013904223u; e = (x >> 8) & 0x3fffff; }
    cudaMemcpy(in[q], h.data(), sizeof(int) * b * k, cudaMemcpyHostToDevice);
  }
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int masks[] = {@MASKS@};
  int launches;
  for (int nops = 1; nops <= 3; ++nops) {
    printf("%d", nops);
    for (int mask : masks) {
      cudaMemcpyToSymbol(g_skip_levels, &mask, sizeof(int));
      const int smem = @SMEM_PER_PLANE@ * nops;
      auto run = [&]() {
        return rvt_sort(in[0], in[1], in[2], nullptr, nullptr, nullptr,
                        out[0], out[1], out[2], &launches, b, k, k, nops,
                        nops, @TILE@, @CLUSTER@, @THREADS@, smem, 0, 0);
      };
      for (int i = 0; i < 3; ++i)
        if (run() != 0) return 1;
      cudaDeviceSynchronize();
      cudaEventRecord(e0);
      for (int i = 0; i < 20; ++i) run();
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms;
      cudaEventElapsedTime(&ms, e0, e1);
      printf(" %.6f", ms / 20);
    }
    printf("\n");
    if (cudaGetLastError() != cudaSuccess) return 1;
  }
  return 0;
}
"""


def harness_source() -> str:
    """The harness, including csrc/sort.cu, on sort_plan's plan for
    (4, 131072) rows (its shared bytes are per plane times the planes)."""
    sys.path.insert(0, str(ROOT))
    from ros_vision_tpu_torch.ops.sort_kernel import sort_plan
    plan = sort_plan(131072, 1)
    if plan.launches != 1:
        raise RuntimeError(f"sort_plan(131072) is {plan}, not one launch")
    fill = {"@SORT_CU@": str(SRC), "@SMEM_PER_PLANE@": str(plan.smem_bytes),
            "@TILE@": str(plan.tile), "@CLUSTER@": str(plan.cluster),
            "@THREADS@": str(plan.threads),
            "@MASKS@": ", ".join(str(m) for m in VARIANTS.values())}
    s = HARNESS
    for key, value in fill.items():
        s = s.replace(key, value)
    return s


def main() -> int:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        print("mb_torch_sort_levels: nvcc not found", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "sort_levels.cu"
    exe = OUT / "sort_levels"
    src.write_text(harness_source())
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-DRVT_SORT_SKIP_LEVELS", "-o",
                    str(exe), str(src)], check=True)
    run = subprocess.run([str(exe)], capture_output=True, text=True)
    if run.returncode != 0:
        print(f"mb_torch_sort_levels: harness failed\n{run.stdout}"
              f"{run.stderr}", file=sys.stderr)
        return 1
    for line in run.stdout.split("\n"):
        if not line.strip():
            continue
        nops, *times = line.split()
        t = dict(zip(VARIANTS, map(float, times)))
        cost = {k: t["full"] - t[f"no_{k}"]
                for k in ("register", "shuffle", "shared", "cluster")}
        print(json.dumps({"rows": "(4, 131072)", "planes": int(nops),
                          "full_ms": t["full"], "load_store_ms": t["none"],
                          **{f"{k}_ms": v for k, v in cost.items()}}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
