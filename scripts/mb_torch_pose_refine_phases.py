#!/usr/bin/env python3
"""Where the device time of P1 estimate_poses and P2 refine_edges goes, on
one CUDA card, from timing builds of the kernels.

    python3 scripts/mb_torch_pose_refine_phases.py [ROOT ...]

Each ROOT (default `.`) is the top of a checkout that holds
ros_vision_tpu_torch/. First this checkout captures P1's and P2's inputs
(scripts/mb_torch_kernel_versions.py pose_inputs and refine_inputs:
chip_smoke.py's pose cases and the refine inputs at the path's tiers)
into build/mb_torch_pose_refine_phases/inputs.pt. Then each ROOT whose
csrc/pose.cu has -DRVT_POSE_PHASE_CLOCKS and whose csrc/refine.cu has
-DRVT_REFINE_PHASE_CLOCKS runs in a process of its own that builds the
kernels again with both flags (a library of its own under build/) and,
for each input after one warm call, reports from one call: P1's cycles a
slot in each phase of its lane form (pose.cu says which), P2's cycles a
block in each phase (refine.cu says which), the span of the call from its
first block's start to its last block's end on the global timer, P2's
spread of block starts (the last start after the first) and the most
blocks that ran on one SM. That build's kernel time is not reported: its clocks
perturb it. Prints one JSON line per root and input, then the card's
name, power limit and SM clock; exits nonzero without a card.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
INPUTS = ROOT / "build" / "mb_torch_pose_refine_phases" / "inputs.pt"
POSE_PHASES = ("corners_translation", "projections_polar_input",
               "polar_start", "newton_steps", "sign", "rest")
REFINE_PHASES = ("terms", "warp_trees_sync", "block_tree_fit",
                 "grid_sync", "corners")


def versions():
    sys.path.insert(0, str(ROOT / "scripts"))
    import mb_torch_kernel_versions
    return mb_torch_kernel_versions


def capture() -> None:
    sys.path.insert(0, str(ROOT))
    import torch
    from ros_vision_tpu_torch.device import require_cuda
    mv = versions()
    cs = mv.timing_helpers()
    dev = require_cuda()
    saved = {"pose": mv.pose_inputs(cs, dev),
             "refine": mv.refine_inputs(cs, dev)}
    INPUTS.parent.mkdir(parents=True, exist_ok=True)
    torch.save(saved, INPUTS)


def read_clocks(fn, n: int) -> list:
    buf = (ctypes.c_ulonglong * n)()
    if fn(ctypes.addressof(buf)) != 0:
        raise RuntimeError("reading the clocks failed")
    return list(buf)


def clocks_root(root: Path) -> None:
    sys.path.insert(0, str(root))
    import torch
    from ros_vision_tpu_torch import _build
    _build.LIBRARY = _build.KernelLibrary(
        flags=_build.NVCC_FLAGS + ("-DRVT_POSE_PHASE_CLOCKS",
                                   "-DRVT_REFINE_PHASE_CLOCKS"))
    _build._FUNCS.clear()
    lib = _build.LIBRARY.get()
    pose_read, refine_read = lib.rvt_pose_clocks, lib.rvt_refine_clocks
    pose_read.argtypes = refine_read.argtypes = [ctypes.c_void_p]
    mv = versions()
    dev = torch.device("cuda", 0)
    saved = torch.load(INPUTS)
    for at, (h, tag_size, intr) in saved["pose"].items():
        run = mv.pose_call((h.to(dev), tag_size,
                            [v.to(dev) for v in intr]))[0]
        run()
        torch.cuda.synchronize()
        read_clocks(pose_read, 9)
        run()
        torch.cuda.synchronize()
        c = read_clocks(pose_read, 9)
        slots = c[6]
        print(json.dumps(dict(
            root=str(root), kernel="estimate_poses", at=at, slots_run=slots,
            cycles_per_slot={k: v / max(slots, 1)
                             for k, v in zip(POSE_PHASES, c)},
            span_ms=(c[8] - c[7]) / 1e6)), flush=True)
    for at, xs in saved["refine"].items():
        xs = [x.to(dev) if isinstance(x, torch.Tensor) else x for x in xs]
        run = mv.refine_call(xs)[0]
        run()
        torch.cuda.synchronize()
        n = len(REFINE_PHASES)
        read_clocks(refine_read, n + 5)
        run()
        torch.cuda.synchronize()
        c = read_clocks(refine_read, n + 5)
        blocks = c[n]
        print(json.dumps(dict(
            root=str(root), kernel="refine_edges", at=at,
            block_launches=blocks,
            cycles_per_block={k: v / max(blocks, 1)
                              for k, v in zip(REFINE_PHASES, c)},
            span_ms=(c[n + 2] - c[n + 1]) / 1e6,
            start_spread_ms=(c[n + 3] - c[n + 1]) / 1e6,
            most_blocks_on_one_sm=c[n + 4])), flush=True)


def main(argv: list[str]) -> int:
    if argv[:1] == ["--capture"]:
        capture()
        return 0
    if argv[:1] == ["--clocks"]:
        clocks_root(Path(argv[1]))
        return 0
    me = [sys.executable, str(Path(__file__).resolve())]
    subprocess.run(me + ["--capture"], check=True)
    for root in argv or ["."]:
        csrc = Path(root) / "ros_vision_tpu_torch" / "csrc"
        if "RVT_POSE_PHASE_CLOCKS" not in (csrc / "pose.cu").read_text() or \
                "RVT_REFINE_PHASE_CLOCKS" not in (
                    csrc / "refine.cu").read_text():
            print(f"{root}: no timing build of P1 and P2", file=sys.stderr)
            continue
        run = subprocess.run(me + ["--clocks", root], capture_output=True,
                             text=True)
        sys.stdout.write(run.stdout)
        if run.returncode != 0:
            sys.stderr.write(run.stderr)
            return run.returncode
    print(subprocess.run(["nvidia-smi",
                          "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
