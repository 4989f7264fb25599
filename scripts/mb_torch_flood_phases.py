#!/usr/bin/env python3
"""Where the device time of K7 label_histogram and K8 propagate goes,
launch by launch, and how many global atomics K7 makes, on one CUDA card.

    python3 scripts/mb_torch_flood_phases.py [ROOT ...]

Each ROOT (default `.`) is the top of a checkout that holds
ros_vision_tpu_torch/, for instance an older commit unpacked with `git
archive` under build/. First this checkout captures the inputs on the
card that scripts/mb_torch_kernel_versions.py flood_inputs makes: K7's
(4, 518400) labels at 960x540 (the decimated 1920x1080 frame; bench,
clutter and random labels) and K8's 640x400 planes (the decimated
1280x800 frame, B=4; bench and spiral), swept from the flat pixel indices
448 times (the hybrid CCL's first round). Then
each ROOT, in the order given, runs in a process of its own that imports
that root's package and, for each input:

- checks the kernel bit-exact against the root's plain version;
- runs the calls under torch.profiler and reports each device operation
  (kernel or memset, by name) with its device time and launches per
  call, and the whole call's device and call time from
  chip_smoke.both_ms;
- where the root's csrc/flood.cu has the RVT_HIST_COUNT_ATOMICS build
  flag, builds the kernels again with it (a library of its own under
  build/) and reports K7's global atomics per call, the most on one
  address and the addresses hit;
- where it has RVT_FLOOD_PHASE_CLOCKS, builds them again with that and
  reports the cycles per block and launch in each phase -- K7: its
  chunks, the wait at the grid barrier, the far runs; K8: the load of the
  region, the sweeps, the write-back -- and
  the span of the call from its first block's start to its last block's
  end on the global timer. Neither counting build's kernel time is
  reported: their own atomics perturb it.

Prints one JSON line per root, kernel and input, then the card's name and
power limit; exits nonzero without a card or if a kernel disagrees.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
INPUTS = ROOT / "build" / "mb_torch_flood_phases" / "inputs.pt"
COUNT_FLAG = "RVT_HIST_COUNT_ATOMICS"
CLOCK_FLAG = "RVT_FLOOD_PHASE_CLOCKS"
SWEEPS = 448


def load(name: str, path: Path):
    """A module of this checkout loaded from its file, so that
    ros_vision_tpu_torch still resolves to the root under test."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def timing_helpers():
    return load("chip_smoke", ROOT / "chip_smoke.py")


def capture() -> None:
    """Save K7's labels and K8's planes, as mb_torch_kernel_versions.py
    captures them."""
    sys.path.insert(0, str(ROOT))
    from ros_vision_tpu_torch.device import require_cuda
    import torch
    versions = load("mb_torch_kernel_versions",
                    ROOT / "scripts" / "mb_torch_kernel_versions.py")
    saved = versions.flood_inputs(timing_helpers(), require_cuda())
    INPUTS.parent.mkdir(parents=True, exist_ok=True)
    torch.save(saved, INPUTS)


def calls_of(kernel: str, x, dev):
    """(kernel call, plain call) of `kernel` on the saved input x."""
    import torch
    from ros_vision_tpu_torch.ops import ccl
    from ros_vision_tpu_torch.ops import ccl_kernel as ck
    x = x.to(dev)
    if kernel == "label_histogram":
        return (lambda: (ck.label_histogram(x),),
                lambda: (ccl.label_histogram(x),))
    b, h, w = x.shape
    lab = torch.arange(h * w, dtype=torch.int32, device=dev)
    lab = lab.view(1, h, w).expand(b, h, w).contiguous()
    return (lambda: (ck.propagate(x, lab, SWEEPS),),
            lambda: (ccl.propagate(x, lab, SWEEPS),))


def time_root(root: Path) -> None:
    """Check and time root's K7 and K8 on the saved inputs, one device
    operation at a time."""
    sys.path.insert(0, str(root))
    import torch
    import ros_vision_tpu_torch
    cs = timing_helpers()
    phases = load("mb_torch_ccl_phases",
                  ROOT / "scripts" / "mb_torch_ccl_phases.py")
    cs.check(Path(ros_vision_tpu_torch.__file__).resolve().is_relative_to(
        root.resolve()), f"ros_vision_tpu_torch imported from "
        f"{ros_vision_tpu_torch.__file__}, not from {root}")
    dev = torch.device("cuda", 0)
    for kernel, inputs in torch.load(INPUTS).items():
        for at, x in inputs.items():
            run, plain = calls_of(kernel, x, dev)
            cs.max_abs_err(f"{root} {kernel} {at}", run(), plain())
            ops = phases.profile_ops(run)
            cs.check(ops, f"{root} {kernel} {at}: the profiler recorded no "
                     "device operation")
            print(json.dumps(dict(
                root=str(root), kernel=kernel, at=at, ops=ops,
                ops_ms=sum(o["ms"] for o in ops.values()),
                launches=sum(o["launches"] for o in ops.values()),
                **cs.both_ms(lambda: run()))), flush=True)


def atomics_root(root: Path) -> None:
    """K7's global atomics per call from a build of root's kernels with
    -DRVT_HIST_COUNT_ATOMICS."""
    sys.path.insert(0, str(root))
    import torch
    from ros_vision_tpu_torch import _build
    _build.LIBRARY = _build.KernelLibrary(
        flags=_build.NVCC_FLAGS + (f"-D{COUNT_FLAG}",))
    _build._FUNCS.clear()
    read = _build.LIBRARY.get().rvt_label_histogram_atomics
    read.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * 3)()
    dev = torch.device("cuda", 0)
    for at, x in torch.load(INPUTS)["label_histogram"].items():
        run, _ = calls_of("label_histogram", x, dev)
        torch.cuda.synchronize()
        read(ctypes.addressof(buf))                      # zero the counts
        run()
        torch.cuda.synchronize()
        if read(ctypes.addressof(buf)) != 0:
            raise RuntimeError("reading the atomic counts failed")
        total, most, addresses = list(buf)
        print(json.dumps(dict(
            root=str(root), kernel="label_histogram", at=at,
            global_atomics=total, most_on_one_address=most,
            addresses=addresses, labels=x.numel())), flush=True)


def clocks_root(root: Path) -> None:
    """Cycles per block by phase of root's K7 and K8 from a build with
    -DRVT_FLOOD_PHASE_CLOCKS."""
    sys.path.insert(0, str(root))
    import torch
    from ros_vision_tpu_torch import _build
    _build.LIBRARY = _build.KernelLibrary(
        flags=_build.NVCC_FLAGS + (f"-D{CLOCK_FLAG}",))
    _build._FUNCS.clear()
    read = _build.LIBRARY.get().rvt_flood_clocks
    read.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * 12)()
    dev = torch.device("cuda", 0)
    phases = {"label_histogram": (0, ("chunks", "barrier_wait",
                                      "far_runs")),
              "propagate": (1, ("load", "sweeps", "write_back"))}
    for kernel, inputs in torch.load(INPUTS).items():
        at_set, names = phases[kernel]
        for at, x in inputs.items():
            run, _ = calls_of(kernel, x, dev)
            run()
            torch.cuda.synchronize()
            read(ctypes.addressof(buf))                  # zero the clocks
            run()
            torch.cuda.synchronize()
            if read(ctypes.addressof(buf)) != 0:
                raise RuntimeError("reading the clocks failed")
            sums = list(buf)[6 * at_set:6 * at_set + 6]
            blocks = sums[3]
            print(json.dumps(dict(
                root=str(root), kernel=kernel, at=at, block_launches=blocks,
                cycles_per_block={k: v / blocks
                                  for k, v in zip(names, sums[:3])},
                span_ms=(sums[5] - sums[4]) / 1e6)), flush=True)


def main(argv: list[str]) -> int:
    if argv[:1] == ["--capture"]:
        capture()
        return 0
    modes = {"--time": time_root, "--atomics": atomics_root,
             "--clocks": clocks_root}
    if argv[:1] and argv[0] in modes:
        modes[argv[0]](Path(argv[1]))
        return 0
    me = [sys.executable, str(Path(__file__).resolve())]
    subprocess.run(me + ["--capture"], check=True)
    for root in argv or ["."]:
        todo = ["--time"]
        src = Path(root) / "ros_vision_tpu_torch" / "csrc" / "flood.cu"
        text = src.read_text()
        todo += [m for m, flag in (("--atomics", COUNT_FLAG),
                                    ("--clocks", CLOCK_FLAG))
                  if flag in text]
        for mode in todo:
            run = subprocess.run(me + [mode, root], capture_output=True,
                                 text=True)
            sys.stdout.write(run.stdout)
            if run.returncode != 0:
                sys.stderr.write(run.stderr)
                return run.returncode
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
