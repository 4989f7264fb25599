#!/usr/bin/env python3
"""The driver the per-kernel phases scripts share: where a kernel's device
time goes, launch by launch, on one CUDA card, for several checkouts in
turn. A script is one Entry (its inputs, its calls, its clock build) and
calls main(ENTRY, argv); scripts/mb_torch_gather_phases.py is one.

    python3 scripts/mb_torch_<name>_phases.py [ROOT ...]

Each ROOT (default `.`) is the top of a checkout that holds
ros_vision_tpu_torch/, for instance an older commit unpacked with `git
archive` under build/. First this checkout captures the entry's inputs on
the card into build/<name>/inputs.pt, once for every ROOT. Then each
ROOT, in the order given, runs in a process of its own that imports that
root's package and, for each input:

- checks the kernel bit-exact against the root's plain version;
- runs the calls under torch.profiler and reports each device operation
  (kernel or memset, by name) with its device time and launches per
  call, and the whole call's device and call time from
  chip_smoke.both_ms.

Where the entry asks for it, the same process times the launch floor the
same two ways: a torch.cuda._sleep(0), one launch of a kernel that does
nothing. Where the root's csrc/<entry.source> has the entry's clock flag,
a further process builds the kernels again with it (a library of its own
under build/) and reports, for each input of the entry's clocked kernels,
the cycles per block in each of the entry's phases and the span of the
call from its first block's start to its last block's end on the global
timer: the clock export returns the phases' sums, the blocks, the first
start and the last end (ns). That build's kernel time is not reported:
its clocks perturb it. Prints one JSON line per root and input (and one
for the floor), then the card's name and power limit; exits nonzero
without a card or if a kernel disagrees.
"""
from __future__ import annotations

import ctypes
import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from typing import Callable

ROOT = Path(__file__).resolve().parent.parent


@dataclasses.dataclass(frozen=True)
class Entry:
    """One phases script."""
    name: str           # build/<name>/inputs.pt
    # (mb_torch_kernel_versions module, chip_smoke module, device) ->
    # {at: (kernel, [tensor, ...])}, saved on the CPU
    inputs: Callable
    # (mb_torch_kernel_versions module, kernel, [tensor on the card]) ->
    # (call, its outputs, the plain version's outputs)
    calls: Callable
    source: str         # the csrc file that holds clock_flag
    clock_flag: str
    clock_export: str   # int (unsigned long long* out) of the clock build
    phases: tuple[str, ...]
    clocked: tuple[str, ...]   # the kernels the clock build times
    floor: bool = False        # also time torch.cuda._sleep(0)


def load(name: str, path: Path):
    """A module of this checkout loaded from its file, so that
    ros_vision_tpu_torch still resolves to the root under test."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def versions():
    return load("mb_torch_kernel_versions",
                ROOT / "scripts" / "mb_torch_kernel_versions.py")


def timing_helpers():
    return load("chip_smoke", ROOT / "chip_smoke.py")


def inputs_path(entry: Entry) -> Path:
    return ROOT / "build" / entry.name / "inputs.pt"


def capture(entry: Entry) -> None:
    """Save the entry's inputs, made with this checkout's package."""
    sys.path.insert(0, str(ROOT))
    import torch
    from ros_vision_tpu_torch.device import require_cuda
    saved = entry.inputs(versions(), timing_helpers(), require_cuda())
    inputs_path(entry).parent.mkdir(parents=True, exist_ok=True)
    torch.save(saved, inputs_path(entry))


def time_root(entry: Entry, root: Path) -> None:
    """Check and time root's kernels on the saved inputs, one device
    operation at a time, and the launch floor where the entry asks."""
    sys.path.insert(0, str(root))
    import torch
    import ros_vision_tpu_torch
    cs = timing_helpers()
    ccl = load("mb_torch_ccl_phases",
               ROOT / "scripts" / "mb_torch_ccl_phases.py")
    cs.check(Path(ros_vision_tpu_torch.__file__).resolve().is_relative_to(
        root.resolve()), f"ros_vision_tpu_torch imported from "
        f"{ros_vision_tpu_torch.__file__}, not from {root}")
    dev = torch.device("cuda", 0)
    if entry.floor:
        floor = lambda: torch.cuda._sleep(0)   # noqa: E731
        print(json.dumps(dict(root=str(root), kernel="launch floor",
                              at="torch.cuda._sleep(0)",
                              ops=ccl.profile_ops(floor),
                              **cs.both_ms(floor))), flush=True)
    for at, (kernel, xs) in torch.load(inputs_path(entry)).items():
        run, got, want = entry.calls(versions(), kernel,
                                     [x.to(dev) for x in xs])
        cs.max_abs_err(f"{root} {kernel} {at}", got, want)
        ops = ccl.profile_ops(run)
        cs.check(ops, f"{root} {kernel} {at}: the profiler recorded no "
                 "device operation")
        print(json.dumps(dict(
            root=str(root), kernel=kernel, at=at, ops=ops,
            ops_ms=sum(o["ms"] for o in ops.values()),
            launches=sum(o["launches"] for o in ops.values()),
            **cs.both_ms(run))), flush=True)


def clocks_root(entry: Entry, root: Path) -> None:
    """Cycles per block by phase of root's clocked kernels from a build
    with -D<clock_flag>."""
    sys.path.insert(0, str(root))
    import torch
    from ros_vision_tpu_torch import _build
    _build.LIBRARY = _build.KernelLibrary(
        flags=_build.NVCC_FLAGS + (f"-D{entry.clock_flag}",))
    _build._FUNCS.clear()
    read = getattr(_build.LIBRARY.get(), entry.clock_export)
    read.argtypes = [ctypes.c_void_p]
    n = len(entry.phases)
    buf = (ctypes.c_ulonglong * (n + 3))()
    dev = torch.device("cuda", 0)
    for at, (kernel, xs) in torch.load(inputs_path(entry)).items():
        if kernel not in entry.clocked:
            continue
        run = entry.calls(versions(), kernel, [x.to(dev) for x in xs])[0]
        run()
        torch.cuda.synchronize()
        read(ctypes.addressof(buf))                  # zero the clocks
        run()
        torch.cuda.synchronize()
        if read(ctypes.addressof(buf)) != 0:
            raise RuntimeError("reading the clocks failed")
        sums = list(buf)
        blocks = sums[n]
        print(json.dumps(dict(
            root=str(root), kernel=kernel, at=at, block_launches=blocks,
            cycles_per_block={k: v / blocks
                              for k, v in zip(entry.phases, sums)},
            span_ms=(sums[n + 2] - sums[n + 1]) / 1e6)), flush=True)


def main(entry: Entry, script: str, argv: list[str]) -> int:
    """`script` is the entry's file, which each root's process runs
    again with a mode."""
    if argv[:1] == ["--capture"]:
        capture(entry)
        return 0
    modes = {"--time": time_root, "--clocks": clocks_root}
    if argv[:1] and argv[0] in modes:
        modes[argv[0]](entry, Path(argv[1]))
        return 0
    me = [sys.executable, str(Path(script).resolve())]
    subprocess.run(me + ["--capture"], check=True)
    for root in argv or ["."]:
        todo = ["--time"]
        src = Path(root) / "ros_vision_tpu_torch" / "csrc" / entry.source
        if entry.clock_flag in src.read_text():
            todo.append("--clocks")
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
