#!/usr/bin/env python3
"""Where the device time of K1 adaptive_threshold and K3 boundary_compact
goes, launch by launch, on one CUDA card.

    python3 scripts/mb_torch_frontend_phases.py [ROOT ...]

Each ROOT (default `.`) is the top of a checkout that holds
ros_vision_tpu_torch/, for instance an older commit unpacked with `git
archive` under build/; ROOT@C runs that root's K3 with clusters of C
blocks (its plan's BOUNDARY_CLUSTER set to C; its launcher takes up to
16, past 8 as a non-portable cluster size). First this checkout captures chip_smoke.py's
inputs at 1280x800 and 1920x1080: the gray bench batches (B = 4) and
clutter frames for K1, and for K3 their plain threshold planes with the
plain ranks and the detector's caps (K = 32,768 and 131,072, the stage-A
cap 3K/4). Then each ROOT, in the order given, runs in a process of its
own that imports that root's package and, for each input:

- checks the kernel bit-exact against the root's plain version;
- runs 20 calls under torch.profiler and reports each device operation
  (kernel or memset, by name) with its device time and launches per call,
  their sum, and the whole call's device and call time from
  chip_smoke.both_ms (device: calls queued behind a torch.cuda._sleep;
  call: one call between CUDA events, the host's enqueue included). The
  device time less the sum of the operations is what the gaps between
  launches cost;
- where the root's csrc/boundary.cu has the RVT_BOUNDARY_PHASE_CLOCKS
  build flag, builds the kernels again with it (a library of its own
  under build/) and reports K3's clock cycles per block in each phase of
  its one launch (thread 0 of each block; the counting build's kernel
  time is not reported).

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
INPUTS = ROOT / "build" / "mb_torch_frontend_phases" / "inputs.pt"
CLOCK_FLAG = "RVT_BOUNDARY_PHASE_CLOCKS"


def load_file(name: str, path: Path):
    """A module of this checkout loaded from its file, so that
    ros_vision_tpu_torch still resolves to the root under test."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def timing_helpers():
    return load_file("chip_smoke", ROOT / "chip_smoke.py")


def capture() -> None:
    """Save the gray frames of K1 and the threshold planes, ranks and caps
    of K3."""
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    from ros_vision_tpu_torch.device import require_cuda
    from ros_vision_tpu_torch.ops import frontend_kernel as fk
    from ros_vision_tpu_torch.ops import quadfit as qf
    from ros_vision_tpu_torch.ops import threshold_kernel as tk
    cs = timing_helpers()
    dev = require_cuda()
    saved = {"adaptive_threshold": {}, "boundary_compact": {}}
    for w, h, noise, k in ((cs.W, cs.H, 1.0, 32768),
                           (cs.W2, cs.H2, cs.NOISE_1080, 131072)):
        frames = {
            f"{w}x{h} bench B=4": np.stack(
                [cs.bench_scene(s, w, h, noise)[0] for s in range(4)]),
            f"{w}x{h} clutter B=1": cs.clutter_frame(width=w,
                                                     height=h)[None]}
        p_cap = qf.QuadFitConfig(max_points=k).max_boundary_pixels
        for at, gray in frames.items():
            g = torch.from_numpy(np.ascontiguousarray(gray)).to(dev)
            th = tk.adaptive_threshold_plain(g)[1]
            ranks = fk.label_components_plain(th)[2].view(th.shape)
            saved["adaptive_threshold"][at] = (g.cpu(),)
            saved["boundary_compact"][at] = (th.cpu(), ranks.cpu(), p_cap,
                                             k)
    INPUTS.parent.mkdir(parents=True, exist_ok=True)
    torch.save(saved, INPUTS)


def calls_of(kernel: str, args, dev):
    """(kernel call, plain call) of `kernel` on the saved arguments."""
    from ros_vision_tpu_torch.ops import frontend_kernel as fk
    from ros_vision_tpu_torch.ops import quadfit as qf
    from ros_vision_tpu_torch.ops import threshold_kernel as tk
    if kernel == "adaptive_threshold":
        g = args[0].to(dev)
        return (lambda: tk.adaptive_threshold_fused(g),
                lambda: tk.adaptive_threshold_plain(g))
    th, ranks, p_cap, k = args
    th, ranks = th.to(dev), ranks.to(dev)

    def plain():
        pts, counts = qf.boundary_points_capped(
            th, ranks.reshape(th.shape[0], -1), p_cap, k)
        return pts["key"], pts["pack2"], counts
    return lambda: fk.boundary_compact(th, ranks, p_cap, k), plain


def import_root(arg: str) -> Path:
    """Put ROOT of `ROOT[@C]` first on the path; with @C, set its K3
    plan's cluster size to C."""
    root, _, cluster = arg.partition("@")
    sys.path.insert(0, root)
    if cluster:
        from ros_vision_tpu_torch.ops import frontend_kernel as fk
        fk.BOUNDARY_CLUSTER = int(cluster)
    return Path(root)


def time_root(arg: str) -> None:
    """Check and time root's K1 and K3 on the saved inputs, one device
    operation at a time."""
    root = import_root(arg)
    import torch
    import ros_vision_tpu_torch
    cs = timing_helpers()
    phases = load_file("mb_torch_ccl_phases",
                       ROOT / "scripts" / "mb_torch_ccl_phases.py")
    cs.check(Path(ros_vision_tpu_torch.__file__).resolve().is_relative_to(
        root.resolve()), f"ros_vision_tpu_torch imported from "
        f"{ros_vision_tpu_torch.__file__}, not from {root}")
    dev = torch.device("cuda", 0)
    for kernel, inputs in torch.load(INPUTS).items():
        for at, args in inputs.items():
            run, plain = calls_of(kernel, args, dev)
            cs.max_abs_err(f"{root} {kernel} {at}", run(), plain())
            ops = phases.profile_ops(run)
            cs.check(ops, f"{root} {kernel} {at}: the profiler recorded no "
                     "device operation")
            print(json.dumps(dict(
                root=arg, kernel=kernel, at=at, ops=ops,
                ops_ms=sum(o["ms"] for o in ops.values()),
                launches=sum(o["launches"] for o in ops.values()),
                **cs.both_ms(run))), flush=True)


def clocks_root(arg: str) -> None:
    """K3's cycles per block by phase, from a build of root's kernels with
    -DRVT_BOUNDARY_PHASE_CLOCKS, on the saved inputs (after one warm-up
    call each)."""
    import_root(arg)
    import torch
    from ros_vision_tpu_torch import _build
    from ros_vision_tpu_torch.ops import frontend_kernel as fk
    from ros_vision_tpu_torch.ops import quadfit as qf
    _build.LIBRARY = _build.KernelLibrary(
        flags=_build.NVCC_FLAGS + (f"-D{CLOCK_FLAG}",))
    _build._FUNCS.clear()
    lib = _build.LIBRARY.get()
    names = lib.rvt_boundary_phase_names
    names.restype = ctypes.c_char_p
    phases = names().decode().split(",")
    read = lib.rvt_boundary_phase_clocks
    read.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * len(phases))()
    dev = torch.device("cuda", 0)
    for at, (th, ranks, p_cap, k) in torch.load(
            INPUTS)["boundary_compact"].items():
        th, ranks = th.to(dev), ranks.to(dev)
        fk.boundary_compact(th, ranks, p_cap, k)
        torch.cuda.synchronize()
        read(ctypes.addressof(buf))                      # zero the counts
        fk.boundary_compact(th, ranks, p_cap, k)
        torch.cuda.synchronize()
        if read(ctypes.addressof(buf)) != 0:
            raise RuntimeError("boundary_compact: reading the clocks failed")
        b, h, w = th.shape
        plan = fk.boundary_plan(h, w, qf.boundary_block_rows(p_cap, w) * w)
        blocks = plan.cluster * b
        print(json.dumps(dict(
            root=arg, kernel="boundary_compact", at=at,
            cycles_per_block={n: c / blocks for n, c in zip(phases, buf)})),
            flush=True)


def main(argv: list[str]) -> int:
    if argv[:1] == ["--capture"]:
        capture()
        return 0
    if argv[:1] in (["--time"], ["--clocks"]):
        (time_root if argv[0] == "--time" else clocks_root)(argv[1])
        return 0
    me = [sys.executable, str(Path(__file__).resolve())]
    subprocess.run(me + ["--capture"], check=True)
    for root in argv or ["."]:
        modes = ["--time"]
        src = (Path(root.partition("@")[0]) / "ros_vision_tpu_torch"
               / "csrc" / "boundary.cu")
        if CLOCK_FLAG in src.read_text():
            modes.append("--clocks")
        for mode in modes:
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
