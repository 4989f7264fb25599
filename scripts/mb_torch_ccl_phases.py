#!/usr/bin/env python3
"""Where the device time of K2 rank_image and K6 propagate_fixpoint goes,
launch by launch, and how long their union-find chains are, on one CUDA
card.

    python3 scripts/mb_torch_ccl_phases.py [ROOT ...]

Each ROOT (default `.`) is the top of a checkout that holds
ros_vision_tpu_torch/, for instance an older commit unpacked with `git
archive` under build/. First this checkout captures chip_smoke.py's
threshold planes (the plain threshold of its bench batches, B = 4, and of
its clutter frames) and its adversarial planes: K2 at 640x400 (the
decimated 1280x800 frame), K6 at 960x540 (1920x1080) with the flat pixel
indices as values, as label_components_flood passes them. Then each ROOT,
in the order given, runs in a process of its own that imports that root's
package and, for each input:

- checks the kernel bit-exact against the root's plain version;
- runs 20 calls under torch.profiler and reports each device operation
  (kernel or memset, by name) with its device time and launches per call,
  and the whole call's device and call time from chip_smoke.both_ms
  (device: calls queued behind a torch.cuda._sleep; call: one call
  between CUDA events, the host's enqueue included);
- where the root's csrc/unionfind.cuh has the RVT_CCL_COUNT_HOPS and
  RVT_CCL_STEP_CLOCKS build flags, builds the kernels again with each (a
  library of its own under build/) and reports, per phase of the
  union-find, the finds and the hops (parent steps) of its finds per
  pixel, the hops per find and the most of one find, the unions per pixel
  and the rounds (atomicMin tries) per union; and, from the second
  build, the clock cycles of each step of the tile phase per block (its
  thread 0). The counting builds' kernel times are not reported: their
  atomics perturb them.

Prints one JSON line per root, kernel and input, then the card's name and
power limit; exits nonzero without a card or if a kernel disagrees.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
INPUTS = ROOT / "build" / "mb_torch_ccl_phases" / "inputs.pt"
CALLS = 20
HOP_FLAG = "RVT_CCL_COUNT_HOPS"
CLOCK_FLAG = "RVT_CCL_STEP_CLOCKS"
HOP_STATS = 5      # per phase: finds, hops, most hops, unions, union rounds
HOP_EXPORTS = {"rank_image": "rvt_rank_image_hops",
               "propagate_fixpoint": "rvt_propagate_fixpoint_hops"}


def timing_helpers():
    """This checkout's chip_smoke.py (its timing and frame functions),
    loaded from its file so that ros_vision_tpu_torch still resolves to
    the root under test."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def capture() -> None:
    """Save the threshold planes K2 and K6 are measured on."""
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    from ros_vision_tpu_torch.device import require_cuda
    from ros_vision_tpu_torch.ops import threshold_kernel as tk
    cs = timing_helpers()
    dev = require_cuda()

    def thresh(gray):
        return tk.adaptive_threshold_plain(
            torch.from_numpy(np.ascontiguousarray(gray)).to(dev))[1].cpu()

    saved = {"rank_image": {}, "propagate_fixpoint": {}}
    for kernel, (w, h, noise) in (("rank_image", (cs.W, cs.H, 1.0)),
                                  ("propagate_fixpoint",
                                   (cs.W2, cs.H2, cs.NOISE_1080))):
        at = f"{w // 2}x{h // 2}"
        bench = np.stack([cs.bench_scene(s, w, h, noise)[0]
                          for s in range(4)])
        planes = saved[kernel]
        planes[f"{at} bench B=4"] = thresh(bench)
        planes[f"{at} clutter B=1"] = thresh(
            cs.clutter_frame(width=w, height=h)[None])
        planes[f"{at} staircase B=1"] = torch.from_numpy(
            cs.staircase_plane(h // 2, w // 2))
        planes[f"{at} spiral B=1"] = torch.from_numpy(
            cs.spiral_plane(h // 2, w // 2))
    INPUTS.parent.mkdir(parents=True, exist_ok=True)
    torch.save(saved, INPUTS)


def short_name(name: str) -> str:
    """A kernel's bare name from its demangled signature."""
    name = name.replace("(anonymous namespace)::", "")
    if "(" in name:
        name = name[:name.index("(")]
    return re.sub(r"^void ", "", name).split("::")[-1]


def calls_of(kernel: str, th, dev):
    """(kernel call, plain call) of `kernel` on the (B, H, W) plane th."""
    import torch
    from ros_vision_tpu_torch.ops import ccl
    from ros_vision_tpu_torch.ops import ccl_kernel as ck
    from ros_vision_tpu_torch.ops import frontend_kernel as fk
    th = th.to(dev)
    if kernel == "rank_image":
        return (lambda: fk.label_components(th),
                lambda: fk.label_components_plain(th))
    b, h, w = th.shape
    flat = torch.arange(h * w, dtype=torch.int32, device=dev)
    flat = flat.view(1, h, w).expand(b, h, w).contiguous()
    return (lambda: (ck.propagate_fixpoint(th, flat),),
            lambda: (ccl.propagate_fixpoint(th, flat),))


def profile_ops(fn) -> dict:
    """Each device operation of fn() by name: device ms and launches per
    call, over CALLS calls under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    ops = {}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        op = ops.setdefault(short_name(e.key), dict(ms=0.0, launches=0.0))
        op["ms"] += us / 1e3 / CALLS
        op["launches"] += e.count / CALLS
    return ops


def time_root(root: Path) -> None:
    """Check and time root's K2 and K6 on the saved planes, one
    operation at a time."""
    sys.path.insert(0, str(root))
    import torch
    import ros_vision_tpu_torch
    cs = timing_helpers()
    cs.check(Path(ros_vision_tpu_torch.__file__).resolve().is_relative_to(
        root.resolve()), f"ros_vision_tpu_torch imported from "
        f"{ros_vision_tpu_torch.__file__}, not from {root}")
    dev = torch.device("cuda", 0)
    for kernel, planes in torch.load(INPUTS).items():
        for at, th in planes.items():
            run, plain = calls_of(kernel, th, dev)
            cs.max_abs_err(f"{root} {kernel} {at}", run(), plain())
            ops = profile_ops(run)
            cs.check(ops, f"{root} {kernel} {at}: the profiler recorded no "
                     "device operation")
            print(json.dumps(dict(
                root=str(root), kernel=kernel, at=at, ops=ops,
                ops_ms=sum(o["ms"] for o in ops.values()),
                launches=sum(o["launches"] for o in ops.values()),
                **cs.both_ms(lambda: run()))), flush=True)


def counting_runs(root: Path, flag: str) -> dict:
    """{(kernel, at): the counts of one call} from a build of root's
    kernels with -D<flag>, with (phase names, step names)."""
    import torch
    from ros_vision_tpu_torch import _build
    dev = torch.device("cuda", 0)
    _build.LIBRARY = _build.KernelLibrary(
        flags=_build.NVCC_FLAGS + (f"-D{flag}",))
    _build._FUNCS.clear()
    lib = _build.LIBRARY.get()
    out = {}
    for kernel, planes in torch.load(INPUTS).items():
        read = getattr(lib, HOP_EXPORTS[kernel])
        names = getattr(lib, HOP_EXPORTS[kernel] + "_phases")
        names.restype = ctypes.c_char_p
        phases, steps = (part.split(",")
                         for part in names().decode().split("|"))
        buf = (ctypes.c_ulonglong * (HOP_STATS * len(phases)
                                     + len(steps)))()
        read.argtypes = [ctypes.c_void_p]
        for at, th in planes.items():
            run, _ = calls_of(kernel, th, dev)
            torch.cuda.synchronize()
            read(ctypes.addressof(buf))                  # zero the counts
            run()
            torch.cuda.synchronize()
            if read(ctypes.addressof(buf)) != 0:
                raise RuntimeError(f"{kernel}: reading the counts failed")
            out[kernel, at] = (list(buf), phases, steps, th.shape)
    return out


def hops_root(root: Path) -> None:
    """Union-find statistics of root's K2 and K6 from the two counting
    builds: finds, hops and union rounds per phase, and phase A's cycles
    by step."""
    sys.path.insert(0, str(root))
    from ros_vision_tpu_torch.ops import ccl_kernel
    hops = counting_runs(root, HOP_FLAG)
    clocks = counting_runs(root, CLOCK_FLAG)
    for (kernel, at), (buf, phases, steps, shape) in hops.items():
        pixels = shape[0] * shape[1] * shape[2]
        out = {}
        for i, name in enumerate(phases):
            finds, nhops, most, unions, rounds = \
                buf[HOP_STATS * i:HOP_STATS * (i + 1)]
            out[name] = dict(finds_per_pixel=finds / pixels,
                             hops_per_pixel=nhops / pixels,
                             hops_per_find=nhops / max(finds, 1),
                             max_hops=most,
                             unions_per_pixel=unions / pixels,
                             rounds_per_union=rounds / max(unions, 1))
        plan = ccl_kernel.ccl_plan(*shape[1:])
        blocks = plan.tiles_x * plan.tiles_y * shape[0]
        cycles = clocks[kernel, at][0][HOP_STATS * len(phases):]
        print(json.dumps(dict(
            root=str(root), kernel=kernel, at=at, hops=out,
            tile_step_cycles_per_block={
                s: c / blocks for s, c in zip(steps, cycles)})), flush=True)


def main(argv: list[str]) -> int:
    if argv[:1] == ["--capture"]:
        capture()
        return 0
    if argv[:1] in (["--time"], ["--hops"]):
        (time_root if argv[0] == "--time" else hops_root)(Path(argv[1]))
        return 0
    me = [sys.executable, str(Path(__file__).resolve())]
    subprocess.run(me + ["--capture"], check=True)
    for root in argv or ["."]:
        modes = ["--time"]
        src = Path(root) / "ros_vision_tpu_torch" / "csrc" / "unionfind.cuh"
        if CLOCK_FLAG in src.read_text():
            modes.append("--hops")
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
