"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout, on a machine with as many NVIDIA cards as the
cell asks for (it exits 2 without them). It makes the cell's frames from
the seed, builds and warms the port (ros_vision_tpu_torch) on the cell's
shapes, drives the cell's traffic for `--seconds`, checks what the window
produced against the plain reference, by the judge its configuration
names (benchmark/judges/<judge>.py), and prints, as the last line of
standard output, one JSON object: correct, attempted, failed, metrics
(--trace 0: the cell's end-to-end metrics; --trace 1: its per-layer
metrics), device, with --trace 1 a breakdown, and last the numbers
compared beside their limits (also the last lines of standard error).
An earlier line of standard output carries the run's notes: the card and
its power limit, the traffic's own counts and, traced, every call's
front-end route, cluster_and_fit width and tail slots.

The port's kernels build into build/ under the checkout (the port's own
build directory); the torch extension and Triton caches are kept there
too, at fixed paths, so only a checkout's first run builds.
"""
from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names the process may not hold once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ros_vision_tpu")


def process_start() -> float:
    """The epoch time this process started (Linux /proc), else the time
    this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        start = time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
        return min(start, T_IMPORT)
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_note() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not available"


def set_env(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout. The
    threads of the CPU libraries are left as the port ships them: how many
    it uses is the port's decision, which a change to it can move."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton_cache")
    os.environ.setdefault("USE_FLAX", "0")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(args, root: Path, device=None, t_start=None) -> dict:
    """One run of a cell; returns the result object (without printing).
    device: a torch device to run on instead of the card (tests only)."""
    from benchmark.harness import cell as cellmod
    from benchmark.harness import roofline, stats, trace
    t_start = process_start() if t_start is None else t_start
    cell = cellmod.find_cell(args.workload, root)
    set_env(root)
    marks = {"python": T_IMPORT - t_start}
    import torch
    marks["torch"] = time.time() - t_start
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            raise SystemExit(
                f"{cell.name} needs {cell.chips} CUDA card(s); "
                f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                f"device_count={torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"
    seed = args.seed & (2 ** 64 - 1)
    scenes = cellmod.load_module("scenes", cell.traffic["scene"]["generator"],
                                 root)
    pool = scenes.make(seed, cell.config, cell.traffic["scene"])
    marks["scenes"] = time.time() - t_start
    tracer = trace.Tracer(cuda) if args.trace else None
    if tracer is not None:
        tracer.install()
    ctx = types.SimpleNamespace(cell=cell, seed=seed, seconds=args.seconds,
                                device=device, pool=pool, tracer=tracer,
                                t_window=None)

    def mark(name):
        """Note how far into set-up (s from process start) a step ended."""
        marks[name] = time.time() - t_start
    ctx.mark = mark

    def window_started(t0):
        """The window opens at t0. A traced run lays its instruments'
        stretches over it (benchmark/harness/trace.py); ctx.t_spans is the
        end of the first, over which the host counters are read (the
        window's end, untraced)."""
        ctx.t_window = t0
        ctx.t_spans = tracer.schedule(t0, args.seconds) \
            if tracer is not None else t0 + args.seconds
    ctx.window_started = window_started
    driver = cellmod.load_module("drivers", cell.traffic["driver"], root)
    try:
        out = driver.run(ctx)
    finally:
        if tracer is not None:
            tracer.uninstall()
    t0, t1 = out["t0"], out["t1"]
    found = forbidden_modules()
    if found:
        raise SystemExit("modules of the JAX stack were loaded: "
                         + ", ".join(found))
    notes = {"card": card_note() if cuda else "cpu", "setup_marks_s": marks,
             "torch_threads": torch.get_num_threads(), **out["notes"]}
    metrics = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    e2e = stats.window_metrics(out["delivered"], t0, t1)
    notes["frames_in_window"] = e2e.pop("frames")
    e2e["setup_s"] = ctx.t_window - t_start
    if args.trace:
        # the instruments' cost, beside an untraced run's metrics
        notes["end_to_end"] = e2e
    else:
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    breakdown = None
    if args.trace:
        calls = [c for c in tracer.calls if t0 <= c["t0"] and c["t1"] <= t1]
        summary = {"calls": calls, "profile": tracer.profile, "cuda": cuda,
                   "stages": tracer.stages, "layers": out["layers"],
                   "least_ms": roofline.stage_least_ms(calls),
                   "spans_window": _window_or_none(out["delivered"], t0,
                                                   ctx.t_spans)}
        for m in cell.per_layer:
            reader = cellmod.load_module("metrics", m["name"], root)
            value = reader.read(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
        notes["calls"] = {
            k: _histogram(c[k] for c in calls)
            for k in ("route", "width", "slots")}
        notes["instruments"] = tracer.cost(calls)
        prof = tracer.profile
        if prof is not None:
            notes["profile"] = {k: prof[k] for k in
                                ("calls", "device_ops", "attributed_share",
                                 "stages", "window_s", "busy_s")}
            breakdown = {"device_ops": [list(x) for x in prof["top_ops"]],
                         "idle_gaps": [list(x) for x in prof["idle_gaps"]]}
    device_rec = {"platform": "gpu" if cuda else device.type,
                  "kind": torch.cuda.get_device_name(device) if cuda
                  else "cpu",
                  "count": cell.chips if cuda else 1,
                  "memory_peak_bytes": int(out["memory_peak_bytes"])}
    if args.trace and tracer.profile is not None:
        device_rec["busy_s"] = tracer.profile["busy_s"]
        device_rec["window_s"] = tracer.profile["window_s"]
    answers = out["answers"]
    del out, tracer, ctx
    if cuda:
        torch.cuda.empty_cache()
    judge = cellmod.load_module("judges", cell.judge, root)
    refs = judge.reference(pool, cell.config)
    worst, failed, extra = judge.judge(answers, refs, pool, cell.config,
                                       cell.limits)
    notes.update(extra)
    notes["readings"] = worst
    checks = {k: {"value": worst[k], "limit": v}
              for k, v in cell.limits.items()}
    correct = failed == 0 and bool(answers) and \
        all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": len(answers),
              "failed": failed, "metrics": metrics, "device": device_rec}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return {"result": result, "notes": notes}


def _window_or_none(delivered, t0, t1):
    """The end-to-end arithmetic over [t0, t1], or None if no frame came."""
    from benchmark.harness import stats
    try:
        return stats.window_metrics(delivered, t0, t1)
    except RuntimeError:
        return None


def _histogram(values) -> dict:
    h = {}
    for v in values:
        h[str(v)] = h.get(str(v), 0) + 1
    return h


def main(argv=None, root: Path | None = None, device=None) -> int:
    args = parse(argv)
    root = Path(root or ROOT)
    try:
        out = measure(args, root, device)
    except SystemExit as e:
        print(f"run.py: {e}", file=sys.stderr, flush=True)
        return 2
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps({"notes": out["notes"]}, default=str), flush=True)
    for name, c in out["result"]["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
