"""Run cells several times in a row, one process a run, and summarise.

    python3 benchmark/tools/sets.py --workload <cell>[,<cell>...]
        --seeds <n,n,...> [--seconds S] [--trace 0|1] [--out DIR]

Each run is `python3 benchmark/run.py ...` from the checkout's root, one
after another (never two at once on the card). The result lines go to
DIR/<cell>.jsonl (default chiprun_out/sets); a summary line a cell
gives, for each metric, the median and the spread (the distance between
the first and third quartile over the median, statistics.quantiles n=4)
of the runs after the first (whose set-up builds), the compared numbers'
widest readings and whether every run was correct. This is how the
bounds and limits in BENCHMARK.json and benchmark/workloads/ were read.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values) -> float | None:
    if len(values) < 2 or statistics.median(values) == 0:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "sets"))
    args = ap.parse_args()
    seconds = args.seconds or json.loads(
        (ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    rc = 0
    for cell in args.workload.split(","):
        rows = []
        for seed in args.seeds.split(","):
            cmd = [sys.executable, "benchmark/run.py", "--workload", cell,
                   "--seed", seed, "--seconds", str(seconds),
                   "--trace", str(args.trace)]
            t = time.time()
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
            wall = time.time() - t
            lines = p.stdout.strip().splitlines()
            try:
                res = json.loads(lines[-1])
                notes = json.loads(lines[-2])["notes"] \
                    if len(lines) > 1 else {}
            except (IndexError, ValueError, KeyError):
                res, notes = None, {}
            rec = {"cell": cell, "seed": seed, "rc": p.returncode,
                   "wall_s": wall, "result": res, "notes": notes}
            if res is None:
                rec["stderr"] = p.stderr[-4000:]
                rc = 1
            rows.append(rec)
            with open(out / f"{cell}.jsonl", "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(json.dumps({k: rec[k] for k in ("cell", "seed", "rc",
                                                  "wall_s")}
                             | {"correct": res and res["correct"],
                                "metrics": res and {
                                    k: v["value"] for k, v in
                                    res["metrics"].items()}}), flush=True)
        ok = [r["result"] for r in rows if r["result"]]
        summary = {"cell": cell, "runs": len(rows), "results": len(ok),
                   "all_correct": all(r["correct"] for r in ok)
                   and len(ok) == len(rows)}
        metrics = {}
        for name in (ok[0]["metrics"] if ok else {}):
            vals = [r["metrics"][name]["value"] for r in ok
                    if name in r["metrics"]]
            warm = vals[1:] if len(vals) > 2 else vals
            metrics[name] = {"median": statistics.median(warm),
                             "spread": spread(warm), "first": vals[0],
                             "all": vals}
        summary["metrics"] = metrics
        summary["checks"] = {k: max(r["checks"][k]["value"] for r in ok)
                             for k in (ok[0]["checks"] if ok else {})}
        print("SUMMARY " + json.dumps(summary), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
