"""The control's readings: the reference one precision below the
configuration's, in the program's place, judged by the judge that the
configuration names (benchmark/judges/<judge>.py), as the program is, on
a cell's frames at the cell's own size.

    python3 benchmark/tools/control.py --workload <cell> --seeds n,n,n

Prints one line a seed with every number's reading beside the cell's
limit; the upper reading of each limit is the least over the seeds. Each
distinct frame is one answer (the timed window repeats them).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell, seed: int, root: Path = ROOT) -> dict:
    from benchmark.harness import cell as cellmod
    scenes = cellmod.load_module("scenes", cell.traffic["scene"]["generator"],
                                 root)
    judge = cellmod.load_module("judges", cell.judge, root)
    pool = scenes.make(seed, cell.config, cell.traffic["scene"])
    worst, failed, n = judge.control_readings(pool, cell.config, cell.limits)
    return {"seed": seed, "failed_answers": failed, "answers": n,
            "readings": worst}


def main() -> int:
    from benchmark.harness import cell as cellmod
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    cell = cellmod.find_cell(args.workload)
    for s in args.seeds.split(","):
        r = readings(cell, int(s))
        r["limits"] = cell.limits
        print(json.dumps({"cell": cell.name, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
