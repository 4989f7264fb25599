"""The control's readings: the reference with its stages held in bfloat16
(benchmark/reference/control.py), in the program's place, judged by the
same comparison as the program (benchmark/harness/compare.py) on a cell's
frames at the cell's own size.

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


def readings(cell, seed: int) -> dict:
    from benchmark.harness import cell as cellmod
    from benchmark.harness import compare
    scenes = cellmod.load_module("scenes", cell.traffic["scene"]["generator"])
    pool = scenes.make(seed, cell.config, cell.traffic["scene"])
    refs = compare.reference(pool.frames, cell.config)
    ctrl = compare.reference(pool.frames, cell.config, control=True)
    robot = "robot_m" in cell.limits
    answers = []
    for i, dets in enumerate(ctrl):
        cam = i % len(cell.config.get("cameras", [0])) if robot else None
        answers.append(compare.Answer(
            i, dets, [(d[0], *compare._robot(cell.config, cam, d[4]))
                      for d in dets] if robot else None, cam))
    placed = [{t.tag_id for t in f} for f in pool.truth]
    worst, failed = compare.compare(answers, refs, cell.config, cell.limits,
                                    placed)
    return {"seed": seed, "failed_answers": failed, "answers": len(answers),
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
