"""BENCHMARK.json against the contract's shape, and every file it names
found by name; a cell added from new files alone."""
import hashlib
import json
import re
import shutil

import pytest
from conftest import ROOT, make_tiny_root

from benchmark.harness import cell as cellmod

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["source"]) <= 200
        assert c["file"].startswith("benchmark/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    names = [m["name"] for m in MANIFEST["end_to_end"]
             + MANIFEST["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]


def test_run_seconds_fit_a_full_check():
    """24 cells at 2 + 14 runs each, run_seconds + 60 s a run, 2 x 90 s a
    cell to compile and 1200 s spare fit in 43200 s."""
    rs = MANIFEST["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_named_file_is_found(cell):
    c = cellmod.find_cell(cell)
    assert c.limits and c.end_to_end and c.per_layer
    cellmod.load_module("drivers", c.traffic["driver"])
    cellmod.load_module("scenes", c.traffic["scene"]["generator"])
    for m in c.per_layer:
        assert callable(cellmod.load_module("metrics", m["name"]).read)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2


def _digest(root):
    return {p.relative_to(root).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts
            and "tests" not in p.parts}


def test_a_cell_is_added_from_new_files_alone(tmp_path):
    root = make_tiny_root(tmp_path)
    before = _digest(ROOT)
    after = _digest(root)
    assert all(after[k] == v for k, v in before.items())
    added = set(after) - set(before)
    assert added == {"benchmark/configs/tiny.json",
                     *(f"benchmark/{d}/tiny-{c}.json"
                       for d in ("traffic", "workloads")
                       for c in ("stream", "sync", "pipe"))}
    c = cellmod.find_cell("tiny-pipe", root)
    assert c.config["width"] == 640 and c.traffic["in_flight"] == 2
    assert "spin.loop_ms" not in {m["name"] for m in c.per_layer}
    # a per-layer metric added as a file and an entry
    (root / "benchmark" / "metrics" / "extra.count.py").write_text(
        "def read(summary):\n    return len(summary['calls'])\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["per_layer"].append({"name": "extra.count", "unit": "count",
                           "better": "lower", "source": "program_span",
                           "layer": "apriltag.detector",
                           "moves": "latency_p50_ms",
                           "workloads": ["tiny-pipe"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    c = cellmod.find_cell("tiny-pipe", root)
    reader = cellmod.load_module("metrics", "extra.count", root)
    assert "extra.count" in {x["name"] for x in c.per_layer}
    assert reader.read({"calls": [1, 2]}) == 2


TOY = {
    "judges/toy.py": '''"""Judge "toy": an answer is (frame, the sum of its
values), held to the sum in float64; the control sums in float32."""
import numpy as np

NUMBERS = ("sum_gap",)


def reference(pool, cfg, control=False, workers=None):
    dtype = np.float32 if control else np.float64
    return [float(np.sum(f.astype(dtype))) for f in pool.frames]


def judge(answers, refs, pool, cfg, limits):
    worst, failed = {"sum_gap": 0.0}, 0
    for frame, value in answers:
        gap = abs(value - refs[frame])
        failed += gap > limits["sum_gap"]
        worst["sum_gap"] = max(worst["sum_gap"], gap)
    return worst, failed, {"toy_frames": len(refs)}


def control_readings(pool, cfg, limits):
    refs = reference(pool, cfg)
    ctrl = list(enumerate(reference(pool, cfg, control=True)))
    worst, failed, _ = judge(ctrl, refs, pool, cfg, limits)
    return worst, failed, len(ctrl)
''',
    "scenes/toy.py": '''"""Scene generator "toy": `frames` vectors of `length`
uniform values."""
import dataclasses

import numpy as np


@dataclasses.dataclass
class Pool:
    frames: list


def make(seed, cfg, params):
    rng = np.random.default_rng(seed)
    return Pool([rng.random(cfg["length"]) for _ in range(params["frames"])])
''',
    "drivers/toy.py": '''"""Traffic driver "toy": sums the pool's frames in
turn for the window; `wrong` answers are off by one."""
import time

import numpy as np


def run(ctx):
    frames = ctx.pool.frames
    ctx.mark("warm")
    t0 = time.time()
    ctx.window_started(t0)
    delivered, answers = [], []
    while time.time() < t0 + ctx.seconds:
        i = len(answers) % len(frames)
        t = time.time()
        answers.append((i, float(np.sum(frames[i]))))
        delivered.append((t, time.time()))
        time.sleep(0.001)
    for k in range(int(ctx.cell.traffic.get("wrong", 0))):
        answers[k] = (answers[k][0], answers[k][1] + 1.0)
    return dict(t0=t0, t1=t0 + ctx.seconds, delivered=delivered,
                answers=answers, memory_peak_bytes=0, layers={},
                notes={"sums": len(answers)})
''',
    "configs/toy.json": json.dumps({"length": 4096, "precision": "float64",
                                    "judge": "toy", "reduced": []}),
    "configs/toy-nojudge.json": json.dumps({"length": 8, "reduced": []}),
    "configs/toy-lost.json": json.dumps({"length": 8, "judge": "lost",
                                         "reduced": []}),
}


def _toy_root(tmp):
    """A copy of the benchmark with a toy kind added as new files and
    entries only: cells `toy-cell`, `toy-wrong` (one answer off by one),
    `toy-nojudge` and `toy-lost` (a judge that is not there)."""
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = tmp / "benchmark"
    files = dict(TOY)
    scene = {"generator": "toy", "frames": 3}
    for mix, wrong in (("toy", 0), ("toy-wrong", 1)):
        files[f"traffic/{mix}.json"] = json.dumps(
            {"driver": "toy", "wrong": wrong, "scene": scene})
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell, cfg, mix in (("toy-cell", "toy", "toy"),
                           ("toy-wrong", "toy", "toy-wrong"),
                           ("toy-nojudge", "toy-nojudge", "toy"),
                           ("toy-lost", "toy-lost", "toy")):
        files[f"workloads/{cell}.json"] = json.dumps(
            {"limits": {"sum_gap": 1e-9}})
        m["workloads"].append({"name": cell, "config": cfg, "traffic": mix,
                               "chips": 1, "why": "tests"})
    for cfg in ("toy", "toy-nojudge", "toy-lost"):
        m["configs"].append({"name": cfg, "source": "tests",
                             "file": f"benchmark/configs/{cfg}.json",
                             "reduced": [], "why": "tests"})
    for rel, text in files.items():
        (b / rel).write_text(text)
    (tmp / "BENCHMARK.json").write_text(json.dumps(m, indent=1))
    return tmp, {f"benchmark/{rel}" for rel in files}


def _last_lines(capsys, argv, root):
    """The run's notes and its result line."""
    from benchmark import run
    assert run.main(argv, root, device="cpu") == 0
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-2])["notes"], json.loads(lines[-1])


def test_a_cell_of_a_new_kind_is_added_from_new_files_alone(tmp_path,
                                                            capsys):
    root, new = _toy_root(tmp_path)
    before = _digest(ROOT)
    after = _digest(root)
    assert all(after[k] == v for k, v in before.items())
    assert set(after) - set(before) == new
    argv = ["--seed", str(2 ** 31 + 19), "--seconds", "1", "--trace", "0"]
    notes, res = _last_lines(capsys, ["--workload", "toy-cell", *argv],
                             root)
    assert res["correct"] is True and res["failed"] == 0
    assert res["checks"] == {"sum_gap": {"value": 0.0, "limit": 1e-9}}
    assert {"latency_p95_ms", "setup_s"} <= set(res["metrics"])
    # the judge's notes join the run's
    assert notes["readings"] == {"sum_gap": 0.0} and notes["toy_frames"] == 3
    # one answer off by one is over the judge's limit
    notes, res = _last_lines(capsys, ["--workload", "toy-wrong", *argv],
                             root)
    assert res["correct"] is False and res["failed"] == 1
    assert res["checks"]["sum_gap"]["value"] == pytest.approx(1.0)
    # the control, one precision below, fails the same limit
    from benchmark.tools import control
    r = control.readings(cellmod.find_cell("toy-cell", root), 2 ** 31 + 19,
                         root)
    assert r["answers"] == 3 and r["failed_answers"] > 0
    assert r["readings"]["sum_gap"] > 1e-9
    # a configuration names its judge, and the judge is a file
    with pytest.raises(KeyError, match='"judge"'):
        cellmod.find_cell("toy-nojudge", root)
    with pytest.raises(FileNotFoundError, match="judges/lost.py"):
        cellmod.find_cell("toy-lost", root)
