"""BENCHMARK.json against the contract's shape, and every file it names
found by name; a cell added from new files alone."""
import hashlib
import json
import re

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
