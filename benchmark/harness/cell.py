"""A cell of the benchmark, found by name from files alone.

BENCHMARK.json at the root of the checkout names each cell (a workload):
its configuration and its traffic mix. Everything else is a file of its
own under benchmark/, found by the name that BENCHMARK.json or the mix
gives:

    benchmark/configs/<config>.json     the deployment, as it is run
    benchmark/traffic/<traffic>.json    the mix: its driver, its scene
                                        generator and their parameters
    benchmark/workloads/<cell>.json     the cell's limits for `correct`
    benchmark/judges/<judge>.py         the judge of `correct` that the
                                        configuration names ("judge")
    benchmark/drivers/<driver>.py       a traffic driver: run(ctx)
    benchmark/scenes/<generator>.py     a scene generator: make(...)
    benchmark/metrics/<metric>.py       a per-layer metric: read(summary)

A judge exposes NUMBERS, the names of its readings;
reference(pool, cfg, control=False, workers=None), one entry a pool
frame (control: the reference one precision below the configuration's);
judge(answers, refs, pool, cfg, limits) -> (the widest reading of each
number, the answers with a number over its limit, notes for the run);
and control_readings(pool, cfg, limits) -> (the control's answers judged
so: widest readings, answers over a limit, answers).

A later cell, mix, configuration, metric or kind of configuration (its
judge, driver and scene generator) adds files and entries; no file here
needs an edit for it.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    """A metric without a "workloads" key is reported in every cell."""
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    judge: str
    traffic_name: str
    traffic: dict
    chips: int
    limits: dict
    end_to_end: list
    per_layer: list


def find_cell(name: str, root: Path = ROOT) -> Cell:
    manifest = load_manifest(root)
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    bench = root / "benchmark"
    cfg_file = configs[w["config"]]["file"]
    cfg = _load_json(root / cfg_file)
    if "judge" not in cfg:
        raise KeyError(f'{cfg_file} names no "judge": a configuration names '
                       f"its judge of `correct`, benchmark/judges/<judge>.py")
    if not (bench / "judges" / f"{cfg['judge']}.py").is_file():
        raise FileNotFoundError(f'{cfg_file}: "judge" {cfg["judge"]!r} is not '
                                f"a file benchmark/judges/{cfg['judge']}.py")
    return Cell(
        name=name, config_name=w["config"], config=cfg, judge=cfg["judge"],
        traffic_name=w["traffic"],
        traffic=_load_json(bench / "traffic" / f"{w['traffic']}.json"),
        chips=int(w["chips"]),
        limits=_load_json(bench / "workloads" / f"{name}.json")["limits"],
        end_to_end=[m for m in manifest["end_to_end"] if applies(m, name)],
        per_layer=[m for m in manifest["per_layer"] if applies(m, name)])


def load_module(kind: str, name: str, root: Path = ROOT):
    """benchmark/<kind>/<name>.py as a module (names may hold '.' and
    '-', so it is loaded from its path)."""
    path = root / "benchmark" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(path)
    modname = f"benchmark.{kind}." + re.sub(r"\W", "_", name)
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod
