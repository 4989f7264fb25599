"""Each cell, run short on the card (skipped without one)."""
import json

import pytest
from conftest import ROOT

from benchmark import run

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(card, cell, trace):
    args = run.parse(["--workload", cell, "--seed", "2147483647",
                      "--seconds", "6", "--trace", str(trace)])
    res = run.measure(args, ROOT)["result"]
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["metrics"]
