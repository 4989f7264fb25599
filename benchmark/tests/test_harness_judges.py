"""The tag comparison, moved from benchmark/harness/compare.py into the
judge benchmark/judges/tags.py, reads exactly as it read before the move.

The constants are what the parent commit
b1ab8eb6c282d7bf72a5090c91d1b5c09ae3415a printed for the same runs on the
CPU (the port's plain paths, one thread): run.measure on the tiny cells
and tools/control.py on tag800-pipelined-4cam at its own size.
"""
import pytest

from benchmark import run
from benchmark.harness import cell as cellmod
from benchmark.tools import control

TINY_LIMITS = {"extra_ids": 0, "missed_tags": 0, "empty_answers": 0,
               "hamming_mismatch": 0, "corner_px": 1.5, "pose_px": 0.2}

READINGS = {
    2147483911: {"extra_ids": 0.0, "empty_answers": 0.0,
                 "hamming_mismatch": 0.0, "corner_px": 0.3044303031992695,
                 "pose_t_m": 1.4972875510093092e-05,
                 "pose_R": 3.3525958656410726e-05,
                 "pose_px": 0.00048803289606358754, "robot_m": 0.0,
                 "missed_tags": 0.0},
    2147486021: {"extra_ids": 0.0, "empty_answers": 0.0,
                 "hamming_mismatch": 0.0, "corner_px": 0.31073600598288376,
                 "pose_t_m": 1.5218401834493742e-05,
                 "pose_R": 3.812867118607732e-05,
                 "pose_px": 0.0004898268171501734, "robot_m": 0.0,
                 "missed_tags": 0.0},
}

# the same frames through tiny-sync and tiny-pipe read the same numbers
GOLDEN = {
    (cell, seed): {
        "readings": READINGS[seed],
        "reference_unplaced": [],
        "failed": 0,
        "checks": {k: {"value": READINGS[seed][k], "limit": v}
                   for k, v in TINY_LIMITS.items()},
    }
    for cell in ("tiny-sync", "tiny-pipe")
    for seed in READINGS}

CONTROL_SEED = 2147483911
CONTROL = {"seed": CONTROL_SEED, "failed_answers": 8, "answers": 8,
           "readings": {"extra_ids": 0.0, "empty_answers": 0.0,
                        "hamming_mismatch": 0.0,
                        "corner_px": 4.099555937690306,
                        "pose_t_m": 0.009498568215956406,
                        "pose_R": 0.001923549745074471,
                        "pose_px": 2.244742864543909, "robot_m": 0.0,
                        "missed_tags": 0.0}}


@pytest.mark.parametrize("cell,seed", list(GOLDEN))
def test_the_judge_reads_as_the_harness_read(tiny_root, cell, seed):
    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds",
                      "4", "--trace", "0"])
    out = run.measure(args, tiny_root, device="cpu")
    want = GOLDEN[(cell, seed)]
    assert out["notes"]["readings"] == want["readings"]
    assert out["notes"]["reference_unplaced"] == want["reference_unplaced"]
    assert out["result"]["failed"] == want["failed"]
    assert out["result"]["checks"] == want["checks"]
    assert out["result"]["correct"] is True


def test_the_controls_readings_are_the_parents():
    cell = cellmod.find_cell("tag800-pipelined-4cam")
    assert cell.judge == "tags"
    assert control.readings(cell, CONTROL_SEED) == CONTROL
