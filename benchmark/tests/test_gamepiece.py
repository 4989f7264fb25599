"""The game-piece kind of configuration: found by name from its files,
run on the CPU at a tiny size through the port's plain paths, judged
`correct`; the timed path broken four ways reads `correct` false; the
control fails the cell's limits; the FLOP count reads the published
YOLO11 figures; on the card, a call makes no host sync."""
import json
import shutil

import pytest
from conftest import ROOT

from benchmark import run
from benchmark.harness import cell as cellmod
from benchmark.reference.yolo11_flops import flops

CELL = "gamepiece-yolo11n-pipelined-4cam"
TINY = {"width": 256, "height": 160, "img_size": 96}
SEED = 2 ** 31 + 2024


def make_tiny_root(tmp):
    """A copy of the benchmark with a tiny game-piece cell added as new
    files and entries only: config `gp-tiny` (256x160 frames, 96 px
    input), cell `gp-tiny-pipe` (batch 2, in_flight 2) with the game-piece
    cell's limits."""
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = tmp / "benchmark"
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((b / "configs" / "gamepiece-yolo11n-640.json")
                     .read_text())
    cfg.update(TINY, reduced=["width", "height", "img_size"])
    (b / "configs" / "gp-tiny.json").write_text(json.dumps(cfg))
    manifest["configs"].append({"name": "gp-tiny", "source": "tests",
                                "file": "benchmark/configs/gp-tiny.json",
                                "reduced": cfg["reduced"], "why": "tests"})
    mix = json.loads((b / "traffic" / "gamepiece-pipelined-b4.json")
                     .read_text())
    mix.update(batch=2, warmup_calls=1)
    mix["scene"].update(frames=4, balls_per_frame=[0, 1, 2, 3],
                        diameter_px=[8, 30])
    (b / "traffic" / "gp-tiny-pipe.json").write_text(json.dumps(mix))
    limits = (b / "workloads" / f"{CELL}.json").read_text()
    (b / "workloads" / "gp-tiny-pipe.json").write_text(limits)
    manifest["workloads"].append({"name": "gp-tiny-pipe",
                                  "config": "gp-tiny",
                                  "traffic": "gp-tiny-pipe", "chips": 1,
                                  "why": "tests"})
    for m in manifest["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("gp-tiny-pipe")
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return tmp


@pytest.fixture(scope="module")
def gp_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("gp"))


def measure(root, trace=0, seconds=2, seed=SEED):
    args = run.parse(["--workload", "gp-tiny-pipe", "--seed", str(seed),
                      "--seconds", str(seconds), "--trace", str(trace)])
    return run.measure(args, root, device="cpu")


def test_the_cell_is_found_by_name():
    c = cellmod.find_cell(CELL)
    assert c.judge == "gamepiece" and c.chips == 1
    assert c.traffic["driver"] == "gamepiece"
    assert c.traffic["batch"] == 4 and c.traffic["in_flight"] == 2
    assert {m["name"] for m in c.end_to_end} == {"latency_p95_ms",
                                                 "setup_s"}
    judge = cellmod.load_module("judges", c.judge)
    assert set(c.limits) <= set(judge.NUMBERS)
    for k in ("missed_clear", "extra_clear", "empty_answers",
              "nms_mismatch"):
        assert c.limits[k] == 0


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_cell_runs_and_is_correct(gp_root, trace):
    out = measure(gp_root, trace)
    res, notes = out["result"], out["notes"]
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert res["attempted"] > 0 and notes["raw_answers"] == 4
    r = notes["readings"]
    assert r["nms_mismatch"] == 0 and r["raw_box_px"] < 0.5
    if trace:
        m = res["metrics"]
        for name in ("gamepiece.span_ms", "gamepiece.forward_ms",
                     "gamepiece.nms_ms", "gamepiece.mfu",
                     "loop.frames_per_s", "loop.latency_p50_ms"):
            assert m[name]["value"] > 0, name
        assert m["gamepiece.span_ms"]["value"] >= \
            m["gamepiece.forward_ms"]["value"] + m["gamepiece.nms_ms"][
                "value"]
    else:
        assert {"latency_p95_ms", "setup_s"} <= set(res["metrics"])
    json.dumps(res)


def _break(monkeypatch, fault):
    from ros_vision_tpu_torch.models import infer
    detect_packed = infer.ModelInference.detect_packed

    def broken(self, frames, with_raw=False):
        packed, raw = detect_packed(self, frames, True)
        packed = packed.clone()
        valid = packed[..., 6] > 0.5
        if fault == "box":
            packed[..., 0] += 3.0
        elif fault == "score":
            packed[..., 4] += 0.02
        elif fault == "drop":
            for r in range(packed.shape[0]):
                packed[r, int(valid[r].nonzero()[0]), 6] = 0.0
        elif fault == "swap":
            packed[[0, 1]] = packed[[1, 0]].clone()
        return (packed, raw) if with_raw else packed
    monkeypatch.setattr(infer.ModelInference, "detect_packed", broken)


@pytest.mark.parametrize("fault", ["box", "score", "drop", "swap"])
def test_a_broken_timed_path_is_not_correct(gp_root, monkeypatch, fault):
    _break(monkeypatch, fault)
    res = measure(gp_root)["result"]
    assert res["correct"] is False and res["failed"] > 0, res["checks"]


def test_the_control_fails_the_limits(gp_root):
    from benchmark.tools import control
    c = cellmod.find_cell("gp-tiny-pipe", gp_root)
    r = control.readings(c, SEED, gp_root)
    assert r["answers"] == 4 and r["failed_answers"] > 0
    assert any(r["readings"][k] > v for k, v in c.limits.items())


@pytest.mark.card
@pytest.mark.parametrize("with_raw", [False, True])
def test_a_call_makes_no_host_sync_on_the_card(card, with_raw):
    """From the copy in to the packed result, a warm call on the card
    makes no synchronising operation: torch raises on one under
    set_sync_debug_mode("error")."""
    import numpy as np
    import torch
    from benchmark.scenes import gamepieces
    c = cellmod.find_cell(CELL)
    drv = cellmod.load_module("drivers", "gamepiece")
    pool = gamepieces.make(SEED, c.config, c.traffic["scene"])
    node = drv.node_for(c.config, pool.state_dict, torch.device("cuda", 0))
    frames = np.stack(pool.frames[:4])
    for _ in range(3):
        node.unpack(node.process_frames(frames))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = node.process_frames(frames, with_raw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    packed = out[0] if with_raw else out
    assert len(node.unpack(node.fetch(packed))) == 4


@pytest.mark.parametrize("scale,gflops", [("n", 6.5), ("s", 21.5),
                                          ("m", 68.0)])
def test_the_flop_count_reads_the_published_figures(scale, gflops):
    """Ultralytics' YOLO11 table, 640 px, 80 classes."""
    got = flops(scale, 80, 640) / 1e9
    assert abs(got - gflops) <= 0.03 * gflops, got
    # a batch multiplies it; one class trims the class branch
    assert flops(scale, 80, 640, 4) == 4 * flops(scale, 80, 640)
    assert flops(scale, 1, 640) < flops(scale, 80, 640)
