"""Tests of the benchmark's harness. They run on the CPU with the port's
plain paths at tiny sizes; a test marked `card` runs a cell on an NVIDIA
card and is skipped, by its fixture, where there is none:

    python3 -m pytest benchmark/tests -q            # here
    python3 -m pytest benchmark/tests -q -m card    # on the card
"""
import json
import os
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the tests' runs share the host with each other (pytest -n): one thread
# each for the CPU libraries, here and in the processes they start
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"


def pytest_configure(config):
    import torch
    torch.set_num_threads(1)
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skipped without one)")


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is there (decided when the test
    runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this host has none")
    return torch.device("cuda", 0)


TINY_CONFIG = {"width": 640, "height": 400, "fx": 450.0, "fy": 450.0,
               "cx": 320.0, "cy": 200.0}


LOOP_METRICS = [
    ("spin.loop_ms", "ms", "lower", "program_counter",
     "launch.VisionSystem.spin", "frames_per_s"),
    ("spin.latency_p95_ms", "ms", "lower", "host_clock",
     "launch.VisionSystem.spin", "latency_p50_ms"),
    ("node.publish_dropped_share", "%", "lower", "program_counter",
     "runtime.vision_node", "frames_per_s"),
]


def make_tiny_root(tmp: Path) -> Path:
    """A copy of the benchmark under `tmp` with tiny cells added as new
    files and entries only: config `tiny` (640x400), cells `tiny-stream`
    (2 cameras at 20 fps), `tiny-sync` (detector, batch 1, in_flight 0)
    and `tiny-pipe` (detector, batch 2, in_flight 2)."""
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp / "benchmark"
    cfg = json.loads((b / "configs" / "tag36h11-1280x800.json").read_text())
    cfg.update(TINY_CONFIG)
    (b / "configs" / "tiny.json").write_text(json.dumps(cfg))
    manifest["configs"].append({"name": "tiny", "source": "tests",
                                "file": "benchmark/configs/tiny.json",
                                "reduced": ["width", "height"],
                                "why": "tests"})
    scene = {"generator": "tags3d", "frames": 4,
             "tags_per_frame": [1, 2, 1, 2], "distance_m": [0.5, 1.5],
             "tilt_deg": 30, "noise_sigma": 1.0}
    mixes = {
        "tiny-stream": {"driver": "stream", "cameras": 2, "fps": 20,
                        "frames_per_camera": 2, "warmup_batches": 4,
                        "scene": scene},
        "tiny-sync": {"driver": "detector", "batch": 1, "in_flight": 0,
                      "warmup_calls": 1, "scene": scene},
        "tiny-pipe": {"driver": "detector", "batch": 2, "in_flight": 2,
                      "warmup_calls": 1, "scene": scene},
    }
    stream_limits = json.loads((b / "workloads" /
                                "tag800-s075-stream-4cam.json")
                               .read_text())["limits"]
    limits = {k: v for k, v in stream_limits.items() if k != "robot_m"}
    for name, mix in mixes.items():
        (b / "traffic" / f"{name}.json").write_text(json.dumps(mix))
        lim = stream_limits if mix["driver"] == "stream" else limits
        (b / "workloads" / f"{name}.json").write_text(
            json.dumps({"limits": lim}))
        manifest["workloads"].append({"name": name, "config": "tiny",
                                      "traffic": name, "chips": 1,
                                      "why": "tests"})
        for m in manifest["end_to_end"]:
            if "workloads" in m:
                m["workloads"].append(name)
        for m in manifest["per_layer"]:
            if mix["driver"] == "stream" or not m["name"].startswith(
                    ("spin.", "node.")):
                m["workloads"].append(name)
    # the served loop's own readers, as the stream cell's entries bring them
    have = {m["name"] for m in manifest["per_layer"]}
    for name, unit, better, source, layer, moves in LOOP_METRICS:
        if name not in have:
            manifest["per_layer"].append({
                "name": name, "unit": unit, "better": better,
                "source": source, "layer": layer, "moves": moves,
                "workloads": ["tiny-stream"]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return tmp


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("bench"))
