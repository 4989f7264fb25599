"""The port's bench (ros_vision_tpu_torch/bench.py) on the CPU: one tiny
sweep with streaming off writes every key that bench.py writes (read from
bench.py's source), plus the port's own, and SIGTERM in the middle of the
sweep still leaves a parseable record as the last line of its output."""
import ast
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# error markers and the JAX bench's in-sweep holder, which it clears before
# its record is built; the port keeps "sweep" current instead
NOT_RECORD_KEYS = {"bench_error", "streaming_error", "sweep_partial"}


def bench_py_keys() -> set:
    """Every key that bench.py writes into its record: subscript stores
    and setdefault calls on its record dicts, and the keys of the dicts
    it passes to their update()."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    keys = set()
    records = {"out", "rec", "PARTIAL"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Subscript) and \
                isinstance(node.ctx, ast.Store) and \
                isinstance(node.value, ast.Name) and \
                node.value.id in records and \
                isinstance(node.slice, ast.Constant):
            keys.add(node.slice.value)
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id in records:
            if node.func.attr == "update":
                for arg in node.args:
                    if isinstance(arg, ast.Dict):
                        keys.update(k.value for k in arg.keys)
            elif node.func.attr == "setdefault":
                keys.add(node.args[0].value)
    return keys - NOT_RECORD_KEYS


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2",
               BENCH_STREAMING="0", **kw)
    env.pop("BENCH_GOLDEN_PHOTO", None)
    return env


def test_bench_py_keys_found():
    keys = bench_py_keys()
    assert {"metric", "value", "tags_ok", "sweep", "active_config",
            "p50_latency_ms", "golden_1080p_ms_per_frame",
            "streaming_fps_per_camera", "e2e_p95_ms"} <= keys


def test_bench_record_on_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "ros_vision_tpu_torch.bench", "--device",
         "cpu"], cwd=ROOT, env=_env(BENCH_BATCHES="1", BENCH_ITERS="1"),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(rec) >= bench_py_keys()
    assert rec["tags_ok"] is True
    assert rec["backend"] == "torch-cpu"
    assert rec["device"] == {"name": "cpu", "power_limit": None}
    assert rec["best_batch"] == 1 and set(rec["sweep"]) == {"1"}
    assert rec["value"] == rec["sweep"]["1"]["fps"] > 0
    assert rec["p50_latency_ms"] == rec["sweep"]["1"]["latency_ms"]
    assert rec["b1_sync_roundtrip_ms"] > 0
    assert set(rec["stage_ms"]) == {"1", "4"}
    assert list(rec["stage_ms"]["1"]) == ["threshold", "ccl", "boundary",
                                          "quadfit", "refine", "decode",
                                          "pose"]
    assert rec["active_config"]["ccl"] == "K2 rank_image"
    assert rec["streaming_fps_per_camera"] is None
    assert rec["streaming_skipped"] == "BENCH_STREAMING=0"
    assert rec["golden_1080p_ms_per_frame"] is None
    assert rec["golden_1080p_skipped"].startswith("photo absent")
    assert "bench_error" not in rec


def test_bench_sigterm_mid_sweep_prints_record():
    p = subprocess.Popen(
        [sys.executable, "-m", "ros_vision_tpu_torch.bench", "--device",
         "cpu"], cwd=ROOT, env=_env(BENCH_BATCHES="1,8", BENCH_ITERS="40"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 240
        seen = ""
        while time.time() < deadline:
            line = p.stderr.readline()
            seen += line
            if line.startswith("bench: sweep B=8") or not line:
                break
        assert "bench: sweep B=8" in seen, seen[-3000:]
        p.send_signal(signal.SIGTERM)
        out, _ = p.communicate(timeout=120)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)
    assert p.returncode == 128 + signal.SIGTERM
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["bench_error"].startswith("terminated by SIGTERM")
    assert set(rec["sweep"]) == {"1"}
    assert rec["value"] == rec["sweep"]["1"]["fps"] > 0
    assert rec["tags_ok"] is True
    assert set(rec) >= bench_py_keys()


def test_record_serialises_snapshots(capsys):
    from ros_vision_tpu_torch.bench import KEYS, Record
    rec = Record(metric="m")
    points = {1: {"fps": 1.0}}
    rec.update(sweep=points)
    points[4] = {"fps": 2.0}                 # a later phase's change
    rec.emit()
    first = json.loads(capsys.readouterr().out)
    assert set(first) == set(KEYS)
    assert first["sweep"] == {"1": {"fps": 1.0}} and first["metric"] == "m"
    snap = rec.snapshot()
    snap["sweep"][9] = {}
    assert rec.snapshot()["sweep"] == {1: {"fps": 1.0}}


def test_bench_needs_a_card_by_default():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from ros_vision_tpu_torch import bench
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
