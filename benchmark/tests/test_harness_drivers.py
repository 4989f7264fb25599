"""Both traffic drivers, through run.py's whole run at tiny sizes on the
CPU (the port's plain paths): the result line's schema, `correct`, and the
traced run's per-call records."""
import json

import pytest

from benchmark import run

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(root, cell, trace, seconds=4.0, seed=2 ** 31 + 101):
    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds",
                      str(seconds), "--trace", str(trace)])
    return run.measure(args, root, device="cpu")


def _schema(res, names):
    keys = list(res)
    assert keys[:5] == RESULT_KEYS and keys[-1] == "checks"
    assert isinstance(res["correct"], bool)
    assert res["attempted"] > 0 and res["failed"] >= 0
    assert set(res["metrics"]) <= set(names)
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    json.dumps(res)


@pytest.mark.parametrize("cell", ["tiny-sync", "tiny-pipe", "tiny-stream"])
def test_untraced_run(tiny_root, cell):
    from benchmark.harness.cell import find_cell
    c = find_cell(cell, tiny_root)
    out = _run(tiny_root, cell, 0)
    res = out["result"]
    _schema(res, [m["name"] for m in c.end_to_end])
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {m["name"] for m in c.end_to_end}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["metrics"]["latency_p95_ms"]["value"] >= \
        res["metrics"]["latency_p50_ms"]["value"]
    assert "breakdown" not in res


@pytest.mark.parametrize("cell", ["tiny-pipe", "tiny-stream"])
def test_traced_run_records_every_call(tiny_root, cell):
    from benchmark.harness.cell import find_cell
    c = find_cell(cell, tiny_root)
    out = _run(tiny_root, cell, 1, seconds=6.0)
    res = out["result"]
    _schema(res, [m["name"] for m in c.per_layer])
    assert res["correct"], res["checks"]
    calls = out["notes"]["calls"]
    n = sum(calls["route"].values())
    assert n > 0 and calls["route"] == {"flood": n}
    assert sum(calls["width"].values()) == n == sum(calls["slots"].values())
    # the host-clock metrics come from the spans stretch alone; the
    # instruments' cost is noted stretch by stretch
    cost = out["notes"]["instruments"]
    assert cost["calls.spans"] > 0 and cost["call_ms.spans"] > 0
    assert cost["calls.spans"] + cost["calls.syncs"] + \
        cost["calls.profile"] <= n
    assert {"detector.call_ms", "quadfit.host_ms",
            "decode.host_ms"} <= set(res["metrics"])
    # no device trace on the CPU: its metrics are absent, never 0
    assert not {"frontend.device_ms", "quadfit.launches",
                "kernels.roofline_share",
                "device.idle_share"} & set(res["metrics"])
    if cell == "tiny-stream":
        assert {"spin.loop_ms", "node.publish_dropped_share",
                "spin.latency_p95_ms"} <= set(res["metrics"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_in_flight_two_reads_each_result_after_the_next_call(tiny_root,
                                                              monkeypatch):
    """At in_flight 2 a call's result is read once two newer calls are
    queued, as spin keeps them at depth 2; at 0 before the next goes in."""
    from ros_vision_tpu_torch.apriltag.detector import TorchDetector
    for cell, lag in (("tiny-pipe", 2), ("tiny-sync", 0)):
        events = []
        detect, unpack = TorchDetector.detect_raw_packed, TorchDetector.unpack

        def rec_detect(self, *a, **kw):
            out = detect(self, *a, **kw)
            events.append(("call", id(out)))
            return out

        def rec_unpack(self, out):
            events.append(("read", id(out)))
            return unpack(self, out)
        monkeypatch.setattr(TorchDetector, "detect_raw_packed", rec_detect)
        monkeypatch.setattr(TorchDetector, "unpack", rec_unpack)
        _run(tiny_root, cell, 0, seconds=4.0)
        monkeypatch.undo()
        at, between, ncalls = {}, [], 0
        for kind, key in events:
            if kind == "call":
                at[key] = ncalls
                ncalls += 1
            else:
                between.append(ncalls - 1 - at.pop(key))
        # every result is read once `lag` newer calls are queued, and never
        # later; fewer only as the queue drains at the window's end
        assert max(between) == lag
        assert between.count(lag) >= 2
        assert lag or set(between) == {0}
