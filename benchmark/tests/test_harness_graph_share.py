"""The readers of the port's CUDA-graph counts, quadfit.graph_share and
decode.graph_share, on a synthetic recorder: replayed calls of the layer
over all of them on a CUDA device, in %, over the "spans" stretch's
program calls; absent, never 0, where none ran on a CUDA device or the
records lack the layer's counts (a port without its graphs)."""
import time

import pytest
from conftest import ROOT

from benchmark.harness.cell import load_module


def _summary(bounds, stretch="spans"):
    return {"calls": [{"ns": list(b), "stretch": stretch} for b in bounds]}


@pytest.mark.parametrize("layer", ["quadfit", "decode"])
def test_graph_share_reader(layer, monkeypatch):
    from ros_vision_tpu_torch.device import HostSyncs
    from ros_vision_tpu_torch.utils import tracing
    rec = tracing.Recorder(span_slots=256, call_slots=64)
    monkeypatch.setattr(tracing, "RECORDER", rec)
    reader = load_module("metrics", f"{layer}.graph_share", ROOT)
    other = "decode" if layer == "quadfit" else "quadfit"
    s = HostSyncs()

    def calls(runs):
        out = []
        for how in runs:
            t0 = time.time_ns()
            with tracing.Call(s):
                if how is not None:
                    rec.graph_run(layer, how)
                rec.graph_run(other, 0)       # the other layer's count
            out.append((t0, time.time_ns()))
        return out

    assert reader.read(_summary(calls([None] * 3))) is None
    bounds = calls([0, 1, 2, 2, None, 2])
    assert [tuple(c[f"{layer}_{k}"] for k in tracing.GRAPH_RUNS)
            for c in rec.calls()[-6:]] == \
        [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 1), (0, 0, 0), (0, 0, 1)]
    assert reader.read(_summary(bounds)) == pytest.approx(60.0)
    assert reader.read(_summary(bounds[2:])) == pytest.approx(100.0)
    assert reader.read(_summary(bounds, "syncs")) is None
    real = rec.calls
    monkeypatch.setattr(rec, "calls", lambda *a: [
        {k: v for k, v in c.items() if not k.startswith(layer + "_")}
        for c in real(*a)])
    assert reader.read(_summary(bounds)) is None
