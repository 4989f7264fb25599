"""detector.sync_wait_ms: host ms a call spent inside the port's
synchronising operations (device.HostSyncs: `.item()` reads and
constant-table uploads, the call record's `sync_ns`), read from
ros_vision_tpu_torch.utils.tracing.RECORDER: the mean over the program's
calls inside the "spans" stretch's harness calls (absent, never 0, where
there are none). Moves latency_p95_ms."""
from pathlib import Path

from benchmark.harness.cell import load_module

_base = load_module("metrics", "detector.span_ms",
                    Path(__file__).resolve().parents[2])


def read(summary):
    calls = _base.program_calls(summary, spans=False)
    if calls is None:
        return None
    return sum(c["sync_ns"] for c in calls) / len(calls) / 1e6
