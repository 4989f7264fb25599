"""detector.syncs_counted: synchronising operations a call as the port
counts them itself (device.HostSyncs: `.item()` reads and constant-table
uploads, each added to the call record's `syncs`), read from
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
    return sum(c["syncs"] for c in calls) / len(calls)
