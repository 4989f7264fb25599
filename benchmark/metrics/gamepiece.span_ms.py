"""gamepiece.span_ms: host ms a call of the port's own `gamepiece` span
(ModelInference.detect_packed through GamePieceNode.process_frames:
staging, preprocess, forward, NMS and packing), read from
ros_vision_tpu_torch.utils.tracing.RECORDER: the mean over the program's
game-piece call records that lie inside a harness call of the traced
window's "spans" stretch (no sync count, no profiler). Absent, never 0,
where the port records no such call. Moves latency_p95_ms.

The other game-piece readers take their calls from gamepiece_calls
here."""
from pathlib import Path

from benchmark.harness.cell import load_module

_base = load_module("metrics", "detector.span_ms",
                    Path(__file__).resolve().parents[2])

NAMES = ("gamepiece",)


def gamepiece_calls(summary):
    """The recorder's game-piece call records inside the "spans"
    stretch's harness calls, or None."""
    calls = _base.program_calls(summary)
    if calls is None:
        return None
    calls = [c for c in calls if "gamepiece" in c["spans"]]
    return calls or None


def span_ms(summary, names):
    """Mean host ms a game-piece call inside the spans named `names`."""
    calls = gamepiece_calls(summary)
    if calls is None:
        return None
    ns = sum(t1 - t0 for c in calls for n in names
             for t0, t1 in c["spans"].get(n, ()))
    return ns / len(calls) / 1e6


def read(summary):
    return span_ms(summary, NAMES)
