"""detector.span_ms: host ms a call of the port's own `detector` span
(TorchDetector._detect_device, with pack_outputs through
detect_raw_packed), read from ros_vision_tpu_torch.utils.tracing.RECORDER:
the mean over the program's call records that lie inside a harness call of
the traced window's "spans" stretch (no sync count, no profiler). Absent,
never 0, where the port keeps no recorder or it holds nothing, or where
its rings no longer hold the stretch's first call. Moves latency_p95_ms.

The port's other span and counter readers (detector.syncs_counted,
detector.sync_wait_ms, quadfit.*_ms, decode.span_ms) take their calls
from program_calls here."""
import bisect

NAMES = ("detector",)


def program_calls(summary, spans: bool = True):
    """The recorder's call records inside the "spans" stretch's harness
    calls, oldest first, or None (see the module's docstring); with
    `spans`, None also where the span ring lost the first call's spans."""
    try:
        from ros_vision_tpu_torch.utils import tracing
    except ImportError:
        return None
    recorder = getattr(tracing, "RECORDER", None)
    harness = sorted(tuple(c["ns"]) for c in summary["calls"]
                     if c["stretch"] == "spans")
    if recorder is None or not harness:
        return None
    held = recorder.calls()
    if not held or held[0]["t0_ns"] > harness[0][1]:
        return None             # what lay inside the first call is gone
    starts = [h[0] for h in harness]
    out = []
    for c in held:
        i = bisect.bisect_right(starts, c["t0_ns"]) - 1
        if i >= 0 and c["t1_ns"] <= harness[i][1]:
            out.append(c)
    if not out or (spans and out[0]["spans"] is None):
        return None
    return out


def span_ms(summary, names):
    """Mean host ms a call inside the spans named `names`."""
    calls = program_calls(summary)
    if calls is None:
        return None
    ns = sum(t1 - t0 for c in calls for n in names
             for t0, t1 in c["spans"].get(n, ()))
    return ns / len(calls) / 1e6


def read(summary):
    return span_ms(summary, NAMES)
