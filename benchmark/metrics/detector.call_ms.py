"""detector.call_ms: the harness's host span around each detector call
(detect_raw_packed, or VisionNode.submit in the served loop), the mean over
the calls of the traced window's "spans" stretch (no sync count, no
profiler). Moves latency_p95_ms."""


def read(summary):
    ms = [c["ms"] for c in summary["calls"] if c["stretch"] == "spans"]
    return sum(ms) / len(ms) if ms else None
