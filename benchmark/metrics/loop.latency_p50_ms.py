"""loop.latency_p50_ms: the median hand-off-to-result latency over every
frame delivered in the traced window's "spans" stretch (no sync count, no
profiler). The end-to-end latency_p50_ms where the host's speed lets the
runs agree; here, in cells whose runs spread too far to bound it, read
per layer. Moves latency_p95_ms."""


def read(summary):
    w = summary.get("spans_window")
    return w["latency_p50_ms"] if w else None
