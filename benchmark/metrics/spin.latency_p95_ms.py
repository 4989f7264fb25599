"""spin.latency_p95_ms: the 95th percentile of capture-to-NT4 latency over
every frame delivered in the traced window's "spans" stretch (no sync
count, no profiler). The served loop runs above its capacity (the cameras
offer 400 frames/s, the rings shed what it cannot take), so its tail
swings with the loop's speed and is read here, beside the end-to-end
frames_per_s and median. Moves latency_p50_ms."""


def read(summary):
    w = summary.get("spans_window")
    return w["latency_p95_ms"] if w else None
