"""loop.frames_per_s: frames whose detections reached the host over the
traced window's "spans" stretch (no sync count, no profiler), over its
seconds. The end-to-end frames_per_s where the host's speed lets the runs
agree; here, in cells whose runs spread too far to bound it, read per
layer. Moves latency_p95_ms."""


def read(summary):
    w = summary.get("spans_window")
    return w["frames_per_s"] if w else None
