"""The end-to-end arithmetic: rates and percentiles over every frame of the
window, and the spread that sets a bound."""
from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) of all `values`, interpolated between
    the two nearest ranks (numpy's default, "linear"). Never taken from
    medians of chunks."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def window_metrics(records, t0: float, t1: float) -> dict:
    """frames_per_s and the latency percentiles of the frames whose result
    reached the consumer in [t0, t1]. records: (start s, result s) pairs on
    one clock; latency is result - start."""
    lat_ms = [(r - s) * 1e3 for s, r in records if t0 <= r <= t1]
    if not lat_ms:
        raise RuntimeError("no frame reached the consumer in the window")
    return {"frames_per_s": len(lat_ms) / (t1 - t0),
            "latency_p50_ms": percentile(lat_ms, 50),
            "latency_p95_ms": percentile(lat_ms, 95),
            "frames": len(lat_ms)}


def spread(values) -> float:
    """The distance between the first and third quartile as a share of the
    median (statistics.quantiles, n=4)."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
