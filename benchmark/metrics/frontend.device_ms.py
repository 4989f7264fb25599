"""frontend.device_ms: device ms a call of the operations launched inside the
threshold and front-end ranges (ops.threshold_kernel, ops.frontend_kernel),
over the profiled calls. Moves latency_p95_ms."""

STAGES = ('threshold', 'frontend')


def read(summary):
    prof = summary["profile"]
    have = [s for s in STAGES if s in summary["stages"]]
    if prof is None or not have or not prof["calls"] \
            or not prof["device_ops"]:
        return None
    got = [prof["stages"][s] for s in have if s in prof["stages"]]
    return sum(g["device_ms"] for g in got) / prof["calls"]
