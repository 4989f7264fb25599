"""quadfit.launches: device operations a call launched inside the
cluster_and_fit range (ops.quadfit), over the profiled calls. Moves
latency_p95_ms."""

STAGES = ('quadfit',)


def read(summary):
    prof = summary["profile"]
    have = [s for s in STAGES if s in summary["stages"]]
    if prof is None or not have or not prof["calls"] \
            or not prof["device_ops"]:
        return None
    got = [prof["stages"][s] for s in have if s in prof["stages"]]
    return sum(g["launches"] for g in got) / prof["calls"]
