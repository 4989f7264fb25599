"""decode.launches: device operations a call launched inside the screen
decode, refine_edges and tail decode ranges (ops.decode), over the
profiled calls. Moves latency_p95_ms."""

STAGES = ('decode', 'refine')


def read(summary):
    prof = summary["profile"]
    have = [s for s in STAGES if s in summary["stages"]]
    if prof is None or not have or not prof["calls"] \
            or not prof["device_ops"]:
        return None
    got = [prof["stages"][s] for s in have if s in prof["stages"]]
    return sum(g["launches"] for g in got) / prof["calls"]
