"""quadfit.host_ms: host-clock ms a call inside the cluster_and_fit range,
the mean over the calls of the traced window's "spans" stretch (no sync
count, no profiler). Moves latency_p95_ms."""

STAGES = ('quadfit',)


def read(summary):
    have = [s for s in STAGES if s in summary["stages"]]
    calls = [c for c in summary["calls"] if c["stretch"] == "spans"]
    if not have or not calls:
        return None
    return sum(c["host_ms"].get(s, 0.0) for c in calls for s in have) \
        / len(calls)
