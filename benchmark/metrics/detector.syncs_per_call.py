"""detector.syncs_per_call: synchronising CUDA operations in a call, counted
under torch.cuda.set_sync_debug_mode("warn") (warnings always shown), the
mean over the calls of the traced window's "syncs" stretch, the only one
in which the count is on. Counts the hidden uploads (memcpy_and_sync)
that the port's own HostSyncs misses. Moves latency_p95_ms."""


def read(summary):
    calls = [c for c in summary["calls"] if c["stretch"] == "syncs"]
    if not calls or not summary["cuda"]:
        return None
    return sum(c["syncs"] for c in calls) / len(calls)
