"""device.idle_share: % of the traced window in which no operation ran on
the card (1 - the union of device-op intervals over the window). Moves
latency_p95_ms."""


def read(summary):
    prof = summary["profile"]
    if prof is None or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
