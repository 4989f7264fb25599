"""spin.loop_ms: launch.VisionSystem.spin's loop time a batch over the
window, from its own spin_stats (pull + upload + submit + consume ms over
batches). Moves frames_per_s."""


def read(summary):
    return summary["layers"].get("spin_loop_ms")
