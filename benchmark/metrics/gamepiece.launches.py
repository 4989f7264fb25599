"""gamepiece.launches: device operations (kernels, copies, memsets) a call
launched from inside the harness's call spans, over the profiled calls:
in the game-piece cell everything GamePieceNode.process_frames enqueues
(the frames' copy in, preprocess, forward, NMS, packing). Moves
latency_p95_ms."""

OUTSIDE = ("outside calls", "unattributed")


def read(summary):
    prof = summary["profile"]
    if prof is None or not prof["calls"] or not prof["device_ops"]:
        return None
    return sum(v["launches"] for k, v in prof["stages"].items()
               if k not in OUTSIDE) / prof["calls"]
