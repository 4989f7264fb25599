"""gamepiece.mfu: the share (%) of the card's BF16 tensor-core peak
(benchmark/harness/roofline.BF16_TENSOR_OPS_S) that a whole game-piece
call reaches: the forward's floating-point operations a call (the
driver's layers, `gamepiece_flops`: benchmark/reference/yolo11_flops.py,
2 x the multiply-adds of every convolution and of attention's two
products, at the call's batch) over gamepiece.span_ms, through
roofline.mfu. Absent, never 0, where either is missing. Moves
latency_p95_ms."""
from pathlib import Path

from benchmark.harness import roofline
from benchmark.harness.cell import load_module

_span = load_module("metrics", "gamepiece.span_ms",
                    Path(__file__).resolve().parents[2])


def read(summary):
    flops = summary["layers"].get("gamepiece_flops")
    ms = _span.read(summary)
    if not flops or not ms:
        return None
    return roofline.mfu(flops, ms)
