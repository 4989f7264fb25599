"""gamepiece.forward_ms: host ms a call in the port's `gamepiece.forward`
span (ModelInference.forward: the YOLO11 forward on the card, bf16
convolutions), read from
ros_vision_tpu_torch.utils.tracing.RECORDER as gamepiece.span_ms reads
the `gamepiece` span (absent, never 0, where there are none). Moves
latency_p95_ms."""
from pathlib import Path

from benchmark.harness.cell import load_module

_base = load_module("metrics", "gamepiece.span_ms",
                    Path(__file__).resolve().parents[2])

NAMES = ("gamepiece.forward",)


def read(summary):
    return _base.span_ms(summary, NAMES)
