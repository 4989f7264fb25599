"""decode.span_ms: host ms a call in the port's `decode.screen`,
`decode.refine` and `decode.tail` spans (the screen's decode_quads,
refine_edges, the tail's decode_quads), read from
ros_vision_tpu_torch.utils.tracing.RECORDER as detector.span_ms reads the
`detector` span (the program's calls inside the "spans" stretch's harness
calls; absent, never 0, where there are none). Moves
latency_p95_ms."""
from pathlib import Path

from benchmark.harness.cell import load_module

_base = load_module("metrics", "detector.span_ms",
                    Path(__file__).resolve().parents[2])

NAMES = ('decode.screen', 'decode.refine', 'decode.tail')


def read(summary):
    return _base.span_ms(summary, NAMES)
