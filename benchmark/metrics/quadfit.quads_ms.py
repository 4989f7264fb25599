"""quadfit.quads_ms: host ms a call in the port's `quadfit.quads` span
(cluster_and_fit's 45 pair fits, 210 combos, corners and slots by area),
read from ros_vision_tpu_torch.utils.tracing.RECORDER as detector.span_ms
reads the `detector` span (the program's calls inside the "spans"
stretch's harness calls; absent, never 0, where there are none). Moves
latency_p95_ms."""
from pathlib import Path

from benchmark.harness.cell import load_module

_base = load_module("metrics", "detector.span_ms",
                    Path(__file__).resolve().parents[2])

NAMES = ('quadfit.quads',)


def read(summary):
    return _base.span_ms(summary, NAMES)
