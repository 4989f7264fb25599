"""decode.graph_share: the share (%) of the port's decode_quads calls on a
CUDA device that replayed their body as a CUDA graph, read from
ros_vision_tpu_torch.utils.tracing.RECORDER as quadfit.graph_share reads
cluster_and_fit's: each call record counts its decode_quads calls by how
they ran (decode_eager, decode_captured, decode_replayed), summed over
the program's calls inside the "spans" stretch's harness calls. Absent,
never 0, where the records carry no such counts (a port without the
decode graph) or no call ran on a CUDA device. Moves latency_p95_ms."""
from pathlib import Path

from benchmark.harness.cell import load_module

_base = load_module("metrics", "detector.span_ms",
                    Path(__file__).resolve().parents[2])
RUNS = ("decode_eager", "decode_captured", "decode_replayed")


def read(summary):
    calls = _base.program_calls(summary, spans=False)
    if calls is None or any(k not in calls[0] for k in RUNS):
        return None
    runs = sum(c[k] for c in calls for k in RUNS)
    if runs == 0:
        return None
    return 100.0 * sum(c["decode_replayed"] for c in calls) / runs
