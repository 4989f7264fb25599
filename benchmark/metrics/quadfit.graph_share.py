"""quadfit.graph_share: the share (%) of the port's cluster_and_fit calls
on a CUDA device that replayed all three of their stages as CUDA graphs,
read from ros_vision_tpu_torch.utils.tracing.RECORDER as
detector.syncs_counted reads `syncs`: each call record counts its
cluster_and_fit calls by how they ran (quadfit_eager, quadfit_captured,
quadfit_replayed), summed over the program's calls inside the "spans"
stretch's harness calls. Absent, never 0, where the records carry no such
counts (a port without the graphs) or no call ran on a CUDA device. Moves
latency_p95_ms."""
from pathlib import Path

from benchmark.harness.cell import load_module

_base = load_module("metrics", "detector.span_ms",
                    Path(__file__).resolve().parents[2])
RUNS = ("quadfit_eager", "quadfit_captured", "quadfit_replayed")


def read(summary):
    calls = _base.program_calls(summary, spans=False)
    if calls is None or any(k not in calls[0] for k in RUNS):
        return None
    runs = sum(c[k] for c in calls for k in RUNS)
    if runs == 0:
        return None
    return 100.0 * sum(c["quadfit_replayed"] for c in calls) / runs
