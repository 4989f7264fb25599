"""kernels.roofline_share: % of the device time of the stages that
hand-written kernels carry (threshold, front end, refine, pose) that their
least time would take: the stages' least time (benchmark/harness/
roofline.py: bytes over HBM's rate or f32 operations over the cores',
from each stage's inputs and outputs) over their device ms, both a call,
over the profiled calls. Moves latency_p95_ms."""
from benchmark.harness.roofline import KERNEL_STAGES


def read(summary):
    prof = summary["profile"]
    least = summary["least_ms"]
    have = [s for s in KERNEL_STAGES if s in least
            and s in (prof or {}).get("stages", {})]
    if not have or not prof["calls"]:
        return None
    device_ms = sum(prof["stages"][s]["device_ms"] for s in have) \
        / prof["calls"]
    if device_ms <= 0:
        return None
    return 100.0 * sum(least[s] for s in have) / device_ms
