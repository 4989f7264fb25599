"""The stages' byte and operation counts behind kernels.roofline_share."""
import pytest
import torch

from benchmark.harness import roofline
from benchmark.harness.trace import nbytes


def test_pose_ops_match_chip_smoke():
    # chip_smoke.POSE_OPS at the commit the counts were taken from
    assert roofline.POSE_OPS == 85_800


def test_nbytes_counts_each_tensor_once():
    a = torch.zeros(4, 400, 640, dtype=torch.uint8)
    b = torch.zeros(4, 128, 36)
    assert nbytes(a) == 4 * 400 * 640
    assert nbytes((a, {"k": b}, [b])) == a.numel() + 2 * b.numel() * 4


def test_least_ms_is_the_larger_bound():
    assert roofline.least_ms(3.35e9, 0) == pytest.approx(1.0)
    assert roofline.least_ms(0, 67e9) == pytest.approx(1.0)
    assert roofline.least_ms(3.35e9, 2 * 67e9) == pytest.approx(2.0)


def test_mfu_is_the_share_of_the_bf16_tensor_peak():
    # the data sheet's dense BF16 tensor-core rate (1,979 with sparsity)
    assert roofline.BF16_TENSOR_OPS_S == 989.4e12
    assert roofline.mfu(989.4e9, 1.0) == pytest.approx(100.0)
    assert roofline.mfu(8.7e9, 2.0) == pytest.approx(
        8.7e9 / 2e-3 / 989.4e12 * 100)
    assert roofline.mfu(989.4e9, 4.0) == pytest.approx(25.0)


def test_pose_and_refine_count_only_live_slots():
    H = torch.zeros(2, 8, 3, 3)
    H[:, :3] = torch.eye(3)
    H[0, 2, 0, 0] = float("nan")
    assert roofline.pose_ops(H) == 5 * roofline.POSE_OPS
    c = torch.zeros(2, 8, 4, 2)
    v = torch.zeros(2, 8, dtype=torch.bool)
    v[0, :2] = True
    c[0, 1, 0, 0] = float("inf")
    per = 4 * (roofline.REFINE_EDGE_OPS + roofline.REFINE_MIN_SAMPLES
               * roofline.REFINE_SAMPLE_OPS) + 4 * roofline.REFINE_CORNER_OPS
    assert roofline.refine_ops(c, v) == per


def test_stage_least_ms_means_over_profiled_calls():
    H = torch.eye(3).expand(1, 4, 3, 3)
    calls = [{"profiled": True, "bytes": {"threshold": 3.35e6, "pose": 0},
              "keep": {"pose": H}},
             {"profiled": True, "bytes": {"threshold": 3.35e6}, "keep": {}},
             {"profiled": False, "bytes": {"threshold": 1e12}, "keep": {}}]
    least = roofline.stage_least_ms(calls)
    assert least["threshold"] == pytest.approx(1e-3)
    assert least["pose"] == pytest.approx(
        4 * roofline.POSE_OPS / 67e12 * 1e3 / 2)
    assert "frontend" not in least
