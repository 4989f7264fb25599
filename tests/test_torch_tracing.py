"""The port's stage taps and check mode
(ros_vision_tpu_torch/utils/tracing.py) against the JAX package's
(ros_vision_tpu/utils/tracing.py) on the CPU, at the 320x160 scene of
tests/test_tracing_tools.py.

Tolerances: threshold, CCL labels, sizes and ranks and the boundary
key/pack2/counts bit-exact (integer outputs of the same algorithm);
ids, hamming and rotations exact; corners within 2e-3 px and poses within
1 mm (float sums and atan2/cos/sin round differently in XLA and PyTorch);
every other float tap within the f32 noise stated at its assert."""
import dataclasses

import numpy as np
import pytest

from ros_vision_tpu.apriltag.detector import DetectorConfig as JaxConfig
from ros_vision_tpu.apriltag.detector import TPUDetector
from ros_vision_tpu.apriltag.render import render_scene, simple_square_corners
from ros_vision_tpu.utils import tracing as jtracing
from ros_vision_tpu_torch.apriltag.detector import (TorchDetector,
                                                    config_from_jax)
from ros_vision_tpu_torch.utils import tracing

W, H = 320, 160
EXACT = ("decimated", "threshim", "labels", "sizes", "ranks", "counts",
         "quad_valid", "n_quads", "ok")


def _scene():
    corners = [simple_square_corners(80, 60, 34, angle_deg=10),
               simple_square_corners(230, 90, 30, angle_deg=-25)]
    img, _ = render_scene([3, 42], corners, W, H, noise_sigma=1.0, seed=1)
    return img


def _pair(**kw):
    jcfg = JaxConfig(width=W, height=H, max_points=4096, max_segments=64,
                     max_quads=8, fx=300.0, fy=300.0, cx=160.0, cy=80.0,
                     estimate_pose=True, **kw)
    return TPUDetector(jcfg), TorchDetector(
        config_from_jax(dataclasses.asdict(jcfg)), device="cpu")


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def taps(pair):
    jdet, tdet = pair
    img = _scene()
    return (jtracing.stage_taps(jdet, img, check=True),
            tracing.stage_taps(tdet, img, check=True))


def test_tap_keys_match_jax(taps):
    jt, tt = taps
    assert set(tt) == set(jt)
    assert set(tt["pts"]) == set(jt["pts"])
    for k in jt:
        if k != "pts":
            assert tt[k].shape == jt[k].shape, k


@pytest.mark.parametrize("key", EXACT)
def test_integer_taps_bit_exact(taps, key):
    jt, tt = taps
    np.testing.assert_array_equal(tt[key], np.asarray(jt[key]))


@pytest.mark.parametrize("key", ["key", "pack2"])
def test_boundary_points_bit_exact(taps, key):
    jt, tt = taps
    np.testing.assert_array_equal(tt["pts"][key], jt["pts"][key])


@pytest.mark.parametrize("key", ["tag_id", "hamming", "rotation"])
def test_decoded_quads_exact(taps, key):
    """Exact on the accepted quads; a rejected quad's best code sits on
    noise, where f32 rounding may pick another one."""
    jt, tt = taps
    ok = jt["ok"]
    np.testing.assert_array_equal(tt[key][ok], jt[key][ok])


def test_quads_decode_and_pose_match_jax(taps):
    jt, tt = taps
    ok = jt["ok"]
    assert ok[0].sum() == 2
    assert sorted(tt["tag_id"][ok].tolist()) == [3, 42]
    # the accepted quads' corners; a junk quad's fit sits on noise
    assert np.abs(tt["corners"][ok] - jt["corners"][ok]).max() < 2e-3
    assert np.abs(tt["corners_full"][ok] - jt["corners_full"][ok]).max() \
        < 2e-3
    assert np.abs(tt["pose_t"][ok] - jt["pose_t"][ok]).max() < 1e-3
    assert np.abs(tt["pose_R"][ok] - jt["pose_R"][ok]).max() < 1e-3
    # H is normalised by H[2,2] and scales with the corners (~1e2 px)
    assert np.abs(tt["H"][ok] - jt["H"][ok]).max() < 2e-2
    assert np.abs(tt["margin"][ok] - jt["margin"][ok]).max() < 0.5


def test_taps_with_distortion_match_jax():
    jdet, tdet = _pair(dist=(0.06, -0.03, 0.001, -0.0015, 0.0))
    img = _scene()
    jt = jtracing.stage_taps(jdet, img)
    tt = tracing.stage_taps(tdet, img)
    ok = jt["ok"]
    np.testing.assert_array_equal(tt["ok"], ok)
    np.testing.assert_array_equal(tt["tag_id"][ok], jt["tag_id"][ok])
    np.testing.assert_array_equal(tt["hamming"][ok], jt["hamming"][ok])
    assert np.abs(tt["corners_full"][ok] - jt["corners_full"][ok]).max() \
        < 2e-3
    assert np.abs(tt["pose_t"][ok] - jt["pose_t"][ok]).max() < 1e-3


@pytest.mark.parametrize("stage,key,value", [
    ("threshold", "threshim", 5),
    ("ccl", "labels", -1),
    ("boundary", "counts", -1),
    ("decode", "hamming", 3),
])
def test_check_names_the_corrupted_stage(pair, monkeypatch, stage, key,
                                         value):
    _, tdet = pair
    real = tracing._stages

    def corrupted(det):
        out = []
        for name, fn in real(det):
            if name == stage:
                def fn(g, st, _fn=fn):
                    res = dict(_fn(g, st))
                    res[key] = res[key].clone()
                    res[key].view(-1)[0] = value
                    if key == "hamming":
                        res["ok"] = res["ok"].clone()
                        res["ok"].view(-1)[0] = True
                    return res
            out.append((name, fn))
        return out

    monkeypatch.setattr(tracing, "_stages", corrupted)
    with pytest.raises(RuntimeError, match=f"stage '{stage}' invariant"):
        tracing.stage_taps(tdet, _scene(), check=True)
    # without check mode the same corrupted run goes through
    tracing.stage_taps(tdet, _scene(), check=False)

