"""The port's YOLO output parsing + NMS (ros_vision_tpu_torch/ops/nms.py)
against the JAX package's (ros_vision_tpu/ops/nms.py) on seeded raw
tensors: every output equal slot for slot (tolerance: none)."""
import numpy as np
import pytest
import jax.numpy as jnp

from ros_vision_tpu.ops import nms as jnms
from ros_vision_tpu_torch.ops import nms as tnms
from tests.torch_port_helpers import n, t

P = 600


def raw_batch(kind: str, seed: int, b: int = 3, nc: int = 3) -> np.ndarray:
    """(b, 4+nc, P) f32 raw model output. Boxes are continuous (no IoU lands
    on the 0.45 threshold); scores on a 1/20 grid, so equal scores are
    common, as they are after the 0.25 cut and sigmoid saturation."""
    rng = np.random.default_rng(seed)
    raw = np.empty((b, 4 + nc, P), np.float32)
    # boxes cluster around a few centres so that many overlap
    centres = rng.uniform(40, 600, (b, 6, 2))
    pick = rng.integers(0, 6, (b, P))
    cxy = np.take_along_axis(centres, pick[..., None], 1) \
        + rng.normal(0, 12, (b, P, 2))
    raw[:, 0:2] = cxy.transpose(0, 2, 1)
    raw[:, 2:4] = rng.uniform(8, 90, (b, 2, P))
    scores = np.round(rng.random((b, nc, P)) * 20) / 20
    if kind == "below":
        scores[1] *= 0.24                    # row 1: nothing reaches 0.25
    elif kind == "saturated":
        scores[:, :, ::3] = 1.0              # many exact 1.0 ties
    elif kind == "duplicates":
        raw[:, :4, 1::2] = raw[:, :4, 0:-1:2]    # pairs of identical boxes
    raw[:, 4:] = scores
    return raw


def _jax(raw, k):
    out = jnms.parse_and_nms(jnp.asarray(raw), max_detections=k)
    return {name: n(v) for name, v in out.items()}


def _port(raw, k):
    out = tnms.parse_and_nms(t(raw), max_detections=k)
    return {name: n(v) for name, v in out.items()}


@pytest.mark.parametrize("k", [100, 8])
@pytest.mark.parametrize("kind", ["plain", "below", "saturated",
                                  "duplicates"])
def test_parse_and_nms_matches_jax(kind, k):
    raw = raw_batch(kind, seed=len(kind) * 7 + k)
    want, got = _jax(raw, k), _port(raw, k)
    for name in ("valid", "classes", "scores", "boxes"):
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert want["valid"].shape == (3, k)
    if kind == "below":
        assert not want["valid"][1].any() and want["valid"][0].any()
    if k == 100:
        # the greedy pass did suppress: fewer kept than candidates in
        # every row that has candidates
        cand = (want["scores"] > 0).sum(1)
        kept = want["valid"].sum(1)
        assert ((kept < cand) | (cand == 0)).all() and cand.any()


def test_ties_keep_the_lower_index_first():
    """lax.top_k puts the lower index first among equal scores; torch.topk
    does not. [.9, .5, .9, .9, .1] keeps slots 0, 2, 3 in that order."""
    raw = np.zeros((1, 5, 5), np.float32)
    raw[0, 0] = np.arange(5) * 200.0         # far apart: nothing suppressed
    raw[0, 1] = 10.0
    raw[0, 2:4] = 20.0
    raw[0, 4] = [.9, .5, .9, .9, .1]
    want, got = _jax(raw, 3), _port(raw, 3)
    np.testing.assert_array_equal(got["boxes"][0, :, 0], [0., 400., 600.])
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_iou_matrix_matches_jax():
    boxes = raw_batch("plain", seed=5)[:, :4, :64].transpose(0, 2, 1).copy()
    want = n(jnms._iou_matrix(jnp.asarray(boxes)))
    got = n(tnms._iou_matrix(t(boxes)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_more_slots_than_anchors_raise_as_in_jax():
    raw = raw_batch("plain", seed=1)[:, :, :50].copy()
    with pytest.raises(ValueError):
        jnms.parse_and_nms(jnp.asarray(raw), max_detections=100)
    with pytest.raises(ValueError):
        tnms.parse_and_nms(t(raw), max_detections=100)


def test_scale_boxes_matches_jax():
    boxes = raw_batch("plain", seed=2)[:, :4, :10].transpose(0, 2, 1).copy()
    want = n(jnms.scale_boxes(jnp.asarray(boxes), (640, 640), (1280, 800)))
    got = n(tnms.scale_boxes(t(boxes), (640, 640), (1280, 800)))
    np.testing.assert_array_equal(got, want)
