"""Parity of the port's detector tail and of TorchDetector as a whole with
the JAX package on the CPU: decode (ros_vision_tpu_torch/ops/decode.py),
pose (ops/pose.py) and TorchDetector against TPUDetector.

Tolerances: ids, hamming and rotations exact; whole-detector corners
< 0.1 px and pose_t < 1 mm (atan2/cos/sin and float sums round
differently in XLA and PyTorch, which moves fitted lines by ~1e-4 px);
stage outputs from identical inputs within the f32 rounding their
algebra amplifies, stated at each assert.

The whole-detector scenes turn tag 0 of the bench layout by 10 degrees.
An axis-aligned tag's edge points share one row of the boundary lattice,
so its fitted edge sits exactly on the quarter-pixel grid of
refine_edges' samples, and their integer truncation turns a 1e-5 px
difference in the unrefined corner into a whole 0.25 px step. That step
is a property of the algorithm (the JAX package on the CPU and on the TPU
differ the same way), not of the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros_vision_tpu.apriltag.detector import DetectorConfig as JaxConfig
from ros_vision_tpu.apriltag.detector import TPUDetector
from ros_vision_tpu.apriltag.families import get_family
from ros_vision_tpu.ops import decode as jdec
from ros_vision_tpu.ops import pose as jpose
from ros_vision_tpu_torch.apriltag.detector import (
    TPU_BACKEND_SWITCHES, DetectorConfig, TorchDetector, config_from_jax,
    pack_outputs, unpack_outputs)
from ros_vision_tpu_torch.ops import decode as tdec
from ros_vision_tpu_torch.ops import pose as tpose
from tests.torch_port_helpers import bench_frames, n, t

W, H = 640, 400
ANGLES = (10, 20, -35, 50)
INTR = dict(fx=450.0, fy=450.0, cx=320.0, cy=200.0)


@pytest.fixture(scope="module")
def frames():
    return bench_frames(W, H, seeds=(0, 1), angles=ANGLES)


def _pair(**kw):
    jcfg = JaxConfig(width=W, height=H, estimate_pose=True, **INTR, **kw)
    tdet = TorchDetector(config_from_jax(dataclasses.asdict(jcfg)),
                         device="cpu")
    return TPUDetector(jcfg), tdet


@pytest.fixture(scope="module")
def plain_pair():
    return _pair()


@pytest.mark.parametrize("dist", [None, (0.06, -0.03, 0.001, -0.0015, 0.0)])
def test_detector_matches_jax(frames, plain_pair, dist):
    g, _ = frames
    jdet, tdet = plain_pair if dist is None else _pair(dist=dist)
    assert tdet.config.max_points == jdet.config.max_points
    assert tdet._active_points == jdet._active_points
    assert tdet._qcfg.max_boundary_pixels == jdet._qcfg.max_boundary_pixels
    jrows = jdet.detect(g)
    trows = tdet.detect(g)
    for jr, tr in zip(jrows, trows):
        assert sorted(d.tag_id for d in jr) == [0, 42, 100, 311]
        assert [d.tag_id for d in tr] == [d.tag_id for d in jr]
        assert [d.hamming for d in tr] == [d.hamming for d in jr]
        for a, b in zip(jr, tr):
            assert np.abs(a.corners - b.corners).max() < 0.1
            assert np.abs(a.pose_t - b.pose_t).max() < 1e-3
            assert abs(a.decision_margin - b.decision_margin) < 1.0


def test_resolved_sizes_match_jax():
    for w, h in ((1280, 800), (1920, 1080), (640, 400), (320, 160)):
        jdet = TPUDetector(JaxConfig(width=w, height=h))
        tdet = TorchDetector(device="cpu", width=w, height=h)
        assert tdet.config.max_points == jdet.config.max_points
        assert tdet._active_points == jdet._active_points
        for f in dataclasses.fields(tdet._qcfg):
            assert getattr(tdet._qcfg, f.name) == \
                getattr(jdet._qcfg, f.name), f.name
        assert tdet._qcfg.max_boundary_pixels == \
            jdet._qcfg.max_boundary_pixels


def test_config_from_jax_drops_only_backend_switches():
    d = dataclasses.asdict(JaxConfig(width=640, height=400, fx=1.0,
                                     use_fused_frontend=True,
                                     route_compaction=False))
    cfg = config_from_jax(d)
    kept = {f.name for f in dataclasses.fields(cfg)}
    assert kept == set(d) - set(TPU_BACKEND_SWITCHES)
    assert all(getattr(cfg, k) == (tuple(v) if k == "dist" else v)
               for k, v in d.items() if k in kept)


def test_host_api_and_packing(frames):
    g, _ = frames
    det = TorchDetector(device="cpu", width=W, height=H, **INTR)
    s0 = det.host_syncs.count
    raw = det.detect_raw(g)
    # the errs branch, the decode screen's tier and the refine tier (the
    # narrow/wide cluster_and_fit choice exists only where active_points
    # < max_points, i.e. from 1280x800 up)
    assert det._active_points == det.config.max_points
    assert det.host_syncs.count - s0 == 3
    packed = det.detect_raw_packed(g)
    assert tuple(packed.shape) == (2, det.config.max_quads, 36)
    back = unpack_outputs(pack_outputs(raw).numpy())
    for k, v in back.items():
        np.testing.assert_array_equal(v, n(raw[k]).reshape(v.shape)
                                      if k != "ok" else n(raw[k]))
    rows = det.unpack(packed)
    assert [d.tag_id for d in rows[1]] == [0, 42, 100, 311]
    one = det.detect(g[0])
    assert [d.tag_id for d in one] == [d.tag_id for d in rows[0]]
    yuyv = np.zeros((2, H, 2 * W), np.uint8)
    yuyv[..., ::2] = g
    by_yuyv = det.detect_yuyv(yuyv)
    for a, b in zip(by_yuyv, rows):
        assert [d.tag_id for d in a] == [d.tag_id for d in b]
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.corners, y.corners)
    intr = det.default_intrinsics(2)
    assert intr.shape == (2, 9) and intr[0, 0] == INTR["fx"]
    with pytest.raises(ValueError):
        DetectorConfig(width=642, height=400)


def test_family_tables_copied_exactly():
    fam = get_family("tag36h11")
    np.testing.assert_array_equal(jdec.make_code_matrix(fam),
                                  tdec.make_code_matrix(fam))
    jt = jdec._decode_tables(fam)
    tt = tdec._decode_tables(fam)
    for a, b in zip(jax.tree_util.tree_leaves(jt),
                    jax.tree_util.tree_leaves(tt)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(jdec._src_basis_inv(),
                                  tdec._SRC_BASIS_INV)


@pytest.fixture(scope="module")
def tag_quads(frames, plain_pair):
    """Full-res corners (2, 8, 4, 2) and validity of the detector's
    first 8 quad slots, from the JAX pipeline."""
    g, _ = frames
    raw = plain_pair[0].detect_raw(g)
    corners = np.asarray(raw["corners"])[:, :8]
    ok = np.asarray(raw["ok"])[:, :8]
    return g, corners.astype(np.float32), ok


def test_decode_stage(tag_quads):
    g, corners, ok = tag_quads
    fam = get_family("tag36h11")
    cm = jdec.make_code_matrix(fam)
    jd = jdec.decode_quads(jnp.asarray(g), jnp.asarray(corners),
                           jnp.asarray(ok), fam, cm)
    td = tdec.decode_quads(t(g), t(corners), t(ok), fam, t(cm))
    for k in ("ok", "tag_id", "hamming", "rotation"):
        np.testing.assert_array_equal(n(jd[k]), n(td[k]))
    # margins are differences of bilinear samples against fitted border
    # models; H entries are ratios of products of corner coordinates
    np.testing.assert_allclose(n(td["margin"]), n(jd["margin"]), atol=1e-2)
    np.testing.assert_allclose(n(td["H"]), n(jd["H"]), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(
        n(tdec.quad_homographies(t(corners))),
        n(jdec.quad_homographies(jnp.asarray(corners))), rtol=1e-4,
        atol=1e-6)
    np.testing.assert_array_equal(
        n(tdec.adjust_pixel_centers(t(corners))),
        n(jdec.adjust_pixel_centers(jnp.asarray(corners))))


@pytest.mark.parametrize("dist", [None, (0.06, -0.03, 0.001, -0.0015, 0.0)])
def test_refine_stage(tag_quads, dist):
    g, corners, ok = tag_quads
    # perturb the corners off the detector's result so refine has work
    rng = np.random.default_rng(0)
    c0 = (corners + rng.normal(0, 0.6, corners.shape)).astype(np.float32)
    if dist is None:
        jargs, targs = (None, None), (None, None)
    else:
        intr = np.tile(np.array([INTR["fx"], INTR["fy"], INTR["cx"],
                                 INTR["cy"]], np.float32), (2, 1))
        dd = np.tile(np.array(dist, np.float32), (2, 1))
        jargs = (tuple(jnp.asarray(intr[:, i]) for i in range(4)),
                 jnp.asarray(dd))
        targs = (tuple(t(intr[:, i]) for i in range(4)), t(dd))
    want = jdec.refine_edges(jnp.asarray(g), jnp.asarray(c0),
                             jnp.asarray(ok), *jargs)
    got = tdec.refine_edges(t(g), t(c0), t(ok), *targs)
    # from identical inputs only the line fit's atan2/cos/sin rounding
    # differs (sample sets are identical off the quarter-pixel lattice)
    np.testing.assert_allclose(n(got)[ok], n(want)[ok], atol=1e-3)
    assert np.abs(n(got)[ok] - c0[ok]).max() > 0.1    # refine moved them


def test_pose_stage(tag_quads):
    g, corners, ok = tag_quads
    fam = get_family("tag36h11")
    cm = jdec.make_code_matrix(fam)
    H = np.asarray(jdec.decode_quads(jnp.asarray(g), jnp.asarray(corners),
                                     jnp.asarray(ok), fam, cm)["H"])
    f = np.full(2, INTR["fx"], np.float32)
    c = (np.full(2, INTR["cx"], np.float32), np.full(2, INTR["cy"],
                                                     np.float32))
    jR, jt_, je = jpose.estimate_poses(jnp.asarray(H), 0.1651, f, f, *c)
    tR, tt_, te = tpose.estimate_poses(t(H), 0.1651, t(f), t(f), t(c[0]),
                                       t(c[1]))
    # 2 x 50 orthogonal-iteration steps in f32 from the same homography
    np.testing.assert_allclose(n(tt_)[ok], n(jt_)[ok], atol=1e-4)
    np.testing.assert_allclose(n(tR)[ok], n(jR)[ok], atol=1e-3)
    rot = n(tR)[ok]
    np.testing.assert_allclose(rot @ rot.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), rot.shape),
                               atol=1e-5)
    # the polar factor of perturbed rotations (Newton converges here)
    noisy = (n(tR) + np.random.default_rng(1).normal(0, 0.05, tR.shape)
             ).astype(np.float32)
    m = np.asarray(jpose.polar_rotation(jnp.asarray(noisy)))
    np.testing.assert_allclose(n(tpose.polar_rotation(t(noisy))), m,
                               atol=1e-5)
    assert torch.get_num_threads() == 1
