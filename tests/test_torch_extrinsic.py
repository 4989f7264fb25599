"""The port's extrinsic calibration (ros_vision_tpu_torch/calib/extrinsic.py)
against the JAX package's (ros_vision_tpu/calib/extrinsic.py), on the CPU.

Framesets are synthetic (tests/test_calib_launch.py's two-camera rig, and
a three-camera rig with two free cameras) or rendered and detected: the
port's TorchDetector(device="cpu") against the JAX TPUDetector at 640x400,
fx = 450 (the shape tests/test_torch_detector.py compiles). Tolerances:
collect_pairs exact; _rot_xyz within 1e-6; after the JAX test's 2,500
iterations a free camera within 1 degree and 2 cm of the truth (the JAX
test's limits) in both packages and the frozen camera exactly its guess;
after 1,000 iterations the port within 0.01 degree and 1e-4 m of the JAX
solve (measured <= 1.3e-6 m along the trajectory). Not at 2,500: Adam at
a constant rate ends in steps that spike once the loss has converged, and
there the two packages' last iterates part by up to 0.52 mm on
tests/test_calib_launch.py's own rig (the JAX solve 0.16 mm from the
truth, the port's 0.68), as two runs of either package do when the inputs
move by 1e-7. Detected tag ids exact per frame and camera, translations
within 1 mm.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros_vision_tpu.apriltag.detector import DetectorConfig as JaxConfig
from ros_vision_tpu.apriltag.detector import TPUDetector
from ros_vision_tpu.apriltag.render import project_tag_corners, render_scene
from ros_vision_tpu.calib import extrinsic as jex
from ros_vision_tpu.utils import rotation_utils as ru
from ros_vision_tpu_torch.apriltag.detector import (TorchDetector,
                                                    config_from_jax)
from ros_vision_tpu_torch.calib import extrinsic as tex
from tests.test_calib_launch import _make_frameset

TWO_CAMS = {"camA": ((0.0, 0.0, 0.0), (0.0, 0.2, 0.5)),
            "camB": ((2.0, -3.0, 25.0), (0.1, -0.3, 0.4))}
ITERATIONS, LR = 2500, 3e-2          # tests/test_calib_launch.py:48
AGREE_ITERATIONS = 1000


def calib_launch_guesses(module):
    """tests/test_calib_launch.py's guesses: camA frozen as the anchor."""
    return {"camA": module.CameraGuess((0.0, 0.0, 0.0), (0.0, 0.2, 0.5),
                                       adjustable=False),
            "camB": module.CameraGuess((0.0, 0.0, 15.0), (0.0, 0.0, 0.3))}


def rotation_err_deg(a, b) -> float:
    """Angle between two rotation matrices from the Frobenius norm of
    their difference (no floor from f32 matrices, as arccos of the trace
    has)."""
    d = np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(np.degrees(2 * np.arcsin(min(d / (2 * np.sqrt(2)), 1.0))))


def truth_rotation(angles):
    return ru.compose_rotations_xyz(*angles) @ ru.camera_to_robot()


def guesses_for(module, true_params, anchor, seed=0):
    """The anchor camera frozen at its truth, the others started 3-10
    degrees and up to 30 cm off."""
    rng = np.random.default_rng(seed)
    out = {}
    for cam, (angles, t) in true_params.items():
        if cam == anchor:
            out[cam] = module.CameraGuess(angles, t, adjustable=False)
        else:
            out[cam] = module.CameraGuess(
                tuple(np.add(angles, rng.uniform(-10, 10, 3))),
                tuple(np.add(t, rng.uniform(-0.3, 0.3, 3))))
    return out


def pair_frameset(true_params, pairs, n_tags=30, seed=0):
    """Tags at random robot-frame positions, each observed by the two
    cameras of one of `pairs` (taken in turn)."""
    rng = np.random.default_rng(seed)
    cams = {c: (truth_rotation(a), np.asarray(t))
            for c, (a, t) in true_params.items()}
    frameset = {}
    for i in range(n_tags):
        p = rng.uniform([1.0, -2.0, 0.3], [4.0, 2.0, 1.5])
        frameset[i] = {200 + i: [
            {"cam_id": c, "translation": cams[c][0].T @ (p - cams[c][1])}
            for c in pairs[i % len(pairs)]]}
    return frameset


def check_solve(frameset, true_params, guesses, anchor):
    """guesses(module) -> that package's CameraGuess dict."""
    j, t = (jex.solve_extrinsics(frameset, guesses(jex), AGREE_ITERATIONS,
                                 LR),
            tex.solve_extrinsics(frameset, guesses(tex), AGREE_ITERATIONS,
                                 LR, device="cpu"))
    for cam in true_params:
        assert rotation_err_deg(t[cam]["rotation"], j[cam]["rotation"]) \
            < 0.01
        assert np.abs(np.subtract(t[cam]["offset"],
                                  j[cam]["offset"])).max() < 1e-4
    jres = jex.solve_extrinsics(frameset, guesses(jex), ITERATIONS, LR)
    tres = tex.solve_extrinsics(frameset, guesses(tex), ITERATIONS, LR,
                                device="cpu")
    assert sorted(tres) == sorted(jres) == sorted(true_params)
    for cam, (angles, offset) in true_params.items():
        for res in (tres, jres):
            got = res[cam]
            assert np.asarray(got["rotation"]).shape == (3, 3)
            assert len(got["offset"]) == 3
            if cam != anchor:
                assert rotation_err_deg(got["rotation"],
                                        truth_rotation(angles)) < 1.0
                assert np.abs(np.subtract(got["offset"], offset)).max() \
                    < 0.02
    g = guesses(tex)
    want = tex._rot_xyz(torch.tensor([g[c].rotations_deg for c in sorted(g)],
                                     dtype=torch.float32)) \
        @ torch.as_tensor(tex._CAM2ROBOT)
    assert tres[anchor]["rotation"] == \
        want[sorted(g).index(anchor)].numpy().tolist()
    assert tres[anchor]["offset"] == np.float32(g[anchor].translation).tolist()


def test_collect_pairs_matches_jax():
    three = dict(TWO_CAMS, camC=((0.0, 5.0, -30.0), (0.2, 0.3, 0.45)))
    frameset = _make_frameset(three, n_tags=6)            # 3 views: skipped
    pairs = pair_frameset(three, [("camA", "camC"), ("camB", "camC")],
                          n_tags=5)
    frameset.update({10 + k: v for k, v in pairs.items()})
    frameset[99] = {7: frameset[1][101][:1]}               # 1 view: skipped
    cams = sorted(three)
    want = jex.collect_pairs(frameset, cams)
    got = tex.collect_pairs(frameset, cams)
    assert len(got[0]) == 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_collect_pairs_requires_two_views():
    frameset = {0: {5: [{"cam_id": "a", "translation": [0, 0, 1]}]}}
    with pytest.raises(ValueError) as jerr:
        jex.collect_pairs(frameset, ["a", "b"])
    with pytest.raises(ValueError) as terr:
        tex.collect_pairs(frameset, ["a", "b"])
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("angles", [(0.0, 0.0, 0.0), (2.0, -3.0, 25.0),
                                    (-170.0, 89.0, 355.0),
                                    (12.5, -45.0, -120.0)])
def test_rot_xyz_matches_jax(angles):
    want = np.asarray(jex._rot_xyz(jnp.asarray(angles, jnp.float32)))
    got = tex._rot_xyz(torch.tensor(angles, dtype=torch.float32)).numpy()
    assert np.abs(got - want).max() < 1e-6
    assert np.abs(got - ru.compose_rotations_xyz(*angles)).max() < 1e-6
    batch = tex._rot_xyz(torch.tensor([angles, (1.0, 2.0, 3.0)],
                                      dtype=torch.float32))
    assert batch.shape == (2, 3, 3)
    assert np.abs(batch[0].numpy() - want).max() < 1e-6


def test_rot_xyz_is_differentiable():
    a = torch.tensor([[2.0, -3.0, 25.0]], requires_grad=True)
    (tex._rot_xyz(a) @ torch.ones(3)).sum().backward()
    assert a.grad is not None and bool(torch.isfinite(a.grad).all())
    assert float(a.grad.abs().max()) > 0


def test_solve_two_cameras_matches_jax():
    check_solve(_make_frameset(TWO_CAMS), TWO_CAMS, calib_launch_guesses,
                anchor="camA")


def test_solve_three_cameras_two_free():
    three = dict(TWO_CAMS, camC=((1.0, 4.0, -35.0), (0.2, 0.3, 0.45)))
    frameset = pair_frameset(three, [("camA", "camB"), ("camA", "camC"),
                                     ("camB", "camC")], n_tags=45)
    check_solve(frameset, three,
                lambda m: guesses_for(m, three, "camA"), anchor="camA")


def test_solve_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tex.solve_extrinsics(_make_frameset(TWO_CAMS, n_tags=3),
                             guesses_for(tex, TWO_CAMS, "camA"))


W, H = 640, 400
INTR = dict(fx=450.0, fy=450.0, cx=320.0, cy=200.0)
RIG = {"left": ((0.0, 0.0, 8.0), (0.0, 0.12, 0.5)),
       "right": ((0.0, 0.0, -8.0), (0.0, -0.12, 0.5))}


def rendered_frames():
    """Two frames of the two-camera rig, three tags each, 1.0-2.2 m ahead,
    turned and rolled so no edge is axis-aligned: {frame: {cam: gray}}."""
    rng = np.random.default_rng(5)
    cams = {c: (truth_rotation(a), np.asarray(t)) for c, (a, t) in RIG.items()}
    images = {}
    for f in range(2):
        tags = []
        for k, y in enumerate((-0.45, 0.0, 0.45)):
            p = np.array([rng.uniform(1.0, 2.2), y * rng.uniform(0.8, 1.2),
                          rng.uniform(0.35, 0.65)])
            rot = (ru.compose_rotations_xyz(rng.uniform(-15, 15) + 10 * k,
                                            rng.uniform(-15, 15), 0)
                   @ ru.camera_to_robot())
            tags.append((10 * f + k, p, rot))
        images[f] = {}
        for cam, (r, t) in cams.items():
            quads = [project_tag_corners(r.T @ rot, r.T @ (p - t), 0.1651,
                                         **INTR)
                     for _, p, rot in tags]
            images[f][cam] = render_scene([i for i, _, _ in tags], quads, W,
                                          H, noise_sigma=1.0, seed=f)[0]
    return images


def test_build_frameset_matches_jax():
    images = rendered_frames()
    jcfg = JaxConfig(width=W, height=H, estimate_pose=True, **INTR)
    import dataclasses
    tdet = TorchDetector(config_from_jax(dataclasses.asdict(jcfg)),
                         device="cpu")
    jdet = TPUDetector(jcfg)
    want = jex.build_frameset_from_images(images, lambda cam: jdet)
    got = tex.build_frameset_from_images(images, lambda cam: tdet)
    assert sorted(got) == sorted(want) == [0, 1]
    for f in want:
        assert {i: [r["cam_id"] for r in recs]
                for i, recs in got[f].items()} == \
            {i: [r["cam_id"] for r in recs] for i, recs in want[f].items()}
        assert len(want[f]) == 3 and all(len(r) == 2
                                         for r in want[f].values())
        for i, recs in want[f].items():
            for a, b in zip(got[f][i], recs):
                assert a["translation"].dtype == np.float64
                assert np.abs(a["translation"] - b["translation"]).max() \
                    < 1e-3
    # each package's frameset solves to the same extrinsics (measured
    # 8.8e-4 degree and 1.9e-5 m apart)
    guesses = {"left": jex.CameraGuess(*RIG["left"], adjustable=False),
               "right": jex.CameraGuess((0.0, 0.0, -5.0), (0.0, -0.1, 0.5))}
    jres = jex.solve_extrinsics(want, guesses, AGREE_ITERATIONS, LR)
    tres = tex.solve_extrinsics(
        got, {c: tex.CameraGuess(g.rotations_deg, g.translation,
                                 g.adjustable) for c, g in guesses.items()},
        AGREE_ITERATIONS, LR, device="cpu")
    assert rotation_err_deg(tres["right"]["rotation"],
                            jres["right"]["rotation"]) < 0.01
    assert np.abs(np.subtract(tres["right"]["offset"],
                              jres["right"]["offset"])).max() < 1e-4
