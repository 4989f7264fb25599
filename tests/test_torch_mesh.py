"""The port's camera-batch sharding (ros_vision_tpu_torch/parallel/mesh.py)
on a mesh of CPU devices, as tests/test_system_integration.py's
test_mesh_sharded_detection holds the JAX package's on its virtual CPU
mesh: each shard runs the detector on its own rows, so the gathered
output equals the per-row B=1 calls and the unsharded call bit for bit,
and the ids equal the JAX detector's on the same frames. Plus the mesh
rule of VisionSystem(enable_mesh=True) (ros_vision_tpu/launch.py:291-314)."""
import dataclasses

import numpy as np
import pytest
import torch

from ros_vision_tpu.apriltag.detector import DetectorConfig as JaxConfig
from ros_vision_tpu.apriltag.detector import TPUDetector
from ros_vision_tpu.apriltag.render import render_scene, simple_square_corners
from ros_vision_tpu_torch.apriltag.detector import (TorchDetector,
                                                    config_from_jax)
from ros_vision_tpu_torch.parallel import mesh as pm
from tests.torch_port_helpers import t  # noqa: F401  (sets torch threads)

W, H = 320, 160


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, NaNs in unused slots included."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxConfig(width=W, height=H, max_points=2048, max_segments=64,
                     max_quads=8, fx=300.0, fy=300.0, cx=160.0, cy=80.0,
                     estimate_pose=True)
    det = TorchDetector(config_from_jax(dataclasses.asdict(jcfg)),
                        device="cpu")
    imgs = np.stack([render_scene(
        [10 + i], [simple_square_corners(80 + 30 * i, 60 + 8 * i, 30,
                                         angle_deg=10 + 7 * i)], W, H,
        noise_sigma=1.0, seed=i)[0] for i in range(4)])
    intr = torch.as_tensor(det.default_intrinsics(4))
    rows = [det._detect_device(torch.from_numpy(imgs[i:i + 1]),
                               intr[i:i + 1]) for i in range(4)]
    per_row = {k: torch.cat([r[k] for r in rows]) for k in rows[0]}
    return jcfg, det, imgs, intr, per_row


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_dict_bit_equal_per_row(setup, n):
    _, det, imgs, intr, per_row = setup
    mesh = pm.make_camera_mesh(devices=["cpu"] * n)
    assert mesh == [torch.device("cpu")] * n
    out = pm.shard_detector(det, mesh)(torch.from_numpy(imgs), intr)
    assert set(out) == set(per_row)
    for k, v in per_row.items():
        assert same_bits(out[k], v), k
    for i in range(4):
        assert out["tag_id"][i][out["ok"][i]].tolist() == [10 + i]
    unsharded = det._detect_device(torch.from_numpy(imgs), intr)
    for k, v in unsharded.items():
        assert same_bits(out[k], v), k
    host = pm.gather_detections(out)
    assert all(isinstance(v, np.ndarray) for v in host.values())


def test_sharded_packed_bit_equal_per_row(setup):
    _, det, imgs, intr, per_row = setup
    from ros_vision_tpu_torch.apriltag.detector import pack_outputs
    mesh = pm.make_camera_mesh(n_cameras=2, devices=["cpu"] * 4)
    assert len(mesh) == 2
    packed = pm.shard_detector_packed(det, mesh)(torch.from_numpy(imgs),
                                                 intr)
    assert same_bits(packed, pack_outputs(per_row))
    # the same callables behind detect_raw / detect_raw_packed, as
    # VisionSystem installs them on a multi-device mesh
    det2 = TorchDetector(det.config, device="cpu")
    det2.use_mesh(mesh)
    assert det2.mesh == mesh
    assert same_bits(det2.detect_raw_packed(imgs), packed)
    rows = det2.detect(imgs)
    assert [[d.tag_id for d in r] for r in rows] == [[10], [11], [12], [13]]
    det2.use_mesh(None)
    assert det2.mesh is None
    assert same_bits(det2.detect_raw_packed(imgs), packed)


def test_sharded_ids_match_jax(setup):
    jcfg, det, imgs, intr, _ = setup
    out = pm.shard_detector(det, pm.make_camera_mesh(devices=["cpu"] * 2))(
        torch.from_numpy(imgs), intr)
    jout = TPUDetector(jcfg).detect_raw(imgs)
    ok = np.asarray(jout["ok"])
    np.testing.assert_array_equal(out["ok"].numpy(), ok)
    for k in ("tag_id", "hamming"):
        np.testing.assert_array_equal(out[k].numpy()[ok],
                                      np.asarray(jout[k])[ok])
    assert np.abs(out["corners"].numpy()[ok]
                  - np.asarray(jout["corners"])[ok]).max() < 0.1


def test_batch_must_split_evenly(setup):
    _, det, imgs, intr, _ = setup
    fn = pm.shard_detector(det, pm.make_camera_mesh(devices=["cpu"] * 3))
    with pytest.raises(ValueError, match="does not split"):
        fn(torch.from_numpy(imgs), intr)
    with pytest.raises(ValueError):
        pm.make_camera_mesh(n_cameras=3, devices=["cpu"] * 2)


@pytest.mark.parametrize("n_dev,n_cam,axis", [
    (1, 4, 1), (2, 1, 1), (2, 4, 2), (3, 4, 2), (4, 3, 3), (8, 4, 4),
    (4, 6, 3), (0, 4, 1)])
def test_camera_axis(n_dev, n_cam, axis):
    assert pm.camera_axis(n_dev, n_cam) == axis


def test_make_camera_mesh_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.make_camera_mesh()


def test_mesh_devices():
    assert pm.mesh_devices("cpu") == [torch.device("cpu")]
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        assert pm.mesh_devices(f"cuda:{n - 1}")[0] == \
            torch.device("cuda", n - 1)
        assert len(pm.mesh_devices("cuda")) == n


def _vision_system(tmp_path, monkeypatch, n_devices, enable_mesh=True):
    """A VisionSystem on two mock cameras whose detector sees `n_devices`
    CPU devices (parallel/mesh.mesh_devices monkeypatched)."""
    import json
    from ros_vision_tpu_torch.config.loader import ConfigLoader
    from ros_vision_tpu_torch.launch import VisionSystem
    from ros_vision_tpu_torch.runtime.camera import MockCamera
    monkeypatch.setattr(pm, "mesh_devices",
                        lambda device: [torch.device(device)] * n_devices)
    rot = [[0, 0, 1], [-1, 0, 0], [0, -1, 0]]
    cfg = {"camera_mounted_positions": {
               f"mock{i}": {"location": loc, "format": "MJPG", "height": H,
                            "width": W, "frame_rate": 30,
                            "api_preference": "ANY"}
               for i, loc in enumerate(["center_front", "left_front"])},
           "extrinsics": {loc: {"rotation": rot, "offset": [0.0, 0.0, 0.0]}
                          for loc in ["center_front", "left_front"]}}
    p = tmp_path / "system_config.json"
    p.write_text(json.dumps(cfg))
    ConfigLoader.set_config_file_path(str(p))
    try:
        return VisionSystem(
            device="cpu", enable_viewer=False, enable_nt=False,
            enable_mesh=enable_mesh, camera_map={"mock0": 0, "mock1": 1},
            camera_factory=lambda ident, idx: MockCamera(width=W, height=H),
            detector_overrides=dict(max_points=2048, max_segments=64,
                                    max_quads=8))
    finally:
        ConfigLoader.set_config_file_path(None)
        ConfigLoader.reload_config()


def test_vision_system_builds_no_mesh_on_one_device(tmp_path, monkeypatch):
    import inspect
    from ros_vision_tpu_torch.launch import VisionSystem
    system = _vision_system(tmp_path, monkeypatch, n_devices=1)
    assert system.mesh is None
    assert system.detector.mesh is None
    assert system.detector._fn == system.detector._detect_device
    # opt-in in the port: the mesh's threads share one interpreter lock
    assert inspect.signature(VisionSystem).parameters[
        "enable_mesh"].default is False
    system.stop()


@pytest.mark.parametrize("enable_mesh", [True, False])
def test_vision_system_shards_over_two_devices(setup, tmp_path, monkeypatch,
                                               enable_mesh):
    """Two devices and two cameras: a two-way mesh whose sharded call is
    the unsharded one bit for bit; none unless enable_mesh."""
    _, det, imgs, intr, per_row = setup
    from ros_vision_tpu_torch.apriltag.detector import pack_outputs
    system = _vision_system(tmp_path, monkeypatch, n_devices=2,
                            enable_mesh=enable_mesh)
    try:
        if not enable_mesh:
            assert system.mesh is None and system.detector.mesh is None
            return
        assert system.mesh == [torch.device("cpu")] * 2
        assert system.detector.mesh == system.mesh
        assert isinstance(system.detector._fn, pm._Sharded)
        packed = system.detector.detect_raw_packed(imgs[:2], intr[:2])
        assert same_bits(packed, pack_outputs(
            {k: v[:2] for k, v in per_row.items()}))
    finally:
        system.stop()
