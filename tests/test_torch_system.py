"""The port's runtime on the CPU: ros_vision_tpu_torch.launch.VisionSystem
with mock cameras end to end (the configuration of
tests/test_system_integration.py), the port's VisionNode upload/submit/
consume cycle, the port's own copies of the host modules against the JAX
package's, the package's independence from jax and from ros_vision_tpu,
and chip_smoke.py refusing to run without a card."""
import dataclasses
import json
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from ros_vision_tpu_torch.apriltag.render import (render_scene,
                                                  simple_square_corners)
from tests.torch_port_helpers import t  # noqa: F401  (sets torch threads)

ROOT = Path(__file__).resolve().parents[1]
W, H = 320, 160
OVERRIDES = dict(max_points=4096, max_segments=64, max_quads=8, fx=300.0,
                 fy=300.0, cx=160.0, cy=80.0)


@pytest.fixture()
def config_file(tmp_path):
    from ros_vision_tpu_torch.config.loader import ConfigLoader
    rot = [[0, 0, 1], [-1, 0, 0], [0, -1, 0]]
    cfg = {
        "camera_mounted_positions": {
            "mock0": {"location": "center_front", "format": "MJPG",
                      "height": H, "width": W, "frame_rate": 30,
                      "api_preference": "ANY"},
            "mock1": {"location": "left_front", "format": "MJPG",
                      "height": H, "width": W, "frame_rate": 30,
                      "api_preference": "ANY"},
        },
        "extrinsics": {
            "center_front": {"rotation": rot, "offset": [0.0, 0.0, 0.0]},
            "left_front": {"rotation": rot, "offset": [0.1, 0.2, 0.0]},
        },
    }
    p = tmp_path / "system_config.json"
    p.write_text(json.dumps(cfg))
    ConfigLoader.set_config_file_path(str(p))
    yield str(p)
    ConfigLoader.set_config_file_path(None)
    ConfigLoader.reload_config()


class _Recorder:
    def __init__(self):
        self.values = []
        self.lock = threading.Lock()

    def send_value(self, flat):
        with self.lock:
            self.values.append(list(flat))

    def send_protobuf(self, data):
        pass


def _scenes():
    return {"mock0": render_scene([5], [simple_square_corners(80, 60, 34)],
                                  W, H)[0],
            "mock1": render_scene([9], [simple_square_corners(220, 90, 36,
                                                              15)], W, H)[0]}


def test_vision_system_end_to_end(config_file):
    from ros_vision_tpu_torch.launch import VisionSystem
    from ros_vision_tpu_torch.runtime.camera import MockCamera
    from ros_vision_tpu_torch.runtime.vision_node import VisionNode

    scenes = _scenes()

    def factory(ident, idx):
        def read(k):
            time.sleep(0.01)                # a 100 fps camera
            return scenes[ident]
        # 2-D gray frames: the path the card's machine (no cv2) takes
        return MockCamera(width=W, height=H, frame_factory=read)

    senders = {"center_front": _Recorder(), "left_front": _Recorder()}
    system = VisionSystem(
        device="cpu", enable_viewer=False, enable_nt=False,
        camera_map={"mock0": 0, "mock1": 1}, camera_factory=factory,
        tag_sender=senders, detector_overrides=OVERRIDES)
    assert isinstance(system.node, VisionNode)
    assert system.mesh is None
    system.start()
    try:
        deadline = time.time() + 60
        while time.time() < deadline:
            results = system.spin_once()
            ids = [[d.tag_id for d in r[0]] for r in results]
            if ids == [[5], [9]]:
                break
            time.sleep(0.02)
        assert ids == [[5], [9]]
        dets, robot = results[1]
        assert robot[0][0] > 0.1            # camera z -> robot x, in front
        for s in senders.values():
            s.values.clear()
        spinner = threading.Thread(target=system.spin, daemon=True)
        spinner.start()
        deadline = time.time() + 60
        while time.time() < deadline and (
                system.spin_stats is None
                or system.spin_stats["batches"] < 4):
            time.sleep(0.02)
        assert system.spin_stats["batches"] >= 4
    finally:
        system._running = False
        if "spinner" in locals():
            spinner.join(timeout=30)
        system.stop()
    for loc, want in (("center_front", 5), ("left_front", 9)):
        rows = [np.asarray(v).reshape(-1, 5) for v in senders[loc].values]
        assert rows and all(set(r[:, 1].astype(int)) <= {want} for r in rows)
        assert any(len(r) for r in rows)
        assert all(np.isfinite(r).all() for r in rows)


def test_node_upload_submit_consume():
    from ros_vision_tpu_torch.apriltag.detector import (PendingOutput,
                                                        TorchDetector)
    from ros_vision_tpu_torch.runtime.vision_node import (CameraChannel,
                                                          VisionNode)

    scenes = _scenes()
    frames = np.stack([scenes["mock0"], scenes["mock1"]])
    det = TorchDetector(device="cpu", width=W, height=H, **OVERRIDES)
    chans = [CameraChannel(location=f"cam{i}", extrinsic_rotation=np.eye(3),
                           extrinsic_offset=np.zeros(3)) for i in range(2)]
    node = VisionNode(det, chans, intrinsics=det.default_intrinsics(2))
    dev = node.upload(frames)
    assert isinstance(dev, torch.Tensor) and dev.device.type == "cpu"
    pending = node.submit(dev)
    assert isinstance(pending, PendingOutput)
    staged = node._intrinsics_for_submit()
    assert node._intrinsics_for_submit() is staged        # staged once
    node.intrinsics = det.default_intrinsics(2)
    assert node._intrinsics_for_submit() is not staged    # re-staged
    out = node.process_batch(frames, pending=pending)
    assert [[d.tag_id for d in dets] for dets, _ in out] == [[5], [9]]
    node.stop()


def _run(code_or_args, cwd, timeout=120):
    return subprocess.run([sys.executable, *code_or_args], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


def test_port_never_imports_jax():
    """Every module of the port, and chip_smoke, import neither jax nor
    anything of the JAX package ros_vision_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ros_vision_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert len(mods) >= 35, mods\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib')\n"
        "print('JAX', bad)\n"
        "ref = sorted(m for m in sys.modules if m == 'ros_vision_tpu' or "
        "m.startswith('ros_vision_tpu.'))\n"
        "print('REF', ref)\n"
        "assert not bad and not ref, (bad, ref)\n")
    r = _run(["-c", code], cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "JAX []" in r.stdout and "REF []" in r.stdout


def test_port_sources_name_no_jax_package_import():
    pattern = re.compile(r"(from|import) ros_vision_tpu(\.| |$)",
                         re.MULTILINE)
    files = sorted((ROOT / "ros_vision_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) >= 36
    bad = [str(f) for f in files if pattern.search(f.read_text())]
    assert not bad, bad


def test_family_copies_match():
    from ros_vision_tpu.apriltag import families as jfam
    from ros_vision_tpu_torch.apriltag import families as tfam
    assert Path(tfam._DATA_PATH).parent == ROOT / "ros_vision_tpu_torch" \
        / "apriltag"
    names = jfam.list_families()
    assert tfam.list_families() == names and "tag36h11" in names
    for name in names:
        a, b = jfam.get_family(name), tfam.get_family(name)
        for field in dataclasses.fields(a):
            va, vb = getattr(a, field.name), getattr(b, field.name)
            if isinstance(va, np.ndarray):
                np.testing.assert_array_equal(va, vb, err_msg=name)
            else:
                assert va == vb, (name, field.name)


@pytest.mark.parametrize("family", ["tag36h11", "tag25h9", "tag16h5"])
def test_render_copy_matches(family):
    from ros_vision_tpu.apriltag import families as jfam
    from ros_vision_tpu.apriltag import render as jr
    from ros_vision_tpu_torch.apriltag import families as tfam
    from ros_vision_tpu_torch.apriltag import render as tr
    kw = dict(width=320, height=200, noise_sigma=1.5, seed=4)
    corners = [(80, 70, 30, 10), (230, 120, 40, -25)]
    ja, jp = jr.render_scene([3, 7], [jr.simple_square_corners(*c)
                                      for c in corners],
                             family=jfam.get_family(family), **kw)
    ta, tp = tr.render_scene([3, 7], [tr.simple_square_corners(*c)
                                      for c in corners],
                             family=tfam.get_family(family), **kw)
    assert ja.dtype == ta.dtype and ja.tobytes() == ta.tobytes()
    for a, b in zip(jp, tp, strict=True):
        assert a.tag_id == b.tag_id
        np.testing.assert_array_equal(a.corners, b.corners)


def test_config_loader_copy_matches(config_file):
    from ros_vision_tpu.config.loader import ConfigLoader as JLoader
    from ros_vision_tpu_torch.config.loader import ConfigLoader as TLoader
    for path in (None, config_file):
        JLoader.set_config_file_path(path)
        TLoader.set_config_file_path(path)
        JLoader.reload_config()
        TLoader.reload_config()
        serials = JLoader.get_all_camera_serials()
        assert TLoader.get_all_camera_serials() == serials and serials
        for serial in serials:
            a = JLoader.get_camera_config(serial)
            b = TLoader.get_camera_config(serial)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            ea = JLoader.get_extrinsic_config(a.location)
            eb = TLoader.get_extrinsic_config(b.location)
            assert (ea is None) == (eb is None)
            if ea is not None:
                assert dataclasses.asdict(ea) == dataclasses.asdict(eb)
        for getter in ("get_network_tables_config",
                       "get_bag_recording_config",
                       "get_performance_config", "get_game_piece_config"):
            assert dataclasses.asdict(getattr(JLoader, getter)()) == \
                dataclasses.asdict(getattr(TLoader, getter)())
    JLoader.set_config_file_path(None)
    JLoader.reload_config()


def test_rotation_utils_copy_matches():
    from ros_vision_tpu.utils import rotation_utils as jru
    from ros_vision_tpu_torch.utils import rotation_utils as tru
    for deg in (-135.0, -30.0, 0.0, 45.0, 90.0, 200.0):
        for fn in ("rot_x", "rot_y", "rot_z"):
            np.testing.assert_array_equal(getattr(jru, fn)(deg),
                                          getattr(tru, fn)(deg))
        np.testing.assert_array_equal(
            jru.compose_rotations_xyz(deg, deg / 2, -deg),
            tru.compose_rotations_xyz(deg, deg / 2, -deg))
        np.testing.assert_array_equal(jru.camera_mount_rotation(deg),
                                      tru.camera_mount_rotation(deg))
    np.testing.assert_array_equal(jru.camera_to_robot(),
                                  tru.camera_to_robot())


def test_chip_smoke_refuses_without_a_card():
    r = _run(["chip_smoke.py"], cwd=ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def _pipes(zero_copy: bool):
    from ros_vision_tpu.runtime.frame_pipe import FramePipe as JPipe
    from ros_vision_tpu_torch.runtime.frame_pipe import FramePipe as TPipe
    return (JPipe(2, 8, 6, zero_copy=zero_copy),
            TPipe(2, 8, 6, zero_copy=zero_copy))


def test_frame_pipe_zero_copy_push_freezes_the_frame():
    """The port's zero-copy push makes the pushed array read-only, so a
    producer that mutates it raises instead of tearing the frame the
    consumer converts; the JAX copy leaves it writable (a deliberate
    divergence)."""
    jpipe, tpipe = _pipes(zero_copy=True)
    frames = [np.arange(48, dtype=np.uint8).reshape(8, 6) for _ in range(2)]
    jpipe.push(0, frames[0])
    tpipe.push(0, frames[1])
    assert frames[0].flags.writeable
    with pytest.raises(ValueError):
        frames[1][0, 0] = 1
    batch, ids, _ = tpipe.pull_batch()
    assert ids == [0, -1]
    np.testing.assert_array_equal(batch[0], frames[0])


@pytest.mark.parametrize("kind", ["float", "strided"])
def test_frame_ring_latest_into_an_unfit_out(kind):
    """latest(out=...) with an `out` that cvtColor cannot write in place
    (float, or not C-contiguous) returns the converted frame, not the
    stale contents of `out`."""
    from ros_vision_tpu_torch.runtime.frame_pipe import (FrameRing,
                                                         bgr_to_gray)
    bgr = np.random.default_rng(3).integers(0, 256, (8, 6, 3),
                                            dtype=np.uint8)
    ring = FrameRing(48, zero_copy=True)
    ring.push(bgr)
    out = (np.full((8, 6), -1.0, np.float32) if kind == "float"
           else np.zeros((8, 12), np.uint8)[:, ::2])
    assert out.shape == (8, 6)
    got, fid, _ = ring.latest(out=out)
    assert fid == 0
    np.testing.assert_array_equal(np.asarray(got).reshape(8, 6),
                                  bgr_to_gray(bgr))


@pytest.mark.parametrize("zero_copy", [False, True])
def test_frame_pipe_copy_matches_on_ordinary_frames(zero_copy):
    """On gray and BGR uint8 frames the port's FramePipe returns what the
    JAX FramePipe returns."""
    rng = np.random.default_rng(8)
    gray = rng.integers(0, 256, (8, 6), dtype=np.uint8)
    bgr = rng.integers(0, 256, (8, 6, 3), dtype=np.uint8)
    outs = []
    for pipe in _pipes(zero_copy):
        pipe.push(0, gray.copy(), timestamp_ns=5)
        pipe.push(1, bgr.copy(), timestamp_ns=7)
        first = pipe.pull_batch()
        pipe.push(1, bgr[::-1].copy(), timestamp_ns=9)
        outs.append((first, pipe.pull_batch(wait_new=True, timeout_s=0.01)))
    for (a, b) in zip(*outs):
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:]
