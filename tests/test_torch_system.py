"""The port's runtime on the CPU: ros_vision_tpu_torch.launch.VisionSystem
with mock cameras end to end (the configuration of
tests/test_system_integration.py), TorchVisionNode's upload/submit/consume
cycle, the package's independence from jax, and chip_smoke.py refusing to
run without a card."""
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from ros_vision_tpu.apriltag.render import render_scene, simple_square_corners
from tests.torch_port_helpers import t  # noqa: F401  (sets torch threads)

ROOT = Path(__file__).resolve().parents[1]
W, H = 320, 160
OVERRIDES = dict(max_points=4096, max_segments=64, max_quads=8, fx=300.0,
                 fy=300.0, cx=160.0, cy=80.0)


@pytest.fixture()
def config_file(tmp_path):
    from ros_vision_tpu.config.loader import ConfigLoader
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
    from ros_vision_tpu.runtime.camera import MockCamera
    from ros_vision_tpu_torch.launch import VisionSystem
    from ros_vision_tpu_torch.runtime.vision_node import TorchVisionNode

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
    assert isinstance(system.node, TorchVisionNode)
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
    from ros_vision_tpu.runtime.vision_node import CameraChannel
    from ros_vision_tpu_torch.apriltag.detector import (PendingOutput,
                                                        TorchDetector)
    from ros_vision_tpu_torch.runtime.vision_node import TorchVisionNode

    scenes = _scenes()
    frames = np.stack([scenes["mock0"], scenes["mock1"]])
    det = TorchDetector(device="cpu", width=W, height=H, **OVERRIDES)
    chans = [CameraChannel(location=f"cam{i}", extrinsic_rotation=np.eye(3),
                           extrinsic_offset=np.zeros(3)) for i in range(2)]
    node = TorchVisionNode(det, chans, intrinsics=det.default_intrinsics(2))
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
    code = (
        "import importlib, pkgutil, sys\n"
        "import ros_vision_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 15, mods\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib')\n"
        "print('JAX', bad)\n"
        "assert not bad, bad\n")
    r = _run(["-c", code], cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "JAX []" in r.stdout


def test_chip_smoke_refuses_without_a_card():
    r = _run(["chip_smoke.py"], cwd=ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
