"""The port's game-piece serving path on the CPU against the JAX package's:
GamePieceNode on weights carried from a JAX ModelInference (its random
init, and the weights the JAX trainer fits in tests/test_game_piece.py),
the ImageProcessorNode copy, and the inference_benchmark CLI.

Tolerance for detections (f32 on both sides, the same cv2 preprocess):
the same count, classes and order; centres and sizes within 5e-3 px of the
capture frame (twice the model-input tolerance of tests/test_torch_yolo.py)
and confidences within 1e-5.
"""
import dataclasses
import logging
import time

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

from ros_vision_tpu.models.infer import ModelInference as JInference  # noqa: E402
from ros_vision_tpu.runtime.game_piece_node import GamePieceNode as JNode  # noqa: E402
from ros_vision_tpu_torch.models import yolo as tyolo  # noqa: E402
from ros_vision_tpu_torch.models.infer import ModelInference  # noqa: E402
from ros_vision_tpu_torch.runtime.game_piece_node import GamePieceNode  # noqa: E402
from tests.torch_port_helpers import n  # noqa: E402

SIZE = 96


def piece_frame() -> np.ndarray:
    """The BGR capture frame of tests/test_game_piece.py: an orange game
    piece on a grey field."""
    frame = np.full((192, 192, 3), 70, np.uint8)
    frame[48:112, 64:144] = (25, 100, 230)
    return frame


@pytest.fixture(scope="module")
def jax_weights():
    """One JAX engine (n, 96 px, one class, f32): its random-init
    variables, then the variables its trainer fits to the game piece
    (tests/test_game_piece.py test_game_piece_node_detects_trained_object:
    150 steps at learning rate 2e-3)."""
    from ros_vision_tpu.models.train import TrainConfig, train
    engine = JInference(num_classes=1, scale="n", img_size=SIZE,
                        class_names=["ball"], dtype=jnp.float32)
    random_vars = engine.variables
    small = cv2.resize(piece_frame(), (SIZE, SIZE),
                       interpolation=cv2.INTER_LINEAR)
    img = (small[..., ::-1].astype(np.float32) / 255.0)[None]
    boxes = np.array([[[52.0, 40.0, 40.0, 32.0]]], np.float32)
    labels = np.zeros((1, 1), np.int32)
    mask = np.ones((1, 1), bool)

    def dataset():
        while True:
            yield img, boxes, labels, mask

    train(engine, dataset(), steps=150,
          cfg=TrainConfig(learning_rate=2e-3), log_every=200)
    return engine, {"random": random_vars, "trained": engine.variables}


def run_both(engine, variables, frame):
    engine.variables = variables
    j_pub, t_pub = [], []
    jnode = JNode(engine=engine, detection_publisher=j_pub.append)
    port = ModelInference(num_classes=1, scale="n", img_size=SIZE,
                          class_names=["ball"], dtype=torch.float32,
                          device="cpu")
    tyolo.from_flax(port.model, variables)     # nested tree of jax arrays
    tnode = GamePieceNode(engine=port, detection_publisher=t_pub.append)
    try:
        want = jnode.process_frame(frame, stamp=1.0, frame_id="cam")
        got = tnode.process_frame(frame, stamp=1.0, frame_id="cam")
    finally:
        jnode.stop()
        tnode.stop()
    assert t_pub[0].detections == got and t_pub[0].stamp == 1.0
    assert t_pub[0].frame_id == j_pub[0].frame_id == "cam"
    assert tnode.frames_processed == 1
    return want, got


def assert_same_detections(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.cls, g.class_name) == (w.cls, w.class_name)
        np.testing.assert_allclose([g.x, g.y, g.w, g.h],
                                   [w.x, w.y, w.w, w.h], rtol=0, atol=5e-3)
        assert abs(g.conf - w.conf) <= 1e-5


@pytest.mark.parametrize("weights", ["random", "trained"])
def test_node_matches_jax_on_carried_weights(jax_weights, weights):
    engine, variables = jax_weights
    frame = piece_frame()
    want, got = run_both(engine, variables[weights], frame)
    assert_same_detections(got, want)
    if weights == "trained":
        assert got, "trained object not detected through the port's node"
        best = max(got, key=lambda d: d.conf)
        assert best.class_name == "ball" and best.conf >= 0.25
        assert abs(best.x - 104.0) < 25 and abs(best.y - 80.0) < 25


def test_node_matches_jax_on_a_random_frame(jax_weights):
    engine, variables = jax_weights
    frame = np.random.default_rng(0).integers(0, 255, (200, 320, 3),
                                              dtype=np.uint8)
    want, got = run_both(engine, variables["trained"], frame)
    assert_same_detections(got, want)


def test_device_path_matches_host_path(jax_weights):
    """preprocess_device -> infer -> detections (the cv2-free path) against
    detect() on a frame at the model's input size, which neither resize
    changes (downscaling, the device path antialiases as jax.image.resize
    does and cv2.resize does not)."""
    engine, variables = jax_weights
    port = ModelInference(num_classes=1, img_size=SIZE, class_names=["ball"],
                          dtype=torch.float32, device="cpu")
    tyolo.from_flax(port.model, variables["trained"])
    frame = cv2.resize(piece_frame(), (SIZE, SIZE),
                       interpolation=cv2.INTER_NEAREST)
    host = port.detect(frame)
    out = port.infer(port.preprocess_device(np.stack([frame, frame])))
    for row in (0, 1):
        assert_same_detections(port.detections(out, (SIZE, SIZE), row),
                               host)
    assert host


def test_node_without_an_engine_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GamePieceNode()


def test_infer_outputs_are_device_tensors():
    port = ModelInference(num_classes=2, img_size=SIZE, dtype=torch.float32,
                          device="cpu", max_detections=8)
    x = np.random.default_rng(2).random((3, SIZE, SIZE, 3), np.float32)
    out = port.infer(x)
    assert {k: tuple(v.shape) for k, v in out.items()} == {
        "boxes": (3, 8, 4), "scores": (3, 8), "classes": (3, 8),
        "valid": (3, 8)}
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for v in out.values())
    assert out["valid"].dtype == torch.bool
    assert out["classes"].dtype == torch.int32


def test_image_processor_copy_matches(caplog):
    from ros_vision_tpu.runtime.image_processor import \
        ImageProcessorNode as JProc
    from ros_vision_tpu_torch.runtime.frame_pipe import FrameRing
    from ros_vision_tpu_torch.runtime.image_processor import \
        ImageProcessorNode
    frame = np.random.default_rng(3).integers(0, 256, (8, 6, 3),
                                              dtype=np.uint8)
    messages = []
    for cls in (JProc, ImageProcessorNode):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="image_processor"):
            got = cls().process(frame)
        assert got == float(frame.astype(np.float64).mean())
        messages.append([r.message.split(", Processing")[0]
                         for r in caplog.records])
    assert messages[0] == messages[1] and len(messages[0]) == 1
    assert messages[0][0].startswith("Mean Intensity: ")

    ring = FrameRing(frame_bytes=24, n_slots=4, force_python=True)
    node = ImageProcessorNode(ring)
    node.start()
    try:
        ring.push(np.full(24, 77, np.uint8), timestamp_ns=1)
        deadline = time.time() + 5
        while node.frames_processed < 1 and time.time() < deadline:
            time.sleep(0.01)
    finally:
        node.stop()
    assert node.frames_processed == 1
    assert node.last_mean_intensity == 77.0


def test_inference_benchmark_cli_runs(tmp_path, capsys):
    """--device cpu at 96 px (the smallest multiple of 32 whose 189
    anchors hold the 100 NMS slots: at 64 px, 84 anchors, both packages'
    NMS refuse K = 100)."""
    from ros_vision_tpu_torch.tools import inference_benchmark as tb
    csv = tmp_path / "it.csv"
    fps = tb.main(["--device", "cpu", "--img-size", "96", "--iterations",
                   "2", "--warmup", "1", "--csv", str(csv)])
    out = capsys.readouterr().out
    assert fps > 0 and "Throughput:" in out and "device cpu" in out
    assert len(csv.read_text().splitlines()) == 3
    assert tb.main(["--device", "cpu", "--img-size", "96", "--iterations",
                    "3", "--warmup", "1", "--streaming", "--batch",
                    "2"]) > 0
    assert "Streaming throughput: batch 2" in capsys.readouterr().out


def test_inference_benchmark_cli_shell_matches_jax(capsys):
    from ros_vision_tpu.tools import inference_benchmark as jb
    from ros_vision_tpu_torch.tools import inference_benchmark as tb
    times = list(np.random.default_rng(4).uniform(1, 9, 37))
    a, b = jb.stats_block("Total", times), tb.stats_block("Total", times)
    assert a == b
    jb.print_block(a)
    want = capsys.readouterr().out
    tb.print_block(b)
    assert capsys.readouterr().out == want


def test_message_types_match_jax():
    from ros_vision_tpu.models.infer import GamePieceDetection as JDet
    from ros_vision_tpu.runtime.game_piece_node import GamePieceMsg as JMsg
    from ros_vision_tpu_torch.models.infer import GamePieceDetection
    from ros_vision_tpu_torch.runtime.game_piece_node import GamePieceMsg
    for a, b in ((JDet, GamePieceDetection), (JMsg, GamePieceMsg)):
        assert [(f.name, f.type) for f in dataclasses.fields(a)] == \
            [(f.name, f.type) for f in dataclasses.fields(b)]
