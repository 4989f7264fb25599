"""The port's host copies of the calibration modules, the tools and the
f64 oracle (ros_vision_tpu_torch/{calib,tools}/*, apriltag/oracle.py)
against the JAX package's modules on the same inputs, on the CPU.

Host copies run the same numpy / cv2 code, so their outputs must be equal:
captures, calibration results and written files byte for byte, printed
output, oracle detections field by field. The tools that detect
(replay_bag, detect_demo) run the port's TorchDetector with --device cpu:
ids exact, centers within 0.1 px and poses within 1 mm of the JAX tool's.
cv2 runs one thread here, so that its calibrations repeat bit for bit.
"""
import argparse
import filecmp
import json
import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from ros_vision_tpu.apriltag import oracle as joracle  # noqa: E402
from ros_vision_tpu.apriltag.render import (  # noqa: E402
    project_tag_corners, render_scene, simple_square_corners)
from ros_vision_tpu.calib import data_collector as jdc  # noqa: E402
from ros_vision_tpu.calib import intrinsic as jintr  # noqa: E402
from ros_vision_tpu_torch.apriltag import oracle as toracle  # noqa: E402
from ros_vision_tpu_torch.calib import data_collector as tdc  # noqa: E402
from ros_vision_tpu_torch.calib import intrinsic as tintr  # noqa: E402

K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1]])


def warped_views(board_img, size_m, n, seed=0):
    """n views of a planar target image spanning size_m (w, h) metres,
    warped by random poses of the camera K into 640x480 frames."""
    rng = np.random.default_rng(seed)
    bh, bw = board_img.shape[:2]
    w, h = size_m
    corners3d = np.array([[0, 0, 0], [w, 0, 0], [w, h, 0], [0, h, 0]],
                         np.float32)
    views = []
    for _ in range(n):
        rvec = rng.uniform(-0.35, 0.35, 3)
        tvec = np.array([rng.uniform(-0.05, 0.05) - w / 2,
                         rng.uniform(-0.04, 0.04) - h / 2,
                         rng.uniform(0.35, 0.6)])
        img_pts, _ = cv2.projectPoints(corners3d, rvec, tvec, K, None)
        hmat = cv2.getPerspectiveTransform(
            np.array([[0, 0], [bw, 0], [bw, bh], [0, bh]], np.float32),
            img_pts.reshape(4, 2).astype(np.float32))
        views.append(cv2.warpPerspective(board_img, hmat, (640, 480),
                                         borderValue=255))
    return views


@pytest.fixture(scope="module")
def charuco_views():
    board = cv2.aruco.CharucoBoard(
        (11, 8), 0.02, 0.015,
        cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_4X4_100))
    return warped_views(board.generateImage((1100, 800)), (0.22, 0.16), 40)


@pytest.fixture(scope="module")
def chessboard_views():
    # a 10x7-square board: 9x6 inner corners, the calibrator's default
    sq = 60
    board = (np.indices((7 * sq, 10 * sq)) // sq).sum(0) % 2 * 255
    board = np.pad(board.astype(np.uint8), sq, constant_values=255)
    return warped_views(board, (0.3, 0.225), 40, seed=1)


@pytest.fixture(autouse=True)
def one_cv_thread():
    """cv2.calibrateCamera's parallel sums round differently run to run;
    one thread makes two runs of the same code comparable bit for bit."""
    n = cv2.getNumThreads()
    cv2.setNumThreads(1)
    yield
    cv2.setNumThreads(n)


def feed(cal, views):
    return [cal.process_frame(v) for v in views]


def same_captures(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for u, v in zip(x if isinstance(x, tuple) else (x,),
                        y if isinstance(y, tuple) else (y,)):
            assert np.array_equal(np.asarray(u), np.asarray(v))


def test_charuco_calibrator_matches_jax(charuco_views, tmp_path):
    j, t = jintr.CharucoCalibrator(max_frames=3), \
        tintr.CharucoCalibrator(max_frames=3)
    assert feed(j, charuco_views) == feed(t, charuco_views)
    assert t.ready and t.n_captures == j.n_captures == 3
    same_captures(t.captures, j.captures)
    res = t.calibrate()
    assert res == j.calibrate()
    assert abs(res["camera_matrix"][0][0] - 600.0) / 600.0 < 0.1
    pj = jintr.write_calibration(res, "cam1", str(tmp_path / "j"))
    pt = tintr.write_calibration(res, "cam1", str(tmp_path / "t"))
    assert os.path.basename(pt) == os.path.basename(pj)
    assert filecmp.cmp(pj, pt, shallow=False)


def test_checkerboard_calibrator_matches_jax(chessboard_views):
    j, t = jintr.CheckerboardCalibrator(max_frames=3), \
        tintr.CheckerboardCalibrator(max_frames=3)
    assert feed(j, chessboard_views) == feed(t, chessboard_views)
    assert t.ready and t.n_captures == j.n_captures == 3
    same_captures(t.img_pts, j.img_pts)
    same_captures(t.obj_pts, j.obj_pts)
    assert t.calibrate() == j.calibrate()


def test_calibrate_camera_flow_matches_jax(charuco_views, tmp_path):
    from ros_vision_tpu.tools.calibrate_camera import run as jrun
    from ros_vision_tpu_torch.tools.calibrate_camera import run as trun

    class SeqCam:
        def __init__(self):
            self.i = 0

        def read(self):
            v = charuco_views[self.i % len(charuco_views)]
            self.i += 1
            return cv2.cvtColor(v, cv2.COLOR_GRAY2BGR) if self.i % 2 else v

    pj = jrun(SeqCam(), jintr.CharucoCalibrator(max_frames=3), "testcam",
              str(tmp_path / "j"), max_seconds=30)
    pt = trun(SeqCam(), tintr.CharucoCalibrator(max_frames=3), "testcam",
              str(tmp_path / "t"), max_seconds=30)
    assert pt is not None and filecmp.cmp(pj, pt, shallow=False)
    m = np.asarray(json.loads(open(pt).read())["camera_matrix"])
    assert abs(m[1, 2] - 240.0) / 240.0 < 0.15


class FakeCam:
    def __init__(self, val):
        self.val = val
        self.released = False

    def read(self):
        return np.full((8, 8), self.val, np.uint8)

    def release(self):
        self.released = True


@pytest.mark.parametrize("module", [jdc, tdc], ids=["jax", "port"])
def test_collect_framesets_mock(module, tmp_path):
    out = str(tmp_path / "caps")
    cams = {}

    def factory(cid, dev):
        cams[cid] = FakeCam(50 if cid == "a" else 200)
        return cams[cid]

    n = module.collect_framesets(out, camera_map={"a": 0, "b": 1},
                                 rate_hz=100.0, duration_s=0.05,
                                 camera_factory=factory)
    assert n >= 1 and all(c.released for c in cams.values())
    sets = tdc.load_framesets(out)
    assert sets.keys() == jdc.load_framesets(out).keys()
    assert set(sets[0]) == {"a", "b"}
    assert sets[0]["a"][0, 0] == 50 and sets[0]["b"][0, 0] == 200


def test_data_collector_scans_the_ports_cameras(monkeypatch, tmp_path):
    from ros_vision_tpu_torch import launch
    seen = []
    monkeypatch.setattr(launch, "scan_for_cameras",
                        lambda: seen.append(1) or {"x": 3})
    n = tdc.collect_framesets(str(tmp_path / "caps"), rate_hz=100.0,
                              duration_s=0.02,
                              camera_factory=lambda cid, dev: FakeCam(9))
    assert seen == [1] and n >= 1


def test_robot_rotations_prints_the_same(capsys):
    from ros_vision_tpu.tools import robot_rotations as jrr
    from ros_vision_tpu_torch.tools import robot_rotations as trr
    jrr.main([])
    want = capsys.readouterr().out
    trr.main([])
    assert capsys.readouterr().out == want
    assert trr.generate() == jrr.generate()
    presets = {"up": {"pitch": 30.0, "yaw": 10.0, "offset": [0.1, 0, 0.5]}}
    assert trr.generate(presets) == jrr.generate(presets)


def bag_scene():
    img, placed = render_scene(
        [42, 7], [simple_square_corners(110, 80, 36, angle_deg=12),
                  simple_square_corners(230, 85, 30, angle_deg=-20)],
        320, 160, noise_sigma=1.0, seed=2)
    return img, placed


def test_replay_bag_matches_jax(tmp_path):
    from ros_vision_tpu.runtime.bags import BagWriter
    from ros_vision_tpu.tools.replay_bag import main as jmain
    from ros_vision_tpu_torch.tools.replay_bag import main as tmain
    img, _ = bag_scene()
    bag = str(tmp_path / "bag")
    w = BagWriter(bag)
    for _ in range(2):
        w.write_image("cameras/center_front/image_raw/compressed", img,
                      jpeg_quality=98)
    w.close()
    outs = {}
    for name, run, extra in (("jax", jmain, []),
                             ("port", tmain, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.jsonl")
        run([bag, "--out", out, "--fx", "300", "--fy", "300",
             "--annotate-dir", str(tmp_path / name)] + extra)
        outs[name] = [json.loads(line) for line in open(out)]
    assert len(outs["port"]) == len(outs["jax"]) == 2
    for t, j in zip(outs["port"], outs["jax"]):
        assert t["seq"] == j["seq"] and t["t"] == j["t"]
        assert [d["id"] for d in t["detections"]] == \
            [d["id"] for d in j["detections"]] == [7, 42]
        for a, b in zip(t["detections"], j["detections"]):
            assert a["hamming"] == b["hamming"]
            assert np.abs(np.subtract(a["center"], b["center"])).max() < 0.1
            assert np.abs(np.subtract(a["pose_t"], b["pose_t"])).max() < 1e-3
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))


def test_replay_bag_defaults_to_the_card(tmp_path, monkeypatch):
    import torch

    from ros_vision_tpu_torch.runtime.bags import BagWriter
    from ros_vision_tpu_torch.tools.replay_bag import main as tmain
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bag = str(tmp_path / "bag")
    w = BagWriter(bag)
    w.write_image("cam/image_raw/compressed", bag_scene()[0])
    w.close()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain([bag, "--out", str(tmp_path / "d.jsonl")])


def test_extract_images_matches_jax(tmp_path):
    from ros_vision_tpu.runtime.bags import BagWriter
    from ros_vision_tpu.runtime.rosbag2 import Rosbag2Writer
    from ros_vision_tpu.tools import extract_images as jcli
    from ros_vision_tpu_torch.tools import extract_images as tcli
    rec = str(tmp_path / "rec")
    w = BagWriter(rec)
    for i in range(5):
        w.write_image("cam/image_raw", np.full((8, 8), 10 * i, np.uint8),
                      t=1.0 + i)
    w.close()
    ros2 = str(tmp_path / "ros2")
    with Rosbag2Writer(ros2) as rw:
        for i in range(4):
            rw.write_image("/cam/image_raw", np.full((8, 8), i, np.uint8),
                           (i + 1) * 1_000_000_000)
    for bag, args in ((rec, ["-s", "2"]), (ros2, ["-m", "3", "-t", "cam"])):
        outs = {}
        for name, cli in (("jax", jcli), ("port", tcli)):
            out = str(tmp_path / f"out_{name}_{os.path.basename(bag)}")
            assert cli.main([bag, "-o", out] + args) == 0
            outs[name] = out
        cmp = filecmp.dircmp(outs["jax"], outs["port"])
        assert not cmp.left_only and not cmp.right_only and cmp.common
        for sub in cmp.common_dirs:
            files = sorted(os.listdir(os.path.join(outs["jax"], sub)))
            assert files
            for f in files:
                assert filecmp.cmp(os.path.join(outs["jax"], sub, f),
                                   os.path.join(outs["port"], sub, f),
                                   shallow=False)
    assert tcli.main([str(tmp_path / "nope"), "-o", str(tmp_path)]) == 1


def test_timing_report_matches_jax(tmp_path):
    import pandas as pd

    from ros_vision_tpu.runtime.timing import TimingLogger
    from ros_vision_tpu.tools import timing_report as jtr
    from ros_vision_tpu_torch.tools import timing_report as ttr
    path = str(tmp_path / "timing.csv")
    tl = TimingLogger(path)
    for i in range(50):
        tl.record(latency_us=1000 + i, det_time_us=5000 + (i % 7) * 13,
                  processing_time_us=8000 + 10 * i)
    tl.close()
    mj = jtr.make_report(path, str(tmp_path / "j"), plots=False)
    mt = ttr.make_report(path, str(tmp_path / "t"), plots=True)
    assert open(mt).read() == open(mj).read()
    assert all(os.path.exists(tmp_path / "t" / f"timing_{k}.png")
               for k in ("line", "hist", "cdf"))
    col = pd.read_csv(path)["processing_time_us"]
    assert ttr.column_stats(col) == jtr.column_stats(col)
    assert ttr.column_stats([]) == jtr.column_stats([]) == {}


def test_detect_demo_camera_loop_with_mock_camera():
    from ros_vision_tpu_torch.runtime.camera import MockCamera
    from ros_vision_tpu_torch.tools.detect_demo import run_camera_loop

    img, _ = render_scene(
        [5], [simple_square_corners(320, 200, 80, angle_deg=12)], 640, 400)
    bgr = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
    cam = MockCamera(width=640, height=400, frame_factory=lambda n: bgr)
    cam.open(0)
    seen = []
    args = argparse.Namespace(camera=0, fx=600.0, fy=600.0, cx=320.0,
                              cy=200.0, tag_size=0.1651, viewer_port=0,
                              device="cpu")
    n = run_camera_loop(args, camera=cam, max_frames=3,
                        on_frame=lambda ann, dets: seen.append(
                            (ann.shape, [d.tag_id for d in dets])))
    assert n == 3 and len(seen) == 3
    for shape, ids in seen:
        assert ids == [5]
        assert shape[0] == 400 and shape[1] == 640


def test_detect_demo_rendered_scene(tmp_path, capsys):
    from ros_vision_tpu_torch.tools.detect_demo import main
    out = str(tmp_path / "det.png")
    prof = str(tmp_path / "prof")
    main(["--device", "cpu", "--out", out, "--profile-dir", prof])
    text = capsys.readouterr().out
    assert "image 1280x800" in text and "2 detections:" in text
    assert "  id 0 " in text and "  id 42 " in text
    assert cv2.imread(out).shape == (800, 1280, 3)
    trace = json.load(open(os.path.join(prof, "detect_demo_trace.json")))
    assert trace["traceEvents"]


def oracle_scenes():
    """The scenes of tests/test_oracle.py (the golden photos aside)."""
    from scipy.spatial.transform import Rotation
    img, _ = render_scene(
        [0, 42, 311], [simple_square_corners(300, 250, 90),
                       simple_square_corners(800, 400, 110, angle_deg=20),
                       simple_square_corners(450, 600, 70, angle_deg=-35)],
        1280, 800)
    yield "ids_and_corners", img, {}
    yield "blank", np.full((400, 640), 128, np.uint8), {}
    yield "noise", render_scene(
        [7], [simple_square_corners(320, 200, 80, 10)], 640, 400,
        noise_sigma=8.0, seed=3)[0], {}
    rng = np.random.default_rng(1)
    pose = dict(fx=900.0, fy=900.0, cx=640.0, cy=400.0, estimate_pose=True,
                tag_size=0.1651)
    for trial in range(2):
        rot = Rotation.from_euler(
            "xyz", [rng.uniform(-25, 25), rng.uniform(-25, 25),
                    rng.uniform(-180, 180)], degrees=True).as_matrix()
        t = np.array([rng.uniform(-0.5, 0.5), rng.uniform(-0.3, 0.3),
                      rng.uniform(0.8, 2.5)])
        corners = project_tag_corners(rot, t, 0.1651, 900.0, 900.0, 640.0,
                                      400.0)
        yield f"pose{trial}", render_scene([trial * 70], [corners], 1280,
                                           800)[0], pose


@pytest.mark.parametrize("name,img,kw", list(oracle_scenes()),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_oracle_matches_jax(name, img, kw):
    want = joracle.OracleDetector(**kw).detect(img)
    got = toracle.OracleDetector(**kw).detect(img)
    assert len(got.detections) == len(want.detections)
    assert (name == "blank") == (not want.detections)
    for a, b in zip(got.detections, want.detections):
        for f in ("tag_id", "hamming", "decision_margin", "pose_err"):
            assert getattr(a, f) == getattr(b, f), f
        for f in ("center", "corners", "H", "pose_R", "pose_t"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None)
            if x is not None:
                assert np.array_equal(x, y), f


def test_oracle_distortion_roundtrip_matches_jax():
    dist = np.array([-0.25, 0.08, 0.001, -0.001, 0.0])
    pts = np.array([[100.0, 80.0], [640.0, 400.0], [1200.0, 700.0]])
    kw = dict(fx=900.0, fy=900.0, cx=640.0, cy=400.0)
    from ros_vision_tpu.apriltag import geometry as jgeo
    from ros_vision_tpu_torch.apriltag import geometry as tgeo
    d = tgeo.distort_points(pts, dist=dist, **kw)
    assert np.array_equal(d, jgeo.distort_points(pts, dist=dist, **kw))
    assert np.array_equal(tgeo.undistort_points(d, dist=dist, **kw),
                          jgeo.undistort_points(d, dist=dist, **kw))
    assert toracle.OracleDetector.__init__.__code__.co_varnames == \
        joracle.OracleDetector.__init__.__code__.co_varnames
