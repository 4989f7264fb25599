"""The port's span recorder (ros_vision_tpu_torch/utils/tracing.py
RECORDER) and its count of synchronising operations (device.HostSyncs) on
the CPU: the spans a detect_raw call records and how they nest, outputs
bit-identical with the recorder off, the count against a patched count of
uploads and `.item()` reads at both deployment sizes, the rings' bounds,
threads, the clock shared with torch.profiler, the benchmark's readers of
them (benchmark/metrics/), the served loop's det_time_us, and the
game-piece call's spans and their readers."""
import csv
import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness.cell import load_module
from ros_vision_tpu_torch import device
from ros_vision_tpu_torch.apriltag.detector import TorchDetector
from ros_vision_tpu_torch.apriltag.render import (render_scene,
                                                  simple_square_corners)
from ros_vision_tpu_torch.device import HostSyncs
from ros_vision_tpu_torch.ops import decode, quadfit
from ros_vision_tpu_torch.utils import tracing

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
W, H = 320, 160
QUADFIT_PARTS = ("quadfit.sort", "quadfit.lines", "quadfit.quads")
READERS = {"detector.span_ms": ("detector",),
           "quadfit.span_ms": ("quadfit",),
           "quadfit.sort_ms": ("quadfit.sort",),
           "quadfit.lines_ms": ("quadfit.lines",),
           "quadfit.quads_ms": ("quadfit.quads",),
           "decode.span_ms": ("decode.screen", "decode.refine",
                              "decode.tail"),
           "detector.syncs_counted": "syncs",
           "detector.sync_wait_ms": "sync_ns"}
CELLS = ["tag800-pipelined-4cam", "tag1080-pipelined-4cam",
         "tag800-sync-1cam"]
GAMEPIECE_CELL = "gamepiece-yolo11n-pipelined-4cam"
GAMEPIECE_READERS = {"gamepiece.span_ms": ("gamepiece",),
                     "gamepiece.forward_ms": ("gamepiece.forward",),
                     "gamepiece.nms_ms": ("gamepiece.nms",)}
# table uploads a CPU detector call makes once the constant tables are
# on the device: finish_points 1 and the plain pose's 2 (the card runs K3
# and P1 in their place, so a warm call there uploads nothing)
UPLOADS = 3
# the constant tables a device's first call uploads: cluster_and_fit's
# 14, decode's homography basis and the tail's corner table, and
# tag36h11's border samples (3) and data bits (2)
TABLES = 14 + 2 + 5


def _small(**kw):
    """A 320x160 two-tag frame and a small detector whose 64 quad slots
    exceed its 32 active ones, so the screen runs unless turned off."""
    img, _ = render_scene(
        [3, 42], [simple_square_corners(80, 60, 34, angle_deg=10),
                  simple_square_corners(230, 90, 30, angle_deg=-25)],
        W, H, noise_sigma=1.0, seed=1)
    det = TorchDetector(device="cpu", width=W, height=H, max_points=4096,
                        max_segments=64, max_quads=64, fx=300.0, fy=300.0,
                        cx=160.0, cy=80.0, **kw)
    return det, torch.as_tensor(img[None]), torch.as_tensor(
        det.default_intrinsics(1))


def _bench(width, height):
    """The bench layout (ids 0, 42, 311, 100) at a deployment size."""
    s = width / 1280
    corners = [simple_square_corners(300 * s, 250 * s, 90 * s),
               simple_square_corners(800 * s, 400 * s, 110 * s,
                                     angle_deg=20),
               simple_square_corners(450 * s, 600 * s, 70 * s,
                                     angle_deg=-35),
               simple_square_corners(1000 * s, 600 * s, 60 * s,
                                     angle_deg=50)]
    img, _ = render_scene([0, 42, 311, 100], corners, width, height,
                          noise_sigma=0.75, seed=3)
    det = TorchDetector(device="cpu", width=width, height=height,
                        fx=900.0, fy=900.0, cx=width / 2, cy=height / 2)
    return det, torch.as_tensor(img[None]), torch.as_tensor(
        det.default_intrinsics(1))


def _one_call(det, g, intr, packed=False):
    """The call record of one call made now."""
    since = time.time_ns()
    out = (det._detect_packed if packed else det._detect_device)(g, intr)
    calls = tracing.RECORDER.calls(since)
    assert len(calls) == 1
    return out, calls[0]


@pytest.fixture(scope="module")
def small():
    return _small()


@pytest.mark.parametrize("screen", [True, False])
def test_a_call_records_each_span_once(screen):
    det, g, intr = _small(**({} if screen else {"screen_hamming": None}))
    out, call = _one_call(det, g, intr)
    assert sorted(d.tag_id for d in det.unpack(out)[0]) == [3, 42]
    want = set(tracing.SPANS) - ({"decode.screen"} if not screen else set())
    assert set(call["spans"]) == want
    assert all(len(v) == 1 for v in call["spans"].values())
    (t0, t1), = call["spans"]["detector"]
    assert (t0, t1) == (call["t0_ns"], call["t1_ns"])
    assert call["thread"] == threading.get_ident()
    # detect_raw_packed's span covers pack_outputs too, in one record
    _, packed = _one_call(det, g, intr, packed=True)
    assert set(packed["spans"]) == want


def test_spans_nest(small):
    det, g, intr = small
    _, call = _one_call(det, g, intr)
    sp = {k: v[0] for k, v in call["spans"].items()}
    d0, d1 = sp["detector"]
    assert all(d0 <= a <= b <= d1 for a, b in sp.values())
    q0, q1 = sp["quadfit"]
    parts = [sp[k] for k in QUADFIT_PARTS]
    assert all(q0 <= a <= b <= q1 for a, b in parts)
    # in order and apart: sort, then lines, then quads
    assert parts[0][1] <= parts[1][0] and parts[1][1] <= parts[2][0]
    assert q1 <= sp["decode.screen"][0] <= sp["decode.screen"][1] \
        <= sp["decode.refine"][0] <= sp["decode.refine"][1] \
        <= sp["decode.tail"][0]


def _bits(x: torch.Tensor) -> np.ndarray:
    x = x.contiguous()
    return (x.view(torch.int32) if x.dtype == torch.float32 else x).numpy()


def test_outputs_bit_identical_with_recorder_off(small, monkeypatch):
    det, g, intr = small
    on = det._detect_device(g, intr)
    packed_on = det._detect_packed(g, intr)
    monkeypatch.setattr(tracing.RECORDER, "enabled", False)
    since = time.time_ns()
    off = det._detect_device(g, intr)
    packed_off = det._detect_packed(g, intr)
    assert tracing.RECORDER.calls(since) == []
    assert set(on) == set(off)
    for k in on:
        np.testing.assert_array_equal(_bits(on[k]), _bits(off[k]), err_msg=k)
    np.testing.assert_array_equal(_bits(packed_on), _bits(packed_off))


def test_host_syncs_counts_with_recorder_off(monkeypatch):
    s = HostSyncs()
    monkeypatch.setattr(tracing.RECORDER, "enabled", False)
    assert s.item(torch.tensor(3)) == 3
    t = s.upload([1, 2], "cpu")
    assert t.dtype == torch.int64 and s.count == 2


@pytest.mark.parametrize("data,dtype", [
    ([[0, 1], [2, 3]], torch.int32), ([1, 0, 2], None),
    ([True, False], None), ([[-0.08255, 0.08255, 0]], torch.float32),
    (np.arange(4, dtype=np.int64), None),
    (np.linspace(-1, 1, 5, dtype=np.float32), None)])
def test_upload_gives_what_torch_tensor_gives(data, dtype):
    got = HostSyncs().upload(data, "cpu", dtype)
    want = torch.tensor(data, dtype=dtype)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("size", [(1280, 800), (1920, 1080)])
def test_syncs_equal_a_patched_count(size, monkeypatch):
    """`syncs` = torch.tensor / torch.as_tensor calls that take host data
    to a device, plus `.item()` reads, seen in one call: a device's first,
    which uploads the constant tables, and a warm one."""
    det, g, intr = _bench(*size)

    def counted(fn):
        def run(data, *a, **kw):
            if kw.get("device") is not None and \
                    not isinstance(data, torch.Tensor):
                seen["uploads"] += 1
            return fn(data, *a, **kw)
        return run

    item = torch.Tensor.item

    def counted_item(self):
        seen["items"] += 1
        return item(self)
    # the constant tables are uploaded on a device's first call only
    monkeypatch.setattr(device, "_TABLES", {})
    for uploads in (UPLOADS + TABLES, UPLOADS):
        seen = {"uploads": 0, "items": 0}
        with monkeypatch.context() as m:
            m.setattr(torch, "tensor", counted(torch.tensor))
            m.setattr(torch, "as_tensor", counted(torch.as_tensor))
            m.setattr(torch.Tensor, "item", counted_item)
            before = det.host_syncs.count
            out, call = _one_call(det, g, intr)
        assert sorted(d.tag_id for d in det.unpack(out)[0]) == \
            [0, 42, 100, 311]
        assert seen["items"] == 4 and seen["uploads"] == uploads
        assert call["syncs"] == seen["uploads"] + seen["items"] \
            == det.host_syncs.count - before
        assert 0 < call["sync_ns"] < call["t1_ns"] - call["t0_ns"]


def _record(rec, n_calls, spans=("quadfit", "decode.tail"), syncs=2):
    """n_calls calls recorded in `rec` (tracing.RECORDER patched to it):
    each with `spans` and `syncs` reads; returns the harness-like
    (t0_ns, t1_ns) around each call."""
    s = HostSyncs()
    out = []
    for _ in range(n_calls):
        t0 = time.time_ns()
        with tracing.Call(s):
            for name in spans:
                with tracing.Span(name):
                    pass
            for _ in range(syncs):
                s.item(torch.tensor(1))
        out.append((t0, time.time_ns()))
    return out


def test_ring_keeps_the_newest_and_knows_what_it_lost(monkeypatch):
    rec = tracing.Recorder(span_slots=8, call_slots=4)
    monkeypatch.setattr(tracing, "RECORDER", rec)
    bounds = _record(rec, 6)                # 3 spans a call: 18 > 8
    calls = rec.calls()
    assert len(calls) == 4                  # calls 2..5
    assert [c["t0_ns"] >= bounds[2][0] for c in calls] == [True] * 4
    # the span ring holds spans 10..17: calls 5 and 4, and 3 but its first
    assert calls[0]["spans"] is None and calls[1]["spans"] is None
    assert all(set(c["spans"]) == {"quadfit", "decode.tail", "detector"}
               for c in calls[2:])
    assert all(c["syncs"] == 2 for c in calls)
    with pytest.raises(ValueError):
        tracing.Recorder(span_slots=12)


def _summary(bounds, stretch="spans"):
    return {"calls": [{"ns": list(b), "stretch": stretch} for b in bounds]}


def _expect(calls, what):
    if isinstance(what, str):
        div = 1e6 if what == "sync_ns" else 1
        return sum(c[what] for c in calls) / len(calls) / div
    return sum(t1 - t0 for c in calls for n in what
               for t0, t1 in c["spans"].get(n, ())) / len(calls) / 1e6


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_a_synthetic_recorder(name, monkeypatch):
    rec = tracing.Recorder(span_slots=256, call_slots=64)
    monkeypatch.setattr(tracing, "RECORDER", rec)
    reader = load_module("metrics", name, ROOT)
    assert reader.read(_summary([])) is None             # nothing recorded
    _record(rec, 2)                                       # warm-up calls
    bounds = _record(rec, 5, spans=tracing.SPANS[1:], syncs=3)
    held = rec.calls()
    end = bounds[-1][1]
    # the first call is not in the stretch; its last holds no program call
    got = reader.read(_summary(bounds[1:] + [(end + 1, end + 2)]))
    assert got == pytest.approx(_expect(held[3:], READERS[name]))
    assert got > 0
    if name == "detector.syncs_counted":
        assert got == 3
    # the other stretches' calls are not read
    assert reader.read(_summary(bounds, "syncs")) is None
    # the ring no longer holds the stretch's first call: absent
    _record(rec, 64)
    assert reader.read(_summary(bounds)) is None
    # a program without the recorder: absent
    monkeypatch.delattr(tracing, "RECORDER")
    assert reader.read(_summary(bounds)) is None


@pytest.mark.parametrize("name", [n for n in READERS
                                  if not n.startswith("detector.sync")])
def test_span_reader_absent_when_the_span_ring_lost_spans(name,
                                                         monkeypatch):
    rec = tracing.Recorder(span_slots=16, call_slots=64)
    monkeypatch.setattr(tracing, "RECORDER", rec)
    bounds = _record(rec, 8, spans=tracing.SPANS[1:])
    reader = load_module("metrics", name, ROOT)
    assert reader.read(_summary(bounds)) is None
    assert load_module("metrics", "detector.syncs_counted", ROOT).read(
        _summary(bounds)) == 2


def test_manifest_entries():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in manifest["per_layer"]}
    layers = {"detector": "apriltag.detector", "quadfit": "ops.quadfit",
              "decode": "ops.decode"}
    for name in READERS:
        m = entries[name]
        assert m == {"name": name,
                     "unit": "count" if name.endswith("counted") else "ms",
                     "better": "lower",
                     "source": "program_counter"
                     if name.endswith("counted") else "program_span",
                     "layer": layers[name.split(".")[0]],
                     "moves": "latency_p95_ms", "workloads": CELLS}
        assert callable(load_module("metrics", name, ROOT).read)
    # added after the benchmark's first 11 metrics
    names = [m["name"] for m in manifest["per_layer"]]
    assert set(names[11:11 + len(READERS)]) == set(READERS)
    assert entries["quadfit.graph_share"] == {
        "name": "quadfit.graph_share", "unit": "%", "better": "higher",
        "source": "program_counter", "layer": "ops.quadfit",
        "moves": "latency_p95_ms", "workloads": CELLS}


def test_graph_share_reader(monkeypatch):
    """quadfit.graph_share: replayed cluster_and_fit calls over all of
    them on a CUDA device, in %, over the spans stretch's program calls;
    absent where none ran on a CUDA device or the records lack the
    counts."""
    rec = tracing.Recorder(span_slots=256, call_slots=64)
    monkeypatch.setattr(tracing, "RECORDER", rec)
    reader = load_module("metrics", "quadfit.graph_share", ROOT)
    s = HostSyncs()

    def calls(runs):
        out = []
        for how in runs:
            t0 = time.time_ns()
            with tracing.Call(s):
                if how is not None:
                    rec.graph_run("quadfit", how)
            out.append((t0, time.time_ns()))
        return out

    assert reader.read(_summary(calls([None] * 3))) is None
    bounds = calls([0, 1, 2, 2, None, 2])
    assert [(c["quadfit_eager"], c["quadfit_captured"],
             c["quadfit_replayed"]) for c in rec.calls()[-6:]] == \
        [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 1), (0, 0, 0), (0, 0, 1)]
    assert reader.read(_summary(bounds)) == pytest.approx(60.0)
    assert reader.read(_summary(bounds[2:])) == pytest.approx(100.0)
    assert reader.read(_summary(bounds, "syncs")) is None
    real = rec.calls
    monkeypatch.setattr(rec, "calls", lambda *a: [
        {k: v for k, v in c.items() if not k.startswith("quadfit_")}
        for c in real(*a)])
    assert reader.read(_summary(bounds)) is None
    # the CPU runs cluster_and_fit eagerly, outside the runner
    monkeypatch.setattr(tracing, "RECORDER", tracing.Recorder())
    det, g, intr = _small()
    _, call = _one_call(det, g, intr)
    assert (call["quadfit_eager"], call["quadfit_captured"],
            call["quadfit_replayed"]) == (0, 0, 0)


def test_decode_graph_share_entry_and_cpu_counts(monkeypatch):
    """decode.graph_share's manifest entry, and its counts in a CPU call
    record: the CPU runs decode_quads eagerly, outside the runner, so a
    call counts no decode run and the reader is absent."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in manifest["per_layer"]}
    assert entries["decode.graph_share"] == {
        "name": "decode.graph_share", "unit": "%", "better": "higher",
        "source": "program_counter", "layer": "ops.decode",
        "moves": "latency_p95_ms", "workloads": CELLS}
    monkeypatch.setattr(tracing, "RECORDER", tracing.Recorder())
    det, g, intr = _small()
    t0 = time.time_ns()
    _, call = _one_call(det, g, intr)
    assert (call["decode_eager"], call["decode_captured"],
            call["decode_replayed"]) == (0, 0, 0)
    reader = load_module("metrics", "decode.graph_share", ROOT)
    assert reader.read(_summary([(t0, time.time_ns())])) is None


def test_threads_record_calls_of_their_own(small):
    """A mesh of two CPU devices: each worker thread records its own
    call, with its own spans and counts."""
    det, g, intr = small
    # the constant tables are uploaded on a device's first call only
    quadfit.constant_tables(torch.device("cpu"), HostSyncs())
    decode.decode_tables(det.family, torch.device("cpu"), HostSyncs())
    det2 = TorchDetector(det.config, device="cpu")
    det2.use_mesh([torch.device("cpu"), torch.device("cpu")])
    g2 = torch.cat([g, g])
    intr2 = torch.cat([intr, intr])
    since = time.time_ns()
    det2.detect_raw(g2, intr2)
    calls = tracing.RECORDER.calls(since)
    me = threading.get_ident()
    assert len(calls) == 2 and len({c["thread"] for c in calls}) == 2
    assert me not in {c["thread"] for c in calls}
    _, alone = _one_call(det, g, intr)
    for c in calls:
        assert set(c["spans"]) == set(alone["spans"])
        assert c["syncs"] == alone["syncs"] > 0


def test_spans_share_the_profilers_clock(small):
    """Under torch.profiler (CPU activity) every aten::sort of a
    cluster_and_fit call (nested ones left out) starts inside that call's
    quadfit span, 3, 2 and 1 of them inside its three parts: the key and
    theta sorts and the y-key sort; the maxima's two sorts; the slots'
    sort."""
    from torch.profiler import ProfilerActivity, profile
    det, g, intr = small
    det._detect_device(g, intr)
    since = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        det._detect_device(g, intr)
    (call,) = tracing.RECORDER.calls(since)
    # by start, the enclosing event first where two start together
    sorts = sorted(((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in p.profiler.kineto_results.events()
                    if e.name() == "aten::sort"),
                   key=lambda x: (x[0], -x[1]))
    outer = [s for i, (s, e) in enumerate(sorts)
             if not any(a <= s and e <= b for a, b in sorts[:i])]
    (q0, q1), = call["spans"]["quadfit"]
    inside = {k: sum(a <= s <= b for s in outer
                     for a, b in call["spans"][k]) for k in QUADFIT_PARTS}
    assert inside == {"quadfit.sort": 3, "quadfit.lines": 2,
                      "quadfit.quads": 1}
    assert sum(q0 <= s <= q1 for s in outer) == 6


def test_det_time_us_holds_the_detector_span(small, tmp_path):
    from ros_vision_tpu_torch.apriltag.detector import PendingOutput
    from ros_vision_tpu_torch.runtime.vision_node import (CameraChannel,
                                                          VisionNode)
    det, g, intr = small
    path = tmp_path / "timing.csv"
    node = VisionNode(det, [CameraChannel(
        location="cam0", extrinsic_rotation=np.eye(3),
        extrinsic_offset=np.zeros(3))], intrinsics=det.default_intrinsics(1),
        measurement_mode=True, timing_csv_path=str(path))
    since = time.time_ns()
    pending = node.submit(g)
    (call,) = tracing.RECORDER.calls(since)
    assert isinstance(pending, PendingOutput)
    assert pending.detect_ns == call["t1_ns"] - call["t0_ns"] > 0
    t0 = time.monotonic()
    node.process_batch(g.numpy(), pending=pending)
    waited_us = (time.monotonic() - t0) * 1e6
    node.stop()
    with open(path) as f:
        (row,) = list(csv.DictReader(f))
    det_us = float(row["det_time_us"])
    assert pending.detect_ns / 1e3 <= det_us + 0.1
    assert det_us <= pending.detect_ns / 1e3 + waited_us + 0.1


def _gamepiece_engine():
    from ros_vision_tpu_torch.models.infer import ModelInference
    return ModelInference(num_classes=1, img_size=96, dtype=torch.float32,
                          device="cpu")


def test_a_gamepiece_call_records_each_span_once():
    eng = _gamepiece_engine()
    frames = np.random.default_rng(0).integers(0, 255, (2, 96, 128, 3),
                                               dtype=np.uint8)
    since = time.time_ns()
    packed = eng.detect_packed(frames)
    calls = tracing.RECORDER.calls(since)
    assert len(calls) == 1 and packed.shape == (2, 100, 7)
    call = calls[0]
    assert set(call["spans"]) == set(tracing.GAMEPIECE_SPANS)
    assert all(len(v) == 1 for v in call["spans"].values())
    sp = {k: v[0] for k, v in call["spans"].items()}
    assert sp["gamepiece"] == (call["t0_ns"], call["t1_ns"])
    parts = [sp[k] for k in tracing.GAMEPIECE_SPANS[1:]]
    assert all(call["t0_ns"] <= a <= b <= call["t1_ns"] for a, b in parts)
    # in order and apart: preprocess, then forward, then NMS
    assert parts[0][1] <= parts[1][0] and parts[1][1] <= parts[2][0]
    # it counts no host read and no upload (the card test holds that
    # there are none)
    assert call["syncs"] == 0 and call["sync_ns"] == 0
    # a second call, a second record
    eng.detect_packed(frames)
    assert len(tracing.RECORDER.calls(since)) == 2


def test_a_call_without_host_syncs_records_none(monkeypatch):
    rec = tracing.Recorder(span_slots=64, call_slots=16)
    monkeypatch.setattr(tracing, "RECORDER", rec)
    with tracing.Call(None, "gamepiece"):
        with tracing.Span("gamepiece.nms"):
            pass
    (call,) = rec.calls()
    assert call["syncs"] == 0 and call["sync_ns"] == 0
    assert set(call["spans"]) == {"gamepiece", "gamepiece.nms"}


def _record_gamepiece(rec, n_calls, syncs=0):
    s = HostSyncs()
    out = []
    for _ in range(n_calls):
        t0 = time.time_ns()
        with tracing.Call(s, "gamepiece"):
            for name in tracing.GAMEPIECE_SPANS[1:]:
                with tracing.Span(name):
                    pass
            for _ in range(syncs):
                s.item(torch.tensor(1))
        out.append((t0, time.time_ns()))
    return out


@pytest.mark.parametrize("name", sorted(GAMEPIECE_READERS))
def test_gamepiece_reader_on_a_synthetic_recorder(name, monkeypatch):
    rec = tracing.Recorder(span_slots=256, call_slots=64)
    monkeypatch.setattr(tracing, "RECORDER", rec)
    reader = load_module("metrics", name, ROOT)
    assert reader.read(_summary([])) is None
    # detector calls alone: nothing of the game piece to read
    bounds = _record(rec, 3)
    assert reader.read(_summary(bounds)) is None
    bounds = _record_gamepiece(rec, 5, syncs=1)
    held = rec.calls()[3:]
    got = reader.read(_summary(bounds))
    assert got == pytest.approx(_expect(held, GAMEPIECE_READERS[name]))
    assert got > 0
    assert reader.read(_summary(bounds, "syncs")) is None
    monkeypatch.delattr(tracing, "RECORDER")
    assert reader.read(_summary(bounds)) is None


def test_gamepiece_mfu_and_launches_readers(monkeypatch):
    from benchmark.harness import roofline
    rec = tracing.Recorder(span_slots=256, call_slots=64)
    monkeypatch.setattr(tracing, "RECORDER", rec)
    mfu = load_module("metrics", "gamepiece.mfu", ROOT)
    span = load_module("metrics", "gamepiece.span_ms", ROOT)
    bounds = _record_gamepiece(rec, 4)
    summary = _summary(bounds)
    summary["layers"] = {}
    assert mfu.read(summary) is None
    summary["layers"] = {"gamepiece_flops": 25.5e9}
    ms = span.read(summary)
    assert mfu.read(summary) == pytest.approx(
        25.5e9 / (ms * 1e-3) / roofline.BF16_TENSOR_OPS_S * 100)
    launches = load_module("metrics", "gamepiece.launches", ROOT)
    assert launches.read({"profile": None}) is None
    prof = {"calls": 4, "device_ops": 4100, "stages": {
        "other": {"launches": 4000, "device_ms": 1.0},
        "outside calls": {"launches": 100, "device_ms": 0.1}}}
    assert launches.read({"profile": prof}) == 1000


def test_gamepiece_manifest_entries():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in manifest["per_layer"]}
    for name in list(GAMEPIECE_READERS) + ["gamepiece.launches",
                                           "gamepiece.mfu"]:
        m = entries[name]
        assert m["workloads"] == [GAMEPIECE_CELL]
        assert m["moves"] == "latency_p95_ms"
        assert m["layer"] == "runtime.game_piece_node + models.infer"
        assert callable(load_module("metrics", name, ROOT).read)
    for name in ("device.idle_share", "loop.frames_per_s",
                 "loop.latency_p50_ms"):
        assert GAMEPIECE_CELL in entries[name]["workloads"]
