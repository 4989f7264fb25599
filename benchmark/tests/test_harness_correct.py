"""`correct` comes out false for the control and for each fault the cells
can have, at sizes a test run holds; the program's plain path passes on
the same frames."""
import json

import numpy as np
import pytest
from conftest import ROOT

from benchmark import run
from benchmark.harness import cell as cellmod
from benchmark.judges import tags


CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
TAG_CELLS = [c for c in CELLS if cellmod.find_cell(c).judge == "tags"]


@pytest.mark.parametrize("cell", TAG_CELLS)
def test_the_control_fails_the_cells_limits(cell):
    c = cellmod.find_cell(cell)
    scenes = cellmod.load_module("scenes", c.traffic["scene"]["generator"])
    params = dict(c.traffic["scene"], frames=2, tags_per_frame=[3, 4])
    pool = scenes.make(2 ** 31 + 77, c.config, params)
    refs = tags.reference(pool, c.config, workers=2)
    ctrl = tags.reference(pool, c.config, control=True, workers=2)
    answers = [tags.Answer(i, d) for i, d in enumerate(ctrl)]
    limits = {k: v for k, v in c.limits.items() if k != "robot_m"}
    worst, failed = tags.compare(answers, refs, c.config, limits)
    assert failed > 0
    assert any(worst[k] > v for k, v in limits.items())
    # the reference in the program's place passes
    same = [tags.Answer(i, d) for i, d in enumerate(refs)]
    assert tags.compare(same, refs, c.config, limits)[1] == 0


def test_a_tag_the_scene_never_placed_is_not_due():
    """Seed 2147485717 at 1920x1080: in frame 2 the reference decodes a
    noise quad as tag 181 (hamming 2, decision margin 0.82) where the scene
    placed none. An answer without it is not short of a tag; one that
    drops a placed tag is."""
    c = cellmod.find_cell("tag1080-pipelined-4cam")
    scenes = cellmod.load_module("scenes", c.traffic["scene"]["generator"])
    pool = scenes.make(2147485717, c.config, c.traffic["scene"])
    frame2 = scenes.Pool(pool.frames[2:3], pool.truth[2:3])
    ref = tags.reference(frame2, c.config, workers=1)[0]
    placed = [{t.tag_id for t in pool.truth[2]}]
    assert 181 in {r[0] for r in ref} and 181 not in placed[0]
    limits = {k: v for k, v in c.limits.items() if k != "robot_m"}
    real = [r for r in ref if r[0] in placed[0]]
    worst, failed = tags.compare([tags.Answer(0, real)], [ref],
                                 c.config, limits, placed)
    assert failed == 0 and worst["missed_tags"] == 0
    # the judge takes the placed ids from the pool and notes the tag
    worst, failed, notes = tags.judge([tags.Answer(0, real)], [ref], frame2,
                                      c.config, limits)
    assert failed == 0 and worst["missed_tags"] == 0
    assert [x[:2] for x in notes["reference_unplaced"]] == [[0, 181]]
    # without the scene's ids every tag the reference finds is due
    assert tags.compare([tags.Answer(0, real)], [ref], c.config,
                        limits)[1] == 1
    short = tags.compare([tags.Answer(0, real[1:])], [ref], c.config,
                         limits, placed)
    assert short[1] == 1 and short[0]["missed_tags"] == 1


def _faulty_run(root, cell, monkeypatch, fault):
    from ros_vision_tpu_torch.apriltag import detector as det_mod
    from ros_vision_tpu_torch.runtime import vision_node
    if fault == "id":
        unpack = det_mod.TorchDetector.unpack

        def altered(self, out):
            rows = unpack(self, out)
            for dets in rows:
                for d in dets[:1]:
                    d.tag_id += 1
            return rows
        monkeypatch.setattr(det_mod.TorchDetector, "unpack", altered)
    elif fault == "corners":
        unpack = det_mod.TorchDetector.unpack

        def moved(self, out):
            rows = unpack(self, out)
            for dets in rows:
                for d in dets:
                    d.corners = np.asarray(d.corners) + 3.0
            return rows
        monkeypatch.setattr(det_mod.TorchDetector, "unpack", moved)
    elif fault == "pose":
        unpack = det_mod.TorchDetector.unpack

        def shifted(self, out):
            rows = unpack(self, out)
            for dets in rows:
                for d in dets:
                    d.pose_t = np.asarray(d.pose_t) * 1.01
            return rows
        monkeypatch.setattr(det_mod.TorchDetector, "unpack", shifted)
    elif fault == "half_batch":
        packed = det_mod.TorchDetector.detect_raw_packed

        def half(self, *a, **kw):
            out = packed(self, *a, **kw).clone()
            b = out.shape[0]
            out[b - max(1, b // 2):, :, 0] = 0.0   # ok = False
            return out
        monkeypatch.setattr(det_mod.TorchDetector, "detect_raw_packed", half)
    elif fault == "robot":
        monkeypatch.setattr(
            vision_node.VisionNode, "transform_camera_to_robot",
            lambda self, ch, p: ch.extrinsic_rotation @ np.asarray(p)
            + ch.extrinsic_offset + 0.05)
    args = run.parse(["--workload", cell, "--seed", "2147483999",
                      "--seconds", "4", "--trace", "0"])
    return run.measure(args, root, device="cpu")["result"]


@pytest.mark.parametrize("cell,fault", [
    ("tiny-pipe", "id"), ("tiny-pipe", "corners"), ("tiny-pipe", "pose"),
    ("tiny-pipe", "half_batch"), ("tiny-sync", "half_batch"),
    ("tiny-stream", "id"), ("tiny-stream", "half_batch"),
    ("tiny-stream", "robot")])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell,
                                            fault):
    res = _faulty_run(tiny_root, cell, monkeypatch, fault)
    assert res["correct"] is False
    assert res["failed"] > 0
    json.dumps(res)


def test_limits_name_only_known_numbers():
    for name in CELLS:
        c = cellmod.find_cell(name)
        lim = c.limits
        assert set(lim) <= set(cellmod.load_module("judges", c.judge).NUMBERS)
        if c.judge != "tags":
            continue
        for k in ("extra_ids", "missed_tags", "empty_answers",
                  "hamming_mismatch"):
            assert lim[k] == 0
