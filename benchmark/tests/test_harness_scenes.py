"""Scenes repeat bit for bit from a seed, and the frozen reference finds
their truth."""
import json

import numpy as np
import pytest
from conftest import ROOT, TINY_CONFIG

from benchmark.harness import cell as cellmod
from benchmark.judges.tags import reference

CFG = dict(json.loads((ROOT / "benchmark" / "configs" /
                       "tag36h11-1280x800.json").read_text()), **TINY_CONFIG)
PARAMS = {"frames": 3, "tags_per_frame": [1, 2, 3], "distance_m": [0.5, 1.5],
          "tilt_deg": 45, "noise_sigma": 1.0}
SCENES = cellmod.load_module("scenes", "tags3d")


def test_a_seed_repeats_bit_for_bit_and_seeds_differ():
    a = SCENES.make(2 ** 31 + 5, CFG, PARAMS)
    b = SCENES.make(2 ** 31 + 5, CFG, PARAMS)
    c = SCENES.make(2 ** 31 + 6, CFG, PARAMS)
    assert all(np.array_equal(x, y) for x, y in zip(a.frames, b.frames))
    assert [[t.tag_id for t in f] for f in a.truth] == \
        [[t.tag_id for t in f] for f in b.truth]
    assert not all(np.array_equal(x, y) for x, y in zip(a.frames, c.frames))


def test_every_seed_has_the_same_amount_of_work():
    for seed in (1, 2, 3):
        pool = SCENES.make(seed, CFG, PARAMS)
        assert sorted(len(t) for t in pool.truth) == [1, 2, 3]
        ids = [t.tag_id for f in pool.truth for t in f]
        assert len(ids) == len(set(ids)) == 6
        assert all(f.shape == (400, 640) and f.dtype == np.uint8
                   for f in pool.frames)


def test_the_reference_finds_the_truth():
    pool = SCENES.make(11, CFG, PARAMS)
    refs = reference(pool, CFG, workers=1)
    for truth, found in zip(pool.truth, refs):
        assert sorted(t.tag_id for t in truth) == sorted(d[0] for d in found)
        for d in found:
            t = next(x for x in truth if x.tag_id == d[0])
            # the same four corners, in the detector's order
            gap = np.linalg.norm(d[2][:, None] - t.corners[None], axis=-1)
            assert gap.min(1).max() < 1.0
            assert np.linalg.norm(d[4] - t.t) < 0.02
            assert d[1] == 0


def test_an_impossible_scene_is_refused():
    with pytest.raises(RuntimeError):
        SCENES.make(1, CFG, dict(PARAMS, tags_per_frame=[60],
                                 distance_m=[0.3, 0.31]))
