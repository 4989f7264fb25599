"""ops/decode's constant tables and its GraphRunner on the CPU.

decode_tables: uploaded once a device, with the values and dtypes
torch.as_tensor gives the numpy tables. GraphRunner: the CUDA graph is
replaced by a stand-in that runs the body at capture and again at each
replay into the same output tensors (as tests/test_torch_quadfit.py's
cpu_graphs does for cluster_and_fit), so the runner's keys, bound buffers,
copies and fallback are held to the eager body's bits here; chip_smoke.py's
decode_graph phase holds the real graphs on the card."""
import dataclasses

import numpy as np
import pytest
import torch

from ros_vision_tpu_torch import device
from ros_vision_tpu_torch.apriltag.families import TagFamily, get_family
from ros_vision_tpu_torch.apriltag.render import (render_scene,
                                                  simple_square_corners)
from ros_vision_tpu_torch.device import HostSyncs
from ros_vision_tpu_torch.ops import decode as dec

torch.set_num_threads(1)

W, H = 320, 160
FAM = get_family("tag36h11")
# tag36h11 with its bits given as a bit_xy layout: the sparse-grid path
# (grid_idx) of the same codes
SPARSE = TagFamily(name="tag36h11-bit-xy", grid_size=0, min_hamming=11,
                   codes=FAM.codes, bit_xy=FAM.bit_coords(),
                   width_at_border_=FAM.border_size,
                   total_width_=FAM.total_width)
KEYS = ("ok", "tag_id", "hamming", "rotation", "margin", "H")


def _inputs(b=2, nq=8, w=W, h=H, seed=0):
    """gray (B, H, W) u8, two tags a frame; corners (B, NQ, 4, 2): the
    tags' corners, then copies moved by N(0, 1.5 px); quad_valid with
    slots 0-2 and every other one after valid."""
    rng = np.random.default_rng(seed)
    frames, corners = [], []
    for i in range(b):
        cs = [simple_square_corners(w * 0.25, h * 0.4, 34, angle_deg=10 + i),
              simple_square_corners(w * 0.7, h * 0.55, 30, angle_deg=-25)]
        img, placed = render_scene([3, 42 + i], cs, w, h, noise_sigma=1.0,
                                   seed=seed + i)
        frames.append(img)
        tags = np.stack([p.corners for p in placed])
        pick = tags[np.arange(nq) % 2]
        pick[2:] += rng.normal(0, 1.5, pick[2:].shape)
        corners.append(pick)
    valid = (np.arange(nq) < 3) | (np.arange(nq) % 2 == 0)
    return (torch.as_tensor(np.stack(frames)),
            torch.as_tensor(np.stack(corners).astype(np.float32)),
            torch.as_tensor(np.tile(valid, (b, 1))))


def _code_matrix(fam):
    return torch.as_tensor(dec.make_code_matrix(fam))


# one code matrix a family, held as a detector holds its own: a graph is
# keyed by the matrix's identity
CM = {f.name: _code_matrix(f) for f in (FAM, SPARSE)}


class _CpuGraph:
    """A CPU stand-in for a captured CUDA graph: it runs the body on its
    bound inputs once at capture, and each replay runs it again and
    writes the results into the same output tensors."""

    def __init__(self, fn, bound):
        self.fn, self.bound = fn, bound
        self.outputs = fn(**bound)

    def replay(self):
        for k, v in self.fn(**self.bound).items():
            self.outputs[k].copy_(v)


@pytest.fixture
def cpu_graphs(monkeypatch):
    def record(self, fn, bound):
        g = _CpuGraph(fn, bound)
        return g, g.outputs
    monkeypatch.setattr(dec.GraphRunner, "_record", record)


def _run(runner, gray, corners, valid, fam=FAM, cm=None):
    cm = CM[fam.name] if cm is None else cm
    syncs = HostSyncs()
    tabs = dec.decode_tables(fam, corners.device, syncs)
    out = runner.run(gray, corners, valid, fam, cm, tabs)
    assert syncs.count == 0           # the tables were already there
    return out


def _eager(gray, corners, valid, fam=FAM):
    return dec.decode_quads(gray, corners, valid, fam, _code_matrix(fam))


def _same(got, want):
    assert set(got) == set(KEYS)
    for k in KEYS:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.fixture(autouse=True)
def _tables():
    for fam in (FAM, SPARSE):
        dec.decode_tables(fam, torch.device("cpu"), HostSyncs())


def test_runner_replays_bit_identical(cpu_graphs):
    """The runner's eager, capture and replay calls give the eager body's
    bits in every returned tensor; a result it returned keeps them when a
    later call replays the graph on other inputs."""
    gray, corners, valid = _inputs()
    want = _eager(gray, corners, valid)
    assert want["ok"].any() and not want["ok"].all()
    runner = dec.GraphRunner()
    got = [_run(runner, gray, corners, valid) for _ in range(3)]
    assert runner.runs == {"eager": 1, "captured": 1, "replayed": 1}
    for g in got:
        _same(g, want)
    flipped = (gray.flip(0), corners.flip(1), valid.flip(1))
    other = _run(runner, *flipped)
    assert runner.runs["replayed"] == 2
    for g in got:
        _same(g, want)
    _same(other, _eager(*flipped))
    assert not torch.equal(other["tag_id"], want["tag_id"])


def test_runner_runs_eagerly_where_capture_fails(cpu_graphs, monkeypatch):
    """A key whose capture raises runs eagerly, then and from then on,
    with a warning; outputs keep their bits."""
    gray, corners, valid = _inputs()
    want = _eager(gray, corners, valid)

    def failing(self, fn, bound):
        raise RuntimeError("capture invalidated")
    monkeypatch.setattr(dec.GraphRunner, "_record", failing)
    runner = dec.GraphRunner()
    _run(runner, gray, corners, valid)
    with pytest.warns(UserWarning, match="decode_quads: capture failed"):
        got = [_run(runner, gray, corners, valid)]
    got += [_run(runner, gray, corners, valid) for _ in range(2)]
    assert runner.runs == {"eager": 4, "captured": 0, "replayed": 0}
    assert not runner._graphs
    for g in got:
        _same(g, want)


@pytest.mark.parametrize("change", ["B", "NQ", "frame", "family",
                                    "code_matrix"])
def test_graph_key_separates(cpu_graphs, change):
    """A call that differs from two earlier ones only in `change` runs
    eagerly again, and captures on its next call: its graph is keyed
    apart. Both keys then replay."""
    base = _inputs()
    cm0 = CM[FAM.name]
    runner = dec.GraphRunner()
    for _ in range(2):
        _run(runner, *base, cm=cm0)
    args, fam, cm = base, FAM, cm0
    if change == "B":
        args = _inputs(b=1)
    elif change == "NQ":
        args = _inputs(nq=32)
    elif change == "frame":
        args = _inputs(w=W + 8)
    elif change == "family":
        fam = SPARSE
        cm = CM[fam.name]
    else:
        cm = cm0.clone()
    want = _eager(*args, fam=fam)
    _same(_run(runner, *args, fam=fam, cm=cm), want)
    assert runner.runs == {"eager": 2, "captured": 1, "replayed": 0}
    _same(_run(runner, *args, fam=fam, cm=cm), want)
    assert runner.runs["captured"] == 2 and len(runner._graphs) == 2
    _run(runner, *base, cm=cm0)
    _same(_run(runner, *args, fam=fam, cm=cm), want)
    assert runner.runs["replayed"] == 2


def test_bit_xy_family_decodes_as_the_dense_one():
    """The sparse-grid path (grid_idx) of tag36h11's own layout gives the
    dense path's bits."""
    gray, corners, valid = _inputs()
    _same(_eager(gray, corners, valid, SPARSE), _eager(gray, corners, valid))


@pytest.mark.parametrize("fam", [FAM, SPARSE], ids=lambda f: f.name)
def test_tables_equal_what_as_tensor_gives(fam, monkeypatch):
    """decode_tables: the numpy tables as torch.as_tensor gives them
    (grid_idx as int64), uploaded through `syncs` on the device's first
    call (the basis and the tag's corners once a device, the family's
    once a device and family) and the same tensors after."""
    monkeypatch.setattr(device, "_TABLES", {})
    cpu = torch.device("cpu")
    syncs = HostSyncs()
    tabs = dec.decode_tables(fam, cpu, syncs)
    n_family = 5 + (fam.bit_xy is not None)
    assert syncs.count == 2 + n_family
    assert dec.decode_tables(fam, cpu, syncs) is tabs
    assert dec.constant_tables(cpu, syncs)["basis"] is tabs["basis"]
    other = dataclasses.replace(fam, name=fam.name + "-copy")
    dec.decode_tables(other, cpu, syncs)
    assert syncs.count == 2 + 2 * n_family
    (btx, bty, bwhite), (dtx, dty), grid_idx = dec._decode_tables(fam)
    want = {"basis": torch.as_tensor(dec._SRC_BASIS_INV),
            "btx": torch.as_tensor(btx), "bty": torch.as_tensor(bty),
            "bwhite": torch.as_tensor(bwhite), "dtx": torch.as_tensor(dtx),
            "dty": torch.as_tensor(dty),
            "grid_idx": None if grid_idx is None
            else torch.as_tensor(grid_idx, dtype=torch.int64)}
    assert set(tabs) == set(want)
    assert (want["grid_idx"] is None) == (fam.bit_xy is None)
    for name, w in want.items():
        if w is None:
            assert tabs[name] is None, name
            continue
        assert tabs[name].dtype == w.dtype, name
        assert torch.equal(tabs[name], w), name
    corners = dec.constant_tables(cpu, syncs)["tag_corners"]
    assert corners.dtype == torch.float32
    assert torch.equal(corners, torch.as_tensor(
        [[-1, 1], [1, 1], [1, -1], [-1, -1]], dtype=torch.float32))
