"""The tiled union-find of csrc/unionfind.cuh (the labelling of K2
rank_image and K6 propagate_fixpoint) on the CPU: its launch plan
(ops/ccl_kernel.py ccl_plan) and a numpy emulation of its three phases on
the plan's tiles, held bit-exact against the port's plain CCL
(ops/ccl.py hook_labels, propagate_fixpoint) and the JAX
ccl.label_components. The card runs the kernels themselves
(chip_smoke.py); the emulation follows their edge rule, tile borders,
corner diagonals and slots step by step, so that a border bug shows here
without a card.

Phase A: union-find inside each tile on tile-local indices, with the edge
rule evaluated as the tile sees it (neighbours outside the tile count as
different); runs of equal values within a warp's 32 pixels of a row start
linked to their first pixel, so left edges are unioned only between
warps; each pixel's label is the global index of its tile-local root. Phase B: the pixels of each tile's top row, left column and right
column union their edges that leave the tile, with the whole frame in
view, finds starting at tile-local roots. Phase C: per tile, each pixel's
slot (its label where that lies in the tile, else the pixel), one total
per slot, one find per slot, then every pixel's final label, into an
array of its own (the union-find's forest is scratch).
"""
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from ros_vision_tpu.ops import ccl as jccl
from ros_vision_tpu_torch.ops import ccl as tccl
from ros_vision_tpu_torch.ops import ccl_kernel as ck
from tests.test_torch_ccl import _scene, _threshim
from tests.torch_port_helpers import checkerboard, n, random_threshim, t

INT32_MAX = 2 ** 31 - 1
BIG = 2 ** 30


CASES = {
    "scene": _scene,                                       # (1, 80, 128)
    "random": lambda: random_threshim(2, 48, 96, seed=3),
    # 2x2 black blocks: thousands of blobs
    "overflow": lambda: _threshim(checkerboard(256, 512, 4, 0.1, 1)),
    # 255 diagonals every 32 px pass through the 32x128 tiles' corners
    "staircase": lambda: chip_smoke.staircase_plane(100, 300),
    "spiral": lambda: chip_smoke.spiral_plane(90, 300),
    "comb": lambda: chip_smoke.comb_plane(70, 260),
    "all127": lambda: np.full((1, 40, 200), 127, np.uint8),
    "all0": lambda: np.zeros((1, 40, 200), np.uint8),
    "ragged_37x53": lambda: random_threshim(3, 37, 53, seed=4),
    "ragged_40x960": lambda: random_threshim(1, 40, 960, seed=5),
}


def _neighbour(img: np.ndarray, dy: int, dx: int, plan=None) -> np.ndarray:
    """img[y + dy, x + dx], -1 outside the frame or (with a plan) outside
    the pixel's tile."""
    h, w = img.shape
    pad = np.full((h + 2, w + 2), -1, np.int32)
    pad[1:-1, 1:-1] = img
    nb = pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    if plan is not None:
        yy, xx = np.mgrid[:h, :w]
        same = (((yy + dy) // plan.tile_h == yy // plan.tile_h)
                & ((xx + dx) // plan.tile_w == xx // plan.tile_w))
        nb = np.where(same, nb, -1)
    return nb


# (bit, dy, dx) of edge_mask: left, up, up-left, up-right
_EDGES = [(1, 0, -1), (2, -1, 0), (4, -1, -1), (8, -1, 1)]


def edge_masks(img: np.ndarray, plan=None) -> np.ndarray:
    """csrc/unionfind.cuh edge_mask at every pixel of an (H, W) plane;
    with a plan, as phase A sees it (only the pixel's tile)."""
    v = img.astype(np.int32)
    left, up, ul, ur = (_neighbour(v, dy, dx, plan) == v
                        for _, dy, dx in _EDGES)
    white = v == 255
    m = (left.astype(np.int32) | (up & ~(left & ul)) << 1
         | (white & ul & ~left & ~up) << 2 | (white & ur & ~up) << 3)
    return np.where(v == 127, 0, m)


class UnionFind:
    """csrc/unionfind.cuh warp_find / warp_union on one label array:
    path-halving finds, the larger root linked under the smaller."""

    def __init__(self, labels: np.ndarray):
        self.L = labels

    def find(self, x: int) -> int:
        L = self.L
        while True:
            p = L[x]
            if p == x:
                return x
            g = L[p]
            if g == p:
                return p
            L[x] = g
            x = g

    def union(self, a: int, b: int) -> None:
        a, b = self.find(a), self.find(b)
        if a != b:
            a, b = min(a, b), max(a, b)
            self.L[b] = a


def _tiles(plan, h, w):
    for ty in range(plan.tiles_y):
        for tx in range(plan.tiles_x):
            y0, x0 = ty * plan.tile_h, tx * plan.tile_w
            yield y0, x0, min(plan.tile_h, h - y0), min(plan.tile_w, w - x0)


def _border_pixels(rh: int, rw: int):
    """Phase B's pixels of a tile, in the kernel's order: the top row,
    the left column below it, the right column below it."""
    yield from ((0, lx) for lx in range(rw))
    yield from ((ly, 0) for ly in range(1, rh))
    if rw > 1:
        yield from ((ly, rw - 1) for ly in range(1, rh))


def emulate(img: np.ndarray, values: np.ndarray, plan):
    """Phases A, B and C on one (H, W) plane -> (labels, sizes at the
    roots, minimum of values at the roots, the cross-tile edges phase B
    unioned)."""
    h, w = img.shape
    img = img.astype(np.int32)
    flat = values.reshape(-1)
    th, tw = plan.tile_h, plan.tile_w
    L = np.zeros(h * w, np.int64)
    tile_root = np.zeros(h * w, bool)
    # A: each tile alone, on tile-local indices
    mask_a = edge_masks(img, plan)
    for y0, x0, rh, rw in _tiles(plan, h, w):
        uf = UnionFind(np.arange(th * tw))
        # a pixel's first parent: the first pixel of its run of equal
        # values among its warp's 32 (lx // 32)
        for ly in range(rh):
            for lx in range(rw):
                if lx % 32 and mask_a[y0 + ly, x0 + lx] & 1:
                    i = ly * tw + lx
                    uf.L[i] = uf.L[i - 1]
        # left edges only between warps, the others by the rule
        for ly in range(rh):
            for lx in range(rw):
                m, i = mask_a[y0 + ly, x0 + lx], ly * tw + lx
                if lx % 32:
                    m &= ~1
                for bit, dy, dx in _EDGES:
                    if m & bit:
                        uf.union(i, i + dy * tw + dx)
        for ly in range(rh):
            for lx in range(rw):
                r = uf.find(ly * tw + lx)
                p = (y0 + ly) * w + x0 + lx
                L[p] = (y0 + r // tw) * w + x0 + r % tw
                tile_root[p] = L[p] == p
    # B: the edges that leave a tile, from its border pixels only
    mask = edge_masks(img)
    guf = UnionFind(L)
    crossed = set()
    before = L.copy()
    for y0, x0, rh, rw in _tiles(plan, h, w):
        for ly, lx in _border_pixels(rh, rw):
            y, x = y0 + ly, x0 + lx
            p = y * w + x
            leaves = {1: lx == 0, 2: ly == 0, 4: ly == 0 or lx == 0,
                      8: ly == 0 or lx == rw - 1}
            for bit, dy, dx in _EDGES:
                if mask[y, x] & bit and leaves[bit]:
                    q = p + dy * w + dx
                    crossed.add((p, q))
                    guf.union(L[p], L[q])
    changed = np.flatnonzero(L != before)
    assert tile_root[changed].all(), "phase B wrote a non-root's label"
    # C: slots per tile, one find per slot
    labels = np.arange(h * w)
    size_root = np.zeros(h * w, np.int64)
    min_root = np.full(h * w, INT32_MAX, np.int64)
    for y0, x0, rh, rw in _tiles(plan, h, w):
        acc_n, acc_min, slot_of = {}, {}, {}
        for ly in range(rh):
            for lx in range(rw):
                p = (y0 + ly) * w + x0 + lx
                if img[y0 + ly, x0 + lx] == 127:
                    size_root[p], min_root[p] = 1, flat[p]
                    continue
                q = L[p]
                inside = (0 <= q // w - y0 < rh) and (0 <= q % w - x0 < rw)
                s = q if inside else p
                slot_of[p] = s
                acc_n[s] = acc_n.get(s, 0) + 1
                acc_min[s] = min(acc_min.get(s, INT32_MAX), flat[p])
        final = {}
        for s in acc_n:
            final[s] = f = guf.find(s)
            size_root[f] += acc_n[s]
            min_root[f] = min(min_root[f], acc_min[s])
        for p, s in slot_of.items():
            labels[p] = final[s]
    return labels, size_root, min_root, crossed


def _cross_edges(img: np.ndarray, plan) -> set:
    """Every edge of the global rule whose two pixels lie in different
    tiles."""
    h, w = img.shape
    mask = edge_masks(img)
    out = set()
    for bit, dy, dx in _EDGES:
        ys, xs = np.nonzero(mask & bit)
        for y, x in zip(ys.tolist(), xs.tolist()):
            if ((y + dy) // plan.tile_h != y // plan.tile_h
                    or (x + dx) // plan.tile_w != x // plan.tile_w):
                out.add((y * w + x, (y + dy) * w + x + dx))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_tile_emulation_bit_exact(name):
    th = CASES[name]()
    b, h, w = th.shape
    plan = ck.ccl_plan(h, w)
    rng = np.random.default_rng(7)
    values = rng.integers(0, INT32_MAX, th.shape, dtype=np.int64)
    values[:, ::3] = INT32_MAX
    values = values.astype(np.int32)
    want_labels = n(tccl.hook_labels(t(th)))
    jl, js, _ = jccl.label_components(jnp.asarray(th))
    np.testing.assert_array_equal(n(jl), want_labels)
    want_min = n(tccl.propagate_fixpoint(t(th), t(values))).reshape(b, -1)
    for i in range(b):
        labels, size_root, min_root, crossed = emulate(th[i], values[i], plan)
        assert crossed == _cross_edges(th[i], plan)
        np.testing.assert_array_equal(labels, want_labels[i])
        np.testing.assert_array_equal(size_root[labels], n(js)[i])
        np.testing.assert_array_equal(
            np.minimum(min_root[labels], BIG), want_min[i])
    if name == "all127":
        np.testing.assert_array_equal(want_labels[0], np.arange(h * w))


@pytest.mark.parametrize("name", ["staircase", "spiral", "comb"])
def test_adversarial_frames_cross_tiles(name):
    """The adversarial frames do what they are for: corner-crossing 255
    diagonals, components that span many tiles."""
    th = CASES[name]()[0]
    plan = ck.ccl_plan(*th.shape)
    crossed = _cross_edges(th, plan)
    w = th.shape[1]
    corner = [(p, q) for p, q in crossed
              if p // w // plan.tile_h != q // w // plan.tile_h
              and p % w // plan.tile_w != q % w // plan.tile_w]
    labels = n(tccl.hook_labels(t(th[None])))[0]
    tiles_of = {}
    for p, lab in enumerate(labels.tolist()):
        tiles_of.setdefault(lab, set()).add(
            (p // w // plan.tile_h, p % w // plan.tile_w))
    widest = max(len(v) for v in tiles_of.values())
    if name == "staircase":
        assert corner and all(th.flat[p] == 255 for p, _ in corner)
    else:
        assert widest == plan.tiles_x * plan.tiles_y


PLAN_SHAPES = [(400, 640), (540, 960), (800, 1280), (37, 53), (40, 960),
               (541, 963), (1, 1), (33, 129), (1080, 1920)]


@pytest.mark.parametrize("h,w", PLAN_SHAPES)
def test_ccl_plan_covers_the_frame_once(h, w):
    plan = ck.ccl_plan(h, w)
    cover = np.zeros((h, w), np.int32)
    for y0, x0, rh, rw in _tiles(plan, h, w):
        assert rh >= 1 and rw >= 1
        cover[y0:y0 + rh, x0:x0 + rw] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("h,w", PLAN_SHAPES)
def test_ccl_plan_fits_the_launchers_layout(h, w):
    """What csrc/unionfind.cuh plan_ok requires of a plan."""
    plan = ck.ccl_plan(h, w)
    px = plan.tile_h * plan.tile_w
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert px == plan.threads * ck.TILE_ITEMS
    # a thread keeps one column of its tile, a warp 32 pixels of one row
    assert plan.tile_w == 128 and plan.threads % plan.tile_w == 0
    assert plan.border_threads % 32 == 0 and plan.border_threads <= 1024
    # one phase-B thread per border pixel of a full tile
    assert plan.border_threads >= plan.tile_w + 2 * (plan.tile_h - 1)
    assert px * ck.TILE_SMEM_PER_PIXEL <= plan.smem_bytes <= ck.SMEM_LIMIT
    assert plan.tiles_y <= ck.MAX_GRID_YZ
    assert plan.args() == (plan.tile_h, plan.tile_w, plan.tiles_x,
                           plan.tiles_y, plan.threads, plan.border_threads,
                           plan.smem_bytes)


@pytest.mark.parametrize("h,w", [(0, 5), (5, 0), (4097, 4097),
                                 (ck.MAX_GRID_YZ * ck.TILE_H + 1, 1)])
def test_ccl_plan_refuses_what_the_launchers_reject(h, w):
    with pytest.raises(ValueError):
        ck.ccl_plan(h, w)
