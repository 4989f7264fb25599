"""K7 label_histogram and K8 propagate of csrc/flood.cu on the CPU: numpy
emulations of the kernels' block logic, held bit-exact against the JAX
ccl_pallas.label_histogram and ccl_pallas.propagate in interpret mode and
against the port's plain versions (ops/ccl.py), and K8's launch plan
(ops/ccl_kernel.py propagate_plan). The card runs the kernels themselves
(chip_smoke.py); the emulations follow their indexing step by step, so
that a tiling or table bug shows here without a card.

K8: each launch (a round of at most `halo` sweeps) loads every tile's
region -- the tile, a halo of `halo` pixels and a ring of one cell -- into
one buffer (2^30 and 127 off the frame) and sweeps between two buffers
(the second starts as whatever earlier blocks left in shared memory:
garbage, which its ring keeps and no sweep carries into the tile). A
region of {0, 127, 255} keeps two planes, the labels of
its 255 pixels and of its 0 pixels, and needs no eligibility bits; any
other region builds each pixel's eight bits from the threshold
(neighbours off the frame never eligible) and sweeps one plane. Then the
tile is written back, a 127 pixel as min(its label, 2^30). K7: each
block takes chunks of the flat (B, N) labels; a thread's run of equal keys
(row * N + label) whose key lies in the chunk adds once to the chunk's
window, and every chunk's window is stored as its part of the output.
After the grid barrier each block adds its chunks' other runs (far runs):
each thread sums the runs of its first far key, the lanes of a warp whose
first keys agree add once, and the thread's other far runs add one
each.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from ros_vision_tpu.ops import ccl_pallas
from ros_vision_tpu_torch.ops import ccl as tccl
from ros_vision_tpu_torch.ops import ccl_kernel as ck
from tests.test_torch_ccl import _scene, _threshim
from tests.torch_port_helpers import checkerboard, n, random_threshim, t

INT32_MAX = 2 ** 31 - 1
BIG = 2 ** 30
T = ck.PROPAGATE_HALO
# (dy, dx) of ccl_pallas._OFFSETS, the order of the eligibility bits
OFFSETS = [(0, -1), (0, 1), (-1, 0), (1, 0),
           (-1, -1), (-1, 1), (1, -1), (1, 1)]
# a plan of small tiles, so that small frames cross many tile borders
SMALL = dataclasses.replace(ck.propagate_plan(1, 1, 1), tile_h=7,
                            tile_w=11, halo=3)   # tiles and rounds set per use


def checker(b: int, h: int, w: int, block: int) -> np.ndarray:
    """(b, h, w) black/white checkerboard of `block`-px squares: white
    squares meet only at corners (8-way), black ones not at all."""
    yy, xx = np.mgrid[:h, :w]
    img = np.where((yy // block + xx // block) % 2 == 0, 255, 0)
    return np.ascontiguousarray(np.broadcast_to(img, (b, h, w))).astype(
        np.uint8)


PLANES = {
    "spiral_90x120": lambda: chip_smoke.spiral_plane(90, 120),
    "checker1_40x50": lambda: checker(1, 40, 50, 1),
    "checker3_45x60": lambda: checker(2, 45, 60, 3),
    "ragged_37x53": lambda: chip_smoke.ragged_planes(3, 37, 53),
    "scene": _scene,                                       # (1, 80, 128)
    "one_px": lambda: np.full((1, 1, 1), 255, np.uint8),
    "other_values": lambda: other_values(2, 30, 41),
}


def other_values(b: int, h: int, w: int) -> np.ndarray:
    """Ragged planes with a patch of values outside {0, 127, 255} (5 and
    200, each 4-connected to its equals only) in one corner: the tiles
    that see it take the kernel's masked path, the others its two
    planes."""
    out = chip_smoke.ragged_planes(b, h, w, seed=3)
    rng = np.random.default_rng(3)
    out[:, :8, :9] = rng.choice([5, 200, 0, 255], (b, 8, 9))
    return out


def launches_of(plan, n_sweeps: int) -> int:
    return max(1, -(-n_sweeps // plan.halo))


def values(kind: str, shape, seed: int = 0) -> np.ndarray:
    """Flat pixel indices, or random values with 2^30, INT32_MAX and
    negatives among them."""
    b, h, w = shape
    if kind == "flat":
        flat = np.arange(h * w, dtype=np.int32).reshape(h, w)
        return np.ascontiguousarray(np.broadcast_to(flat, shape))
    rng = np.random.default_rng(seed)
    v = rng.integers(-5, INT32_MAX, shape, dtype=np.int64).astype(np.int32)
    k = min(3, v.size)
    v.reshape(-1)[:k] = [BIG, INT32_MAX, BIG + 1][:k]
    return v


def eligibility(thr: np.ndarray, y0: int, x0: int, rows: int,
                cols: int) -> np.ndarray:
    """(8, rows, cols) eligibility bits of the frame pixels
    (y0 + r, x0 + c), as each thread builds them from the staged
    threshold (False off the frame)."""
    h, w = thr.shape
    yy, xx = np.mgrid[y0:y0 + rows, x0:x0 + cols]

    def inside(y, x):
        return (y >= 0) & (y < h) & (x >= 0) & (x < w)

    def at(y, x):
        return thr[np.clip(y, 0, h - 1), np.clip(x, 0, w - 1)].astype(int)

    v = at(yy, xx)
    own = inside(yy, xx) & (v != 127)
    bits = np.zeros((8, rows, cols), bool)
    for k, (dy, dx) in enumerate(OFFSETS):
        ny, nx = yy + dy, xx + dx
        bits[k] = own & inside(ny, nx) & (at(ny, nx) == v)
        if k >= 4:
            bits[k] &= v == 255
    return bits


def sweep_masked(cur, nxt, bits, sweeps):
    """Sweeps over one label plane with the eligibility bits (any
    threshold values) -> the buffer of the last sweep."""
    rh, rw = bits.shape[1:]
    for _ in range(sweeps):
        m = cur[1:-1, 1:-1].copy()
        for k, (dy, dx) in enumerate(OFFSETS):
            nb = cur[1 + dy:1 + dy + rh, 1 + dx:1 + dx + rw]
            m = np.minimum(m, np.where(bits[k], nb, BIG))
        nxt[1:-1, 1:-1] = m
        cur, nxt = nxt, cur
    return cur


def sweep_planes(cur, nxt, v, sweeps):
    """Sweeps over the two planes of a {0, 127, 255} region (.x = [..., 0]
    the labels of its 255 pixels, .y = [..., 1] of its 0 pixels, 2^30
    elsewhere): a 255 pixel takes the min of its 3x3 .x, a 0 pixel the
    min of its cross's .y and 2^30 -> the buffer of the last sweep."""
    rh, rw = v.shape[0] - 2, v.shape[1] - 2
    white, black = v[1:-1, 1:-1] == 255, v[1:-1, 1:-1] == 0
    for _ in range(sweeps):
        def at(dy, dx, plane):
            return cur[1 + dy:1 + dy + rh, 1 + dx:1 + dx + rw, plane]
        wm = np.minimum.reduce([at(dy, dx, 0) for dy in (-1, 0, 1)
                                for dx in (-1, 0, 1)])
        bm = np.minimum.reduce([at(0, 0, 1), at(0, -1, 1), at(0, 1, 1),
                                at(-1, 0, 1), at(1, 0, 1),
                                np.full((rh, rw), BIG)])
        nxt[1:-1, 1:-1, 0] = np.where(white, wm, BIG)
        nxt[1:-1, 1:-1, 1] = np.where(black, bm, BIG)
        cur, nxt = nxt, cur
    return cur


def emulate_propagate(thr: np.ndarray, labels: np.ndarray, n_sweeps: int,
                      plan) -> tuple[np.ndarray, int, int]:
    """K8's launches on (B, H, W) planes -> (labels after n_sweeps, the
    launches made, the tile launches that took the masked path). The
    scratch and output planes start as garbage."""
    b, h, w = thr.shape
    if n_sweeps == 0:
        return labels.copy(), 1, 0
    th, tw, halo = plan.tile_h, plan.tile_w, plan.halo
    rh, rw = th + 2 * halo, tw + 2 * halo
    rounds = -(-n_sweeps // halo)
    assert rounds == plan.rounds
    rng = np.random.default_rng(0)
    out, scratch = (rng.integers(-9, 9, labels.shape).astype(np.int32)
                    for _ in range(2))
    yy, xx = np.mgrid[:rh + 2, :rw + 2]
    in_tile = ((yy >= halo + 1) & (yy < halo + 1 + th)
               & (xx >= halo + 1) & (xx < halo + 1 + tw))
    masked = 0
    src = labels
    for r in range(rounds):
        sweeps = halo if r < rounds - 1 else n_sweeps - halo * r
        assert 1 <= sweeps <= halo
        # the last round writes out, the ones before alternate with scratch
        dst = out if (rounds - 1 - r) % 2 == 0 else scratch
        for f in range(b):
            for ty in range(plan.tiles_y):
                for tx in range(plan.tiles_x):
                    fy, fx = yy + ty * th - halo - 1, xx + tx * tw - halo - 1
                    inside = (fy >= 0) & (fy < h) & (fx >= 0) & (fx < w)
                    yc, xc = fy.clip(0, h - 1), fx.clip(0, w - 1)
                    lab = np.where(inside, src[f, yc, xc], BIG)
                    v = np.where(inside, thr[f, yc, xc], 127).astype(int)
                    # the second buffer: what earlier blocks left there
                    left = rng.integers(-9, INT32_MAX, (*v.shape, 2)).astype(
                        np.int32)
                    if np.isin(v, (0, 127, 255)).all():
                        cur = np.stack([np.where(v == 255, lab, BIG),
                                        np.where(v == 0, lab, BIG)], -1)
                        cur = sweep_planes(cur, left, v, sweeps)
                        val = np.where(v == 255, cur[..., 0],
                                       np.where(v == 0, cur[..., 1],
                                                np.minimum(lab, BIG)))
                    else:
                        masked += 1
                        bits = eligibility(thr[f], fy[0, 0] + 1,
                                           fx[0, 0] + 1, rh, rw)
                        val = sweep_masked(lab, left[..., 0].copy(), bits,
                                           sweeps)
                    keep = in_tile & inside
                    dst[f, fy[keep], fx[keep]] = val[keep]
        src = dst
    return out, rounds, masked


@pytest.mark.parametrize("n_sweeps", [0, 1, T - 1, T, T + 1, 2 * T + 3, 96])
@pytest.mark.parametrize("plane", list(PLANES))
def test_propagate_tiles_bit_exact(plane, n_sweeps):
    thr = PLANES[plane]()
    _, h, w = thr.shape
    small = dataclasses.replace(SMALL, tiles_x=-(-w // SMALL.tile_w),
                                tiles_y=-(-h // SMALL.tile_h))
    for kind in ("flat", "random"):
        lab = values(kind, thr.shape, seed=n_sweeps)
        want = n(tccl.propagate(t(thr), t(lab), n_sweeps))
        if plane != "scene" or n_sweeps <= 2 * T + 3:
            jax_out = n(ccl_pallas.propagate(
                jnp.asarray(thr), jnp.asarray(lab), n_sweeps=n_sweeps,
                interpret=True))
            np.testing.assert_array_equal(jax_out, want)
        plan = ck.propagate_plan(h, w, n_sweeps)
        got, launches, _ = emulate_propagate(thr, lab, n_sweeps, plan)
        np.testing.assert_array_equal(got, want)
        assert launches == plan.launches <= -(-n_sweeps // T) + 1
        got, _, masked = emulate_propagate(thr, lab, n_sweeps,
                                           dataclasses.replace(
            small, rounds=-(-n_sweeps // small.halo)))
        np.testing.assert_array_equal(got, want)
        if plane == "other_values" and n_sweeps:
            assert 0 < masked < launches_of(small, n_sweeps) * thr.shape[0] \
                * small.tiles_x * small.tiles_y


def test_propagate_tiles_cross_the_real_tiles():
    """Frames larger than one 80 x 112 tile, with the real plan: a spiral
    (its two components wind through every tile) and a random frame."""
    for thr in (chip_smoke.spiral_plane(170, 250),
                random_threshim(2, 170, 250, seed=9)):
        _, h, w = thr.shape
        plan = ck.propagate_plan(h, w, 2 * T + 3)
        assert plan.tiles_x == 3 and plan.tiles_y == 3
        for kind in ("flat", "random"):
            lab = values(kind, thr.shape, seed=4)
            want = n(tccl.propagate(t(thr), t(lab), 2 * T + 3))
            got, _, _ = emulate_propagate(thr, lab, 2 * T + 3, plan)
            np.testing.assert_array_equal(got, want)
            assert not np.array_equal(want, lab)


def test_propagate_is_not_the_fixpoint():
    """After one round of 448 sweeps the hybrid has not converged on a
    spiral: the sweeps are counted exactly, not run to a fixpoint."""
    thr = chip_smoke.spiral_plane(60, 80)
    lab = values("flat", thr.shape)
    once = n(tccl.propagate(t(thr), t(lab), 40))
    more = n(tccl.propagate(t(thr), t(lab), 41))
    assert not np.array_equal(once, more)
    got, _, _ = emulate_propagate(thr, lab, 41, dataclasses.replace(
        SMALL, tiles_x=-(-80 // SMALL.tile_w), tiles_y=-(-60 // SMALL.tile_h),
        rounds=-(-41 // SMALL.halo)))
    np.testing.assert_array_equal(got, more)


# ---- K7 ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HistLayout:
    """The kernel's compiled sizes (csrc/flood.cu kHist*)."""
    threads: int = 512
    items: int = 16

    @property
    def chunk(self) -> int:
        return self.threads * self.items


REAL = HistLayout()
TINY = HistLayout(threads=8, items=4)


def thread_runs(flat: np.ndarray, n_lab: int, i0: int, items: int):
    """(key, run length) of a thread's runs of equal keys from flat index
    i0 (key -1 outside [0, n) or past the end: never added)."""
    total = flat.size
    idx = np.arange(i0, i0 + items)
    lab = np.where(idx < total, flat[idx.clip(0, total - 1)], -1)
    ok = (idx < total) & (lab >= 0) & (lab < n_lab)
    key = np.where(ok, idx // n_lab * n_lab + lab, -1)
    runs, start = [], 0
    for e in range(items):
        if e == items - 1 or key[e] != key[e + 1]:
            runs.append((int(key[e]), e + 1 - start))
            start = e + 1
    return runs


def emulate_histogram(labels: np.ndarray, lay: HistLayout,
                      grid: int) -> np.ndarray:
    """K7's cooperative launch of `grid` blocks on (B, N) labels."""
    b, n_lab = labels.shape
    flat = labels.reshape(-1)
    total = flat.size
    chunks = -(-total // lay.chunk)
    counts = np.full(total, -7, np.int64)          # torch.empty: garbage
    # 1. each chunk's window: the runs of keys in the chunk, stored
    for c in range(chunks):
        c0 = c * lay.chunk
        win = np.zeros(lay.chunk, np.int64)
        for th in range(lay.threads):
            for key, run in thread_runs(flat, n_lab, c0 + th * lay.items,
                                        lay.items):
                if 0 <= key - c0 < lay.chunk:
                    win[key - c0] += run
        m = min(lay.chunk, total - c0)
        counts[c0:c0 + m] = win[:m]
    # 2. after the grid barrier, each block's chunks' far runs: a thread's
    # first far key with every run of that key summed, one add for each
    # key of a warp's first keys; the thread's other far runs one each
    for blk in range(min(grid, chunks)):
        for c in range(blk, chunks, grid):
            c0 = c * lay.chunk
            firsts = []
            for th in range(lay.threads):
                runs = [(k, r) for k, r in thread_runs(
                    flat, n_lab, c0 + th * lay.items, lay.items)
                    if k >= 0 and not 0 <= k - c0 < lay.chunk]
                if runs:
                    first = runs[0][0]
                    firsts.append((th, first,
                                   sum(r for k, r in runs if k == first)))
                for k, r in runs:
                    if k != runs[0][0]:
                        counts[k] += r
            for w0 in range(0, lay.threads, 32):
                sums = {}
                for th, k, r in firsts:
                    if w0 <= th < w0 + 32:
                        sums[k] = sums.get(k, 0) + r
                for k, r in sums.items():
                    counts[k] += r
    return counts.reshape(b, n_lab)


def hist_labels(kind: str) -> np.ndarray:
    if kind == "converged":
        th = _threshim(checkerboard(96, 160, 4, 0.1, 1))
        return n(tccl.label_components(t(th))[0])
    if kind == "converged_scene":
        return n(tccl.label_components(t(_scene()))[0])
    rng = np.random.default_rng(2)
    if kind == "random_big":               # more far runs than slots
        return rng.integers(-600, 21_500, (2, 20_000)).astype(np.int32)
    if kind == "runs_of_8":                # few far runs, many keys
        return np.repeat(rng.integers(0, 3200, 400), 8)[None].astype(
            np.int32)
    size = 37 * 53
    lab = rng.integers(-600, size + 1500, (3, size)).astype(np.int32)
    lab[:, :4] = [-1, size, size + 511, INT32_MAX]
    if kind == "random_runs":
        lab = np.repeat(lab[:, ::5], 5, axis=1)[:, :size]
    return lab


@pytest.mark.parametrize("grid", [1, 3, 1000])
@pytest.mark.parametrize("lay", [REAL, TINY], ids=["real", "tiny"])
@pytest.mark.parametrize("kind", ["converged", "converged_scene", "random",
                                  "random_runs", "random_big", "runs_of_8"])
def test_histogram_blocks_bit_exact(kind, lay, grid):
    labels = hist_labels(kind)
    want = n(tccl.label_histogram(t(labels)))
    np.testing.assert_array_equal(n(ccl_pallas.label_histogram(
        jnp.asarray(labels), interpret=True)), want)
    got = emulate_histogram(labels, lay, grid)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("b,size", [(3, 1), (7, 5), (2, 15), (2, 17),
                                    (1, 8193)])
def test_histogram_rows_shorter_than_a_thread(b, size):
    """Rows shorter than a thread's 16 items (several row boundaries in
    one thread), and a chunk boundary inside a row."""
    rng = np.random.default_rng(size)
    labels = rng.integers(-2, size + 2, (b, size)).astype(np.int32)
    want = n(tccl.label_histogram(t(labels)))
    for lay in (REAL, TINY):
        np.testing.assert_array_equal(emulate_histogram(labels, lay, 2),
                                      want)


# ---- K8's plan ----------------------------------------------------------

def test_propagate_plan_fits_every_frame():
    """Every frame size up to 1023 x 1023: the tiles cover the frame
    exactly once, the region is the threads' rows, the shared memory fits
    an H100 block's opt-in limit, and the launches are ceil(n / T) (1 for
    the copy at n = 0)."""
    for h in range(1, 1024):
        for w in (1, 2, 111, 112, 113, 640, 1023, h):
            p = ck.propagate_plan(h, w, 448)
            assert p.tiles_y * p.tile_h >= h > (p.tiles_y - 1) * p.tile_h
            assert p.tiles_x * p.tile_w >= w > (p.tiles_x - 1) * p.tile_w
    p = ck.propagate_plan(1023, 1023, 448)
    rh, rw = p.tile_h + 2 * p.halo, p.tile_w + 2 * p.halo
    assert rh % ck.PROPAGATE_ROWS == 0 and rw % 32 == 0
    assert rh // ck.PROPAGATE_ROWS * rw == p.threads == 1024
    cells = (rh + 2) * (rw + 2)
    assert cells == ck.propagate_cells(p.tile_h, p.tile_w, p.halo)
    assert cells <= 13 * p.threads                 # kPropLoadSteps
    assert p.smem_bytes == 16 * cells + -(-cells // 16) * 16 <= 232_448
    for n_sweeps, launches in ((0, 1), (1, 1), (T, 1), (T + 1, 2),
                               (448, 56), (64, 8)):
        assert ck.propagate_plan(400, 640, n_sweeps).launches == launches


def test_propagate_plan_is_one_wave_on_the_path():
    """640x400 B=4 (the hybrid CCL's 1280x800 frames): 120 tiles, no more
    than the H100's 132 SMs at one block an SM."""
    p = ck.propagate_plan(400, 640, 448)
    assert p.tiles_x * p.tiles_y * 4 == 120
    assert p.smem_bytes > 228 * 1024 // 2          # one block an SM


def test_propagate_plan_rejects_what_the_launcher_cannot_take():
    with pytest.raises(ValueError):
        ck.propagate_plan(0, 5, 1)
    with pytest.raises(ValueError):
        ck.propagate_plan(5, 5, -1)
    with pytest.raises(ValueError):
        ck.propagate_plan(80 * 65536, 5, 1)
