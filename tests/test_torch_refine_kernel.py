"""P2 (csrc/refine.cu): refine_edges' dispatch, its plain version against
the JAX function, and the kernel's edge arithmetic built for the host.

The card runs the kernel; here a CPU tensor takes refine_edges_plain, so
the kernel's own arithmetic (csrc/refine.cuh, which also compiles as plain
C++) is built with the host's C++ compiler (-ffp-contract=off, as the
kernel's __f*_rn operations round) and held against the plain version and
the JAX function. Inputs: the bench layout at 640x400 (tags turned 10-50
degrees, two noise seeds) and one tag with 300-px edges, which need more
than 32 samples, every tag's rendered corners moved by a seeded N(0, 0.6 px),
one quad not valid, and a zero and a NaN slot in each row; every sample
grid tier; no distortion, the detector tests' lens and chip_smoke's
LENS_DIST lens; normal border, and the reversed border on the inverted
frames. Limits: sample positions, pixel indices, in-frame flags, weights
and undistorted points bit-equal to the plain version; refined corners
within 1e-3 px of it and of the JAX function (the order of the six
moment sums and XLA's atan2/cos/sin rounding are the only differences),
non-finite outputs in the same places.
"""
import ctypes
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ros_vision_tpu.apriltag.render import render_scene, simple_square_corners
from ros_vision_tpu.ops import decode as jdec
from ros_vision_tpu_torch import _build
from ros_vision_tpu_torch.ops import decode as tdec
from tests.torch_port_helpers import bench_frames, n, t

W, H = 640, 400
TIERS = tdec.REFINE_ALPHA_TIERS
# the detector tests' calibrated camera, and chip_smoke's lens at 640 px
LENSES = {"none": None,
          "test": ((450.0, 450.0, 320.0, 200.0),
                   (0.06, -0.03, 0.001, -0.0015, 0.0)),
          "LENS_DIST": (tuple(chip_smoke.lens_for(W, H).values()),
                        chip_smoke.LENS_DIST)}
LIMIT_PX = 1e-3


def _slots(tags: np.ndarray, seed: int) -> np.ndarray:
    """(B, NT, 4, 2) tag corners moved by N(0, 0.6 px), then a zero and a
    NaN slot a row."""
    rng = np.random.default_rng(seed)
    c = tags + rng.normal(0, 0.6, tags.shape)
    b = c.shape[0]
    extra = np.zeros((b, 2, 4, 2))
    extra[:, 1] = np.nan
    return np.concatenate([c, extra], 1).astype(np.float32)


def _scenes() -> dict:
    g, placed = bench_frames(W, H, seeds=(0, 1), angles=(10, 20, -35, 50))
    tags = np.stack([p.corners for p in placed])
    bench = _slots(np.stack([tags, tags]), 0)
    valid = np.ones(bench.shape[:2], bool)
    valid[1, 3] = False
    big, placed_big = render_scene(
        [7], [simple_square_corners(320, 200, 150, angle_deg=15)], W, H,
        noise_sigma=1.0, seed=3)
    bc = _slots(placed_big[0].corners[None, None], 1)
    return {"bench": (g, bench, valid),
            "big": (big[None], bc, np.ones(bc.shape[:2], bool))}


SCENES = _scenes()


def _case(scene: str, lens: str, reversed_border: bool):
    """numpy gray, corners, valid; (fx, fy, cx, cy) rows and dist rows or
    None. The reversed border runs on the inverted frames (what a
    reversed-border tag looks like)."""
    g, c, v = SCENES[scene]
    if reversed_border:
        g = 255 - g
    if LENSES[lens] is None:
        return g, c, v, None, None
    intr, dist = LENSES[lens]
    b = g.shape[0]
    return (g, c, v, np.tile(np.float32(intr), (b, 1)),
            np.tile(np.float32(dist), (b, 1)))


def _torch_lens(intr, dist):
    if intr is None:
        return None, None
    return tuple(t(intr[:, i]) for i in range(4)), t(dist)


def _jax(case, n_alpha, reversed_border):
    g, c, v, intr, dist = case
    jlens = (None, None) if intr is None else (
        tuple(jnp.asarray(intr[:, i]) for i in range(4)), jnp.asarray(dist))
    return np.asarray(jdec._refine_edges_core(
        jnp.asarray(g), jnp.asarray(c), jnp.asarray(v), *jlens, n_alpha,
        reversed_border))


def _plain(case, n_alpha, reversed_border):
    g, c, v, intr, dist = case
    return tdec.refine_edges_plain(t(g), t(c), t(v), *_torch_lens(intr, dist),
                                   n_alpha, reversed_border)


def _bits(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32).view(np.int32)


def _assert_corners(got, want, what: str) -> float:
    """Non-finite in the same places, finite corners within LIMIT_PX."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    err = float(np.abs(got[fin] - want[fin]).max())
    assert err <= LIMIT_PX, f"{what}: {err} px"
    return err


GRID = [(scene, n_alpha, lens, rb) for scene in SCENES for n_alpha in TIERS
        for lens in LENSES for rb in (False, True)]


def _id(p):
    scene, n_alpha, lens, rb = p
    return f"{scene}-{n_alpha}-{lens}-{'reversed' if rb else 'normal'}"


def test_cpu_tensor_runs_plain_bit_for_bit():
    g, c, v, intr, dist = _case("bench", "LENS_DIST", False)
    args = (t(g), t(c), t(v), *_torch_lens(intr, dist))
    _build.reset_counts()
    got = tdec.refine_edges(*args)
    tier = TIERS[tdec.refine_tier(t(c), t(v))]
    want = tdec.refine_edges_plain(*args, tier)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert _build.counts()["refine_edges"] == 0
    assert _build.kernel_counts()["refine_edges"] == 0


@pytest.mark.parametrize("lens", ["none", "test"])
def test_cuda_route_launches_or_raises(monkeypatch, lens):
    """With the kernel route, refine_edges hands P2's launcher the wrapper's
    contiguous operands, and a refused launch raises: no path falls back
    to the plain version."""
    g, c, v, intr, dist = _case("bench", lens, False)
    calls = []

    def refused(name, device, *args):
        calls.append((name, args))
        raise RuntimeError(f"{name}: CUDA launch failed with error 1")

    monkeypatch.setattr(tdec, "kernel_route", lambda x: "cuda")
    monkeypatch.setattr(_build, "launch", refused)
    with pytest.raises(RuntimeError, match="launch failed"):
        tdec.refine_edges(t(g), t(c), t(v), *_torch_lens(intr, dist))
    (name, args), = calls
    assert name == "rvt_refine_edges"
    b, nq = c.shape[:2]
    assert tuple(args[6].shape) == (b, nq, 4, 5)     # the lines' scratch
    strides = (0, 0) if intr is None else (4, 5)
    assert args[8:] == (*strides, b, nq, H, W, 32, int(intr is not None), 0)
    if intr is None:
        assert args[3] is None and args[4] is None
    else:
        np.testing.assert_array_equal(n(args[3]), intr)
        np.testing.assert_array_equal(n(args[4]), dist)


def test_cuda_route_takes_an_intrinsics_row_as_it_is(monkeypatch):
    """The detector's (B, 9) intrinsics row reaches P2's launcher as its
    own two views, rows 9 floats apart: nothing is copied or stacked. The
    plain version reads the same views as the tuple of columns."""
    g, c, v, intr, dist = _case("bench", "LENS_DIST", False)
    row = t(np.concatenate([intr, dist], 1))
    calls = []

    def refused(name, device, *args):
        calls.append(args)
        raise RuntimeError(f"{name}: CUDA launch failed with error 1")

    monkeypatch.setattr(tdec, "kernel_route", lambda x: "cuda")
    monkeypatch.setattr(_build, "launch", refused)
    with pytest.raises(RuntimeError, match="launch failed"):
        tdec.refine_edges(t(g), t(c), t(v), row[:, :4], row[:, 4:9])
    (args,) = calls
    assert args[3].data_ptr() == row.data_ptr()
    assert args[4].data_ptr() == row[:, 4:].data_ptr()
    assert args[8:10] == (9, 9)
    got = tdec.refine_edges_plain(t(g), t(c), t(v), row[:, :4], row[:, 4:9],
                                  32)
    want = _plain(_case("bench", "LENS_DIST", False), 32, False)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    g, c, v, _, _ = _case("bench", "none", False)
    for bad in ((t(g).float(), t(c), t(v)), (t(g), t(c), t(v).to(torch.uint8)),
                (t(g), t(c).double(), t(v)), (t(g)[:1], t(c), t(v))):
        with pytest.raises(ValueError):
            tdec._refine_edges_cuda(*bad, None, None, 32)
    b = c.shape[0]
    row = torch.zeros((b, 9))
    for intr, dist in ((row[:, :4].double(), row[:, 4:9]),
                       (row[:, :4], row[:1, 4:9]),
                       (torch.zeros((9, b)).t()[:, :4], row[:, 4:9])):
        with pytest.raises(ValueError):
            tdec._refine_edges_cuda(t(g), t(c), t(v), intr, dist, 32)


def test_lens_rows():
    """One camera's (1,) intrinsics and (5,) distortion serve every row."""
    one = tuple(torch.tensor([v]) for v in (1.0, 2.0, 3.0, 4.0))
    rows, d = tdec.lens_rows(one, torch.arange(5.0), 3, torch.device("cpu"))
    assert rows.shape == (3, 4) and rows.is_contiguous()
    assert torch.equal(rows, torch.tensor([[1., 2., 3., 4.]] * 3))
    assert torch.equal(d, torch.arange(5.0).expand(3, 5))
    assert tdec.lens_rows(None, None, 3, torch.device("cpu")) == (None, None)


def test_launcher_declared():
    """_build binds rvt_refine_edges with the signature csrc/refine.cu
    defines extern "C": 8 pointers, intr_stride, dist_stride, b, nq, h, w,
    n_alpha, have_dist, reversed_border, then device and stream."""
    args = _build._SIGNATURES["rvt_refine_edges"]
    assert args == [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
    src = (_build.CSRC / "refine.cu").read_text()
    m = re.search(r'extern "C" int rvt_refine_edges\(([^)]*)\)', src)
    assert m is not None
    params = [p.strip() for p in m.group(1).split(",")]
    assert len(params) == len(args) + 2
    assert params[6] == "float* lines"
    assert [p.split()[-1] for p in params[8:17]] == [
        "intr_stride", "dist_stride", "b", "nq", "h", "w", "n_alpha",
        "have_dist", "reversed_border"]
    assert params[-2:] == ["int device", "cudaStream_t stream"]


@pytest.mark.parametrize("scene,n_alpha,lens,rb", GRID, ids=map(_id, GRID))
def test_plain_vs_jax(scene, n_alpha, lens, rb):
    case = _case(scene, lens, rb)
    g, c, v, intr, dist = case
    got = _plain(case, n_alpha, rb)
    _assert_corners(n(got), _jax(case, n_alpha, rb), "plain vs JAX")
    # refine moved the valid tags' corners; the zero, NaN and invalid
    # slots keep theirs
    moved = np.abs(n(got) - c).max(axis=(2, 3))[:, :-2]
    assert (moved[v[:, :-2]] > 0.05).all()
    keep = ~v
    keep[:, -2:] = True
    np.testing.assert_array_equal(_bits(n(got)[keep]), _bits(c[keep]))


def test_reversed_border_on_inverted_frames_is_normal():
    """The reversed polarity gate on inverted frames takes the samples and
    weights the normal gate takes on the frames themselves."""
    for lens in LENSES:
        normal = _plain(_case("bench", lens, False), 32, False)
        reversed_ = _plain(_case("bench", lens, True), 32, True)
        assert torch.equal(normal.view(torch.int32),
                           reversed_.view(torch.int32))


def _host_compiler():
    return shutil.which("c++") or shutil.which("g++")


HOST_GLUE = r'''
#include "refine.cuh"
using namespace rvt_refine;

static Lens lens_of(const float* intr, const float* dist, int b, int have) {
  Lens l = {};
  if (have)
    l = {intr[b * 4], intr[b * 4 + 1], intr[b * 4 + 2], intr[b * 4 + 3],
         dist[b * 5], dist[b * 5 + 1], dist[b * 5 + 2], dist[b * 5 + 3],
         dist[b * 5 + 4]};
  return l;
}

// refine.cu's order of an edge's six sums: its block's edge_threads(n_alpha)
// threads' sums, a shuffle-down tree in each warp (offsets 16, 8, 4, 2, 1),
// then the same tree over the warps' totals in warp 0, zeros past the last
// warp.
static void edge_sums(const Edge& e, const uint8_t* gray, int h, int w,
                      int n_alpha, const Lens& lens, bool have_dist,
                      bool reversed, float m[6]) {
  const int threads = edge_threads(n_alpha);
  static float part[kMaxEdgeThreads][6];
  for (int t = 0; t < threads; ++t)
    thread_sums(e, gray, h, w, n_alpha, lens, have_dist, reversed, t,
                threads, part[t]);
  float tot[32][6];
  for (int l = 0; l < 32; ++l)
    for (int q = 0; q < 6; ++q) tot[l][q] = 0.0f;
  for (int base = 0; base < threads; base += 32) {
    for (int off = 16; off > 0; off >>= 1)
      for (int l = 0; l < off; ++l)
        for (int q = 0; q < 6; ++q)
          part[base + l][q] = add(part[base + l][q], part[base + l + off][q]);
    for (int q = 0; q < 6; ++q) tot[base / 32][q] = part[base][q];
  }
  for (int off = 16; off > 0; off >>= 1)
    for (int l = 0; l < off; ++l)
      for (int q = 0; q < 6; ++q) tot[l][q] = add(tot[l][q], tot[l + off][q]);
  for (int q = 0; q < 6; ++q) m[q] = tot[0][q];
}

// How often the threads of an edge's block visit each term of its grid.
extern "C" int host_term_visits(int n_alpha, int* visits, int* most) {
  const int threads = edge_threads(n_alpha);
  *most = 0;
  for (int t = 0; t < threads; ++t) {
    const int n = thread_terms(n_alpha, t, threads);
    *most = n > *most ? n : *most;
    for (int r = 0; r < n; ++r) {
      const int i = term_index(t, r, threads);
      if (i >= 0 && i < edge_terms(n_alpha)) ++visits[i];
    }
  }
  return threads;
}

extern "C" void host_refine_edges(const uint8_t* gray, const float* corners,
    const uint8_t* valid, const float* intr, const float* dist, float* out,
    int b, int nq, int h, int w, int n_alpha, int have, int reversed) {
  for (int slot = 0; slot < b * nq; ++slot) {
    const int bi = slot / nq;
    const float* c = corners + 8 * slot;
    const Lens l = lens_of(intr, dist, bi, have);
    Line lines[4];
    for (int i = 0; i < 4; ++i) {
      const int j = (i + 1) & 3;
      const Edge e = make_edge(c[2 * i], c[2 * i + 1], c[2 * j],
                               c[2 * j + 1], n_alpha);
      float m[6];
      edge_sums(e, gray + (size_t)bi * h * w, h, w, n_alpha, l, have,
                reversed, m);
      lines[i] = fit_line(e, m);
    }
    for (int i = 0; i < 4; ++i) {
      const int j = (i + 1) & 3;
      corner(lines[i], lines[j], valid[slot], l, have, c + 2 * j,
             out + 8 * slot + 2 * j);
    }
  }
}

extern "C" void host_refine_terms(const uint8_t* gray, const float* corners,
    const float* intr, const float* dist, int b, int nq, int h, int w,
    int n_alpha, int have, int reversed, float* ux, float* uy, uint8_t* ok,
    int* idx, float* wgt, float* xo, float* yo) {
  for (int slot = 0; slot < b * nq; ++slot) {
    const int bi = slot / nq;
    const float* c = corners + 8 * slot;
    const Lens l = lens_of(intr, dist, bi, have);
    for (int i = 0; i < 4; ++i) {
      const int j = (i + 1) & 3;
      const Edge e = make_edge(c[2 * i], c[2 * i + 1], c[2 * j],
                               c[2 * j + 1], n_alpha);
      for (int s = 0; s < n_alpha; ++s) {
        const size_t row = ((size_t)slot * 4 + i) * n_alpha + s;
        float x0, y0;
        sample_origin(e, s, &x0, &y0);
        for (int u = 0; u < kUnionSteps; ++u) {
          const Sample p = union_sample(e, x0, y0, u, h, w);
          const size_t at = row * kUnionSteps + u;
          ux[at] = p.px;
          uy[at] = p.py;
          ok[at] = p.ok;
          idx[at] = p.idx;
        }
        for (int k = 0; k < kNormalSteps; ++k) {
          const Term tm = edge_term(e, gray + (size_t)bi * h * w, h, w, s,
                                    k, l, have, reversed);
          const size_t at = row * kNormalSteps + k;
          wgt[at] = tm.wgt;
          xo[at] = tm.xo;
          yo[at] = tm.yo;
        }
      }
    }
  }
}
'''


@pytest.fixture(scope="module")
def host_refine(tmp_path_factory):
    """csrc/refine.cuh built for the host: (corners, terms) functions of a
    case, n_alpha and the border."""
    cxx = _host_compiler()
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("host_refine")
    src = out / "host_refine.cpp"
    src.write_text(HOST_GLUE)
    lib = out / "libhost_refine.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC",
                    "-shared", f"-I{_build.CSRC}", "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    dll.host_refine_edges.argtypes = [P] * 6 + [I] * 7
    dll.host_refine_terms.argtypes = [P] * 4 + [I] * 7 + [P] * 7
    dll.host_term_visits.argtypes = [I, P, P]

    def operands(case):
        g, c, v, intr, dist = case
        have = intr is not None
        b = g.shape[0]
        intr = np.zeros((b, 4), np.float32) if intr is None else intr
        dist = np.zeros((b, 5), np.float32) if dist is None else dist
        return [np.ascontiguousarray(a) for a in (
            g, c, v.astype(np.uint8), intr, dist)], have

    def corners(case, n_alpha, rb):
        (g, c, v, intr, dist), have = operands(case)
        res = np.empty_like(c)
        b, nq = c.shape[:2]
        dll.host_refine_edges(*[a.ctypes.data for a in (g, c, v, intr, dist,
                                                         res)],
                              b, nq, H, W, n_alpha, int(have), int(rb))
        return res

    def terms(case, n_alpha, rb):
        (g, c, _, intr, dist), have = operands(case)
        b, nq = c.shape[:2]
        us = (b, nq, 4, n_alpha, 33)
        ks = (b, nq, 4, n_alpha, 25)
        res = dict(ux=np.empty(us, np.float32), uy=np.empty(us, np.float32),
                   ok=np.empty(us, np.uint8), idx=np.empty(us, np.int32),
                   wgt=np.empty(ks, np.float32), xo=np.empty(ks, np.float32),
                   yo=np.empty(ks, np.float32))
        dll.host_refine_terms(*[a.ctypes.data for a in (g, c, intr, dist)],
                              b, nq, H, W, n_alpha, int(have), int(rb),
                              *[res[k].ctypes.data for k in (
                                  "ux", "uy", "ok", "idx", "wgt", "xo",
                                  "yo")])
        return res

    def visits(n_alpha):
        counts = np.zeros(n_alpha * 25, np.int32)
        most = ctypes.c_int(0)
        threads = dll.host_term_visits(n_alpha, counts.ctypes.data,
                                       ctypes.addressof(most))
        return threads, counts, most.value

    return corners, terms, visits


@pytest.mark.parametrize("n_alpha,threads,most", [(32, 800, 1),
                                                   (64, 1024, 2),
                                                   (128, 1024, 4)])
def test_term_mapping_visits_every_term_once(host_refine, n_alpha, threads,
                                             most):
    """P2's block of an edge: a thread a term of the n_alpha x 25 grid in
    whole warps, at most 1,024 threads; every term visited exactly once."""
    got_threads, counts, got_most = host_refine[2](n_alpha)
    assert (got_threads, got_most) == (threads, most)
    np.testing.assert_array_equal(counts, 1)


def _same_bits(got: np.ndarray, want: np.ndarray, what: str) -> None:
    """Equal f32 bits, NaN in the same places (any NaN's bits)."""
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
    assert np.array_equal(_bits(got)[~nan], _bits(want)[~nan]), what


@pytest.mark.parametrize("scene,n_alpha,lens,rb", GRID, ids=map(_id, GRID))
def test_kernel_terms_on_host(host_refine, scene, n_alpha, lens, rb):
    """Every sample position, in-frame flag and pixel index, every weight
    and every (undistorted) point of the kernel's arithmetic has the plain
    version's bits."""
    case = _case(scene, lens, rb)
    g, c, _, intr, dist = case
    got = host_refine[1](case, n_alpha, rb)
    want = tdec.refine_terms_plain(t(g).to(torch.float32), t(c), n_alpha, rb,
                                   *_torch_lens(intr, dist))
    for k in ("ux", "uy", "wgt", "xo", "yo"):
        _same_bits(got[k], n(want[k]), k)
    idx, ok = tdec._int_index(want["ux"], want["uy"], H, W)
    np.testing.assert_array_equal(got["ok"].astype(bool), n(ok))
    np.testing.assert_array_equal(got["idx"][n(ok)], n(idx)[n(ok)])
    assert n(want["wgt"]).max() > 0


def test_mathf_sqrt_is_correctly_rounded():
    """The plain version's edge length: mathf.sqrt gives numpy's (IEEE)
    f32 square root, which P2's __fsqrt_rn gives on the card; torch's own
    f32 sqrt on the CPU may miss it by an ulp."""
    x = np.random.default_rng(2).uniform(1, 4e5, 1 << 20).astype(np.float32)
    want = np.sqrt(x)
    assert np.array_equal(_bits(n(tdec.mathf.sqrt(t(x)))), _bits(want))
    off = int((_bits(n(torch.sqrt(t(x)))) != _bits(want)).sum())
    print(f"torch.sqrt on the CPU: {off} of {x.size} f32 square roots an "
          "ulp from IEEE")


def _random_quads(seed: int, nq: int = 64) -> np.ndarray:
    """(2, nq, 4, 2) squares of random place, size (20-200 px) and turn
    over the bench frames, corners in tl, tr, br, bl order."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform((60, 60), (W - 60, H - 60), (2, nq, 1, 2))
    half = rng.uniform(10, 100, (2, nq, 1, 1))
    ang = rng.uniform(0, np.pi / 2, (2, nq))
    rot = np.stack([np.cos(ang), -np.sin(ang), np.sin(ang), np.cos(ang)],
                   -1).reshape(2, nq, 2, 2)
    base = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64)
    corners = centre + half * np.einsum("bnij,kj->bnki", rot, base)
    return corners.astype(np.float32)


@pytest.mark.parametrize("n_alpha", TIERS)
@pytest.mark.parametrize("lens", list(LENSES))
def test_kernel_terms_on_random_quads(host_refine, lens, n_alpha):
    """The same bits on 128 quads of random place, size and turn: many
    more edge lengths than the tag scenes, so square roots that torch's CPU
    sqrt rounds the other way come up (the plain version's mathf.sqrt does
    not)."""
    g, _, _, intr, dist = _case("bench", lens, False)
    c = _random_quads(5)
    case = (g, c, np.ones(c.shape[:2], bool), intr, dist)
    got = host_refine[1](case, n_alpha, False)
    want = tdec.refine_terms_plain(t(g).to(torch.float32), t(c), n_alpha,
                                   False, *_torch_lens(intr, dist))
    for k in ("ux", "uy", "wgt", "xo", "yo"):
        _same_bits(got[k], n(want[k]), k)
    pb = np.roll(c, -1, axis=2)
    s2 = t(((pb - c) ** 2).sum(-1).astype(np.float32))
    off = int((torch.sqrt(s2) != tdec.mathf.sqrt(s2)).sum())
    print(f"{off} of {s2.numel()} edge lengths torch.sqrt rounds otherwise")


@pytest.mark.parametrize("scene,n_alpha,lens,rb", GRID, ids=map(_id, GRID))
def test_kernel_corners_on_host(host_refine, scene, n_alpha, lens, rb):
    """The kernel's corners, its own order of the moment sums included,
    within LIMIT_PX of the plain version and of the JAX function,
    non-finite in the same places."""
    case = _case(scene, lens, rb)
    got = host_refine[0](case, n_alpha, rb)
    err = _assert_corners(got, n(_plain(case, n_alpha, rb)),
                          "host kernel vs plain")
    err_jax = _assert_corners(got, _jax(case, n_alpha, rb),
                              "host kernel vs JAX")
    print(f"{_id((scene, n_alpha, lens, rb))}: {err:.3e} px from the plain "
          f"version, {err_jax:.3e} from the JAX function")
