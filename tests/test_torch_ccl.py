"""Parity of the port's flood CCL (ros_vision_tpu_torch/ops/ccl.py, the K6-K8
wrappers in ops/ccl_kernel.py and the K12 wrapper in ops/gather_kernel.py)
with the JAX package: ccl_pallas.propagate_fixpoint, label_histogram and
propagate and gather_pallas.rank_gather in interpret mode, and
ccl.label_components_flood, flood_ranks and label_components_hybrid. Every
comparison is bit-exact (integer outputs), including values at and above
2^30 (the flood's _BIG), INT32_MAX, out-of-range labels and overflow of the
2048-blob rank space. On the CPU the wrappers run the plain versions and
count no launch."""
import jax.numpy as jnp
import numpy as np
import pytest

from ros_vision_tpu.apriltag.render import render_scene, simple_square_corners
from ros_vision_tpu.ops import ccl as jccl
from ros_vision_tpu.ops import ccl_pallas
from ros_vision_tpu.ops import gather_pallas as jgp
from ros_vision_tpu.ops import threshold as jthr
from ros_vision_tpu_torch.device import HostSyncs
from ros_vision_tpu_torch.ops import ccl as tccl
from ros_vision_tpu_torch.ops import ccl_kernel as ck
from ros_vision_tpu_torch.ops import gather_kernel as gk
from tests.torch_port_helpers import checkerboard, n, random_threshim, t

INT32_MAX = 2 ** 31 - 1
BIG = 2 ** 30


def _threshim(gray: np.ndarray) -> np.ndarray:
    return np.asarray(jthr.adaptive_threshold(
        jthr.decimate2(jnp.asarray(gray)))[0])


def _scene() -> np.ndarray:
    """(1, 80, 128) threshold image of the two-tag scene of
    tests/test_ops_units.py test_ccl_flood_interpret_matches_xla."""
    img, _ = render_scene(
        [3, 9], [simple_square_corners(70, 60, 34),
                 simple_square_corners(190, 90, 30, angle_deg=40)],
        256, 160, noise_sigma=2.0, seed=5)
    return _threshim(img[None])


CASES = {
    "scene": (_scene, 25),
    "random": (lambda: random_threshim(2, 48, 96, seed=3), 25),
    # 2x2 black blocks with min_blob=4: ~4000 big blobs > 2048
    "overflow": (lambda: _threshim(checkerboard(256, 512, 4, 0.1, 1)), 4),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    make, min_blob = CASES[request.param]
    return request.param, make(), min_blob


def _values(kind: str, th: np.ndarray, seed: int = 0) -> np.ndarray:
    b, h, w = th.shape
    rng = np.random.default_rng(seed)
    if kind == "flat":
        flat = np.arange(h * w, dtype=np.int32).reshape(h, w)
        return np.ascontiguousarray(np.broadcast_to(flat, th.shape))
    if kind == "per_root":
        # random values (some above 2^30) at the component roots,
        # INT32_MAX elsewhere: label_components_flood's broadcast="flood"
        labels = n(tccl.label_components(t(th))[0]).reshape(th.shape)
        roots = labels == np.arange(h * w).reshape(h, w)
        vals = rng.integers(0, INT32_MAX, th.shape, dtype=np.int64)
        return np.where(roots, vals, INT32_MAX).astype(np.int32)
    return rng.integers(0, INT32_MAX, th.shape, dtype=np.int64).astype(
        np.int32)


@pytest.mark.parametrize("kind", ["flat", "per_root", "random"])
def test_propagate_fixpoint_bit_exact(case, kind):
    _, th, _ = case
    vals = _values(kind, th)
    want = n(ccl_pallas.propagate_fixpoint(jnp.asarray(th), jnp.asarray(vals),
                                           interpret=True))
    before = ck.fixpoint_launches.count
    for fn in (tccl.propagate_fixpoint, ck.propagate_fixpoint):
        got = n(fn(t(th), t(vals)))
        assert got.dtype == np.int32 and got.shape == th.shape
        np.testing.assert_array_equal(want, got)
    assert ck.fixpoint_launches.count == before      # CPU: plain version
    if kind != "flat":
        assert (want == BIG).any()                   # the 2^30 cap binds


@pytest.mark.parametrize("kind", ["converged", "random"])
def test_label_histogram_bit_exact(case, kind):
    _, th, _ = case
    b, h, w = th.shape
    size = h * w
    if kind == "converged":
        labels = n(tccl.label_components(t(th))[0])
    else:
        # in range, just past N, past the kernel's padded table, negative
        rng = np.random.default_rng(1)
        labels = rng.integers(-600, size + 1500, (b, size)).astype(np.int32)
        labels[:, :4] = [-1, size, size + 511, INT32_MAX]
    want = n(ccl_pallas.label_histogram(jnp.asarray(labels), interpret=True))
    inside = labels[(labels >= 0) & (labels < size)]
    assert want.sum() == inside.size                 # out-of-range dropped
    before = ck.histogram_launches.count
    for fn in (tccl.label_histogram, ck.label_histogram):
        np.testing.assert_array_equal(want, n(fn(t(labels))))
    assert ck.histogram_launches.count == before


@pytest.mark.parametrize("n_sweeps", [0, 1, 7, 96])
def test_propagate_bit_exact(case, n_sweeps):
    _, th, _ = case
    for kind in ("flat", "random"):
        vals = _values(kind, th, seed=n_sweeps)
        want = n(ccl_pallas.propagate(jnp.asarray(th), jnp.asarray(vals),
                                      n_sweeps=n_sweeps, interpret=True))
        before = ck.propagate_launches.count
        for fn in (tccl.propagate, ck.propagate):
            np.testing.assert_array_equal(want,
                                          n(fn(t(th), t(vals), n_sweeps)))
        assert ck.propagate_launches.count == before
        if n_sweeps == 0:
            np.testing.assert_array_equal(want, vals)


def test_propagate_rejects_negative_sweeps():
    th = random_threshim(1, 16, 32, seed=0)
    with pytest.raises(ValueError):
        ck.propagate(t(th), t(_values("flat", th)), -1)


@pytest.mark.parametrize("size", [8192, 5000])
def test_rank_gather_bit_exact(size):
    rng = np.random.default_rng(11)
    labels = rng.integers(0, size, (2, size)).astype(np.int32)
    labels[:, :4] = [-1, size, size + 700, INT32_MAX]     # -> 0
    rank_v = rng.integers(0, 2049, (2, size)).astype(np.int32)
    want = n(jgp.rank_gather(jnp.asarray(labels), jnp.asarray(rank_v),
                             interpret=True))
    np.testing.assert_array_equal(want[:, :4], 0)
    before = gk.rank_gather_launches.count
    for fn in (gk.rank_gather_plain, gk.rank_gather):
        np.testing.assert_array_equal(want, n(fn(t(labels), t(rank_v))))
    assert gk.rank_gather_launches.count == before


@pytest.mark.parametrize("broadcast", ["gather", "flood"])
def test_label_components_flood_bit_exact(case, broadcast):
    name, th, min_blob = case
    want = jccl.label_components_flood(jnp.asarray(th), interpret=True,
                                       min_blob=min_blob, broadcast=broadcast)
    got = tccl.label_components_flood(t(th), min_blob=min_blob,
                                      broadcast=broadcast)
    for w_, g_ in zip(want, got, strict=True):
        np.testing.assert_array_equal(n(w_), n(g_))
    # labels agree with the union-find / hook CCL
    np.testing.assert_array_equal(n(got[0]),
                                  n(tccl.label_components(t(th), min_blob)[0]))
    if name == "overflow":
        assert int(n(got[2]).max()) == tccl.MAX_BLOBS


def test_flood_ranks_bit_exact(case):
    _, th, min_blob = case
    want = jccl.flood_ranks(jnp.asarray(th), interpret=True,
                            min_blob=min_blob)
    got = tccl.flood_ranks(t(th), min_blob=min_blob)
    np.testing.assert_array_equal(n(want), n(got))
    np.testing.assert_array_equal(
        n(got), n(tccl.label_components_flood(t(th), min_blob)[2]))


@pytest.mark.parametrize("sweeps", [(96, 16), (448, 64)])
def test_label_components_hybrid_bit_exact(case, sweeps):
    name, th, min_blob = case
    pallas_sweeps, verify_sweeps = sweeps
    jl, js, jr = jccl.label_components_hybrid(
        jnp.asarray(th), pallas_sweeps=pallas_sweeps,
        verify_sweeps=verify_sweeps, interpret=True, min_blob=min_blob)
    syncs = HostSyncs()
    tl, ts, tr = tccl.label_components_hybrid(
        t(th), pallas_sweeps=pallas_sweeps, verify_sweeps=verify_sweeps,
        min_blob=min_blob, syncs=syncs)
    np.testing.assert_array_equal(n(jl), n(tl))
    np.testing.assert_array_equal(n(js), n(ts))
    np.testing.assert_array_equal(n(jr), n(tr))
    assert 1 <= syncs.count <= 16                    # one read per round
    if name == "overflow":
        # the JAX epilogue packs rank << 20 | size: rank 2048 wraps
        assert int(n(tr).min()) == -tccl.MAX_BLOBS


def test_flood_rejects_large_frames():
    """The rank << 19 | size packing needs H*W < 2^19, as in the JAX
    package; the check runs before any work."""
    th = np.zeros((1, 512, 1024), np.uint8)
    for fn in (tccl.label_components_flood, tccl.flood_ranks):
        with pytest.raises(ValueError, match="2\\^19"):
            fn(t(th))
    with pytest.raises(ValueError):
        tccl.label_components_flood(t(th[:, :8, :8]), broadcast="scatter")
