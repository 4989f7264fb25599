"""Parity of the port's front half with the JAX package: connected
components (ros_vision_tpu_torch/ops/ccl.py, the K2 wrapper in
ops/frontend_kernel.py) and boundary compaction (ops/quadfit.py, the K3
wrapper) are bit-exact against ops/ccl.label_components, the
interpret-mode Pallas rank_image / boundary_compact and
quadfit.boundary_points, including overflow of the 2048-blob rank space
and of both boundary caps."""
import jax.numpy as jnp
import numpy as np
import pytest

from ros_vision_tpu.ops import ccl as jccl
from ros_vision_tpu.ops import frontend_pallas as fp
from ros_vision_tpu.ops import quadfit as jqf
from ros_vision_tpu.ops import threshold as jthr
from ros_vision_tpu_torch.ops import ccl as tccl
from ros_vision_tpu_torch.ops import frontend_kernel as fk
from ros_vision_tpu_torch.ops import quadfit as tqf
from tests.test_frontend_pallas import _boundary_ref
from tests.torch_port_helpers import (checkerboard, n, random_threshim,
                                      small_scene, t)


def _threshim(gray: np.ndarray) -> np.ndarray:
    return np.asarray(jthr.adaptive_threshold(
        jthr.decimate2(jnp.asarray(gray)))[0])


@pytest.fixture(scope="module")
def scene2():
    """(2, 64, 128) threshold images of two noisy two-tag scenes."""
    return _threshim(np.concatenate([small_scene(0), small_scene(1)]))


def _cases():
    return {
        "scene": lambda: _threshim(small_scene(0)),
        "random": lambda: random_threshim(2, 48, 96, seed=3),
        # 2x2 black blocks with min_blob=4: ~4000 big blobs > 2048
        "overflow": lambda: _threshim(checkerboard(256, 512, 4, 0.1, 1)),
    }


@pytest.mark.parametrize("case", ["scene", "random", "overflow"])
def test_label_components_bit_exact(case):
    """ccl.label_components equals the JAX function, rank -2048 of the
    2048th blob included (the JAX epilogue packs rank << 20 | size); K2
    and its plain version return 2048 there, as frontend_pallas.rank_image
    does, and equal the JAX ranks everywhere else."""
    th = _cases()[case]()
    min_blob = 4 if case == "overflow" else 25
    jl, js, jr = jccl.label_components(jnp.asarray(th), min_blob=min_blob)
    tl, ts, tr = tccl.label_components(t(th), min_blob)
    np.testing.assert_array_equal(n(jl), n(tl))
    np.testing.assert_array_equal(n(js), n(ts))
    np.testing.assert_array_equal(n(jr), n(tr))
    want = n(jr)
    if case == "overflow":
        big = (n(js) >= min_blob) & (n(jl) == np.arange(th[0].size))
        assert big.sum() > tccl.MAX_BLOBS
        assert int(want.min()) == -tccl.MAX_BLOBS
        want = n(fp.rank_image(jnp.asarray(th), min_blob=min_blob,
                               interpret=True)).reshape(1, -1)
        assert int(want.max()) == tccl.MAX_BLOBS
    for fn in (fk.label_components_plain, fk.label_components):
        kl, ks, kr = fn(t(th), min_blob)
        np.testing.assert_array_equal(n(jl), n(kl))
        np.testing.assert_array_equal(n(js), n(ks))
        np.testing.assert_array_equal(want, n(kr))


def test_rank_image_matches_pallas_interpret(scene2):
    want = fp.rank_image(jnp.asarray(scene2), interpret=True)
    before = fk.rank_launches.count
    got = fk.rank_image(t(scene2))
    assert fk.rank_launches.count == before
    assert tuple(got.shape) == scene2.shape
    np.testing.assert_array_equal(n(want), n(got))


@pytest.mark.parametrize("p_cap,k_cap", [
    (1536, 2048),      # no overflow at either stage
    (256, 2048),       # stage-A overflow (pixel thinning)
    (1536, 384),       # stage-B overflow (point thinning)
    (192, 256),        # both overflow
])
def test_boundary_compact_bit_exact(scene2, p_cap, k_cap):
    th = jnp.asarray(scene2)
    _, _, jr = jccl.label_components(th)
    b, h, w = scene2.shape
    pts_ref, counts_ref = _boundary_ref(th, jr, p_cap, k_cap)
    jkey, jpack2, jcounts = fp.boundary_compact(
        th, jr.reshape(b, h, w), p_cap, k_cap, interpret=True)
    ranks = t(jr).view(b, h, w)
    before = fk.boundary_launches.count
    key, pack2, counts = fk.boundary_compact(t(scene2), ranks, p_cap, k_cap)
    assert fk.boundary_launches.count == before
    np.testing.assert_array_equal(n(counts), n(counts_ref))
    np.testing.assert_array_equal(n(counts), n(jcounts))
    np.testing.assert_array_equal(n(key), n(pts_ref["key"]))
    np.testing.assert_array_equal(n(pack2), n(pts_ref["pack2"]))
    # the Pallas output is padded to whole rows; its leading k_cap slots
    np.testing.assert_array_equal(n(key), n(jkey)[:, :k_cap])
    np.testing.assert_array_equal(n(pack2), n(jpack2)[:, :k_cap])


@pytest.mark.parametrize("k", [1024, 4096])
def test_boundary_points_matches_xla_path(scene2, k):
    th = jnp.asarray(scene2)
    _, _, jr = jccl.label_components(th)
    jpts, jc = jqf.boundary_points(th, jr, jqf.QuadFitConfig(max_points=k))
    cfg = tqf.QuadFitConfig(max_points=k)
    tpts, tc = tqf.boundary_points(t(scene2), t(jr), cfg)
    np.testing.assert_array_equal(n(jc), n(tc))
    for key in ("key", "pack2"):
        np.testing.assert_array_equal(n(jpts[key]), n(tpts[key]))
    # the detector's front half: K2 + K3 wrappers end to end
    fpts, fc = fk.frontend(t(scene2), k, cfg.max_boundary_pixels)
    np.testing.assert_array_equal(n(fc), n(tc))
    for key in ("key", "pack2"):
        np.testing.assert_array_equal(n(fpts[key]), n(tpts[key]))


def test_boundary_masks_bit_exact(scene2):
    th = jnp.asarray(scene2)
    _, _, jr = jccl.label_components(th)
    b, h, w = scene2.shape
    jm, jk = jqf.boundary_masks(th, jr.reshape(b, h, w))
    tm, tkey = tqf.boundary_masks(t(scene2), t(jr).view(b, h, w))
    np.testing.assert_array_equal(n(jm), n(tm))
    np.testing.assert_array_equal(n(jk), n(tkey))


@pytest.mark.parametrize("p_cap,w", [(24576, 640), (98304, 640),
                                     (1536, 128), (100, 128), (5000, 960)])
def test_boundary_block_rows(p_cap, w):
    """Including the 307,200-element clamp (98304 at W=640 binds it)."""
    assert tqf.boundary_block_rows(p_cap, w) == fp.boundary_block_rows(
        p_cap, w)
