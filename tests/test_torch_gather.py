"""Parity of the K4 value histogram (ros_vision_tpu_torch/ops/gather_kernel.py)
with ops/gather_pallas.value_histogram (interpret mode) and its reference
value_histogram_ref: bit-exact, values outside [0, S) not counted."""
import jax.numpy as jnp
import numpy as np
import pytest

from ros_vision_tpu.ops import gather_pallas as gp
from ros_vision_tpu_torch.ops import gather_kernel as gk
from tests.torch_port_helpers import n, t

S = 1025                       # max_segments + 1, as cluster_and_fit calls it


def _values(kind: str, b: int, k: int) -> np.ndarray:
    rng = np.random.default_rng(11)
    if kind == "uniform":
        return rng.integers(0, S, (b, k), dtype=np.int32)
    if kind == "out_of_range":
        return rng.integers(-40, S + 40, (b, k), dtype=np.int32)
    # sorted segment ids with a long overflow bucket, as after the
    # (key, payload) sort of cluster_and_fit
    v = np.sort(rng.integers(0, 300, (b, k)), axis=1).astype(np.int32)
    v[:, k // 2:] = S - 1
    return v


@pytest.mark.parametrize("kind", ["uniform", "out_of_range", "sorted_ids"])
@pytest.mark.parametrize("k", [2048, 8192])
def test_histogram_bit_exact(kind, k):
    v = _values(kind, 2, k)
    want = gp.value_histogram_ref(jnp.asarray(v), S)
    got = gk.histogram(t(v), S)
    assert got.dtype == gk.value_histogram_plain(t(v), S).dtype
    np.testing.assert_array_equal(n(want), n(got))
    if kind == "out_of_range":
        inside = ((v >= 0) & (v < S)).sum(axis=1)
        np.testing.assert_array_equal(n(got).sum(axis=1), inside)


def test_histogram_matches_pallas_interpret():
    v = _values("out_of_range", 2, 4096)
    want = gp.value_histogram(jnp.asarray(v), S, interpret=True)
    before = gk.launches.count
    got = gk.histogram(t(v), S)
    assert gk.launches.count == before          # CPU tensor: plain version
    np.testing.assert_array_equal(n(want), n(got))


def test_histogram_of_a_noncontiguous_view():
    v = _values("uniform", 2, 4096)
    wide = t(np.concatenate([v, v], axis=1))
    got = gk.histogram(wide[:, :4096], S)
    np.testing.assert_array_equal(n(gp.value_histogram_ref(
        jnp.asarray(v), S)), n(got))
