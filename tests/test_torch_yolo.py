"""The port's YOLOv11 (ros_vision_tpu_torch/models/yolo.py, infer.py)
against the JAX package's flax model, on the CPU.

Weights are carried from a JAX variables tree of the flax model's own
structure (jax.eval_shape of its init) filled from a numpy seed, BatchNorm
scale, bias, mean and var randomised (default statistics would hide a
wrong transfer). Tolerances, on (B, 4+nc, A) outputs with boxes in input
pixels: f32 boxes within 2e-3 px and scores within 1e-5 (measured at most
1.8e-4 px and 1.2e-7, XLA's FMA contraction and reduce order against
torch's); bf16 boxes within 0.5 px and scores within 5e-3 (measured 0.079
px and 4.7e-4 at n/64).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from ros_vision_tpu.models.infer import ModelInference as JInference
from ros_vision_tpu.models.yolo import YOLOv11 as JYolo
from ros_vision_tpu_torch.models import yolo as tyolo
from ros_vision_tpu_torch.models.infer import ModelInference
from tests.torch_port_helpers import n

NC = 2


def random_variables(scale: str, size: int, seed: int = 0, nc: int = NC):
    """A flax variables tree (nested, numpy f32) of YOLOv11(nc, scale), its
    leaves random: kernels lecun-scaled, BatchNorm scale U(0.5, 1.5), bias
    U(-0.3, 0.3), mean U(-0.5, 0.5), var U(0.5, 2)."""
    shapes = jax.eval_shape(JYolo(num_classes=nc, scale=scale).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3), jnp.float32))
    rng = np.random.default_rng(seed)
    flat = {}
    for path, s in flatten_dict(shapes).items():
        leaf = path[-1]
        if leaf == "kernel":
            a = rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
        else:
            lo, hi = {"scale": (0.5, 1.5), "bias": (-0.3, 0.3),
                      "mean": (-0.5, 0.5), "var": (0.5, 2.0)}[leaf]
            a = rng.uniform(lo, hi, s.shape)
        flat[path] = a.astype(np.float32)
    return unflatten_dict(flat)


class Pair:
    """The flax model and the port's, on one random variables tree."""

    def __init__(self, scale: str, size: int):
        self.scale, self.size = scale, size
        self.variables = random_variables(scale, size)
        self.jax_model = JYolo(num_classes=NC, scale=scale)
        self.apply = jax.jit(self.jax_model.apply)
        self.model = tyolo.from_flax(tyolo.YOLOv11(NC, scale).eval(),
                                     self.variables)

    def inputs(self, b: int, seed: int = 1) -> np.ndarray:
        return np.random.default_rng(seed).random(
            (b, self.size, self.size, 3), np.float32)

    def jax_out(self, x, dtype=jnp.float32):
        return n(self.apply(self.variables, jnp.asarray(x).astype(dtype)))

    def port_out(self, x, model=None):
        with torch.no_grad():
            return n((model or self.model)(
                torch.from_numpy(x).permute(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(scale, size):
        if (scale, size) not in cache:
            cache[scale, size] = Pair(scale, size)
        return cache[scale, size]
    return get


def assert_outputs_close(got, want, box_tol, score_tol):
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    assert np.isfinite(got).all()
    box_err = np.abs(got[:, :4] - want[:, :4]).max()
    score_err = np.abs(got[:, 4:] - want[:, 4:]).max()
    assert box_err <= box_tol, box_err
    assert score_err <= score_tol, score_err


def test_from_flax_carries_every_leaf(pairs):
    p = pairs("n", 64)
    want = {"/".join(k): v for k, v in flatten_dict(p.variables).items()}
    got = tyolo.to_flax(p.model)
    assert set(got) == set(want) and len(want) == 417
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    sd = p.model.state_dict()
    # a grouped (depthwise) kernel: flax (kh, kw, in/groups, out)
    dw = want["params/m10/m0/attn/pe/Conv_0/kernel"]
    assert dw.shape[2] == 1
    np.testing.assert_array_equal(
        sd["m10.m0.attn.pe.conv.weight"].numpy(), dw.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["m0.bn.running_var"].numpy(),
        want["batch_stats/m0/BatchNorm_0/var"])


@pytest.mark.parametrize("scale,size,b", [("n", 64, 2), ("s", 64, 1),
                                          ("m", 96, 2), ("n", 640, 1)])
def test_f32_forward_matches_flax(pairs, scale, size, b):
    p = pairs(scale, size)
    x = p.inputs(b)
    want = p.jax_out(x)
    assert want.shape == (b, 4 + NC, sum((size // s) ** 2
                                         for s in (8, 16, 32)))
    assert_outputs_close(p.port_out(x), want, box_tol=2e-3, score_tol=1e-5)


def test_bf16_forward_matches_flax(pairs):
    p = pairs("n", 64)
    x = p.inputs(2, seed=3)
    bf16 = tyolo.from_flax(tyolo.YOLOv11(NC, "n").eval(), p.variables)
    bf16.set_compute_dtype(torch.bfloat16)
    assert bf16.m0.conv.weight.dtype == torch.bfloat16
    assert bf16.m0.bn.weight.dtype == torch.float32
    assert bf16.cv2_0_2.weight.dtype == torch.float32
    assert_outputs_close(p.port_out(x, bf16), p.jax_out(x, jnp.bfloat16),
                         box_tol=0.5, score_tol=5e-3)


def _jax_engine(img_size: int, variables=None):
    """The JAX ModelInference's weight I/O without its flax init (its
    save_params/load_params read and write only .variables)."""
    eng = object.__new__(JInference)
    eng.img_size, eng.num_classes = img_size, NC
    eng.variables = variables
    return eng


def test_npz_from_jax_to_port(pairs, tmp_path):
    p = pairs("n", 64)
    path = str(tmp_path / "jax.npz")
    _jax_engine(64, p.variables).save_params(path)
    eng = ModelInference(num_classes=NC, img_size=64, params_path=path,
                         dtype=torch.float32, device="cpu")
    x = p.inputs(1, seed=4)
    np.testing.assert_array_equal(n(eng.forward(x)), p.port_out(x))
    assert eng.input_shape == (1, 64, 64, 3)
    assert eng.output_shape == _jax_engine(64).output_shape == (1, 6, 84)


def test_npz_from_port_to_jax(pairs, tmp_path):
    p = pairs("n", 64)
    eng = ModelInference(num_classes=NC, img_size=64, dtype=torch.float32,
                         device="cpu")
    path = str(tmp_path / "port.npz")
    eng.save_params(path)
    jeng = _jax_engine(64)
    jeng.load_params(path)
    x = p.inputs(1, seed=5)
    want = n(p.apply(jeng.variables, jnp.asarray(x)))
    assert_outputs_close(n(eng.forward(x)), want, box_tol=2e-3,
                         score_tol=1e-5)
    # and back: the .npz refills an engine holding other weights to the
    # same bits
    again = ModelInference(num_classes=NC, img_size=64, dtype=torch.float32,
                           device="cpu")
    tyolo.from_flax(again.model, p.variables)
    assert not np.array_equal(n(again.forward(x)), n(eng.forward(x)))
    again.load_params(path)
    np.testing.assert_array_equal(n(again.forward(x)), n(eng.forward(x)))


def test_torch_checkpoint_round_trip(tmp_path, pairs):
    p = pairs("n", 64)
    npz = str(tmp_path / "w.npz")
    _jax_engine(64, p.variables).save_params(npz)
    eng = ModelInference(num_classes=NC, img_size=64, params_path=npz,
                         dtype=torch.bfloat16, device="cpu")
    path = str(tmp_path / "w.pt")
    eng.save_checkpoint(path)
    other = ModelInference(num_classes=NC, img_size=64, dtype=torch.bfloat16,
                           device="cpu")
    x = p.inputs(1, seed=6)
    assert not np.array_equal(n(other.forward(x)), n(eng.forward(x)))
    other.load_checkpoint(path)
    np.testing.assert_array_equal(n(other.forward(x)), n(eng.forward(x)))


def test_seeded_init_is_reproducible():
    a = ModelInference(num_classes=1, img_size=64, dtype=torch.float32,
                       device="cpu")
    b = ModelInference(num_classes=1, img_size=64, dtype=torch.float32,
                       device="cpu")
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def test_from_flax_refuses_extra_and_missing_keys(pairs):
    p = pairs("n", 64)
    flat = {"/".join(k): v for k, v in flatten_dict(p.variables).items()}
    model = tyolo.YOLOv11(NC, "n").eval()
    extra = dict(flat)
    extra["params/m0/Conv_1/kernel"] = np.zeros((3, 3, 3, 16), np.float32)
    with pytest.raises(KeyError, match="not used"):
        tyolo.from_flax(model, extra)
    missing = dict(flat)
    del missing["batch_stats/m4/m0/cv2/BatchNorm_0/mean"]
    with pytest.raises(KeyError, match="lack"):
        tyolo.from_flax(model, missing)
    wrong = dict(flat)
    wrong["params/m1/Conv_0/kernel"] = np.zeros((3, 3, 16, 8), np.float32)
    with pytest.raises(ValueError, match="does not fit"):
        tyolo.from_flax(model, wrong)
    # the port's own model for another class count does not fit either
    with pytest.raises(ValueError):
        tyolo.from_flax(tyolo.YOLOv11(3, "n"), flat)


def test_engine_needs_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelInference(num_classes=1, img_size=64)


@pytest.mark.parametrize("shape", [(1, 800, 1280, 3), (2, 48, 40, 3)])
def test_preprocess_device_matches_jax(shape):
    """jax.image.resize antialiases when it downsamples (1280x800 -> 640
    here; torch without antialias differs by ~0.3): within 1e-5."""
    bgr = np.random.default_rng(7).integers(0, 256, shape, dtype=np.uint8)
    size = 640 if shape[1] > 100 else 64
    want = n(_jax_engine(size).preprocess_device(bgr))
    eng = ModelInference(num_classes=1, img_size=size, dtype=torch.float32,
                         device="cpu")
    got = n(eng.preprocess_device(bgr))
    assert got.shape == want.shape == (shape[0], size, size, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
