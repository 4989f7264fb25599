"""The port's Ultralytics weight converter
(ros_vision_tpu_torch/tools/convert_yolo_weights.py) against the JAX
package's (scripts/convert_yolo_weights.py) on tests/torch_yolo_ref.py's
YOLO11Torch with randomised BatchNorm, as tests/test_yolo_convert.py
builds it: the same .npz key for key and bit for bit, loadable by the
port's ModelInference with the torch reference's outputs, and the same
refusals, each writing nothing."""
import numpy as np
import pytest
import torch

from ros_vision_tpu_torch.tools import convert_yolo_weights as tconv
from scripts import convert_yolo_weights as jconv
from tests.torch_port_helpers import t  # noqa: F401  (sets torch threads)
from tests.torch_yolo_ref import YOLO11Torch


def _model():
    torch.manual_seed(0)
    model = YOLO11Torch(nc=2, scale="n").eval()
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.weight.uniform_(0.5, 1.5)
                mod.bias.uniform_(-0.3, 0.3)
                mod.running_mean.uniform_(-0.5, 0.5)
                mod.running_var.uniform_(0.5, 2.0)
    return model


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("yolo")
    model = _model()
    pt = tmp / "ref.pt"
    torch.save({"model": model}, pt)
    jnpz, tnpz = tmp / "jax.npz", tmp / "port.npz"
    jconv.convert(str(pt), str(jnpz), num_classes=2, scale="n",
                  img_size=160)
    tconv.convert(str(pt), str(tnpz), num_classes=2, scale="n")
    return model, str(jnpz), str(tnpz)


def test_npz_equals_jax_converter(converted):
    _, jnpz, tnpz = converted
    with np.load(jnpz) as j, np.load(tnpz) as p:
        assert sorted(p.files) == sorted(j.files)
        for k in j.files:
            assert p[k].dtype == j[k].dtype == np.float32, k
            assert p[k].shape == j[k].shape, k
            assert p[k].tobytes() == j[k].tobytes(), k


def test_port_engine_on_converted_weights_matches_torch(converted):
    from ros_vision_tpu_torch.models.infer import ModelInference
    model, _, tnpz = converted
    m = ModelInference(num_classes=2, scale="n", img_size=160,
                       params_path=tnpz, dtype=torch.float32, device="cpu")
    img = np.random.default_rng(1).random((1, 160, 160, 3), np.float32)
    with torch.no_grad():
        want = model(torch.from_numpy(img.transpose(0, 3, 1, 2))).numpy()
    got = m.forward(img).numpy()
    assert got.shape == want.shape
    assert np.abs(got[:, :4] - want[:, :4]).max() < 0.05
    assert np.abs(got[:, 4:] - want[:, 4:]).max() < 1e-3


def _bad_state(kind: str) -> dict:
    sd = {k: v.clone() for k, v in _model().state_dict().items()}
    if kind == "shape":
        sd["model.2.cv1.conv.weight"] = torch.zeros(7, 7, 3, 3)
    elif kind == "no_leaf":
        sd["model.2.m.7.cv1.conv.weight"] = torch.zeros(8, 8, 3, 3)
    elif kind == "dfl":
        sd["model.23.dfl.conv.weight"] = \
            sd["model.23.dfl.conv.weight"].flip(1)
    elif kind == "unassigned":
        del sd["model.0.bn.running_var"]
    return sd


@pytest.mark.parametrize("kind", ["shape", "no_leaf", "dfl", "unassigned"])
def test_same_refusals_as_jax(tmp_path, capsys, kind):
    pt = tmp_path / "bad.pt"
    torch.save(_bad_state(kind), pt)
    errors = {}
    for name, run in (("jax", lambda out: jconv.convert(
            str(pt), out, num_classes=2, scale="n", img_size=160)),
                      ("port", lambda out: tconv.convert(
            str(pt), out, num_classes=2, scale="n"))):
        out = tmp_path / f"{name}.npz"
        with pytest.raises(SystemExit, match="refusing to write"):
            run(str(out))
        assert not out.exists()
        errors[name] = [line.split(":")[1].split()[0] for line in
                        capsys.readouterr().err.splitlines()
                        if line.startswith("ERROR")]
    assert errors["port"] == errors["jax"] and errors["port"]


def test_cli_help(capsys):
    with pytest.raises(SystemExit) as e:
        tconv.main(["--help"])
    assert e.value.code == 0
    assert "--num-classes" in capsys.readouterr().out
