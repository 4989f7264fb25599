"""The port's training loop (ros_vision_tpu_torch/models/train.py) against
the JAX package's (ros_vision_tpu/models/train.py), on the CPU, in f32.

Both sides start from the weights of one JAX ModelInference (create_model's
flax init, scale n, f32), carried to the port by from_flax; the batches are
synthetic scenes made from a numpy seed. The JAX step's gradients are read
through an optax transformation that hands them back as its state.

Tolerances: loss and metrics within 1e-5 relative; each gradient tensor
within 1e-4 of its max-abs (XLA and torch sum in other orders); AdamW
parameters after 3 steps on the same numpy gradients within 1e-6; the
train() history over 3 steps within 1e-4 relative; the port's trained
weights loaded into the JAX engine give its forward within the f32
tolerances of tests/test_torch_yolo.py (2e-3 px, 1e-5).
"""
import copy
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from ros_vision_tpu.models import train as jtrain
from ros_vision_tpu.models.infer import ModelInference as JInference
from ros_vision_tpu_torch.models import train as ttrain
from ros_vision_tpu_torch.models import yolo as tyolo
from ros_vision_tpu_torch.models.infer import ModelInference
from tests.torch_port_helpers import n

SIZE = 64
K = 50            # NMS slots: 64 px has 84 anchors, fewer than the default 100


def synthetic_batch(seed: int, b: int = 2, size: int = SIZE, m: int = 3):
    """(imgs, boxes, labels, mask): grey noise with an orange box per
    object, boxes cx,cy,w,h; row 0 has two overlapping objects (anchors in
    both go to the nearer center) and a padded slot, the other rows one
    object each."""
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0.2, 0.4, (b, size, size, 3)).astype(np.float32)
    boxes = np.zeros((b, m, 4), np.float32)
    labels = np.zeros((b, m), np.int32)
    mask = np.zeros((b, m), bool)
    for r in range(b):
        for k in range(2 if r == 0 else 1):
            w, h = rng.uniform(size / 4, size / 2, 2)
            cx = rng.uniform(w / 2, size - w / 2)
            cy = rng.uniform(h / 2, size - h / 2)
            if k == 1:   # overlap the first object
                cx, cy = boxes[r, 0, 0] + w / 3, boxes[r, 0, 1] + h / 4
            imgs[r, int(cy - h / 2):int(cy + h / 2),
                 int(cx - w / 2):int(cx + w / 2)] = [0.9, 0.4, 0.1]
            boxes[r, k] = (cx, cy, w, h)
            mask[r, k] = True
    return imgs, boxes, labels, mask


def grad_catcher():
    """An optax transformation whose update is zero and whose state is the
    gradients it was given."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.fixture(scope="module")
def jengine():
    return JInference(num_classes=1, scale="n", img_size=SIZE,
                      class_names=["ball"], dtype=jnp.float32)


def port_engine(variables, dtype=torch.float32):
    eng = ModelInference(num_classes=1, scale="n", img_size=SIZE,
                         class_names=["ball"], dtype=dtype, device="cpu",
                         max_detections=K)
    tyolo.from_flax(eng.model, variables)
    eng._refresh()
    return eng


def jax_grads(jengine, batch):
    tx = grad_catcher()
    step = jtrain.make_train_step(jengine.model, tx, SIZE, 1)
    params = jengine.variables["params"]
    _, grads, metrics = step(params, jengine.variables["batch_stats"],
                             tx.init(params), *map(jnp.asarray, batch))
    return ({"params/" + "/".join(k): n(v)
             for k, v in flatten_dict(grads).items()},
            {k: float(v) for k, v in metrics.items()})


def port_grads(variables, batch):
    eng = port_engine(variables)
    step = ttrain.make_train_step(
        eng.model, torch.optim.SGD(eng.model.parameters(), lr=0.0), SIZE, 1)
    metrics = step(*map(torch.from_numpy, batch))
    grads = {tyolo.flax_key(k): p.grad.numpy()
             for k, p in eng.model.named_parameters()}
    return grads, {k: float(v) for k, v in metrics.items()}


def hwio(a: np.ndarray) -> np.ndarray:
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a


@pytest.mark.parametrize("size", [64, 96, 640])
def test_anchor_grid_identical(size):
    jc, js = jtrain._anchor_grid(size)
    tc, ts = ttrain._anchor_grid(size)
    assert jc.dtype == tc.dtype and js.dtype == ts.dtype
    assert np.array_equal(jc, tc) and np.array_equal(js, ts)


def test_train_config_defaults():
    assert dataclasses.asdict(ttrain.TrainConfig()) == \
        dataclasses.asdict(jtrain.TrainConfig())


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_metrics_and_gradients_match_jax(jengine, seed):
    batch = synthetic_batch(seed)
    jg, jm = jax_grads(jengine, batch)
    tg, tm = port_grads(jengine.variables, batch)
    assert jm["mean_iou"] > 0 and jm["box_loss"] > 0
    for k in jm:
        assert abs(tm[k] - jm[k]) <= 1e-5 * abs(jm[k]), (k, tm[k], jm[k])
    assert set(tg) == set(jg)
    for k, g in tg.items():
        want = jg[k]
        scale = max(float(np.abs(want).max()), 1e-12)
        err = float(np.abs(hwio(g) - want).max())
        assert err <= 1e-4 * scale, (k, err, scale)


def test_parameter_set_is_optax_leaf_set(jengine):
    eng = port_engine(jengine.variables)
    leaves = {"params/" + "/".join(k): v.shape for k, v in
              flatten_dict(jengine.variables["params"]).items()}
    params = dict(eng.model.named_parameters())
    assert len(params) == len(leaves)
    got = {tyolo.flax_key(k): tuple(hwio(p.detach().numpy()).shape)
           for k, p in params.items()}
    assert got == {k: tuple(s) for k, s in leaves.items()}
    # the batch statistics are buffers, outside the optimiser
    opt = ttrain.make_optimizer(eng.model)
    assert sum(len(g["params"]) for g in opt.param_groups) == len(leaves)


def test_adamw_matches_optax(jengine):
    cfg = ttrain.TrainConfig(learning_rate=1e-2, weight_decay=5e-2)
    eng = port_engine(jengine.variables)
    opt = ttrain.make_optimizer(eng.model, cfg)
    tx = optax.adamw(cfg.learning_rate, weight_decay=cfg.weight_decay)
    params = jengine.variables["params"]
    state = tx.init(params)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(3)
    named = dict(eng.model.named_parameters())
    for _ in range(3):
        flat = {k: rng.normal(0, 1, v.shape).astype(np.float32)
                for k, v in flatten_dict(params).items()}
        for k, p in named.items():
            key = tuple(tyolo.flax_key(k).split("/")[1:])
            g = flat[key]
            p.grad = torch.from_numpy(np.ascontiguousarray(
                g.transpose(3, 2, 0, 1) if g.ndim == 4 else g))
        opt.step()
        grads = jax.tree.map(jnp.asarray, unflatten_dict(flat))
        updates, state = update(grads, state, params)
        params = optax.apply_updates(params, updates)
    want = {"params/" + "/".join(k): n(v)
            for k, v in flatten_dict(params).items()}
    for k, p in named.items():
        err = np.abs(hwio(p.detach().numpy()) - want[tyolo.flax_key(k)])
        assert float(err.max()) <= 1e-6, (k, float(err.max()))


def test_train_history_matches_jax(jengine):
    batches = [synthetic_batch(s) for s in (4, 5, 6)]
    cfg = jtrain.TrainConfig(learning_rate=2e-3)
    jeng = types.SimpleNamespace(model=jengine.model,
                                 variables=jengine.variables,
                                 img_size=SIZE, num_classes=1)
    jhist = jtrain.train(jeng, iter(batches), steps=3, cfg=cfg, log_every=1)
    eng = port_engine(jengine.variables)
    thist = ttrain.train(eng, iter(batches), steps=3,
                         cfg=ttrain.TrainConfig(learning_rate=2e-3),
                         log_every=1)
    assert len(thist) == len(jhist) == 3
    for t, j in zip(thist, jhist):
        assert set(t) == set(j)
        for k in j:
            assert abs(t[k] - j[k]) <= 1e-4 * abs(j[k]), (k, t[k], j[k])


@pytest.mark.parametrize("log_every", [1, 2, 59])
def test_history_reads_at_log_steps(jengine, log_every):
    eng = port_engine(jengine.variables)
    batch = synthetic_batch(0, b=1)

    def data():
        while True:
            yield batch

    hist = ttrain.train(eng, data(), steps=4, log_every=log_every)
    assert len(hist) == len([i for i in range(4)
                             if i % log_every == 0 or i == 3])


def test_overfit_single_box():
    """tests/test_train.py's overfit test for the port: one bright box,
    60 steps at 96 px, from the engine's seeded init."""
    rng = np.random.default_rng(0)
    size = 96
    img = rng.uniform(0.2, 0.4, (1, size, size, 3)).astype(np.float32)
    img[0, 24:56, 32:72] = [0.9, 0.4, 0.1]
    boxes = np.array([[[52.0, 40.0, 40.0, 32.0]]], np.float32)
    labels = np.zeros((1, 1), np.int32)
    mask = np.ones((1, 1), bool)
    engine = ModelInference(num_classes=1, scale="n", img_size=size,
                            class_names=["ball"], dtype=torch.float32,
                            device="cpu")

    def dataset():
        while True:
            yield img, boxes, labels, mask

    hist = ttrain.train(engine, dataset(), steps=60,
                        cfg=ttrain.TrainConfig(learning_rate=2e-3),
                        log_every=59)
    first, last = hist[0], hist[-1]
    assert last["loss"] < first["loss"] * 0.7, (first, last)
    assert last["mean_iou"] > first["mean_iou"]


@pytest.fixture(scope="module")
def trained(jengine):
    """A bf16 port engine on the JAX weights, its f32 weights and raw
    output before training, and the history of 3 steps."""
    eng = port_engine(jengine.variables, dtype=torch.bfloat16)
    x = synthetic_batch(7)[0]
    before = {k: v.clone() for k, v in eng.model.state_dict().items()}
    out_before = eng.forward(x).clone()
    batch = synthetic_batch(8)

    def data():
        while True:
            yield batch

    hist = ttrain.train(eng, data(), steps=3,
                        cfg=ttrain.TrainConfig(learning_rate=2e-3))
    return eng, before, out_before, x, hist


def test_batchnorm_buffers_unchanged(trained):
    eng, before, _, _, _ = trained
    after = eng.model.state_dict()
    bufs = [k for k in after if "running_" in k]
    assert bufs
    for k in bufs:
        assert torch.equal(after[k], before[k]), k
    # BatchNorm scale and bias did train, as flax's params
    assert not torch.equal(after["m0.bn.weight"], before["m0.bn.weight"])
    assert not torch.equal(after["m0.bn.bias"], before["m0.bn.bias"])


def test_infer_uses_trained_weights(trained, tmp_path):
    eng, _, out_before, x, _ = trained
    path = str(tmp_path / "trained.npz")
    eng.save_params(path)
    fresh = ModelInference(num_classes=1, scale="n", img_size=SIZE,
                           class_names=["ball"], params_path=path,
                           dtype=torch.bfloat16, device="cpu",
                           max_detections=K)
    out = eng.forward(x)
    assert torch.equal(out, fresh.forward(x))
    assert not torch.equal(out, out_before)
    a, b = eng.infer(x), fresh.infer(x)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_trained_weights_load_into_jax(jengine, trained, tmp_path):
    eng, _, _, x, _ = trained
    path = str(tmp_path / "trained.npz")
    eng.save_params(path)
    loaded = copy.copy(jengine)       # the module's engine keeps its weights
    loaded.load_params(path)
    want = n(jax.jit(loaded.model.apply)(loaded.variables, jnp.asarray(x)))
    with torch.no_grad():
        got = eng.model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert np.abs(got[:, :4] - want[:, :4]).max() < 2e-3
    assert np.abs(got[:, 4:] - want[:, 4:]).max() < 1e-5
