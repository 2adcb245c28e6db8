"""The port's MLP, VGG and Inception V3, held against the flax models of
``horovod_tpu.models`` after :func:`flax_to_torch`.

Every variable is drawn from a numpy seed (kernels scaled by
1/sqrt(fan-in), biases, batch-norm scales, biases and running statistics),
so that every weight matters. Both sides run in fp32 on the CPU; the port's
gradients and, in train mode, its updated batch statistics are compared
with ``jax.value_and_grad`` of ``model.apply(..., mutable=["batch_stats"])``.

* MLP at its default widths (784-128-64-10).
* VGG with the narrow ``cfg=(8, 8, "M", 16, "M")`` at 16x16, so that the
  head reads 4x4x16 features: a flatten in torch's ``(c, h, w)`` order
  instead of flax's ``(h, w, c)`` moves the logits (a 1x1 map would hide
  it). VGG-16 itself is checked by shapes: its 32 leaves and 138,357,544
  parameters.
* Inception V3 at full widths (23,834,568 parameters in 284 leaves, 94
  batch norms) on 2 images of 75x75, in eval mode in fp32 and in train
  mode in float64 on both sides. At 75x75 the last blocks run on a 1x1
  grid, so a train-mode batch norm there normalizes 2 values a channel:
  the problem is so ill-conditioned that fp32 rounding moves the logits
  by percents (the flax model's fp32 logits lie 2.7% of the largest from
  its float64 ones, the port's 1.4%; flax also takes the variance as
  E[x^2] - E[x]^2). In float64 the two agree to 3e-9 of the largest logit.

Tolerance: logits and loss within rtol 1e-4 of the largest logit, each
gradient within 1e-4 of its largest magnitude, running statistics within
1e-5 (Inception in eval mode: 1e-4 of the largest); in float64 all
within 1e-7. Both sides sum in fp32 in other
orders (XLA's convolutions against oneDNN's): a few 2^-24 per term over
sums of up to 3·3·2048 terms, grown through 47 layers of Inception;
a wrong pad, pool or flatten order moves values by their own size.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.models import inception as jax_inception
from horovod_tpu.models import mlp as jax_mlp
from horovod_tpu.models import vgg as jax_vgg
from horovod_tpu_torch.models import MLP, VGG, VGG16, InceptionV3
from horovod_tpu_torch.models.convert import flax_to_torch

from test_torch_port_model import _randomise, random_variables

RTOL, STATS_TOL, F64_TOL = 1e-4, 1e-5, 1e-7
NARROW = (8, 8, "M", 16, "M")


def _flax_step(flax_model, variables, x, y, train):
    """Logits, loss, gradients and (train) the updated batch statistics."""
    has_stats = "batch_stats" in variables
    kw = {"train": train} if "train" in inspect.signature(
        type(flax_model).__call__).parameters else {}

    def loss_fn(params):
        v = dict(variables, params=params)
        if has_stats and train:
            logits, upd = flax_model.apply(v, jnp.asarray(x), train=True,
                                           mutable=["batch_stats"])
        else:
            logits, upd = flax_model.apply(v, jnp.asarray(x), **kw), {}
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()
        return loss, (logits, upd)

    (loss, (logits, upd)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return (np.asarray(logits), float(loss),
            jax.tree.map(np.asarray, grads),
            jax.tree.map(np.asarray, upd.get("batch_stats")))


def _check(model, flax_model, variables, x, y, train, stats_tol=STATS_TOL,
           rtol=RTOL):
    """``flax_model`` computes in the dtype of ``x``, and so does the port
    (``model`` is cast to it)."""
    if x.dtype == np.float64:
        variables = jax.tree.map(lambda v: np.asarray(v, np.float64),
                                 variables)
    logits, loss, grads, stats = _flax_step(flax_model, variables, x, y,
                                            train)
    state = flax_to_torch(variables)
    own = model.state_dict()
    assert set(state) == set(own)
    model.load_state_dict(state)
    model.to(torch.from_numpy(x).dtype)
    model.train(train)
    got = model(torch.from_numpy(x))
    got_loss = F.cross_entropy(got, torch.from_numpy(y))
    got_loss.backward()
    scale = np.abs(logits).max()
    np.testing.assert_allclose(got.detach().numpy(), logits, rtol=0,
                               atol=rtol * scale)
    np.testing.assert_allclose(got_loss.item(), loss, rtol=rtol)
    want = flax_to_torch({"params": grads})
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    for k, g in want.items():
        g = g.numpy()
        np.testing.assert_allclose(named[k].grad.numpy(), g, rtol=0,
                                   atol=rtol * np.abs(g).max(), err_msg=k)
    if stats is not None:
        want = flax_to_torch({"batch_stats": stats})
        buffers = dict(model.named_buffers())
        assert set(want) == set(buffers)
        for k, v in want.items():
            v = v.numpy()
            np.testing.assert_allclose(buffers[k].numpy(), v, rtol=0,
                                       atol=stats_tol * max(1.0, np.abs(
                                           v).max()), err_msg=k)


def _data(shape, classes, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randint(0, classes, shape[0]))


def test_mlp_matches_flax():
    x, y = _data((4, 28, 28, 1), 10, 0)
    flax_model = jax_mlp.MLP()
    shapes = jax.eval_shape(lambda: flax_model.init(jax.random.PRNGKey(0),
                                                    jnp.asarray(x)))
    _check(MLP(), flax_model, _randomise(shapes, 1, weights=True), x, y,
           train=True)


def test_vgg_flattens_as_flax_does():
    """The narrow VGG at 16x16: 4x4x16 features reach the head."""
    x, y = _data((2, 16, 16, 3), 10, 2)
    flax_model = jax_vgg.VGG(cfg=NARROW, num_classes=10, dtype=jnp.float32)
    model = VGG(cfg=NARROW, num_classes=10, image_size=16)
    assert model.fc1.in_features == 4 * 4 * 16
    _check(model, flax_model, random_variables(flax_model, x, 3), x, y,
           train=True)


def _torch_shape(name, shape):
    """A flax leaf's shape in the port's layout (``convert._leaf``)."""
    if name == "kernel" and len(shape) == 4:
        return (shape[3], shape[2], shape[0], shape[1])
    return tuple(reversed(shape)) if name == "kernel" else tuple(shape)


def test_vgg16_has_the_flax_leaves():
    """VGG-16's leaves against flax's, by shapes alone (no compute): the
    names ``flax_to_torch`` gives one-element stand-ins, in its order."""
    flax_model = jax_vgg.VGG16(dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: flax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False))

    def walk(tree, stand_in, out):
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                stand_in[k] = {}
                walk(v, stand_in[k], out)
            else:
                stand_in[k] = np.zeros((1,) * len(v.shape), np.float32)
                out.append(_torch_shape(k, v.shape))
        return out

    stand_in = {"params": {}}
    want_shapes = walk(shapes["params"], stand_in["params"], [])
    want = dict(zip(flax_to_torch(stand_in), want_shapes))
    with torch.device("meta"):
        model = VGG16()
    own = dict(model.named_parameters())
    assert want == {k: tuple(v.shape) for k, v in own.items()}
    assert len(own) == 32
    assert sum(p.numel() for p in own.values()) == 138_357_544


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_inception_v3_matches_flax(train):
    """Full-width Inception V3 on 2 images of 75x75: eval mode in fp32;
    train mode in float64 on both sides (see the module doc)."""
    x, y = _data((2, 75, 75, 3), 1000, 4)
    dtype = jnp.float64 if train else jnp.float32
    flax_model = jax_inception.InceptionV3(dtype=dtype)
    variables = random_variables(flax_model, x, 5)
    model = InceptionV3()
    params = list(model.parameters())
    assert len(params) == 284
    assert sum(p.numel() for p in params) == 23_834_568
    tol = dict(rtol=F64_TOL, stats_tol=F64_TOL) if train else \
        dict(stats_tol=RTOL)
    _check(model, flax_model, variables, x.astype(dtype), y, train=train,
           **tol)
