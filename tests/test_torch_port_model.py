"""The port's ResNet and weight conversion, held against the flax ResNet.

All in fp32 on the CPU. The batch-norm scales and statistics are drawn
from numpy seeds (ResNet-50 keeps the rest of its flax init; the small
models draw every variable), so that every residual branch contributes
(the flax init zeroes each block's last scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.models import resnet as jax_resnet
from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.models.convert import flax_to_torch


def _randomise(variables, seed, weights=False):
    """Random BN scale/bias and positive running statistics; with
    ``weights``, random kernels (scaled by 1/sqrt(fan-in)) and dense bias
    too, so that ``variables`` may hold only shapes."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("scale", "var"):
                out[k] = (0.5 + rng.rand(*v.shape)).astype(np.float32)
            elif k == "mean" or (k == "bias" and (weights or "scale" in tree)):
                out[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
            elif k == "kernel" and weights:
                fan_in = int(np.prod(v.shape[:-1]))
                out[k] = (rng.randn(*v.shape) / np.sqrt(fan_in)).astype(
                    np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    return {k: walk(v) for k, v in variables.items()}


def random_variables(flax_model, x, seed):
    """Flax variables for ``flax_model`` on input ``x``, all drawn from a
    numpy seed. The shapes come from ``jax.eval_shape``, which compiles
    nothing: a jitted flax init costs seconds for each model."""
    shapes = jax.eval_shape(lambda: flax_model.init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    return _randomise(shapes, seed, weights=True)


def _leaf_count(tree):
    return sum(_leaf_count(v) if isinstance(v, dict) else 1
               for v in tree.values())


def test_resnet50_logits_from_converted_weights():
    """Full-width ResNet-50 (25,557,032 parameters in 161 leaves), eval
    mode, 2 images at 64x64: logits within rtol 1e-4."""
    flax_model = jax_resnet.ResNet50(num_classes=1000, dtype=jnp.float32)
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    variables = jax.jit(flax_model.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    variables = _randomise(jax.tree.map(np.asarray, variables), 1)
    assert _leaf_count(variables["params"]) == 161
    state = flax_to_torch(variables)

    model = resnet.ResNet50(num_classes=1000)
    own = model.state_dict()
    assert set(state) == set(own)
    assert sum(p.numel() for p in model.parameters()) == 25_557_032
    for k, v in state.items():
        assert tuple(v.shape) == tuple(own[k].shape), k
    model.load_state_dict(state)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(flax_model.apply, static_argnames="train")(
        variables, jnp.asarray(x), train=False))
    assert got.dtype == np.float32 and got.shape == (2, 1000)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("block", ["ResNetBlock", "BottleneckResNetBlock"])
def test_small_resnet_train_step_matches_flax(block):
    """A train-mode step of ResNet(stage_sizes=[1, 1], num_filters=8,
    num_classes=10) at 32x32: loss rtol 1e-4, gradients rtol 1e-4 / atol
    1e-5, running mean and var atol 1e-5."""
    flax_model = jax_resnet.ResNet(
        stage_sizes=[1, 1], block_cls=getattr(jax_resnet, block),
        num_classes=10, num_filters=8, dtype=jnp.float32)
    rng = np.random.RandomState(2)
    x = rng.randn(4, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, 4)
    variables = random_variables(flax_model, x, 3)

    def loss_fn(params):
        logits, updates = flax_model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()
        return loss, updates

    (want_loss, updates), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])

    model = resnet.ResNet(stage_sizes=[1, 1],
                          block_cls=getattr(resnet, block), num_classes=10,
                          num_filters=8)
    model.load_state_dict(flax_to_torch(variables))
    model.train()
    loss = F.cross_entropy(model(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()

    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    want_grads = flax_to_torch({"params": jax.tree.map(np.asarray, grads)})
    named = dict(model.named_parameters())
    assert set(want_grads) == set(named)
    for k, g in want_grads.items():
        np.testing.assert_allclose(named[k].grad.numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    want_stats = flax_to_torch(
        {"batch_stats": jax.tree.map(np.asarray, updates["batch_stats"])})
    buffers = dict(model.named_buffers())
    assert set(want_stats) == set(buffers)
    for k, v in want_stats.items():
        np.testing.assert_allclose(buffers[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("size,kernel,stride,pads", [
    (112, 3, 2, (0, 1)), (56, 3, 2, (0, 1)), (7, 3, 2, (1, 1)),
    (56, 1, 2, (0, 0)), (56, 3, 1, (1, 1)), (224, 7, 2, (2, 3))])
def test_same_padding_matches_xla(size, kernel, stride, pads):
    """XLA's SAME padding: (0, 1) for the stride-2 3x3 ops on even sizes."""
    assert resnet._same_pads(size, kernel, stride) == pads
