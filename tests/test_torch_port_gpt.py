"""The port's GPT held against the JAX package's, with converted weights.

A small configuration (vocab 64, 2 layers, 4 query heads over 2 kv heads of
16, embed 64, MLP 128, batch 2, 130 tokens: one full and one ragged flash
tile of the JAX kernel) in fp32 with ``attention="flash"``. The JAX side
runs its Pallas kernels in interpret mode and is computed once for the
module. Tolerances: logits rtol 2e-4, loss rtol 1e-5, gradients rtol 5e-4
/ atol 5e-5, the optimizer step 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu.models import gpt as jax_gpt
from horovod_tpu.models import transformer as jax_transformer
from horovod_tpu_torch.models import gpt, transformer
from horovod_tpu_torch.models.convert import gpt_params_to_torch

SMALL = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             head_dim=16, embed_dim=64, mlp_dim=128, attention="flash")
# bench.py's gpt_long_context_flash phase: the width chip_smoke.py trains.
LONG_CONTEXT = dict(vocab_size=32000, num_layers=6, num_heads=8,
                    head_dim=64, embed_dim=512, mlp_dim=2048,
                    attention="flash", remat="full")
BATCH, SEQ = 2, 130


def _data():
    rng = np.random.RandomState(11)
    tokens = rng.randint(0, SMALL["vocab_size"], (BATCH, SEQ))
    targets = np.roll(tokens, -1, axis=1)
    targets[:, -1] = -1
    targets[0, 5] = -1  # one more ignored position
    positions = np.broadcast_to(np.arange(SEQ), (BATCH, SEQ)).copy()
    return tokens, targets, positions


def _jax_params():
    """``init_params`` with the norm weights drawn from numpy, so that
    every norm has a gradient that matters."""
    cfg = jax_gpt.GPTConfig(dtype=jnp.float32, **SMALL)
    params = jax.tree.map(np.asarray,
                          jax_gpt.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(3)
    for layer in params["layers"]:
        for name in ("attn_norm", "mlp_norm"):
            layer[name] = (1 + 0.2 * rng.randn(*layer[name].shape)).astype(
                np.float32)
    params["out_norm"] = (1 + 0.2 * rng.randn(SMALL["embed_dim"])).astype(
        np.float32)
    return params


@pytest.fixture(scope="module")
def ref():
    """JAX logits, loss and gradients (fp32), and bf16 logits."""
    params = _jax_params()
    tokens, targets, positions = _data()
    cfg = jax_gpt.GPTConfig(dtype=jnp.float32, **SMALL)
    loss, grads = jax.jit(jax.value_and_grad(jax_gpt.loss_fn),
                          static_argnums=4)(params, tokens, targets,
                                            positions, cfg)
    fwd = jax.jit(jax_gpt.forward, static_argnums=3)
    logits = fwd(params, tokens, positions, cfg)
    logits16 = fwd(params, tokens, positions,
                   dataclasses.replace(cfg, dtype=jnp.bfloat16))
    return dict(params=params, loss=float(loss),
                grads=gpt_params_to_torch(jax.tree.map(np.asarray, grads)),
                logits=np.asarray(logits), logits16=np.asarray(logits16))


def _model(params, **overrides):
    cfg = gpt.GPTConfig(**{**SMALL, "dtype": torch.float32, **overrides})
    model = gpt.GPT(cfg)
    model.load_state_dict(gpt_params_to_torch(params))
    return model


def _batch():
    return tuple(torch.from_numpy(x) for x in _data())


def _grads(model):
    tokens, targets, positions = _batch()
    loss = gpt.loss_fn(model, tokens, targets, positions)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return float(loss.detach()), grads


def test_logits_match_jax(ref):
    tokens, _, positions = _batch()
    with torch.no_grad():
        got = _model(ref["params"])(tokens, positions)
    assert got.dtype == torch.float32
    assert got.shape == (BATCH, SEQ, SMALL["vocab_size"])
    np.testing.assert_allclose(got.numpy(), ref["logits"], rtol=2e-4,
                               atol=2e-4 * np.abs(ref["logits"]).max())


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_gradients_match_jax(ref, remat):
    loss, grads = _grads(_model(ref["params"], remat=remat))
    np.testing.assert_allclose(loss, ref["loss"], rtol=1e-5)
    assert set(grads) == set(ref["grads"])
    for name, want in ref["grads"].items():
        np.testing.assert_allclose(grads[name].numpy(), want.numpy(),
                                   rtol=5e-4, atol=5e-5, err_msg=name)


def test_remat_full_equals_none(ref):
    """The recompute runs the same operations on the same inputs."""
    loss_a, grads_a = _grads(_model(ref["params"], remat="none"))
    loss_b, grads_b = _grads(_model(ref["params"], remat="full"))
    assert loss_a == loss_b
    for name, g in grads_a.items():
        torch.testing.assert_close(grads_b[name], g, rtol=0, atol=0)


def test_bf16_logits_match_jax(ref):
    """bf16 activations round at the same points in both packages, but the
    matmuls sum in different orders, so a rounding may go the other way
    and the step it makes carries through the layers. Held element by
    element within one bf16 step (rtol 2^-7) plus 2^-4 of the mean |logit|,
    and on average at least as close to JAX's bf16 logits as those are to
    JAX's fp32 logits: the port adds no rounding of its own."""
    tokens, _, positions = _batch()
    with torch.no_grad():
        got = _model(ref["params"], dtype=torch.bfloat16)(tokens, positions)
    want = ref["logits16"]
    assert got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=2**-7,
                               atol=2**-4 * np.abs(want).mean())
    assert (np.abs(got - want).mean() <=
            np.abs(want - ref["logits"]).mean())


@pytest.fixture
def world():
    thvd.init(device="cpu")
    yield
    thvd.shutdown()


def test_distributed_optimizer_step_matches_jax(ref, world):
    """One SGD(1e-3) step through the dense DistributedOptimizer (Average,
    one fused grouped_allreduce) on a gloo world of one gives
    ``p - 1e-3 * g_jax``."""
    model = _model(ref["params"])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=1e-3),
        named_parameters=model.named_parameters())
    tokens, targets, positions = _batch()
    opt.zero_grad()
    gpt.loss_fn(model, tokens, targets, positions).backward()
    opt.step()
    for name, p in model.named_parameters():
        want = before[name] - 1e-3 * ref["grads"][name]
        np.testing.assert_allclose(p.detach().numpy(), want.numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_long_context_parameters_match_jax():
    """The configuration chip_smoke.py trains: 51,649,024 parameters in 51
    leaves, with the JAX package's names and shapes."""
    shapes = jax.eval_shape(
        lambda: jax_gpt.init_params(
            jax.random.PRNGKey(0), jax_gpt.GPTConfig(**LONG_CONTEXT)))
    flat = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(v.shape)
            for path, v in flat.items()}
    model = gpt.GPT(gpt.GPTConfig(**LONG_CONTEXT))
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == want
    assert len(got) == 51
    assert sum(p.numel() for p in model.parameters()) == 51_649_024


def test_init_follows_jax_scales():
    """Ones for the norms, 0.02 for the embedding, 1/sqrt(fan_in) for the
    dense weights."""
    model = gpt.GPT(gpt.GPTConfig(**SMALL), seed=1).requires_grad_(False)
    assert torch.equal(model.out_norm, torch.ones(SMALL["embed_dim"]))
    assert abs(float(model.embed.std()) - 0.02) < 2e-3
    layer = model.layers[0]
    assert abs(float(layer.wo.std()) - 1 / np.sqrt(64)) < 1e-2
    assert abs(float(layer.w_down.std()) - 1 / np.sqrt(128)) < 1e-2
    again = gpt.GPT(gpt.GPTConfig(**SMALL), seed=1)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                  again.parameters()))


def test_config_has_every_jax_field():
    """``GPTConfig`` takes the JAX config's fields, with its defaults (the
    dtype aside)."""
    jax_cfg, cfg = jax_gpt.GPTConfig(), gpt.GPTConfig()
    names = [f.name for f in dataclasses.fields(jax_cfg)]
    assert [f.name for f in dataclasses.fields(cfg)] == names
    for name in names:
        if name != "dtype":
            assert getattr(cfg, name) == getattr(jax_cfg, name), name


def test_flash_with_a_bound_sp_axis_raises():
    """``"flash"`` is local attention: with an sp axis on the mesh it
    raises, as the JAX ``_attention`` does; ``"ulysses_flash"`` runs."""
    thvd.init(device="cpu", mesh_shape={"sp": 1})
    try:
        tokens = torch.zeros(1, 8, dtype=torch.long)
        model = gpt.GPT(gpt.GPTConfig(**{**SMALL, "dtype": torch.float32}))
        with pytest.raises(ValueError, match="local attention"):
            model(tokens)
        ulysses = gpt.GPT(gpt.GPTConfig(**{
            **SMALL, "dtype": torch.float32, "attention": "ulysses_flash"}))
        assert ulysses(tokens).shape == (1, 8, SMALL["vocab_size"])
    finally:
        thvd.shutdown()


@pytest.mark.parametrize("overrides,error", [
    (dict(moe_every=2), None),
    (dict(remat="dots"), None),
    (dict(remat="some"), ValueError),
    (dict(attention="sparse"), ValueError)])
def test_unported_options_raise(overrides, error):
    """Unknown options raise; mixture of experts and ``remat="dots"`` are
    ported and build."""
    cfg = gpt.GPTConfig(**{**SMALL, **overrides})
    if error is None:
        gpt.GPT(cfg)
        return
    with pytest.raises(error):
        gpt.GPT(cfg)


@pytest.mark.parametrize("attention", ["dense", "ring", "ulysses"])
def test_unbound_axes_dispatch_to_plain_attention(ref, attention):
    """Without a mesh, the context-parallel choices are plain attention, as
    in the JAX ``_attention`` with unbound axes."""
    tokens, _, positions = _batch()
    overrides = dict(attention=attention, num_kv_heads=None)
    params = jax_gpt.init_params(jax.random.PRNGKey(1), jax_gpt.GPTConfig(
        dtype=jnp.float32, **{**SMALL, **overrides}))
    params = jax.tree.map(np.asarray, params)
    model = _model(params, **overrides)
    with torch.no_grad():
        got = model(tokens, positions)
    flash = _model(params, attention="flash", num_kv_heads=None)
    with torch.no_grad():
        want = flash(tokens, positions)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4 * float(want.abs().max()))


@pytest.mark.parametrize("causal", [True, False])
def test_default_attention_matches_jax(causal):
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(2, 33, 3, 16).astype(np.float32) for _ in range(3))
    want = jax_transformer.default_attention(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal)
    got = transformer.default_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_jax(dtype):
    """Rotation of the two halves of D, cos/sin cast to x's type."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 40, 3, 16).astype(np.float32)
    positions = rng.randint(0, 5000, (2, 40))
    want = jax_transformer.rope(jnp.asarray(x, dtype), jnp.asarray(positions))
    got = transformer.rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                           torch.from_numpy(positions))
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
