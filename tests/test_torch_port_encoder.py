"""The port's flax models (``Transformer``, ``Encoder``) held against the JAX
package's through ``flax_to_torch``, and ``remat="dots"``.

Small widths (vocab 64, 2 layers, 2 heads of 8, embed 16, MLP 32, batch 2,
40 tokens) in fp32; the loss is ``masked_lm_loss`` at a seeded 15% of the
positions. Both attentions run: plain, and the fused kernels (JAX's in
Pallas interpret mode, the port's plain versions on the CPU), causal
(``Transformer``) and not (``Encoder``). Tolerances: logits and loss
within rtol 2e-5 (fp32 sums in other orders, with the flash recurrence
against whole-row softmax), gradients within 1e-4 of each tensor's largest
JAX magnitude.

``remat="dots"`` recomputes the block in backward but keeps the outputs of
the products without batch dimensions, which the model computes through
``ops.remat.saved_einsum``: its gradients are bitwise those of
``"none"``, and a ``TorchDispatchMode`` count of the matrix products in
backward shows what it recomputes (attention's two products a layer,
where ``"full"`` recomputes seven), although ``torch.einsum`` lowers
those projections to ``aten.bmm`` as it lowers attention's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from horovod_tpu.models import Encoder as JaxEncoder
from horovod_tpu.models import Transformer as JaxTransformer
from horovod_tpu.models import masked_lm_loss as jax_masked_lm_loss
from horovod_tpu.ops.flash_attention import flash_attention as jax_flash
from horovod_tpu_torch.models import (Encoder, Transformer, gpt,
                                      masked_lm_loss)
from horovod_tpu_torch.models.convert import flax_to_torch
from horovod_tpu_torch.ops import remat
from horovod_tpu_torch.ops.flash_attention import flash_attention

WIDTHS = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=8,
              embed_dim=16, mlp_dim=32)
BATCH, SEQ = 2, 40
MODELS = {"transformer": (JaxTransformer, Transformer),
          "encoder": (JaxEncoder, Encoder)}
ATTENTION = {"plain": None, "flash": (jax_flash, flash_attention)}


def _data():
    rng = np.random.RandomState(4)
    tokens = rng.randint(0, WIDTHS["vocab_size"], (BATCH, SEQ))
    targets = rng.randint(0, WIDTHS["vocab_size"], (BATCH, SEQ))
    mask = (rng.rand(BATCH, SEQ) < 0.15).astype(np.float32)
    mask[0, 0] = 1.0
    return tokens, targets, mask


def _models(model, attention):
    jax_cls, port_cls = MODELS[model]
    jax_kw, port_kw = {}, {}
    if ATTENTION[attention] is not None:
        jax_kw["attn_fn"], port_kw["attn_fn"] = ATTENTION[attention]
    return (jax_cls(dtype=jnp.float32, **WIDTHS, **jax_kw),
            port_cls(dtype=torch.float32, **WIDTHS, **port_kw))


def _variables(jax_model, tokens):
    """``model.init``'s variables with random RMSNorm scales and biases,
    so that every parameter's gradient matters."""
    variables = jax.tree.map(np.asarray, jax_model.init(
        jax.random.PRNGKey(0), tokens))
    rng = np.random.RandomState(6)

    def perturb(path, leaf):
        name = path[-1].key
        if name == "scale":
            return (1 + 0.2 * rng.randn(*leaf.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(perturb, variables)


@pytest.mark.parametrize("attention", sorted(ATTENTION))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_matches_flax(model, attention):
    """Logits, loss and every parameter's gradient against ``model.apply``
    and ``jax.grad``."""
    tokens, targets, mask = _data()
    jax_model, port = _models(model, attention)
    variables = _variables(jax_model, tokens)

    def loss_of(v):
        logits = jax_model.apply(v, tokens)
        return jax_masked_lm_loss(logits, targets, mask), logits

    (loss, logits), grads = jax.value_and_grad(loss_of, has_aux=True)(
        variables)
    port.load_state_dict(flax_to_torch(variables))
    got_logits = port(torch.from_numpy(tokens))
    got_loss = masked_lm_loss(got_logits, torch.from_numpy(targets),
                              torch.from_numpy(mask))
    got_loss.backward()
    np.testing.assert_allclose(got_logits.detach().numpy(),
                               np.asarray(logits), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(got_loss.detach()), float(loss),
                               rtol=2e-5)
    want = flax_to_torch(jax.tree.map(np.asarray, grads))
    named = dict(port.named_parameters())
    assert set(named) == set(want)
    for name, g in want.items():
        scale = float(g.abs().max())
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(),
                                   rtol=0, atol=1e-4 * scale, err_msg=name)


def test_encoder_attends_both_ways():
    """The encoder's first position sees the last token; the decoder's
    does not."""
    tokens = torch.from_numpy(_data()[0])
    changed = tokens.clone()
    changed[:, -1] = (changed[:, -1] + 1) % WIDTHS["vocab_size"]
    for cls, moves in ((Encoder, True), (Transformer, False)):
        model = cls(dtype=torch.float32, **WIDTHS)
        with torch.no_grad():
            delta = (model(tokens) - model(changed))[:, 0].abs().max()
        assert bool(delta > 0) == moves, cls


# ---------------------------------------------------------------------------
# remat="dots"
# ---------------------------------------------------------------------------

GPT_SMALL = dict(vocab_size=64, num_layers=2, num_heads=4, head_dim=8,
                 embed_dim=32, mlp_dim=64, dtype=torch.float32)


class _Products(TorchDispatchMode):
    """Counts the matrix products dispatched, by ATen op."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in remat.PRODUCTS:
            self.ops.append(func)
        return func(*args, **(kwargs or {}))


def _gpt_grads(mode, **overrides):
    """GPT's loss and gradients with ``remat=mode``; the products
    dispatched in backward."""
    cfg = gpt.GPTConfig(**{**GPT_SMALL, **overrides}, remat=mode)
    model = gpt.GPT(cfg, seed=3)
    rng = np.random.RandomState(2)
    tokens = torch.from_numpy(rng.randint(0, 64, (2, 24)))
    targets = torch.roll(tokens, -1, dims=1)
    loss = gpt.loss_fn(model, tokens, targets)
    with _Products() as counted:
        loss.backward()
    return loss, {k: p.grad for k, p in model.named_parameters()}, counted


@pytest.mark.parametrize("overrides", [
    dict(attention="dense"), dict(attention="flash"),
    dict(attention="flash", moe_every=2, num_experts=4)],
    ids=["dense", "flash", "moe"])
def test_dots_gradients_are_bitwise_none(overrides):
    loss, grads, _ = _gpt_grads("none", **overrides)
    for mode in ("dots", "full"):
        got_loss, got, _ = _gpt_grads(mode, **overrides)
        assert torch.equal(got_loss, loss), mode
        for name, g in grads.items():
            assert torch.equal(got[name], g), (mode, name)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_dots_recomputes_only_attention_products(attention):
    """Backward recomputes 7 products a layer under "full" (q, k, v,
    attention's two, o and up; the down projection's output serves no
    gradient, and the recompute stops before it) and attention's 2 under
    "dots"."""
    layers = GPT_SMALL["num_layers"]
    counts = {mode: len(_gpt_grads(mode, attention=attention)[2].ops)
              for mode in remat.MODES}
    assert counts["full"] - counts["none"] == 7 * layers
    assert counts["dots"] - counts["none"] == 2 * layers


def test_projections_lower_to_bmm():
    """The trouble the role-based policy answers: ``torch.einsum`` runs
    the q projection (no batch dims) as ``aten.bmm``, the op attention's
    batched products run as, so the op's name cannot pick what to keep."""
    h = torch.randn(2, 24, 32)
    w = torch.randn(32, 4, 8)
    q = torch.randn(2, 24, 4, 8)
    with _Products() as proj:
        torch.einsum("bse,ehd->bshd", h, w)
    with _Products() as attn:
        torch.einsum("bqhd,bkhd->bhqk", q, q)
    assert torch.ops.aten.bmm.default in proj.ops
    assert attn.ops == [torch.ops.aten.bmm.default]


def test_dots_keeps_the_switch_products():
    """In a switch block "dots" keeps the router, the dispatch to slots
    and the combine, and recomputes the experts' batched products."""
    overrides = dict(attention="flash", moe_every=1, num_experts=4,
                     num_layers=1)
    counts = {mode: len(_gpt_grads(mode, **overrides)[2].ops)
              for mode in remat.MODES}
    # "full" recomputes 11 products; "dots" only the four with batch dims,
    # attention's two and the experts' two.
    assert counts["full"] - counts["none"] == 11
    assert counts["dots"] - counts["none"] == 4
