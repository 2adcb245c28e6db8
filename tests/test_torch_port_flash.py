"""The port's flash attention held against the JAX package's.

The same numpy inputs go to ``horovod_tpu.ops.flash_attention`` (Pallas in
interpret mode on the CPU, as its own tests run it) and to the port, whose
wrappers run their plain versions on the CPU. Tolerances are those of
``tests/test_flash_attention.py``: fp32 forward rtol/atol 2e-5, gradients
rtol 5e-4 / atol 5e-5; bf16 outputs element by element within one bf16
step (rtol 2^-7) plus 2^-8 of the mean |value|.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as jax_flash
from horovod_tpu_torch.ops import flash_attention as flash

# (B, S, H, D), kv heads: aligned, ragged, one token, grouped-query.
SHAPES = [((2, 128, 2, 64), 2), ((1, 200, 2, 64), 2), ((1, 1, 1, 8), 1),
          ((1, 64, 4, 16), 2)]
CASES = [(shape, hkv, causal) for shape, hkv in SHAPES
         for causal in (True, False)]
_IDS = [f"{'x'.join(map(str, s))}-kv{h}-{'causal' if c else 'bidir'}"
        for s, h, c in CASES]


def _inputs(shape, hkv, seed):
    rng = np.random.RandomState(seed)
    b, s, h, d = shape
    q = rng.randn(b, s, h, d).astype(np.float32) * 0.5
    k = rng.randn(b, s, hkv, d).astype(np.float32) * 0.5
    v = rng.randn(b, s, hkv, d).astype(np.float32) * 0.5
    w = rng.randn(b, s, h, d).astype(np.float32)
    return q, k, v, w


@functools.lru_cache(maxsize=None)
def _jax_reference(shape, hkv, causal, dtype="float32"):
    """JAX output and the gradients of ``sum(o * w)``, as numpy fp32."""
    q, k, v, w = _inputs(shape, hkv, seed=sum(shape) + hkv)
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))

    def loss(q, k, v):
        o = jax_flash.flash_attention(q, k, v, causal=causal)
        return jnp.sum(o.astype(jnp.float32) * w), o

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(jq, jk, jv)
    as_np = lambda x: np.asarray(x.astype(jnp.float32))  # noqa: E731
    return as_np(out), tuple(as_np(g) for g in grads)


def _port(shape, hkv, causal, dtype=torch.float32):
    q, k, v, w = _inputs(shape, hkv, seed=sum(shape) + hkv)
    tq, tk, tv = (torch.tensor(x).to(dtype).requires_grad_()
                  for x in (q, k, v))
    out = flash.flash_attention(tq, tk, tv, causal=causal)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return (out.detach().float().numpy(),
            tuple(t.grad.float().numpy() for t in (tq, tk, tv)))


@pytest.mark.parametrize("shape,hkv,causal", CASES, ids=_IDS)
def test_forward_matches_jax(shape, hkv, causal):
    want, _ = _jax_reference(shape, hkv, causal)
    got, _ = _port(shape, hkv, causal)
    assert got.shape == shape
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape,hkv,causal", CASES, ids=_IDS)
def test_gradients_match_jax(shape, hkv, causal):
    _, want = _jax_reference(shape, hkv, causal)
    _, got = _port(shape, hkv, causal)
    for g, w, name in zip(got, want, "qkv"):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=5e-4, atol=5e-5,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("shape,hkv,causal", CASES[:6], ids=_IDS[:6])
def test_lse_matches_jax_kernel(shape, hkv, causal):
    """B7's logsumexp against lane 0 of the Pallas kernel's lane-replicated
    statistics, in the ``[B*H, S, D]`` layout both kernels take."""
    q, k, v, _ = _inputs(shape, hkv, seed=sum(shape) + hkv)
    b, s, h, d = shape
    k = np.repeat(k, h // hkv, axis=2)
    v = np.repeat(v, h // hkv, axis=2)
    bhsd = [x.transpose(0, 2, 1, 3).reshape(b * h, s, d) for x in (q, k, v)]
    scale = 1.0 / float(np.sqrt(d))
    padded = [jax_flash._pad_seq(jnp.asarray(x), jax_flash.BLOCK_Q)
              for x in bhsd]
    _, lse_jax = jax_flash._fwd_call(*padded, scale, causal, s,
                                     interpret=True)
    o, lse = flash.flash_fwd(*(torch.from_numpy(x) for x in bhsd), scale,
                             causal)
    assert lse.dtype == torch.float32 and lse.shape == (b * h, s)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_jax)[:, :s, 0],
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_matches_jax(causal):
    """bf16 inputs: both kernels widen to fp32 and round each output to
    bf16, so they may land one bf16 step apart, at most 2^-7 of the value.
    Held element by element at that, plus 2^-8 of the mean |value| for
    values near zero (the fp32 sums differ there by more than a step)."""
    shape, hkv = (1, 200, 2, 64), 2
    want_o, want_g = _jax_reference(shape, hkv, causal, "bfloat16")
    got_o, got_g = _port(shape, hkv, causal, torch.bfloat16)
    for g, w, name in zip((got_o,) + got_g, (want_o,) + want_g,
                          ("o", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, rtol=2**-7,
                                   atol=2**-8 * np.abs(w).mean(),
                                   err_msg=name)


def test_masked_rows_stay_finite():
    """Large logits: a -1e30 mask, not -inf, and no NaN anywhere."""
    rng = np.random.RandomState(5)
    q, k, v = (torch.tensor(rng.randn(3, 70, 16).astype(np.float32) * 30)
               for _ in range(3))
    for causal in (True, False):
        o, lse = flash.flash_fwd(q, k, v, 0.25, causal)
        do = torch.ones_like(o)
        delta = (do * o).sum(-1)
        dk, dv = flash.flash_dkdv(q, k, v, do, lse, delta, 0.25, causal)
        dq = flash.flash_dq(q, k, v, do, lse, delta, 0.25, causal)
        for t in (o, lse, dk, dv, dq):
            assert torch.isfinite(t).all()


@pytest.mark.parametrize("d", [4, 12, 136])
def test_head_dim_is_checked(d):
    x = torch.zeros(1, 8, d)
    with pytest.raises(ValueError, match="head_dim"):
        flash.flash_fwd(x, x, x, 1.0, True)


def test_type_and_shape_are_checked():
    x = torch.zeros(2, 8, 16)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        flash.flash_fwd(x.half(), x.half(), x.half(), 1.0, True)
    with pytest.raises(ValueError, match="differ"):
        flash.flash_fwd(x, x[:1], x, 1.0, True)
    with pytest.raises(ValueError, match="lse and delta"):
        flash.flash_dq(x, x, x, x, torch.zeros(2, 8, 1), torch.zeros(2, 8),
                       1.0, True)
    with pytest.raises(ValueError, match="not a multiple"):
        flash.repeat_kv_heads(torch.zeros(1, 4, 3, 8), 4)
