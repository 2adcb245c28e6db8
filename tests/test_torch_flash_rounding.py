"""The bound that holds bf16 B7, B8 and B9 on the tensor cores to their
plain versions, checked on the CPU against an emulation of that route.

The route (``horovod_tpu_torch/csrc/flash_attention_mma.cu``) multiplies
bf16 operands exactly with fp32 sums, applies the scale to the fp32 logits
after the product, and rounds two intermediates to bf16 before they enter a
product: P (before ``P V`` and ``Pᵀ dO``) and dS (before ``dSᵀ Q`` and
``dS K``). The emulation below does just that in plain PyTorch, over whole
rows instead of 64-key tiles: a rounding to bf16 is relative, so the bound
does not depend on the running maximum the kernel rounds against.

The bound, element by element, is the one of every bf16 output of the
attention kernels, ``2^-7 |ref| + 2^-8 mean|ref| + 2^-14``, plus
``mma_rounding_terms`` of ``horovod_tpu_torch.ops.flash_attention``,
computed on the plain side: ``4 u sqrt(sum_j p_ij^2 v_j^2)`` for ``o``,
``4 u sqrt(sum_i p_ij^2 dO_i^2)`` for dV,
``4 u scale sqrt(sum_i dS_ij^2 q_i^2)`` for dK and
``4 u scale sqrt(sum_j dS_ij^2 k_j^2)`` for dQ, with u = 2^-8, the largest
relative error of rounding to bf16.

Why a root-sum-square, and why 4. A rounded x_j moves an output element
``sum_j x_j y_j`` by ``sum_j e_j y_j``, ``|e_j| <= u |x_j|``. The worst case,
``u sum_j |x_j y_j|``, is reached only if every error has the sign of its
product. In a late causal row of ``o`` thousands of p_j of about 1/S each
carry the sum, and that worst case grows to several times the row's typical
value: a bound built on it passes an error of 2% in the whole last quarter
of the rows at S 1024 (``test_planted_error_fails_the_bound`` catches one).
Rounding to nearest gives errors that act as independent and zero-mean,
each uniform within half a step, so of variance at most ``u^2 x_j^2 / 3``:
the sum's standard deviation is at most ``u sqrt(sum_j x_j^2 y_j^2) / sqrt 3``
and the factor 4 puts the term at 4 sqrt 3 = 6.9 of them, a normal tail of
4e-12 an element, so not one of the 4.2M elements of an output at the GPT
path's shape is expected beyond it. Where few products carry the sum, the
central limit does not apply, but there the worst case is within the term:
with at most 16 nonzero products, ``sum_j |a_j| <= 4 sqrt(sum_j a_j^2)``
(Cauchy-Schwarz).

Against the JAX package's ``flash_attention`` (Pallas in interpret mode, as
its own tests run it) one bf16 step of the value, ``2^-7 |ref|``, comes on
top: both sides round their outputs to bf16 on their own.

Inputs: B 1, H 2, S 256 (the planted-error case S 1024), D 64, unit normals
from a numpy seed, rounded to bf16, causal and bidirectional.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import flash_attention as jax_flash
from horovod_tpu_torch.ops import flash_attention as flash

B, H, S, D = 1, 2, 256, 64
SCALE = 1.0 / D ** 0.5
OUTPUTS = ("o", "dk", "dv", "dq")
# The rows whose sums are longest in causal attention, where a planted error
# shows first: the last queries for the outputs summed over keys (o, dQ),
# the first keys for those summed over queries (dK, dV).
LAST_QUERIES = ("o", "dq")


def _inputs(seed: int = 11, s: int = S):
    """q, k, v and the output cotangent w, ``[B, s, H, D]`` fp32 values
    that bf16 holds exactly."""
    rng = np.random.RandomState(seed)
    return [np.asarray(torch.from_numpy(rng.randn(B, s, H, D).astype(
        np.float32)).bfloat16().float()) for _ in range(4)]


def _bhsd(x: np.ndarray) -> torch.Tensor:
    return (torch.from_numpy(x).transpose(1, 2).reshape(B * H, -1, D)
            .contiguous().bfloat16())


def _from_bhsd(x: torch.Tensor) -> np.ndarray:
    return x.float().reshape(B, H, S, D).transpose(1, 2).numpy()


def _logits(q, k, causal: bool) -> torch.Tensor:
    """The product of the bf16 operands in fp32, then the scale."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * SCALE
    if causal:
        n = q.shape[1]
        keep = torch.ones(n, n, dtype=torch.bool).tril()
        s = s.masked_fill(~keep, flash.NEG_INF)
    return s


def _rounded(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def emulate_fwd(q, k, v, causal: bool):
    """B7 on the tensor cores: P rounded to bf16 before ``P V``; the row
    sum l of the fp32 P."""
    s = _logits(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(_rounded(p), v.float()) / denom
    return o.bfloat16(), (m + torch.log(denom))[..., 0]


def emulate_dkdv(q, k, v, do, lse, delta, causal: bool):
    """B8 on the tensor cores: Pᵀ rounded before ``Pᵀ dO``, dSᵀ (from the
    fp32 P) rounded before ``dSᵀ Q``, dK scaled at the end."""
    p = torch.exp(_logits(q, k, causal) - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dv = torch.matmul(_rounded(p).transpose(-1, -2), do.float())
    dk = torch.matmul(_rounded(ds).transpose(-1, -2), q.float()) * SCALE
    return dk.bfloat16(), dv.bfloat16()


def emulate_dq(q, k, v, do, lse, delta, causal: bool):
    """B9 on the tensor cores: dS (from the fp32 P) rounded before
    ``dS K``, dQ scaled at the end."""
    p = torch.exp(_logits(q, k, causal) - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    return (torch.matmul(_rounded(ds), k.float()) * SCALE).bfloat16()


def _beyond(got, want, term, extra_step: bool = False) -> int:
    """Elements of ``got`` beyond the bound around ``want`` (``term`` None:
    today's bound without the rounding term)."""
    got = torch.as_tensor(got).float()
    size = torch.as_tensor(want).float().abs()
    bound = 2**-7 * size + (2**-8 * size.mean() + 2**-14)
    if term is not None:
        bound = bound + term
    if extra_step:
        bound = bound + 2**-7 * size
    return int(((got - torch.as_tensor(want).float()).abs() > bound).sum())


@functools.lru_cache(maxsize=None)
def _case(causal: bool, s: int = S):
    """Plain outputs, the emulation's, and the rounding terms; the backward
    of both is fed the plain ``lse`` and ``delta``, as the card's checks
    feed the kernels."""
    q, k, v, w = (_bhsd(x) for x in _inputs(s=s))
    o_ref, lse = flash.flash_fwd_plain(q, k, v, SCALE, causal)
    delta = (w.float() * o_ref.float()).sum(dim=-1)
    dk_ref, dv_ref = flash.flash_dkdv_plain(q, k, v, w, lse, delta, SCALE,
                                            causal)
    o, lse_emulated = emulate_fwd(q, k, v, causal)
    dq_ref = flash.flash_dq_plain(q, k, v, w, lse, delta, SCALE, causal)
    dk, dv = emulate_dkdv(q, k, v, w, lse, delta, causal)
    dq = emulate_dq(q, k, v, w, lse, delta, causal)
    terms = flash.mma_rounding_terms(q, k, v, w, lse, delta, SCALE, causal)
    return ({"o": o_ref, "dk": dk_ref, "dv": dv_ref, "dq": dq_ref},
            {"o": o, "dk": dk, "dv": dv, "dq": dq}, terms,
            (lse, lse_emulated))


@functools.lru_cache(maxsize=None)
def _jax(causal: bool):
    """The JAX package's output and the gradients of ``sum(o * w)`` on the
    same bf16 inputs, as numpy fp32 ``[B, S, H, D]``."""
    q, k, v, w = _inputs()
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))

    def loss(q, k, v):
        o = jax_flash.flash_attention(q, k, v, causal=causal)
        return jnp.sum(o.astype(jnp.float32) * w), o

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(jq, jk, jv)
    as_np = lambda x: np.array(x.astype(jnp.float32))  # noqa: E731
    return {"o": as_np(out), "dq": as_np(grads[0]), "dk": as_np(grads[1]),
            "dv": as_np(grads[2])}


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_emulation_within_bound_of_plain(causal):
    want, got, terms, (lse, lse_emulated) = _case(causal)
    for name in OUTPUTS:
        assert got[name].dtype == torch.bfloat16
        assert _beyond(got[name], want[name], terms[name]) == 0, name
    # lse keeps its fp32 bound, 1e-4 of the largest value (at least 1).
    assert float((lse_emulated - lse).abs().max()) <= 1e-4 * max(
        1.0, float(lse.abs().max()))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_emulation_within_bound_of_jax(causal):
    """The emulated route against the JAX package's kernels on the same
    bf16 inputs. The emulated backward takes its own forward's ``lse`` and
    the ``delta`` of its own ``o`` and the bf16 cotangent, as the port's
    autograd function does."""
    _, _, terms, _ = _case(causal)
    q, k, v, w = (_bhsd(x) for x in _inputs())
    o, lse = emulate_fwd(q, k, v, causal)
    delta = (w.float() * o.float()).sum(dim=-1)
    dk, dv = emulate_dkdv(q, k, v, w, lse, delta, causal)
    dq = emulate_dq(q, k, v, w, lse, delta, causal)
    want = _jax(causal)
    got = {"o": _from_bhsd(o), "dk": _from_bhsd(dk), "dv": _from_bhsd(dv),
           "dq": _from_bhsd(dq)}
    for name in OUTPUTS:
        term = torch.from_numpy(_from_bhsd(terms[name]))
        assert _beyond(got[name], want[name], term, extra_step=True) == 0, \
            name


@pytest.mark.parametrize("name", OUTPUTS)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_rounding_term_is_needed(causal, name):
    """Without the added term the emulated route breaks the bf16 bound the
    CUDA-core kernels meet (at this seed 20 to 229 elements of each output,
    of 32,768), so the term is what lets the tensor-core route pass."""
    want, got, terms, _ = _case(causal)
    assert _beyond(got[name], want[name], None) > 0
    assert _beyond(got[name], want[name], terms[name]) == 0


@pytest.mark.parametrize("name", OUTPUTS)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_planted_error_fails_the_bound(causal, name):
    """An error of 2% in the rows with the longest sums (the last quarter of
    the queries for ``o`` and dQ, the first quarter of the keys for dK and
    dV) is
    caught at S 1024, where the emulated route itself stays within the
    bound; the worst-case sum ``u sum_j |x_j y_j|`` as the term would let the
    planted error in ``o`` pass there."""
    s = 1024
    want, got, terms, _ = _case(causal, s)
    assert _beyond(got[name], want[name], terms[name]) == 0
    rows = (slice(3 * s // 4, s) if name in LAST_QUERIES
            else slice(0, s // 4))
    planted = got[name].float().clone()
    planted[:, rows] *= 1.02
    assert _beyond(planted, want[name], terms[name]) > 0
    if name == "o":
        q, k, v, w = (_bhsd(x) for x in _inputs(s=s))
        p = torch.exp(_logits(q, k, causal) - _case(causal, s)[3][0][..., None])
        worst = 2.0 ** -8 * torch.matmul(p, v.float().abs())
        assert _beyond(planted, want[name], worst) == 0


def test_terms_are_zero_without_rounding():
    """The terms scale with the rounded quantities: zero values give zero
    terms, and the terms never go negative."""
    q, k, v, w = (_bhsd(x) for x in _inputs())
    zeros = torch.zeros_like(v)
    o, lse = flash.flash_fwd_plain(q, k, zeros, SCALE, True)
    delta = torch.zeros(B * H, S)
    terms = flash.mma_rounding_terms(q, k, zeros, zeros, lse, delta, SCALE,
                                     True)
    for name in OUTPUTS:
        assert terms[name].shape == (B * H, S, D)
        assert float(terms[name].abs().max()) == 0.0
    terms = flash.mma_rounding_terms(q, k, v, w, lse, delta, SCALE, True)
    assert all(float(terms[n].min()) >= 0.0 for n in OUTPUTS)
