"""The bound that holds bf16 B7, B8 and B9 on the tensor cores to their
plain versions, checked on the CPU against an emulation of that route.

The route (``horovod_tpu_torch/csrc/flash_attention_wgmma.cu`` for B7, B8
and B9) multiplies bf16 operands exactly
with fp32 sums, applies the scale to the fp32 logits
after the product, and rounds two intermediates to bf16 before they enter a
product: P (before ``P V`` and ``Pᵀ dO``) and dS (before ``dSᵀ Q`` and
``dS K``). The emulation below does just that in plain PyTorch, over whole
rows instead of the kernels' tiles: a rounding to bf16 is relative, so the
bound does not depend on the running maximum the kernel rounds against.

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

The forward on the card (``flash_attention_wgmma.cu``) rounds P against a
running maximum, one 128-key tile at a time, not against the row's
maximum. ``emulate_fwd_tiled`` follows its order of operations exactly
(the head dimension zero-padded to 64 or 128, the maximum of the fp32
logits times ``scale log2 e``, ``exp2`` of ``x scale log2 e - m`` in one
rounding, P rounded to bf16 against the running maximum, the accumulator
rescaled once a tile), and is held to the same bound at S 200 and 256, D
16 and 64, causal and bidirectional.

dQ on the card sums ``bf16(dS) K`` one 128-key tile at a time and takes
P as ``exp2`` of the logit times ``scale log2 e`` less ``lse log2 e`` in
one rounding. ``emulate_dq_tiled`` follows that order and is held to the
bound of the plain version and of the JAX package's gradient at the same
shapes; a 2% error planted in its last quarter of queries fails the bound
at S 1024.
"""

import functools
import math

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


KEY_TILE = 128  # keys of a K/V tile of the forward and of dQ on the card
LOG2E = 1.4426950408889634


def emulate_fwd_tiled(q, k, v, scale: float, causal: bool):
    """B7 on the wgmma route, in its order of operations: the head
    dimension zero-padded to DP (64 up to D 64, else 128); for each
    128-key tile, the fp32 logits ``x`` (a masked one, causal: key after
    query, bidirectional: key past S, takes no part), ``m' = max(m,
    rowmax(x) c)`` with ``c = fp32(scale log2 e)``, ``p = 2^(x c - m')``
    with ``x c - m'`` rounded once (the kernel's FMA) and masked p 0,
    ``l' = l 2^(m - m') + rowsum p`` (fp32 p) and ``acc' = acc 2^(m - m')
    + bf16(p) v``; then ``o = acc / l`` (l = 0 read as 1) and ``lse = (m
    + log2 l) ln 2``. A causal query tile stops at the diagonal tile, as
    the kernel does."""
    bh, s, d = q.shape
    dp = 64 if d <= 64 else 128
    pad = [0, dp - d]
    qp, kp, vp = (torch.nn.functional.pad(x.float(), pad) for x in (q, k, v))
    c = float(np.float32(scale) * np.float32(LOG2E))
    rows = torch.arange(s)[:, None]
    m = torch.full((bh, s, 1), flash.NEG_INF)
    l = torch.zeros(bh, s, 1)
    acc = torch.zeros(bh, s, dp)
    n_tiles = -(-s // KEY_TILE)
    for kt in range(n_tiles):
        cols = torch.arange(kt * KEY_TILE, min(s, (kt + 1) * KEY_TILE))
        x = torch.matmul(qp, kp[:, cols].transpose(-1, -2))
        keep = rows >= cols[None, :] if causal else cols[None, :] < s
        # The query tiles past this key tile's diagonal never load it.
        seen = (rows // KEY_TILE >= kt) if causal else torch.ones_like(
            rows, dtype=torch.bool)
        x = x.masked_fill(~keep, -math.inf)
        row_max = (x.amax(-1, keepdim=True) * c).float()
        m_new = torch.where(seen, torch.maximum(m, row_max), m)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2((x.double() * c - m_new.double()).float())
        p = p.masked_fill(~keep, 0.0)
        l = torch.where(seen, l * alpha + p.sum(-1, keepdim=True), l)
        acc = torch.where(seen, acc * alpha + torch.matmul(
            _rounded(p), vp[:, cols]), acc)
        m = m_new
    safe = torch.where(l == 0, torch.ones_like(l), l)
    o = (acc / safe)[..., :d]
    return o.bfloat16(), ((m + torch.log2(safe)) * math.log(2.0))[..., 0]


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


def _tiled_inputs(s: int, d: int):
    """q, k, v and a cotangent ``[1, s, 2, d]`` (numpy, values bf16
    holds) and the same as bf16 ``[2, s, d]``."""
    rng = np.random.RandomState(s + d)
    arrays = [np.asarray(torch.from_numpy(rng.randn(1, s, 2, d).astype(
        np.float32)).bfloat16().float()) for _ in range(4)]
    bhsd = [torch.from_numpy(x).transpose(1, 2).reshape(2, s, d)
            .contiguous().bfloat16() for x in arrays]
    return arrays, bhsd


@functools.lru_cache(maxsize=None)
def _tiled_case(s: int, d: int, causal: bool):
    """The tiled emulation's ``o`` and ``lse``, the plain ones, the
    rounding term of ``o`` and the JAX package's ``o`` (numpy ``[1, s, 2,
    d]``)."""
    (q_np, k_np, v_np, w_np), (q, k, v, w) = _tiled_inputs(s, d)
    scale = 1.0 / d ** 0.5
    o, lse = emulate_fwd_tiled(q, k, v, scale, causal)
    o_ref, lse_ref = flash.flash_fwd_plain(q, k, v, scale, causal)
    delta = (w.float() * o_ref.float()).sum(dim=-1)
    term = flash.mma_rounding_terms(q, k, v, w, lse_ref, delta, scale,
                                    causal)["o"]
    jax_o = jax_flash.flash_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q_np, k_np, v_np)),
        causal=causal)
    return o, lse, o_ref, lse_ref, term, np.array(jax_o.astype(jnp.float32))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("s", [200, 256])
def test_tiled_forward_within_bound_of_plain(s, d, causal):
    """The forward's tiled order (128-key tiles, P rounded against the
    running maximum, D zero-padded to 64) stays within the unchanged bound
    of the plain version; lse within its fp32 bound."""
    o, lse, o_ref, lse_ref, term, _ = _tiled_case(s, d, causal)
    assert o.dtype == torch.bfloat16 and o.shape == o_ref.shape
    assert _beyond(o, o_ref, term) == 0
    assert float((lse - lse_ref).abs().max()) <= 1e-4 * max(
        1.0, float(lse_ref.abs().max()))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("s", [200, 256])
def test_tiled_forward_within_bound_of_jax(s, d, causal):
    """The same against the JAX package's ``flash_attention`` (Pallas in
    interpret mode) on the same bf16 inputs, with the extra bf16 step of
    two sides that round on their own."""
    o, _, _, _, term, want = _tiled_case(s, d, causal)
    got = o.float().reshape(1, 2, s, d).transpose(1, 2)
    term = term.reshape(1, 2, s, d).transpose(1, 2)
    assert _beyond(got, want, term, extra_step=True) == 0


def emulate_dq_tiled(q, k, v, do, lse, delta, scale: float, causal: bool):
    """B9 on the wgmma route, in its order of operations: the head
    dimension zero-padded to DP (64 up to D 64, else 128); for each
    128-key tile, the fp32 logits ``x`` and ``dP = dO
    Vᵀ``, ``p = 2^(x c - lse2)`` with ``c = fp32(scale log2 e)``, ``lse2 =
    fp32(lse log2 e)`` and ``x c - lse2`` rounded once (the kernel's FMA),
    a masked p 0 (causal: key after query; bidirectional: key past S),
    ``dS = p (dP - delta)`` in fp32 and ``acc += bf16(dS) K``; then ``dQ =
    bf16(acc scale)``. The tiles past a causal block's diagonal, which the
    kernel never loads, add exact zeros here."""
    bh, s, d = q.shape
    dp_ = 64 if d <= 64 else 128
    pad = [0, dp_ - d]
    qp, kp, vp, op = (torch.nn.functional.pad(x.float(), pad)
                      for x in (q, k, v, do))
    c = float(np.float32(scale) * np.float32(LOG2E))
    lse2 = (lse.float() * np.float32(LOG2E)).float()[..., None].double()
    rows = torch.arange(s)[:, None]
    acc = torch.zeros(bh, s, dp_)
    for k0 in range(0, s, KEY_TILE):
        cols = torch.arange(k0, min(s, k0 + KEY_TILE))
        x = torch.matmul(qp, kp[:, cols].transpose(-1, -2))
        keep = rows >= cols[None, :] if causal else cols[None, :] < s
        p = torch.exp2((x.double() * c - lse2).float())
        p = p.masked_fill(~keep, 0.0)
        dp = torch.matmul(op, vp[:, cols].transpose(-1, -2))
        ds = p * (dp - delta.float()[..., None])
        acc = acc + torch.matmul(_rounded(ds), kp[:, cols])
    return (acc * np.float32(scale))[..., :d].bfloat16()


@functools.lru_cache(maxsize=None)
def _tiled_dq_case(s: int, d: int, causal: bool):
    """The tiled dQ emulation on the plain ``lse`` and ``delta`` (as the
    card's checks feed the kernel), the plain dQ, its rounding term and
    the JAX package's dQ of ``sum(o * w)`` (numpy ``[1, s, 2, d]``)."""
    (q_np, k_np, v_np, w_np), (q, k, v, w) = _tiled_inputs(s, d)
    scale = 1.0 / d ** 0.5
    o_ref, lse_ref = flash.flash_fwd_plain(q, k, v, scale, causal)
    delta = (w.float() * o_ref.float()).sum(dim=-1)
    dq = emulate_dq_tiled(q, k, v, w, lse_ref, delta, scale, causal)
    dq_ref = flash.flash_dq_plain(q, k, v, w, lse_ref, delta, scale, causal)
    term = flash.mma_rounding_terms(q, k, v, w, lse_ref, delta, scale,
                                    causal)["dq"]

    def loss(q, k, v):
        o = jax_flash.flash_attention(q, k, v, causal=causal)
        return jnp.sum(o.astype(jnp.float32) * w_np)

    jax_dq = jax.grad(loss)(*(jnp.asarray(x, jnp.bfloat16)
                              for x in (q_np, k_np, v_np)))
    return dq, dq_ref, term, np.array(jax_dq.astype(jnp.float32))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("s", [200, 256])
def test_tiled_dq_within_bound_of_plain(s, d, causal):
    """dQ's tiled order (128-key tiles, P by one FMA and exp2, D
    zero-padded to 64) stays within the unchanged bound of the plain
    version."""
    dq, dq_ref, term, _ = _tiled_dq_case(s, d, causal)
    assert dq.dtype == torch.bfloat16 and dq.shape == dq_ref.shape
    assert _beyond(dq, dq_ref, term) == 0


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("s", [200, 256])
def test_tiled_dq_within_bound_of_jax(s, d, causal):
    """The same against the JAX package's ``flash_attention`` gradient
    (Pallas in interpret mode) on the same bf16 inputs, with the extra
    bf16 step of two sides that round on their own. The emulation takes
    the plain ``lse`` and ``delta``; the chain below takes the tiled
    forward's."""
    dq, _, term, want = _tiled_dq_case(s, d, causal)
    got = dq.float().reshape(1, 2, s, d).transpose(1, 2)
    term = term.reshape(1, 2, s, d).transpose(1, 2)
    assert _beyond(got, want, term, extra_step=True) == 0


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_tiled_dq_planted_error_fails_the_bound(causal):
    """At S 1024, D 64 the tiled dQ stays within the bound, and the same
    dQ made 2% larger in its last quarter of queries does not."""
    s, d = 1024, 64
    _, (q, k, v, w) = _tiled_inputs(s, d)
    scale = 1.0 / d ** 0.5
    o_ref, lse = flash.flash_fwd_plain(q, k, v, scale, causal)
    delta = (w.float() * o_ref.float()).sum(dim=-1)
    dq = emulate_dq_tiled(q, k, v, w, lse, delta, scale, causal)
    want = flash.flash_dq_plain(q, k, v, w, lse, delta, scale, causal)
    term = flash.mma_rounding_terms(q, k, v, w, lse, delta, scale,
                                    causal)["dq"]
    assert _beyond(dq, want, term) == 0
    planted = dq.float().clone()
    planted[:, 3 * s // 4:] *= 1.02
    assert _beyond(planted, want, term) > 0


@functools.lru_cache(maxsize=None)
def _chain_dq_case(s: int, d: int, causal: bool):
    """Forward then backward as the card runs them: the tiled forward's
    ``o`` and ``lse``, ``delta`` from that bf16 ``o``, and the tiled dQ on
    them; with the plain dQ and the dQ terms (``dq`` and ``dq_delta``,
    computed on the plain side)."""
    _, (q, k, v, w) = _tiled_inputs(s, d)
    scale = 1.0 / d ** 0.5
    o, lse = emulate_fwd_tiled(q, k, v, scale, causal)
    delta = (w.float() * o.float()).sum(dim=-1)
    dq = emulate_dq_tiled(q, k, v, w, lse, delta, scale, causal)
    o_ref, lse_ref = flash.flash_fwd_plain(q, k, v, scale, causal)
    delta_ref = (w.float() * o_ref.float()).sum(dim=-1)
    dq_ref = flash.flash_dq_plain(q, k, v, w, lse_ref, delta_ref, scale,
                                  causal)
    terms = flash.mma_rounding_terms(q, k, v, w, lse_ref, delta_ref, scale,
                                     causal)
    return dq, dq_ref, terms["dq"], terms["dq_delta"]


def _to_bshd(x: torch.Tensor, s: int, d: int) -> torch.Tensor:
    return x.float().reshape(1, 2, s, d).transpose(1, 2)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("s", [200, 256])
def test_tiled_chain_dq_within_bound_of_jax(s, d, causal):
    """The chain's dQ against the JAX package's gradient (its own forward,
    its own ``delta``), within the dQ bound plus ``dq_delta``, the term
    that the bf16 rounding of ``o`` adds through ``delta``."""
    dq, _, term, term_delta = _chain_dq_case(s, d, causal)
    want = _tiled_dq_case(s, d, causal)[3]
    assert _beyond(_to_bshd(dq, s, d), want,
                   _to_bshd(term + term_delta, s, d), extra_step=True) == 0


def test_chain_needs_the_delta_term():
    """Without ``dq_delta`` the chain misses the bound: at S 256, D 64,
    causal, elements of query 3 reach 1.67 of it."""
    s, d = 256, 64
    dq, _, term, _ = _chain_dq_case(s, d, True)
    want = _tiled_dq_case(s, d, True)[3]
    assert _beyond(_to_bshd(dq, s, d), want, _to_bshd(term, s, d),
                   extra_step=True) > 0


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_tiled_chain_dq_planted_error_fails_the_bound(causal):
    """At S 1024, D 64 the chain's dQ stays within the bound with
    ``dq_delta``, and the same dQ made 2% larger in its last quarter of
    queries does not."""
    s = 1024
    dq, dq_ref, term, term_delta = _chain_dq_case(s, 64, causal)
    assert _beyond(dq, dq_ref, term + term_delta) == 0
    planted = dq.float().clone()
    planted[:, 3 * s // 4:] *= 1.02
    assert _beyond(planted, dq_ref, term + term_delta) > 0

