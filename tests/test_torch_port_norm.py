"""The port's normalized quantizer and its kernels' plain versions (B5, B6),
held against the JAX package on the same numpy inputs.

Against the JAX package's XLA path (``use_pallas=False``) and against its
Pallas kernels in interpret mode: with the linf norm, codes, packed bytes
and norms are bitwise equal, and so are the decoded values. With the l2
norm the sum of squares runs in another order, so norms agree to rtol
1e-6; a code may then differ where the ratio ``|x| / norm`` lies within a
few ulp of the midpoint of two levels, and there by one level index and
never in its sign bit. The tests count such codes and allow at most 1 in
1000.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.compression import NormalizedQuantizer as JaxNorm
from horovod_tpu.compression import pallas_kernels as pk
from horovod_tpu.compression import quantize as jax_quantize
from horovod_tpu.compression import set_quantization_levels as \
    jax_set_levels
from horovod_tpu.compression.quantize import unpack_bits as jax_unpack
from horovod_tpu_torch.compression import (NormalizedQuantizer,
                                           compressed_size_bytes,
                                           norm_kernels, quantize,
                                           set_quantization_levels,
                                           unpack_bits)

BUCKET = 64
MIDPOINT_SHARE = 1e-3


def _data(n, seed, nan=True):
    """Gradient-like values with a ragged tail: bucket 1 is all zeros and,
    when ``nan``, bucket 2 holds a NaN."""
    x = np.random.RandomState(seed).randn(n).astype(np.float32)
    x[BUCKET:2 * BUCKET] = 0.0
    if nan:
        x[2 * BUCKET + 5] = np.nan
    return x


@pytest.fixture
def user_levels():
    """Restore both packages' level tables after the test."""
    yield
    jax_quantize._user_levels.clear()
    quantize._user_levels.clear()


def _assert_codes(got, want, norm):
    """Codes as the module docstring states: equal for linf; for l2 equal
    but at midpoint cases, which keep their sign bit, move one index, and
    are rare."""
    if norm == "linf":
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_array_equal(got & 1, want & 1)
    step = np.abs((got >> 1).astype(int) - (want >> 1).astype(int))
    assert step.max() <= 1
    assert (step > 0).mean() <= MIDPOINT_SHARE, int((step > 0).sum())


def _assert_norms(got, want, norm):
    if norm == "linf":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("norm", ["linf", "l2"])
@pytest.mark.parametrize("kind", ["uni", "exp"])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_compress_matches_jax(bits, kind, norm):
    """3 buckets + a ragged 37, a zero bucket and a NaN bucket."""
    n = 5 * BUCKET + 37
    x = _data(n, bits * 10 + len(kind))
    quant = NormalizedQuantizer(bits, BUCKET, kind, norm)
    ref = JaxNorm(bits, BUCKET, kind, norm, use_pallas=False)
    payload, ctx = quant.compress(torch.from_numpy(x))
    want, want_ctx = ref.compress(jnp.asarray(x))
    padded = 6 * BUCKET
    _assert_codes(unpack_bits(payload["q"], bits, padded).numpy(),
                  np.asarray(jax_unpack(want["q"], bits, padded)), norm)
    if norm == "linf":
        np.testing.assert_array_equal(payload["q"].numpy(),
                                      np.asarray(want["q"]))
    _assert_norms(payload["norm"].numpy(), np.asarray(want["norm"]), norm)
    assert payload["norm"][1] == 0 and torch.isnan(payload["norm"][2])
    # The same payload decodes bitwise alike in both packages.
    jax_payload = {k: torch.from_numpy(np.array(v)) for k, v in
                   want.items()}
    np.testing.assert_array_equal(
        quant.decompress(jax_payload, ctx).numpy(),
        np.asarray(ref.decompress(want, want_ctx)))
    out = quant.decompress(payload, ctx)
    assert out.shape == (n,)
    assert torch.isnan(out[2 * BUCKET:3 * BUCKET]).all()
    assert (out[BUCKET:2 * BUCKET] == 0).all()


@pytest.mark.parametrize("norm,bits", [("linf", 2), ("linf", 4),
                                       ("linf", 8), ("l2", 4), ("l2", 8)])
def test_plain_kernels_match_pallas(norm, bits):
    """The plain B5 and B6 against ``norm_quantize_pallas`` and
    ``norm_dequantize_pallas`` in interpret mode."""
    x = _data(3 * BUCKET + 9, bits, nan=False)
    table = jax_quantize.default_levels(bits, "uni")
    levels = torch.from_numpy(table)
    q, nrm = norm_kernels.norm_quantize(torch.from_numpy(x), levels, BUCKET,
                                        norm == "l2")
    wq, wnrm = pk.norm_quantize_pallas(jnp.asarray(x), jnp.asarray(table),
                                       BUCKET, norm == "l2", True)
    _assert_codes(q.numpy(), np.asarray(wq), norm)
    _assert_norms(nrm.numpy(), np.asarray(wnrm), norm)
    out = norm_kernels.norm_dequantize(torch.from_numpy(np.array(wq)),
                                       levels,
                                       torch.from_numpy(np.array(wnrm)))
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(pk.norm_dequantize_pallas(
            wq, jnp.asarray(table), wnrm, True)))


def test_level_tables_bitwise():
    for bits in (2, 4, 8):
        for kind in ("uni", "exp"):
            np.testing.assert_array_equal(
                quantize.default_levels(bits, kind),
                jax_quantize.default_levels(bits, kind))


def test_user_levels_match_jax(user_levels):
    """A table installed through both packages' ``set_quantization_levels``
    (scaled so its first entry is 1) codes alike, and is part of the
    quantizer's identity."""
    key_before = NormalizedQuantizer(4, BUCKET)._key()
    for setter in (set_quantization_levels, jax_set_levels):
        setter([2.0, 1.0, 0.3, 0.0], for_type="uni")
    after = NormalizedQuantizer(4, BUCKET)
    assert after._key() != key_before
    x = _data(2 * BUCKET + 3, 9, nan=False)
    payload, ctx = after.compress(torch.from_numpy(x))
    ref = JaxNorm(4, BUCKET, use_pallas=False)
    want, want_ctx = ref.compress(jnp.asarray(x))
    np.testing.assert_array_equal(payload["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(after.decompress(payload, ctx).numpy(),
                                  np.asarray(ref.decompress(want, want_ctx)))
    np.testing.assert_array_equal(after._levels(),
                                  np.float32([1.0, 0.5, 0.15, 0.0]))


def test_table_too_large_raises(user_levels):
    set_quantization_levels(np.linspace(1, 0, 9), for_type="exp")
    with pytest.raises(ValueError, match="can index at most 8"):
        NormalizedQuantizer(4, BUCKET, "exp").compress(torch.ones(10))
    with pytest.raises(ValueError, match="at least 2"):
        set_quantization_levels([1.0])
    for bad in (dict(bits=3), dict(norm="l1")):
        with pytest.raises(ValueError):
            NormalizedQuantizer(**bad)


def test_decode_clips_to_the_table(user_levels):
    """A payload coded against a larger table decodes at the last level of
    a smaller one, in both packages and in the Pallas kernel."""
    x = np.linspace(-1, 1, 2 * BUCKET).astype(np.float32)
    quant = NormalizedQuantizer(8, BUCKET)
    ref = JaxNorm(8, BUCKET, use_pallas=False)
    payload, ctx = quant.compress(torch.from_numpy(x))
    want_payload, want_ctx = ref.compress(jnp.asarray(x))
    set_quantization_levels([1.0, 0.5, 0.25, 0.125])
    jax_set_levels([1.0, 0.5, 0.25, 0.125])
    got = quant.decompress(payload, ctx).numpy()
    want = ref.decompress(want_payload, want_ctx)
    np.testing.assert_array_equal(got, np.asarray(want))
    q = unpack_bits(payload["q"], 8, x.size).reshape(-1, BUCKET)
    np.testing.assert_array_equal(got, np.asarray(pk.norm_dequantize_pallas(
        jnp.asarray(q.numpy()), jnp.float32([1.0, 0.5, 0.25, 0.125]),
        jnp.asarray(payload["norm"].numpy()), True)).reshape(-1))
    assert (q >> 1).max() > 3 and np.abs(got).min() == 0.125


def test_compress_rows_quantizes_each_row_alone():
    rows = _data(3 * 100, 5, nan=False).reshape(3, 100)
    quant = NormalizedQuantizer(4, BUCKET, "exp", "l2")
    payload, ctx = quant.compress_rows(torch.from_numpy(rows))
    back = quant.decompress_rows(payload, ctx)
    for r in range(3):
        one, _ = quant.compress(torch.from_numpy(rows[r]))
        for k in ("q", "norm"):
            np.testing.assert_array_equal(payload[k][r].numpy(),
                                          one[k].numpy())
        np.testing.assert_array_equal(back[r].numpy(),
                                      quant.decompress(one, ctx).numpy())
    # 4-bit codes of two buckets of 64 and two fp32 norms a row.
    assert compressed_size_bytes(payload) == 3 * (128 // 2 + 2 * 4)


def test_plain_search_keeps_the_first_minimum():
    """A ratio halfway between two levels takes the first (larger) level,
    as ``jnp.argmin`` does."""
    levels = torch.tensor([1.0, 0.5, 0.0])
    x = torch.tensor([1.0, 0.75, 0.25, -0.25])
    q, _ = norm_kernels.norm_quantize(x, levels, 4, False)
    np.testing.assert_array_equal(q[0].numpy(), [0, 0, 2, 3])
