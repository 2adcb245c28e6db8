"""The port's stochastic max-min quantizer and its kernel's plain version
(B2), held against the JAX package.

The TPU kernel draws its noise from the TPU's hardware generator and the
JAX package's XLA path from ``jax.random``; the port draws it from a
counter-based Philox4x32-10. No two of these give the same bits, so the
codes are held by property: ``min`` and ``unit`` are bitwise those of the
JAX package's stochastic quantizer, every code lies in ``{floor(s),
floor(s) + 1}`` clipped to ``[0, levels]``, where ``s`` is JAX's scaled
value ``(x - min) / unit`` (not "floor or ceil": when ``s`` is an integer
``k`` and ``u`` is near 1, the fp32 sum ``k + u`` rounds to ``k + 1``), the
decoded mean over many seeds is unbiased, and a seed fixes the codes.
The generator itself is pinned by Random123's known-answer vectors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.compression import MaxMinQuantizer as JaxMaxMin
from horovod_tpu_torch.compression import (MaxMinQuantizer,
                                           compress_with_feedback, kernels,
                                           pack_bits, unpack_bits)
from horovod_tpu_torch.compression.quantize import fold_in, seed_from_key

BUCKET = 64


def _data(n, seed):
    """Gradient-like values; the first bucket is constant, and bucket 2
    holds values on the code grid of its own min and unit."""
    x = np.random.RandomState(seed).randn(n).astype(np.float32)
    x[:BUCKET] = 0.5
    x[2 * BUCKET:3 * BUCKET] = np.arange(BUCKET) % 16 - 7.0
    return x


def _codes(payload, bits, n):
    padded = -(-n // BUCKET) * BUCKET
    return unpack_bits(payload["q"], bits, padded).numpy().reshape(-1, BUCKET)


@pytest.mark.parametrize("counter,key,want", [
    (0, 0, (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    (0xffffffff, 2**64 - 1, (0x408f276d, 0x41c83b0e, 0xa20bc7c6,
                             0x6d5451fd)),
])
def test_philox_known_answers(counter, key, want):
    """Random123's known-answer vectors for philox4x32 with 10 rounds."""
    c = torch.full((1,), counter, dtype=torch.int64)
    got = kernels.philox4x32_10((c, c, c, c), key)
    assert tuple(int(w) for w in got) == want


def test_philox_words_follow_the_counter():
    """Value ``i`` takes word ``i % 4`` of counter ``(i // 4, offset)``."""
    words = kernels.philox_words(11, 7, 2**33 + 5, torch.device("cpu"))
    for i in (0, 3, 4, 10):
        c = torch.tensor([i // 4])
        counter = (c, torch.zeros_like(c), torch.full_like(c, 5),
                   torch.full_like(c, 2))
        assert int(words[i]) == int(kernels.philox4x32_10(counter, 7)[i % 4])


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_floor_or_next_and_jax_meta(bits):
    """``min``/``unit`` bitwise against JAX's stochastic quantizer; every
    code in ``{floor(s), floor(s) + 1} ∩ [0, levels]``; a ragged tail."""
    n = 4 * BUCKET + 21
    x = _data(n, bits)
    quant = MaxMinQuantizer(bits, BUCKET, stochastic=True)
    payload, ctx = quant.compress(torch.from_numpy(x), key=bits)
    want, _ = JaxMaxMin(bits, BUCKET, stochastic=True,
                        use_pallas=False).compress(jnp.asarray(x),
                                                   jax.random.PRNGKey(0))
    mn, unit = np.asarray(want["min"]), np.asarray(want["unit"])
    np.testing.assert_array_equal(payload["min"].numpy(), mn)
    np.testing.assert_array_equal(payload["unit"].numpy(), unit)
    padded = np.zeros(5 * BUCKET, np.float32)
    padded[:n] = x
    safe = np.where(unit == 0, np.float32(1), unit)[:, None]
    s = (padded.reshape(-1, BUCKET) - mn[:, None]) / safe
    q = _codes(payload, bits, n)
    levels = (1 << bits) - 1
    low = np.clip(np.floor(s), 0, levels)
    high = np.clip(np.floor(s) + 1, 0, levels)
    assert ((q == low) | (q == high)).all()
    assert (q[0] == 0).all()  # the constant bucket
    out = quant.decompress(payload, ctx).numpy()
    assert np.abs(out - x).max() <= unit.max() * (1 + 1e-6)


def test_unbiased_over_seeds():
    """E[decompress(compress(x))] == x over 300 seeds, as
    ``TestStochasticRounding`` holds the JAX package; deterministic
    rounding of the same values is biased by up to half a unit."""
    x = np.random.RandomState(6).randn(BUCKET).astype(np.float32)
    quant = MaxMinQuantizer(2, BUCKET, stochastic=True)
    trials = 300
    acc = np.zeros(BUCKET, np.float64)
    for seed in range(trials):
        payload, ctx = quant.compress(torch.from_numpy(x), key=seed)
        acc += quant.decompress(payload, ctx).numpy()
    unit = float(payload["unit"][0])
    # The mean of 300 draws of a value spread over one unit: 4.5 standard
    # errors is 0.13 of a unit.
    np.testing.assert_allclose(acc / trials, x, atol=0.13 * unit)


def test_seeds_fix_the_codes():
    x = torch.from_numpy(_data(3 * BUCKET, 1))
    quant = MaxMinQuantizer(4, BUCKET, stochastic=True)
    q = lambda key: quant.compress(x, key=key)[0]["q"]  # noqa: E731
    assert torch.equal(q(5), q(5)) and not torch.equal(q(5), q(6))
    assert torch.equal(q(None), q(0))
    assert torch.equal(q(torch.Generator().manual_seed(3)),
                       q(torch.Generator().manual_seed(3)))
    assert torch.equal(q(-1), q(2**64 - 1))
    # Another offset draws other words under the same seed.
    flat = x.reshape(-1)
    a = kernels.maxmin_quantize_stochastic(flat, 4, BUCKET, 5, offset=0)[0]
    b = kernels.maxmin_quantize_stochastic(flat, 4, BUCKET, 5, offset=1)[0]
    assert torch.equal(pack_bits(a.view(-1), 4), q(5))
    assert not torch.equal(a, b)
    with pytest.raises(TypeError):
        quant.compress(x, key="seed")


def test_compress_rows_is_compress_of_the_padded_rows():
    """The row form draws the noise of the rows' padded concatenation, in
    one launch."""
    rows = _data(3 * 100, 4).reshape(3, 100)
    quant = MaxMinQuantizer(4, BUCKET, stochastic=True)
    payload, ctx = quant.compress_rows(torch.from_numpy(rows), key=9)
    padded = np.zeros((3, 128), np.float32)
    padded[:, :100] = rows
    whole, _ = quant.compress(torch.from_numpy(padded.reshape(-1)), key=9)
    np.testing.assert_array_equal(payload["q"].numpy().reshape(-1),
                                  whole["q"].numpy())
    for k in ("min", "unit"):
        np.testing.assert_array_equal(payload[k].numpy().reshape(-1),
                                      whole[k].numpy())
    back = quant.decompress_rows(payload, ctx)
    assert back.shape == (3, 100)


def test_nan_bucket_codes_zero():
    x = _data(3 * BUCKET, 2)
    x[BUCKET + 3] = np.nan
    q, mn, unit = kernels.maxmin_quantize_stochastic(torch.from_numpy(x), 4,
                                                     BUCKET, 1)
    assert (q[1] == 0).all() and torch.isnan(mn[1]) and torch.isnan(unit[1])


def test_identity_and_keys():
    """Equality includes ``stochastic``, so the optimizer never fuses a
    stochastic group with a deterministic one; the deterministic quantizer
    takes and ignores a key, and error feedback passes it on."""
    det, sto = MaxMinQuantizer(4, BUCKET), MaxMinQuantizer(4, BUCKET, True)
    assert det != sto and len({det, sto, MaxMinQuantizer(4, BUCKET)}) == 2
    x = torch.from_numpy(_data(3 * BUCKET, 3))
    r = torch.full_like(x, 0.01)
    assert torch.equal(det.compress(x, key=4)[0]["q"], det.compress(x)[0]["q"])
    payload, _, _ = compress_with_feedback(sto, x, r, key=11)
    assert torch.equal(payload["q"], sto.compress(x + r, key=11)[0]["q"])
    assert fold_in(3, 1) == fold_in(3, 1) != fold_in(3, 2) != fold_in(4, 2)
    assert seed_from_key(None) == 0 and 0 <= fold_in(None, 1) < 2**64
