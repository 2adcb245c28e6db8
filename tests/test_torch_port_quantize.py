"""The port's packing, max-min quantizer, kernels' plain versions and error
feedback, held against the JAX package on the same numpy inputs.

Against the JAX package's XLA path (``use_pallas=False``, what its
``compress``/``decompress`` run on the CPU) codes and packed bytes are
bitwise equal, min/unit exact and decoded values bitwise equal.

Against the Pallas kernels in interpret mode codes and min are bitwise
equal, but unit only within 1 ulp and decoded values within one rounding
of the product and one of the sum: inside the
interpreted kernel XLA computes ``unit`` as ``(max-min) * fl(1/levels)``
and ``min + q*unit`` as one fused multiply-add, where the XLA path and the
port round the quotient, the product and the sum each on its own. The
fused dequantize-sum kernel B3 also adds in another order (``Σ q·unit +
Σ min`` against rank by rank). Each order rounds a product at most once
and passes it and a min through at most n + 1 roundings of a sum over n
ranks (a fused multiply-add rounds less), so each lies within
γ(n+1)·M of the exact sum, M = Σ(|min| + |q·unit|) over ranks and
γ(k) = k·u/(1 - k·u) <= (n + 2)·u with u = 2^-24; the two are held within
2(n + 2)·u·M of each other. The cases it had before this bound (4 bits,
buckets of 64, its seeds and shapes) also keep rtol 1e-5 of the result,
as ``tests/test_compression.py`` holds B3.

B3 and B4 take the payload packed, as it crosses the wire (JAX's
``pack_bits`` of each row's codes); the Pallas kernels get the same codes
unpacked. Against the decode they replace (``unpack_bits``, then the
formula: :func:`_unpack_then_decode`, kept here as it was) the port's
``decompress``, ``decompress_rows`` and B3 path are bitwise equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.compression import MaxMinQuantizer as JaxMaxMin
from horovod_tpu.compression import TopKCompressor as JaxTopK
from horovod_tpu.compression import compress_with_feedback as jax_feedback
from horovod_tpu.compression import pallas_kernels as pk
from horovod_tpu.compression.quantize import pack_bits as jax_pack
from horovod_tpu.compression.quantize import unpack_bits as jax_unpack
from horovod_tpu_torch.compression import (MaxMinQuantizer, TopKCompressor,
                                           compress_with_feedback,
                                           compressed_size_bytes, kernels,
                                           pack_bits, unpack_bits)


def _data(n, seed, constant_bucket=0):
    """Gradient-like values; the first ``constant_bucket`` values equal."""
    x = np.random.RandomState(seed).randn(n).astype(np.float32)
    x[:constant_bucket] = 0.75
    return x


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [1, 7, 64, 1001])
def test_pack_unpack_bytes_equal(bits, n):
    vals = np.random.RandomState(n).randint(0, 1 << bits, n).astype(np.uint8)
    packed = pack_bits(torch.from_numpy(vals), bits)
    want = np.asarray(jax_pack(jnp.asarray(vals), bits))
    np.testing.assert_array_equal(packed.numpy(), want)
    out = unpack_bits(packed, bits, n)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jax_unpack(jnp.asarray(want), bits, n)))
    np.testing.assert_array_equal(out.numpy(), vals)


def test_pack_rows_equal_per_row():
    """The row form packs each row as the JAX package packs a vector."""
    rows = np.random.RandomState(3).randint(0, 4, (3, 11)).astype(np.uint8)
    packed = pack_bits(torch.from_numpy(rows), 2)
    for r in range(3):
        np.testing.assert_array_equal(
            packed[r].numpy(), np.asarray(jax_pack(jnp.asarray(rows[r]), 2)))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("bucket", [64, 125, 512])
def test_compress_matches_jax(bits, bucket):
    """Ragged tail (3 buckets + 37) and a constant first bucket."""
    x = _data(3 * bucket + 37, bits * 1000 + bucket, constant_bucket=bucket)
    payload, ctx = MaxMinQuantizer(bits, bucket).compress(torch.from_numpy(x))
    want, want_ctx = JaxMaxMin(bits, bucket, use_pallas=False).compress(
        jnp.asarray(x))
    np.testing.assert_array_equal(payload["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(payload["min"].numpy(),
                                  np.asarray(want["min"]))
    np.testing.assert_array_equal(payload["unit"].numpy(),
                                  np.asarray(want["unit"]))
    assert payload["unit"][0] == 0  # the constant bucket
    out = MaxMinQuantizer(bits, bucket).decompress(payload, ctx)
    ref = JaxMaxMin(bits, bucket, use_pallas=False).decompress(want,
                                                               want_ctx)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("bits,bucket", [(1, 64), (2, 512), (4, 512),
                                         (8, 64), (4, 125)])
def test_quantize_plain_matches_pallas_kernel(bits, bucket):
    """The plain B1 against ``maxmin_quantize_pallas`` in interpret mode."""
    x = _data(2 * bucket + 5, bits + bucket, constant_bucket=bucket)
    q, mn, unit = kernels.maxmin_quantize(torch.from_numpy(x), bits, bucket)
    wq, wmn, wunit = pk.maxmin_quantize_pallas(jnp.asarray(x), bits, bucket,
                                               True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(mn.numpy(), np.asarray(wmn))
    np.testing.assert_array_max_ulp(unit.numpy(), np.asarray(wunit), 1)


def test_nonfinite_buckets_match_jax():
    """A NaN passes through a bucket's min and unit, an inf makes the unit
    infinite; such buckets code as 0 and decode to NaN, as in the JAX
    package's XLA path and its Pallas kernel."""
    x = _data(4 * 64 + 9, 21)
    x[3] = np.nan
    x[64 + 5] = np.inf
    x[128 + 7] = -np.inf
    x[192 + 1], x[192 + 2] = np.inf, -np.inf
    q, mn, unit = kernels.maxmin_quantize(torch.from_numpy(x), 4, 64)
    want, _ = JaxMaxMin(4, 64, use_pallas=False).compress(jnp.asarray(x))
    wq, wmn, wunit = pk.maxmin_quantize_pallas(jnp.asarray(x), 4, 64, True)
    np.testing.assert_array_equal(mn.numpy(), np.asarray(want["min"]))
    np.testing.assert_array_equal(unit.numpy(), np.asarray(want["unit"]))
    np.testing.assert_array_equal(mn.numpy(), np.asarray(wmn))
    # The interpreted kernel's unit is within 1 ulp (module docstring).
    np.testing.assert_array_equal(unit[:4].numpy(), np.asarray(wunit)[:4])
    np.testing.assert_array_max_ulp(unit[4:].numpy(), np.asarray(wunit)[4:],
                                    1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(pack_bits(q.view(-1), 4).numpy(),
                                  np.asarray(want["q"]))
    assert torch.isnan(mn[0]) and torch.isinf(unit[1:4]).all()
    assert (q[:4] == 0).all() and torch.isfinite(mn[4]) and unit[4] > 0
    back = kernels.maxmin_dequantize(q, mn, unit, 8, 64)  # byte codes
    assert torch.isnan(back[:4]).all() and torch.isfinite(back[4]).all()


def _packed(codes: np.ndarray, bits: int) -> np.ndarray:
    """JAX's ``pack_bits`` of each row of ``codes``."""
    return np.stack([np.asarray(jax_pack(jnp.asarray(row), bits))
                     for row in codes])


def _payload(bits, bucket, n_buckets, rows, seed):
    """Seeded codes of ``n_buckets`` buckets in ``rows`` rows, each row
    packed on its own, and each bucket's min and unit."""
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, 1 << bits, (n_buckets, bucket)).astype(np.uint8)
    mn = rng.randn(n_buckets).astype(np.float32)
    unit = (np.abs(rng.randn(n_buckets)) / ((1 << bits) - 1)).astype(
        np.float32)
    return codes, _packed(codes.reshape(rows, -1), bits), mn, unit


def _assert_one_fma_apart(out, want, codes, unit):
    """One fused multiply-add against a rounded product and a rounded sum:
    they differ by at most one rounding of each."""
    prod = codes.astype(np.float32) * unit[:, None]
    bound = np.spacing(np.abs(prod)) + np.spacing(np.abs(out))
    assert (np.abs(out - np.asarray(want)) <= bound).all()


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("bucket", [64, 512, 100])
def test_dequantize_plain_matches_pallas_kernel(bucket, bits):
    """B4 on a packed payload (3 buckets, one row) against the Pallas
    kernel on the same codes unpacked."""
    codes, q, mn, unit = _payload(bits, bucket, 3, 1, bits * bucket)
    out = kernels.maxmin_dequantize(torch.from_numpy(q), torch.from_numpy(mn),
                                    torch.from_numpy(unit), bits, bucket)
    want = pk.maxmin_dequantize_pallas(jnp.asarray(codes), jnp.asarray(mn),
                                       jnp.asarray(unit), bucket, True)
    _assert_one_fma_apart(out.numpy(), want, codes, unit)


@pytest.mark.parametrize("bits,bucket", [(1, 100), (2, 64), (4, 100),
                                         (8, 64)])
def test_dequantize_rows_plain_matches_pallas_kernel(bits, bucket):
    """A ``compress_rows`` payload of 4 rows whose length (150) is not a
    multiple of the bucket: each row packed on its own (at 1 bit and
    buckets of 100 a row ends inside a byte)."""
    rows = _data(4 * 150, bits + bucket).reshape(4, 150)
    quant = MaxMinQuantizer(bits, bucket)
    payload, ctx = quant.compress_rows(torch.from_numpy(rows))
    per_row = -(-150 // bucket)
    assert payload["q"].shape == (4, -(-per_row * bucket * bits // 8))
    codes = np.concatenate([
        np.asarray(jax_unpack(jnp.asarray(r.numpy()), bits, per_row * bucket))
        for r in payload["q"]]).reshape(-1, bucket)
    mn, unit = payload["min"].reshape(-1), payload["unit"].reshape(-1)
    out = kernels.maxmin_dequantize(payload["q"], mn, unit, bits, bucket)
    want = pk.maxmin_dequantize_pallas(jnp.asarray(codes),
                                       jnp.asarray(mn.numpy()),
                                       jnp.asarray(unit.numpy()), bucket,
                                       True)
    _assert_one_fma_apart(out.numpy(), want, codes, unit.numpy())
    np.testing.assert_array_equal(
        quant.decompress_rows(payload, ctx).numpy(),
        out.view(4, -1)[:, :150].numpy())


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("bucket", [64, 512, 100])
@pytest.mark.parametrize("n_ranks", [1, 2, 4])
def test_dequantize_sum_plain_matches_pallas_kernel(n_ranks, bucket, bits):
    """B3 on every rank's packed row against the Pallas kernel on the same
    codes unpacked, within the two summation orders' rounding (module
    docstring); at 4 bits and buckets of 64 on the 5 buckets a rank this
    test had before the payload was packed, also within rtol 1e-5."""
    if (bits, bucket) == (4, 64):
        rng = np.random.RandomState(n_ranks)
        codes = rng.randint(0, 16, (n_ranks, 5, 64)).astype(np.uint8)
        mn = rng.randn(n_ranks, 5).astype(np.float32)
        unit = np.abs(rng.randn(n_ranks, 5)).astype(np.float32) / 15
    else:
        rng = np.random.RandomState(n_ranks * bucket + bits)
        codes = rng.randint(0, 1 << bits, (n_ranks, 2, bucket)).astype(
            np.uint8)
        mn = rng.randn(n_ranks, 2).astype(np.float32)
        unit = (np.abs(rng.randn(n_ranks, 2)) / ((1 << bits) - 1)).astype(
            np.float32)
    q = _packed(codes.reshape(n_ranks, -1), bits)
    out = kernels.maxmin_dequantize_sum(torch.from_numpy(q),
                                        torch.from_numpy(mn),
                                        torch.from_numpy(unit), bits, bucket)
    want = np.asarray(pk.maxmin_dequantize_sum_pallas(
        jnp.asarray(codes), jnp.asarray(mn), jnp.asarray(unit), True))
    # q * unit is exact in float64 (8 bits times 24).
    magnitude = (np.abs(mn[:, :, None].astype(np.float64)) +
                 codes * unit[:, :, None].astype(np.float64)).sum(0)
    bound = 2 * (n_ranks + 2) * 2.0**-24 * magnitude
    assert (np.abs(out.numpy().astype(np.float64) - want) <= bound).all()
    if (bits, bucket) == (4, 64):
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-5)


def _unpack_then_decode(payload, ctx, rows):
    """The decode the packed one replaces: ``unpack_bits`` of the payload,
    then ``min + q * unit`` per bucket (B4's plain formula), as
    ``[rows, padded]``."""
    padded = -(-ctx.count // ctx.bucket_size) * ctx.bucket_size
    q = unpack_bits(payload["q"].reshape(rows, -1), ctx.bits, padded)
    q = q.reshape(-1, ctx.bucket_size).to(torch.float32)
    mn, unit = payload["min"].reshape(-1), payload["unit"].reshape(-1)
    return (mn[:, None] + q * unit[:, None]).view(rows, padded)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("bucket", [64, 512, 100])
def test_packed_decode_is_the_unpacked_decode(bucket, bits):
    """``decompress``, ``decompress_rows`` and the reducers' B3 path
    (``_dequant_sum_stacked``: 3 ranks' payloads, stacked as an allgather
    stacks them) bitwise against unpacking first; with a constant bucket,
    a NaN and an inf."""
    from horovod_tpu_torch.compression.reducers import _dequant_sum_stacked

    quant = MaxMinQuantizer(bits, bucket)
    x = _data(2 * bucket + 37, bits * bucket, constant_bucket=bucket)
    x[bucket + 3], x[-1] = np.nan, np.inf
    payload, ctx = quant.compress(torch.from_numpy(x))
    want = _unpack_then_decode(payload, ctx, 1)[0, :ctx.count]
    torch.testing.assert_close(quant.decompress(payload, ctx), want, rtol=0,
                               atol=0, equal_nan=True)

    rows = torch.from_numpy(_data(3 * 150, bits + 7).reshape(3, 150))
    payload, ctx = quant.compress_rows(rows)
    want = _unpack_then_decode(payload, ctx, 3)[:, :ctx.count]
    assert torch.equal(quant.decompress_rows(payload, ctx), want)

    ranks = [quant.compress(torch.from_numpy(_data(333, seed)))
             for seed in range(3)]
    gathered = {k: torch.stack([p[k] for p, _ in ranks]) for k in ranks[0][0]}
    ctx = ranks[0][1]
    decoded = _unpack_then_decode(gathered, ctx, 3)[:, :ctx.count]
    want = torch.zeros(ctx.count)
    for r in range(3):
        want = want + decoded[r]
    assert torch.equal(_dequant_sum_stacked(quant, gathered, ctx, 3), want)


def test_decode_checks_the_payload():
    """B3 and B4 refuse a payload whose rows do not hold exactly the packed
    codes of their buckets, and buckets that do not fill the rows."""
    q = torch.zeros(2, 16, dtype=torch.uint8)  # 2 rows of 2 x 64 at 1 bit
    mn = torch.zeros(4)
    assert kernels.maxmin_dequantize(q, mn, mn, 1, 64).shape == (4, 64)
    with pytest.raises(ValueError, match="must hold 32 bytes"):
        kernels.maxmin_dequantize(q, mn, mn, 2, 64)
    with pytest.raises(ValueError, match="do not fill"):
        kernels.maxmin_dequantize(q, mn[:3], mn[:3], 1, 64)
    with pytest.raises(ValueError, match="must agree"):
        kernels.maxmin_dequantize_sum(q, mn[None], mn[None], 1, 64)
    assert kernels.maxmin_dequantize_sum(
        q, mn.view(2, 2), mn.view(2, 2), 1, 64).shape == (2, 64)


def test_error_feedback_matches_jax():
    x = _data(1000, 11)
    res = _data(1000, 12) * 0.01
    payload, ctx, new_res = compress_with_feedback(
        MaxMinQuantizer(4, 64), torch.from_numpy(x), torch.from_numpy(res))
    want, _, want_res = jax_feedback(JaxMaxMin(4, 64, use_pallas=False),
                                     jnp.asarray(x), jnp.asarray(res))
    np.testing.assert_array_equal(payload["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(new_res.numpy(), np.asarray(want_res))


def test_compress_rows_quantizes_each_row_alone():
    """The row form equals compressing each row on its own (jax.vmap)."""
    rows = _data(3 * 100, 5).reshape(3, 100)
    quant = MaxMinQuantizer(2, 64)
    payload, ctx = quant.compress_rows(torch.from_numpy(rows))
    for r in range(3):
        want, _ = JaxMaxMin(2, 64, use_pallas=False).compress(
            jnp.asarray(rows[r]))
        for k in ("q", "min", "unit"):
            np.testing.assert_array_equal(payload[k][r].numpy(),
                                          np.asarray(want[k]))
    back = quant.decompress_rows(payload, ctx)
    for r in range(3):
        one = {k: v[r] for k, v in payload.items()}
        np.testing.assert_array_equal(back[r].numpy(),
                                      quant.decompress(one, ctx).numpy())


def test_stochastic_waits_for_b2():
    """Stochastic compress runs (B2's plain version on the CPU) and is
    seeded: a key fixes the codes, another key changes them, and no key is
    seed 0 (``tests/test_torch_port_stochastic.py`` holds the rest)."""
    x = torch.from_numpy(_data(3 * 512 + 5, 8))
    quant = MaxMinQuantizer(4, 512, stochastic=True)
    codes = [quant.compress(x, key=k)[0]["q"] for k in (1, 1, 2, None, 0)]
    assert torch.equal(codes[0], codes[1])
    assert not torch.equal(codes[0], codes[2])
    assert torch.equal(codes[3], codes[4])
    assert not torch.equal(codes[0], MaxMinQuantizer(4, 512).compress(x)[0][
        "q"])


@pytest.mark.parametrize("ratio", [0.01, 0.1, 1.0])
@pytest.mark.parametrize("n", [1, 100, 1001])
def test_topk_matches_jax(n, ratio):
    """Distinct magnitudes, so both packages keep the same entries; the
    order of the kept entries is compared after sorting by index."""
    x = np.random.RandomState(n).permutation(n).astype(np.float32) - n / 2
    x += 0.25  # no zero, no tie in |x|
    quant = TopKCompressor(ratio)
    payload, ctx = quant.compress(torch.from_numpy(x.reshape(-1, 1)))
    want, want_ctx = JaxTopK(ratio).compress(jnp.asarray(x.reshape(-1, 1)))
    order = np.argsort(payload["indices"].numpy())
    want_order = np.argsort(np.asarray(want["indices"]))
    assert payload["indices"].dtype == torch.int32
    np.testing.assert_array_equal(payload["indices"].numpy()[order],
                                  np.asarray(want["indices"])[want_order])
    np.testing.assert_array_equal(payload["values"].numpy()[order],
                                  np.asarray(want["values"])[want_order])
    np.testing.assert_array_equal(
        quant.decompress(payload, ctx).numpy(),
        np.asarray(JaxTopK(ratio).decompress(want, want_ctx)))
    assert compressed_size_bytes(payload) == 8 * max(1, int(n * ratio))


def test_topk_rows_and_identity():
    rows = np.random.RandomState(2).randn(3, 50).astype(np.float32)
    quant = TopKCompressor(0.1)
    payload, ctx = quant.compress_rows(torch.from_numpy(rows))
    back = quant.decompress_rows(payload, ctx)
    for r in range(3):
        one, _ = quant.compress(torch.from_numpy(rows[r]))
        np.testing.assert_array_equal(back[r].numpy(),
                                      quant.decompress(one, ctx).numpy())
    assert quant == TopKCompressor(0.1) != TopKCompressor(0.2)
    with pytest.raises(ValueError):
        TopKCompressor(0.0)
