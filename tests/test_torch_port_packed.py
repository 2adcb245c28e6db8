"""The packed routes of B2 and B5 (``csrc/bucket_groups.cuh``,
``csrc/maxmin.cu``, ``csrc/norm.cu``): what the kernels promise, held on
the CPU through emulations used only here, and on the card against the
plain versions.

* B5 finds the nearest level of a strictly descending, finite table by
  bisection and a walk left along equal rounded distances
  (``nearest_levels<true>`` in ``norm.cu``). :func:`_bisect` repeats those
  steps in fp32 torch arithmetic; it must equal the scan
  (``norm_kernels.nearest_level_plain``, the strict-< running argmin)
  bitwise on every ratio: at, just above and just below each level, at and
  beside each midpoint, NaN and the infinities, below every level of a
  table whose levels lie closer than an ulp of their distance (a long walk
  left), on 1- to 128-entry tables, and on a hypothesis sweep.
* The host's table check (``norm_kernels.searchable``, made once by
  ``norm_kernels.LevelTable``): the uniform and exponential tables take
  bisection; an unsorted table, one with equal neighbours or one that is
  not finite takes the scan.
* The route rule (``kernels.packed_route``): buckets of a multiple of 8 up
  to 2048 values pack, at any address; others take the byte-code route.
* The hard divisors of ``chip_smoke.hard_divisors``: their table pins every
  quotient to the ulp, so a division one ulp off (``hvd_groups::divide``
  against ``__fdiv_rn``) changes a code.
* The packed layout: 8 codes in ``bits`` bytes, LSB first (:func:`_pack`,
  ``store_packed`` in ``bucket_groups.cuh``), equals ``pack_bits`` at 1, 2,
  4 and 8 bits, flat and row by row.
* B3 and B4 read that layout back (``maxmin_decode_packed_kernel`` and
  ``maxmin_decode_generic_kernel`` in ``maxmin.cu``): :func:`_decode_packed`
  repeats the packed route's lane, group and half-group indexing and
  :func:`_decode_generic` the generic route's byte and shift of each code;
  both must give ``unpack_bits`` of every row, the packed one writing each
  output value exactly once.

The tests marked ``cuda`` run on the card (``python -m pytest --noconftest
-m cuda tests/test_torch_port_packed.py``) and skip elsewhere: every route
of B2 and B5 is bitwise against ``pack_bits`` of the plain codes (B5 with
l2 within the midpoint contract of ``test_torch_port_norm.py``) and
reports the route its input asks for, and B5's codes of the hard divisors
are bitwise.
"""

import importlib.util
import inspect
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from horovod_tpu_torch.compression import (MaxMinQuantizer,
                                           NormalizedQuantizer, kernels,
                                           norm_kernels, quantize)
from horovod_tpu_torch.compression.quantize import (default_levels,
                                                    pack_bits, unpack_bits)

F32 = np.float32


MAX_LEVELS = 128


def _bisect(ratio: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """``nearest_levels<true>`` of ``norm.cu``, element by element, on the
    table as ``load_padded_levels`` lays it out (+inf before the levels,
    -inf after them up to 255 entries): the length k of the prefix of
    levels above the ratio by the steps ``top, top / 2, ..., 1``, then k if
    strictly nearer than k - 1, else the first of the run of equal
    distances that ends at k - 1; 0 where k is 0."""
    n_levels = levels.shape[0]
    padded = torch.cat([torch.tensor([np.inf], dtype=torch.float32), levels,
                        torch.full((2 * MAX_LEVELS - 1 - n_levels,),
                                   -np.inf)])

    def lv(i):  # lv[i] of the kernel
        return padded[i + 1]

    def dist(i):
        return (ratio - lv(i)).abs()

    top = 1 << (n_levels.bit_length() - 1)
    k = torch.zeros(ratio.shape, dtype=torch.int64)
    step = MAX_LEVELS
    while step:
        if step <= top:
            k = k + torch.where(lv(k + step - 1) > ratio, step, 0)
        step >>= 1
    left = dist(k - 1)
    right = dist(k) < left
    best = torch.where(right, k, k - 1)
    while True:
        walk = ~right & (best > 0) & (dist(best - 1) == left)
        if not walk.any():
            break
        best = torch.where(walk, best - 1, best)
    return torch.where(k == 0, 0, best)


def _probes(table: np.ndarray) -> np.ndarray:
    """Each level, its fp32 neighbours, the midpoints of neighbouring
    levels and theirs, NaN, the infinities, 0, 1 and 2."""
    up = np.nextafter(table, F32(np.inf))
    down = np.nextafter(table, F32(-np.inf))
    mid = ((table[1:] + table[:-1]) / F32(2)).astype(F32)
    return np.concatenate([
        table, up, down, mid, np.nextafter(mid, F32(np.inf)),
        np.nextafter(mid, F32(-np.inf)),
        np.array([np.nan, np.inf, -np.inf, 0, 1, 2], F32)]).astype(F32)


def _assert_bisect_is_scan(table: np.ndarray, ratio: np.ndarray) -> None:
    levels = torch.from_numpy(np.ascontiguousarray(table, F32))
    r = torch.from_numpy(np.ascontiguousarray(ratio, F32))
    want = norm_kernels.nearest_level_plain(r, levels).to(torch.int64)
    np.testing.assert_array_equal(_bisect(r, levels).numpy(), want.numpy())


TABLES = {f"{kind}{bits}": default_levels(bits, kind)
          for kind in ("uni", "exp") for bits in (2, 4, 8)}
# Distinct small levels whose distances from a ratio near 1/2 round equal.
TABLES["tiny"] = np.array([1, 2.0**-30, 2.0**-31, 2.0**-32, 0], F32)
# 128 levels one ulp apart: from any ratio below them, every distance
# rounds to the same few values, so the first minimum is far left of k.
TABLES["ulp-apart"] = np.array([1 - i * 2.0**-24 for i in range(128)], F32)
TABLES["single"] = np.array([0.5], F32)


@pytest.mark.parametrize("name", sorted(TABLES))
def test_bisection_is_the_scan(name):
    table = TABLES[name]
    assert norm_kernels.searchable(table)
    probes = _probes(table)
    _assert_bisect_is_scan(table, np.concatenate([
        probes, (probes * F32(3)).astype(F32), np.array(
            [-5, -0.5, 0.25, 0.5 - 2.0**-25], F32)]))


def test_ties_walk_left():
    """The cases the walk exists for, with their first minima: a ratio
    below a run of levels one ulp apart, and a ratio at a midpoint."""
    table = TABLES["ulp-apart"]
    levels = torch.from_numpy(table)
    r = torch.tensor([-5.0, 0.5 - 2.0**-25])
    want = norm_kernels.nearest_level_plain(r, levels).to(torch.int64)
    got = _bisect(r, levels)
    assert torch.equal(got, want)
    assert int(got[0]) < 127  # the walk went left of k - 1 = 127
    mid = torch.tensor([0.5], dtype=torch.float32)
    assert int(_bisect(mid, torch.tensor([1.0, 0.0]))[0]) == 0


@settings(database=None, deadline=None, max_examples=150)
@given(st.lists(st.floats(-4, 4, width=32, allow_subnormal=True),
                min_size=1, max_size=128, unique=True),
       st.lists(st.floats(width=32, allow_nan=True, allow_infinity=True),
                min_size=1, max_size=64))
def test_bisection_is_the_scan_on_any_table(levels, ratios):
    table = np.sort(np.array(levels, F32))[::-1].copy()
    if not norm_kernels.searchable(table):  # -0.0 and 0.0 are not distinct
        return
    _assert_bisect_is_scan(table, np.concatenate(
        [np.array(ratios, F32), _probes(table)]))


@pytest.mark.parametrize("table,search", [
    (default_levels(2, "uni"), True), (default_levels(4, "uni"), True),
    (default_levels(8, "uni"), True), (default_levels(4, "exp"), True),
    (default_levels(8, "exp"), True), ([1, 0.25, 0.5, 0], False),
    ([1, 0.5, 0.5, 0], False), ([1, np.nan, 0], False),
    ([np.inf, 0.5, 0], False), ([1, 0], True)])
def test_table_check(table, search):
    assert norm_kernels.searchable(np.array(table, F32)) is search


def test_quantizer_checks_the_user_table(user_levels):
    """``set_quantization_levels`` takes any order; the quantizer's cached
    table says which search B5 may use."""
    quant = NormalizedQuantizer(4, 64)
    assert quant._table(torch.device("cpu")).search is True
    quantize.set_quantization_levels([1.0, 0.25, 0.5, 0.0])
    assert quant._table(torch.device("cpu")).search is False
    quantize.set_quantization_levels([1.0, 0.5, 0.5, 0.0])
    assert quant._table(torch.device("cpu")).search is False


@pytest.mark.parametrize("table,search", [
    ([1, 0.5, 0.25, 0], True), ([1, 0.25, 0.5, 0], False),
    ([1, 0.5, 0.5, 0], False)])
def test_level_table_makes_its_own_claim(table, search):
    """Only ``LevelTable`` says a table may be bisected, and it checks the
    table to say so; ``norm_quantize`` has no way to be told otherwise."""
    made = norm_kernels.LevelTable(table, torch.device("cpu"))
    assert made.search is search
    np.testing.assert_array_equal(made.levels.numpy(), np.array(table, F32))
    assert made.levels.dtype == torch.float32
    assert "search" not in inspect.signature(
        norm_kernels.norm_quantize).parameters
    x = torch.linspace(-1, 1, 100)
    for given in (made, made.levels):
        q, nrm = norm_kernels.norm_quantize(x, given, 64, False, bits=4)
        want = norm_kernels.norm_quantize_plain(x, made.levels, 64, False)
        assert torch.equal(q, want[0]) and torch.equal(nrm, want[1])


@pytest.fixture
def user_levels():
    yield
    quantize._user_levels.clear()


@pytest.mark.parametrize("bucket,packed", [
    (512, True), (64, True), (256, True), (2048, True), (8, True),
    (125, False), (2056, False), (12, False), (1, False), (16, True),
    (2040, True)])
def test_route_rule(bucket, packed):
    """The rule both wrappers use to size their output, the one
    ``packed_groups_per_lane`` applies in C (the C side reports what it
    launched, and the wrapper raises where the two disagree): the bucket
    alone decides it."""
    assert kernels.packed_route(bucket) is packed


def test_route_counts_raise_on_a_disagreement():
    routes = {"packed": 0, "bytes": 0}
    kernels.count_route(routes, {1: "packed", 2: "bytes"}, 1, "packed", "B2")
    assert routes == {"packed": 1, "bytes": 0}
    with pytest.raises(RuntimeError, match="expected bytes"):
        kernels.count_route(routes, {1: "packed", 2: "bytes"}, 1, "bytes",
                            "B2")
    with pytest.raises(RuntimeError, match="route 0"):
        kernels.count_route(routes, {1: "packed", 2: "bytes"}, 0, "packed",
                            "B2")


def _pack(codes: np.ndarray, bits: int) -> np.ndarray:
    """``store_packed``: each group of 8 codes as a little-endian word of
    ``8 * bits`` bits, code t at bit ``t * bits``, cut to ``bits`` bytes."""
    groups = codes.reshape(-1, 8).astype(np.uint64)
    words = np.zeros(groups.shape[0], np.uint64)
    for t in range(8):
        words |= groups[:, t] << np.uint64(t * bits)
    return words.view(np.uint8).reshape(-1, 8)[:, :bits].reshape(-1)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("bucket", [8, 64, 512])
def test_group_packing_is_pack_bits(bits, bucket):
    """Flat, per bucket and per row of a ``compress_rows`` layout (3 rows
    of 2 buckets): the same bytes."""
    rng = np.random.RandomState(bits * bucket)
    codes = rng.randint(0, 1 << bits, 6 * bucket).astype(np.uint8)
    got = _pack(codes, bits)
    q = torch.from_numpy(codes)
    np.testing.assert_array_equal(got, pack_bits(q, bits).numpy())
    np.testing.assert_array_equal(
        got.reshape(6, -1), pack_bits(q.view(6, bucket), bits).numpy())
    np.testing.assert_array_equal(
        got.reshape(3, -1), pack_bits(q.view(3, 2 * bucket), bits).numpy())
    # What the quantizers do with codes a kernel packed, and with bytes.
    rows = torch.from_numpy(got.reshape(6, -1))
    for lead in ((), (3,)):
        np.testing.assert_array_equal(
            quantize._payload(rows, bits, bucket, *lead).numpy(),
            quantize._payload(q.view(6, bucket), bits, bucket,
                              *lead).numpy())


# What maxmin.cu's decode kernels use: a warp per bucket, kDecodeGroups
# groups a lane in flight.
WARP, DECODE_GROUPS = 32, 4


def _bucket_start(b, per_row, row_bytes, bucket, bits):
    """``bucket_codes``: the byte of bucket b's first code and its bit."""
    row = b // per_row
    first_bit = (b - row * per_row) * bucket * bits
    return row * row_bytes + first_bit // 8, first_bit % 8


def _decode_generic(flat, per_row, row_bytes, n_buckets, bucket, bits):
    """The generic route's codes: lane l on values l, l + 32, ..., code j
    at bit ``skew + j * bits`` of the bucket's first byte."""
    out = np.full((n_buckets, bucket), 255, np.int64)
    for b in range(n_buckets):
        first, skew = _bucket_start(b, per_row, row_bytes, bucket, bits)
        for lane in range(WARP):
            j = np.arange(lane, bucket, WARP)
            bit = skew + j * bits
            out[b, j] = (flat[first + bit // 8] >> (bit % 8)) & \
                ((1 << bits) - 1)
    return out


def _decode_packed(flat, per_row, row_bytes, n_buckets, bucket, bits):
    """The packed route's codes: lanes 2k and 2k + 1 load group
    ``k + 16 i`` (``bits`` bytes, little-endian) and decode its first and
    second half into values ``8 g + 4 (l % 2) + t``; returns the codes and
    how often each output value was written."""
    out = np.zeros((n_buckets, bucket), np.int64)
    writes = np.zeros((n_buckets, bucket), np.int64)
    groups = bucket // 8
    for b in range(n_buckets):
        first, _ = _bucket_start(b, per_row, row_bytes, bucket, bits)
        for lane in range(WARP):
            half = lane % 2
            for g0 in range(lane // 2, groups, WARP // 2 * DECODE_GROUPS):
                for i in range(DECODE_GROUPS):
                    g = g0 + i * WARP // 2
                    if g >= groups:
                        continue
                    at = first + g * bits
                    word = int.from_bytes(bytes(flat[at:at + bits]),
                                          "little") >> (half * 4 * bits)
                    for t in range(4):
                        v = 8 * g + 4 * half + t
                        out[b, v] = (word >> (t * bits)) & ((1 << bits) - 1)
                        writes[b, v] += 1
    return out, writes


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("bucket", [1, 3, 12, 100, 125, 8, 64, 520, 2056])
def test_decode_indexing_is_unpack_bits(bucket, bits):
    """3 rows of 2 buckets, each row ``pack_bits`` of its codes (a row of
    odd buckets can end inside a byte): both routes' indexing (the generic
    one for every bucket, the packed one where the bucket is a multiple of
    8) gives ``unpack_bits`` of each row."""
    rng = np.random.RandomState(bucket * bits)
    codes = rng.randint(0, 1 << bits, (3, 2 * bucket)).astype(np.uint8)
    rows = pack_bits(torch.from_numpy(codes), bits).numpy()
    want = unpack_bits(torch.from_numpy(rows), bits, 2 * bucket).numpy()
    args = (rows.reshape(-1), 2, rows.shape[1], 6, bucket, bits)
    np.testing.assert_array_equal(_decode_generic(*args),
                                  want.reshape(6, bucket))
    assert kernels.decode_route(bucket) == \
        ("packed" if bucket % 8 == 0 else "generic")
    if bucket % 8 == 0:
        got, writes = _decode_packed(*args)
        np.testing.assert_array_equal(got, want.reshape(6, bucket))
        assert (writes == 1).all()


def test_norm_quantize_checks_bits():
    x = torch.ones(100)
    levels = torch.from_numpy(default_levels(8, "uni"))
    with pytest.raises(ValueError, match="bits must be"):
        norm_kernels.norm_quantize(x, levels, 64, False, bits=3)
    with pytest.raises(ValueError, match="does not fit"):
        norm_kernels.norm_quantize(x, levels, 64, False, bits=4)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


def _values(n: int, bucket: int, seed: int, dev) -> torch.Tensor:
    """Unit normals with a constant first bucket, a NaN in the second and
    an inf in the third, where there is room."""
    x = torch.randn(n, generator=torch.Generator().manual_seed(seed))
    x[:bucket] = 0.5
    x[bucket + 1:bucket + 2] = float("nan")
    x[2 * bucket + 3:2 * bucket + 4] = float("inf")
    return x.to(dev)


def _at(x: torch.Tensor, offset: int) -> torch.Tensor:
    """``x`` as a view that starts ``offset`` floats into a new buffer."""
    buf = torch.zeros(x.shape[0] + offset, device=x.device)
    buf[offset:] = x
    return buf[offset:]


def _assert_equal(got, want, what):
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True,
                               msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("n,bucket", [(5001, 64), (70_001, 256),
                                      (70_001, 512), (70_001, 1024),
                                      (70_001, 2048), (3001, 125)])
def test_cuda_stochastic_routes(n, bucket, bits, offset):
    dev = _cuda()
    x = _at(_values(n, bucket, n + bits, dev), offset)
    kernels.reset_launches()
    got = kernels.maxmin_quantize_stochastic(x, bits, bucket, 2**40 + 9, 3)
    want = kernels.maxmin_quantize_stochastic_plain(x, bits, bucket,
                                                    2**40 + 9, 3)
    packed = bucket % 8 == 0  # at either address
    assert kernels.ROUTES["maxmin_quantize_stochastic"] == {
        "packed": int(packed), "bytes": int(not packed)}
    codes = pack_bits(want[0], bits) if packed else want[0]
    for g, w, what in zip(got, (codes,) + want[1:], ("q", "min", "unit")):
        _assert_equal(g, w, what)
    torch.cuda.synchronize()


def _midpoints(table: np.ndarray, n: int, bucket: int, dev) -> torch.Tensor:
    """Buckets whose largest magnitude is 1 (so the linf ratio is |x|),
    filled with the table's levels, their midpoints and the fp32
    neighbours of both, with random signs."""
    probes = _probes(table)
    probes = probes[np.isfinite(probes) & (np.abs(probes) <= 1)]
    rng = np.random.RandomState(n)
    x = rng.choice(probes, n).astype(F32) * rng.choice([-1, 1], n)
    x[::bucket] = 1.0
    return torch.from_numpy(x.astype(F32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["uni", "exp", "unsorted", "equal"])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("norm", ["linf", "l2"])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("n,bucket", [(70_001, 512), (5001, 64),
                                      (3001, 125)])
def test_cuda_norm_routes(n, bucket, bits, norm, offset, table):
    """B5 on each route: the table's order picks the search, the bucket
    packed or byte codes (at either address). The table goes in as a
    ``LevelTable`` at offset 0 and as a plain tensor, which the wrapper
    checks itself, at offset 1. linf codes and norms bitwise;
    l2 norms within rtol 1e-6 and codes within the midpoint contract (one
    level value apart, same sign, at most 1 in 1000)."""
    dev = _cuda()
    size = 1 << (bits - 1)
    levels = {"uni": default_levels(bits, "uni"),
              "exp": default_levels(bits, "exp"),
              "unsorted": np.roll(default_levels(bits, "uni"), 1),
              "equal": np.repeat(default_levels(bits, "uni")[::2], 2)[:size]
              }[table].astype(F32)
    search = norm_kernels.searchable(levels)
    assert search is (table in ("uni", "exp"))
    x = _midpoints(levels, n, bucket, dev) if norm == "linf" else \
        _values(n, bucket, n + bits, dev)
    x = _at(x, offset)
    lv = torch.from_numpy(levels).to(dev)
    norm_kernels.reset_launches()
    given = norm_kernels.LevelTable(levels, dev) if offset == 0 else lv
    q, nrm = norm_kernels.norm_quantize(x, given, bucket, norm == "l2", bits)
    packed = bucket % 8 == 0
    route = ("packed_search" if search else "packed_scan") if packed \
        else "bytes"
    assert norm_kernels.ROUTES["norm_quantize"][route] == 1
    wq, wnrm = norm_kernels.norm_quantize_plain(x, lv, bucket, norm == "l2")
    codes = unpack_bits(q, bits, bucket) if packed else q
    if norm == "linf":
        _assert_equal(nrm, wnrm, "norm")
        _assert_equal(q, pack_bits(wq, bits) if packed else wq, "codes")
    else:
        torch.testing.assert_close(nrm, wnrm, rtol=1e-6, atol=0,
                                   equal_nan=True)
        assert torch.equal(codes & 1, wq & 1)
        # Steps between level values: a table that is unsorted or repeats
        # a level puts neighbouring values at distant indices.
        distinct = torch.unique(lv)
        step = (torch.searchsorted(distinct, lv[(codes >> 1).long()]) -
                torch.searchsorted(distinct, lv[(wq >> 1).long()])).abs()
        assert int(step.max()) <= 1
        assert int((step > 0).sum()) <= max(1, wq.numel() // 1000)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [
    NormalizedQuantizer(4, 512), NormalizedQuantizer(8, 256, "exp"),
    MaxMinQuantizer(4, 512, stochastic=True),
    MaxMinQuantizer(1, 64, stochastic=True),
    MaxMinQuantizer(2, 125, stochastic=True)])
def test_cuda_payloads_equal_the_cpu_ones(quant):
    """``compress`` and ``compress_rows`` on the card give the CPU's packed
    payload (linf norms, Philox noise: bitwise)."""
    dev = _cuda()
    x = torch.randn(7, 3001, generator=torch.Generator().manual_seed(5))
    for form in ("compress", "compress_rows"):
        arg = x if form == "compress_rows" else x[2]
        got, _ = getattr(quant, form)(arg.to(dev), key=11)
        want, _ = getattr(quant, form)(arg, key=11)
        for name in want:
            _assert_equal(got[name].cpu(), want[name], f"{form} {name}")


# ---------------------------------------------------------------------------
# hard divisors (chip_smoke.hard_divisors)
# ---------------------------------------------------------------------------

def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# The (bucket, seed) pairs chip_smoke.check_norm codes.
HARD_CASES = [(64, 64), (64, 65), (512, 512), (512, 513)]


@pytest.mark.parametrize("bucket,seed", HARD_CASES)
def test_hard_divisors_pin_every_quotient(bucket, seed):
    """Each bucket's linf norm is its divisor; every quotient of a value
    fl(q d) lands exactly on a level of the (strictly descending) table,
    and so does each of its fp32 neighbours, at another index: a quotient
    one ulp off gives another code. Zeros, the divisor itself and the
    values below 2^-40 d are the only ones left unpinned."""
    smoke = _chip_smoke()
    x, table = smoke.hard_divisors(bucket, seed)
    assert x.dtype == table.dtype == F32
    assert norm_kernels.searchable(table) and table.shape[0] <= MAX_LEVELS
    buckets = torch.from_numpy(x).view(-1, bucket)
    divisors = torch.tensor([np.ldexp(s, e) for s in smoke.HARD_SIGNIFICANDS
                             for e in smoke.HARD_EXPONENTS],
                            dtype=torch.float32)
    norm = buckets.abs().amax(dim=1, keepdim=True)
    assert torch.equal(norm[:, 0], divisors)
    assert bool((divisors > 2.0**40).any() and (divisors < 2.0**-40).any())
    ratio = buckets.abs() / norm  # IEEE division on the CPU
    levels = torch.from_numpy(table)
    idx = norm_kernels.nearest_level_plain(ratio, levels).long()
    pinned = (ratio > 2.0**-20) & (ratio < 1)
    assert float(pinned.float().mean()) > 0.9
    assert torch.equal(levels[idx][pinned], ratio[pinned])
    for direction in (np.inf, -np.inf):
        off = norm_kernels.nearest_level_plain(
            torch.nextafter(ratio, torch.tensor(direction)), levels).long()
        assert bool((off != idx)[pinned].all())


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("bucket,seed", HARD_CASES)
def test_cuda_hard_divisors(bucket, seed, offset):
    """B5's codes of the hard divisors bitwise against ``pack_bits`` of the
    plain codes: every pinned quotient of the card's division is the IEEE
    quotient."""
    dev = _cuda()
    x, table = _chip_smoke().hard_divisors(bucket, seed)
    x = _at(torch.from_numpy(x).to(dev), offset)
    lv = norm_kernels.LevelTable(table, dev)
    norm_kernels.reset_launches()
    q, nrm = norm_kernels.norm_quantize(x, lv, bucket, False, 8)
    assert norm_kernels.ROUTES["norm_quantize"]["packed_search"] == 1
    wq, wnrm = norm_kernels.norm_quantize_plain(x, lv.levels, bucket, False)
    _assert_equal(nrm, wnrm, "norm")
    _assert_equal(q, pack_bits(wq, 8), "codes")
