"""Guards of the port: it imports no JAX, it never falls back to the CPU on
its own, and its kernel wrappers refuse tensors they cannot serve. The tests
marked ``cuda`` hold each CUDA kernel against its plain version on the card
(``python -m pytest --noconftest -m cuda tests/test_torch_port_guards.py``
on a machine with an NVIDIA GPU); elsewhere they skip.

Tolerances of the attention kernels on the card, whose kernels and plain
versions both compute in fp32 from the same unit-normal inputs: fp32
forward within 1e-4 of the largest reference value (taken as at least 1),
fp32 backward within 5e-4 of it. bf16 outputs are held element by element:
both sides round an fp32 value to bf16 and may land one bf16 step apart,
at most 2^-7 of the value; to that come 2^-8 of the mean |value| and 2^-14
for values near zero, where the fp32 sums differ by more than a bf16 step
of the value (at S = 1, dK and dQ are zero in exact arithmetic and rounding
noise in both). bf16 B7, B8 and B9 run on the tensor cores, which round P
and dS to bf16 before their products: their ``o``, dK, dV and dQ also get
``mma_rounding_terms`` (``tests/test_torch_flash_rounding.py`` derives it)."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch.compression import kernels, norm_kernels
from horovod_tpu_torch.utils import cuda_build
from horovod_tpu_torch.compression.quantize import default_levels, pack_bits
from horovod_tpu_torch.ops import flash_attention as flash
from horovod_tpu_torch.exceptions import NotInitializedError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in _FORBIDDEN


def test_import_pulls_in_no_jax():
    from conftest import subprocess_env
    code = ("import sys\n"
            "import horovod_tpu_torch\n"
            "import horovod_tpu_torch.models.convert\n"
            "import horovod_tpu_torch.checkpoint\n"
            "import horovod_tpu_torch.compression.ab\n"
            "import horovod_tpu_torch.compression.powersgd\n"
            "import horovod_tpu_torch.models.inception\n"
            "import horovod_tpu_torch.models.mlp\n"
            "import horovod_tpu_torch.models.vgg\n"
            "import horovod_tpu_torch.compression.kernels\n"
            "import horovod_tpu_torch.compression.norm_kernels\n"
            "import horovod_tpu_torch.compression.quantize\n"
            "import horovod_tpu_torch.compression.config\n"
            "import horovod_tpu_torch.models.gpt\n"
            "import horovod_tpu_torch.models.encoder\n"
            "import horovod_tpu_torch.models.transformer\n"
            "import horovod_tpu_torch.ops.flash_attention\n"
            "import horovod_tpu_torch.ops.remat\n"
            "import horovod_tpu_torch.ops.spmd\n"
            "import horovod_tpu_torch.parallel.adasum\n"
            "import horovod_tpu_torch.parallel.axes\n"
            "import horovod_tpu_torch.parallel.moe\n"
            "import horovod_tpu_torch.parallel.pipeline\n"
            "import horovod_tpu_torch.parallel.ring_attention\n"
            "import horovod_tpu_torch.parallel.sharded_optimizer\n"
            "import horovod_tpu_torch.parallel.strategy\n"
            "import horovod_tpu_torch.parallel.sync_batch_norm\n"
            "import horovod_tpu_torch.parallel.ulysses\n"
            "import horovod_tpu_torch.basics\n"
            "import horovod_tpu_torch.ops.dispatch\n"
            "import horovod_tpu_torch.utils.native_build\n"
            "import horovod_tpu_torch.runner\n"
            "import horovod_tpu_torch.runner.hosts\n"
            "import horovod_tpu_torch.runner.safe_exec\n"
            "import horovod_tpu_torch.runner.http_kv\n"
            "import horovod_tpu_torch.runner.preflight\n"
            "import horovod_tpu_torch.runner.launch\n"
            "import horovod_tpu_torch.runner.task_runner\n"
            "import horovod_tpu_torch.runner.elastic\n"
            "import horovod_tpu_torch.runner.elastic.discovery\n"
            "import horovod_tpu_torch.runner.elastic.registration\n"
            "import horovod_tpu_torch.runner.elastic.driver\n"
            "import horovod_tpu_torch.elastic\n"
            "import horovod_tpu_torch.elastic.state\n"
            "import horovod_tpu_torch.elastic.torch_state\n"
            "import horovod_tpu_torch.observability\n"
            "import horovod_tpu_torch.flightrec\n"
            "import horovod_tpu_torch.perfstats\n"
            "import horovod_tpu_torch.gradstats\n"
            "import horovod_tpu_torch.profiler\n"
            "import horovod_tpu_torch.trace_analysis\n"
            "import horovod_tpu_torch.postmortem\n"
            "import horovod_tpu_torch.runner.metrics_agg\n"
            "import horovod_tpu_torch.runner.hvdtop\n"
            "import horovod_tpu_torch.torch\n"
            "import horovod_tpu_torch.torch.sync_batch_norm\n"
            "import horovod_tpu_torch.torch.estimator\n"
            "import horovod_tpu_torch.spark\n"
            "import horovod_tpu_torch.spark.store\n"
            "import horovod_tpu_torch.spark.pandas_df\n"
            "import horovod_tpu_torch.spark.fit_dispatch\n"
            "import horovod_tpu_torch.spark.util\n"
            "import horovod_tpu_torch.spark.elastic\n"
            "import horovod_tpu_torch.integrations\n"
            "import horovod_tpu_torch.integrations.estimator\n"
            "import horovod_tpu_torch.integrations.executor\n"
            "import horovod_tpu_torch.integrations.ray\n"
            "horovod_tpu_torch.spark.Estimator\n"
            "horovod_tpu_torch.spark.TorchEstimator\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{_FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], env=subprocess_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", ["chip_smoke.py", "horovod_tpu_torch"])
def test_sources_import_no_jax(path):
    full = os.path.join(REPO, path)
    files = [full] if full.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(full) for f in fs
        if f.endswith(".py")]
    if not full.endswith(".py"):
        # Every module of the package, the ones added later included.
        names = {os.path.relpath(f, full) for f in files}
        assert {"models/gpt.py", "models/transformer.py",
                "ops/flash_attention.py", "utils/cuda_build.py",
                "compression/kernels.py", "compression/norm_kernels.py",
                "compression/quantize.py", "compression/config.py",
                "compression/reducers.py", "parallel/adasum.py",
                "parallel/axes.py", "parallel/sharded_optimizer.py",
                "parallel/strategy.py", "parallel/sync_batch_norm.py",
                "basics.py", "ops/dispatch.py", "utils/native_build.py",
                "runner/hosts.py", "runner/safe_exec.py",
                "runner/http_kv.py", "runner/preflight.py",
                "runner/launch.py", "runner/task_runner.py",
                "runner/elastic/discovery.py",
                "runner/elastic/registration.py",
                "runner/elastic/driver.py", "elastic/state.py",
                "elastic/torch_state.py", "observability.py",
                "flightrec.py", "perfstats.py", "gradstats.py",
                "profiler.py", "trace_analysis.py", "postmortem.py",
                "runner/metrics_agg.py", "runner/hvdtop.py",
                "torch/__init__.py", "torch/sync_batch_norm.py",
                "torch/estimator.py", "spark/__init__.py", "spark/store.py",
                "spark/pandas_df.py", "spark/fit_dispatch.py",
                "spark/util.py", "spark/elastic.py",
                "integrations/__init__.py", "integrations/estimator.py",
                "integrations/executor.py", "integrations/ray.py"} <= names, \
            names
    for f in files:
        with open(f) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            assert not any(_forbidden(n) for n in names), (f, names)


def test_init_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        thvd.init()
    assert not thvd.is_initialized()


def test_process_mode_without_its_core_raises(monkeypatch, tmp_path):
    """init(mode="process") raises when the native core cannot be loaded,
    and the runtime stays down: no world without the core, and no
    torch.distributed group in its place."""
    from horovod_tpu_torch import basics
    monkeypatch.setattr(basics, "_lib", None)  # no library loaded yet
    monkeypatch.setattr(basics, "_library_path",
                        lambda: str(tmp_path / "missing.so"))
    with pytest.raises(NotInitializedError, match="native core"):
        thvd.init(mode="process", device="cpu")
    assert not thvd.is_initialized()
    assert not torch.distributed.is_initialized()


def test_process_mode_whose_core_fails_to_build_raises(monkeypatch):
    """As above, when the core's sources do not compile."""
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.utils import native_build

    def fail():
        raise RuntimeError("g++ failed on core.cpp")

    monkeypatch.setattr(basics, "_lib", None)
    monkeypatch.setattr(native_build, "build", fail)
    with pytest.raises(NotInitializedError, match="g\\+\\+ failed"):
        thvd.init(mode="process", device="cpu")
    assert not thvd.is_initialized()
    assert not torch.distributed.is_initialized()


def test_topology_on_the_cpu():
    with pytest.raises(NotInitializedError):
        thvd.rank()
    thvd.init(device="cpu")
    try:
        assert (thvd.rank(), thvd.size(), thvd.local_rank(),
                thvd.local_size()) == (0, 1, 0, 1)
        assert thvd.device() == torch.device("cpu")
        x = torch.arange(6.0)
        np.testing.assert_array_equal(thvd.allreduce(x).numpy(), x.numpy())
        np.testing.assert_array_equal(thvd.broadcast(x, 0).numpy(),
                                      x.numpy())
        outs = thvd.grouped_allreduce([x, torch.ones(2, 2)], op=thvd.Sum,
                                      postscale_factor=2.0)
        np.testing.assert_array_equal(outs[1].numpy(), np.full((2, 2), 2.0))
    finally:
        thvd.shutdown()


def _meta_args(name):
    m = dict(device="meta")
    if name.startswith("flash"):
        x = torch.empty(2, 8, 16, **m)
        stats = torch.empty(2, 8, **m)
        if name == "flash_fwd":
            return (x, x, x, 0.25, True)
        return (x, x, x, x, stats, stats, 0.25, True)
    if name == "maxmin_quantize":
        return (torch.empty(100, **m), 4, 64)
    if name == "maxmin_quantize_stochastic":
        return (torch.empty(100, **m), 4, 64, 7)
    q = torch.empty(2, 64, dtype=torch.uint8, **m)
    v = torch.empty(2, **m)
    levels = torch.empty(8, **m)
    if name == "norm_quantize":
        return (torch.empty(100, **m), levels, 64, False)
    if name == "norm_dequantize":
        return (q, levels, v)
    if name == "maxmin_dequantize":  # 2 rows of one bucket of byte codes
        return (q, v, v, 8, 64)
    return (q, v[:, None], v[:, None], 8, 64)  # 2 ranks of one bucket


_MODULES = {**{n: kernels for n in kernels.LAUNCHES},
            **{n: norm_kernels for n in norm_kernels.LAUNCHES},
            **{n: flash for n in flash.LAUNCHES}}


@pytest.mark.parametrize("name", sorted(_MODULES))
def test_wrappers_refuse_other_devices(name):
    """A tensor that is neither on the CPU nor on CUDA raises; it is never
    handed to the plain version."""
    with pytest.raises(ValueError, match="meta"):
        getattr(_MODULES[name], name)(*_meta_args(name))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


def _assert_bitwise(got, want):
    """Equal values, and NaN exactly where the other has NaN."""
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("n,bucket", [(1, 64), (1000, 64), (4097, 512)])
def test_cuda_quantize_matches_plain(bits, n, bucket):
    """A constant first bucket; past it (where there is room) a bucket
    with a NaN and one with an inf."""
    dev = _cuda()
    x = torch.randn(n, generator=torch.Generator().manual_seed(n)).to(dev)
    x[:bucket] = 0.5
    x[bucket + 1:bucket + 2] = float("nan")
    x[2 * bucket + 3:2 * bucket + 4] = float("inf")
    got = kernels.maxmin_quantize(x, bits, bucket)
    want = kernels.maxmin_quantize_plain(x, bits, bucket)
    for g, w in zip(got, want):
        _assert_bitwise(g, w)
    q, mn, unit = got
    # B4 on B1's byte codes (8 bits a code) and on its packed payload.
    for codes, width in ((q, 8), (pack_bits(q.view(1, -1), bits), bits)):
        back = kernels.maxmin_dequantize(codes, mn, unit, width, bucket)
        _assert_bitwise(back, kernels.maxmin_dequantize_plain(
            codes, mn, unit, width, bucket))
    if n > 2 * bucket:
        assert torch.isnan(back[1:3]).all() and torch.isfinite(back[0]).all()


def _packed_ranks(n_ranks: int, n_buckets: int, bucket: int, bits: int,
                  seed: int, dev):
    """Each rank's packed row of random codes, with a NaN min and an
    infinite unit in rank 0's first buckets."""
    g = torch.Generator().manual_seed(seed)
    codes = torch.randint(0, 1 << bits, (n_ranks, n_buckets * bucket),
                          generator=g, dtype=torch.uint8)
    mn = torch.randn(n_ranks, n_buckets, generator=g)
    unit = torch.rand(n_ranks, n_buckets, generator=g) / ((1 << bits) - 1)
    mn[0, 0], unit[0, -1] = float("nan"), float("inf")
    return pack_bits(codes, bits).to(dev), mn.to(dev), unit.to(dev)


def _at_byte(q: torch.Tensor, offset: int) -> torch.Tensor:
    """``q`` in a new buffer, ``offset`` bytes into it."""
    buf = torch.zeros(q.numel() + offset, dtype=torch.uint8, device=q.device)
    buf[offset:] = q.reshape(-1)
    return buf[offset:].view(q.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("n_ranks", [1, 2, 4])
def test_cuda_dequantize_sum_matches_plain(n_ranks):
    """B3 bitwise against its plain version at 4 bits: both add rank by
    rank in rank order."""
    dev = _cuda()
    q, mn, unit = _packed_ranks(n_ranks, 33, 512, 4, n_ranks, dev)
    _assert_bitwise(kernels.maxmin_dequantize_sum(q, mn, unit, 4, 512),
                    kernels.maxmin_dequantize_sum_plain(q, mn, unit, 4, 512))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("bucket", [64, 512, 100, 8, 2056])
def test_cuda_decode_packed_payloads(bucket, bits, offset):
    """B4 (3 rows of 5 buckets) and B3 (1 to 4 ranks of 7 buckets) on
    packed payloads, at the payload's own address and one byte into a
    buffer: bitwise against their plain versions, on the route the bucket
    asks for."""
    dev = _cuda()
    route = "packed" if bucket % 8 == 0 else "generic"
    q, mn, unit = _packed_ranks(3, 5, bucket, bits, bucket + bits, dev)
    q = _at_byte(q, offset)
    kernels.reset_launches()
    got = kernels.maxmin_dequantize(q, mn.view(-1), unit.view(-1), bits,
                                    bucket)
    _assert_bitwise(got, kernels.maxmin_dequantize_plain(
        q, mn.view(-1), unit.view(-1), bits, bucket))
    assert kernels.ROUTES["maxmin_dequantize"][route] == 1
    for n_ranks in (1, 2, 3, 4):
        q, mn, unit = _packed_ranks(n_ranks, 7, bucket, bits, n_ranks, dev)
        q = _at_byte(q, offset)
        _assert_bitwise(
            kernels.maxmin_dequantize_sum(q, mn, unit, bits, bucket),
            kernels.maxmin_dequantize_sum_plain(q, mn, unit, bits, bucket))
    assert kernels.ROUTES["maxmin_dequantize_sum"][route] == 4
    torch.cuda.synchronize()


def _special_values(n: int, bucket: int, seed: int, dev) -> torch.Tensor:
    """Unit normals with a constant first bucket and, where there is room,
    a bucket holding a NaN and one holding an inf."""
    x = torch.randn(n, generator=torch.Generator().manual_seed(seed)).to(dev)
    x[:bucket] = 0.5
    x[bucket + 1:bucket + 2] = float("nan")
    x[2 * bucket + 3:2 * bucket + 4] = float("inf")
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("seed,offset", [(0, 0), (2**40 + 3, 5)])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("n,bucket", [(1, 64), (1001, 64), (4097, 512),
                                      (3001, 125)])
def test_cuda_stochastic_quantize_matches_plain(n, bucket, bits, seed,
                                                offset):
    """B2 bitwise against its plain version, with the same Philox words:
    ragged sizes, odd buckets (whose counters straddle two buckets, on the
    byte-code route), a NaN and an inf bucket, and 64-bit seeds and
    offsets. On the packed route the codes are ``pack_bits`` of the plain
    version's, bucket by bucket."""
    dev = _cuda()
    x = _special_values(n, bucket, n + bits, dev)
    got = kernels.maxmin_quantize_stochastic(x, bits, bucket, seed, offset)
    want = kernels.maxmin_quantize_stochastic_plain(x, bits, bucket, seed,
                                                    offset)
    if bucket % 8 == 0:
        want = (pack_bits(want[0], bits),) + want[1:]
    for g, w in zip(got, want):
        _assert_bitwise(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("norm", ["linf", "l2"])
@pytest.mark.parametrize("kind", ["uni", "exp"])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("n,bucket", [(1, 64), (1001, 64), (4097, 512)])
def test_cuda_norm_kernels_match_plain(n, bucket, bits, kind, norm):
    """B5 and B6 against their plain versions. linf: codes and norms
    bitwise. l2: the kernel sums in another order, so norms agree to rtol
    1e-6, and a code may differ only by one level index, where the ratio
    lies within a few ulp of the midpoint of two levels. B6 is bitwise on
    the kernel's own codes and norms, and clips an index past the table."""
    dev = _cuda()
    x = _special_values(n, bucket, n + bits, dev)
    table = default_levels(bits, kind)
    levels = torch.from_numpy(table).to(dev)
    q, nrm = norm_kernels.norm_quantize(x, levels, bucket, norm == "l2")
    wq, wnrm = norm_kernels.norm_quantize_plain(x, levels, bucket,
                                                norm == "l2")
    if norm == "linf":
        _assert_bitwise(q, wq)
        _assert_bitwise(nrm, wnrm)
    else:
        torch.testing.assert_close(nrm, wnrm, rtol=1e-6, atol=0,
                                   equal_nan=True)
        assert torch.equal(q & 1, wq & 1)
        assert int(((q >> 1).int() - (wq >> 1).int()).abs().max()) <= 1
    back = norm_kernels.norm_dequantize(q, levels, nrm)
    _assert_bitwise(back, norm_kernels.norm_dequantize_plain(q, levels, nrm))
    short = levels[:2].contiguous()
    _assert_bitwise(norm_kernels.norm_dequantize(q, short, nrm),
                    norm_kernels.norm_dequantize_plain(q, short, nrm))


def _close(got, want, rel: float, what: str, term=None) -> None:
    """fp32: ``max|got - want| <= rel * max(1, max|want|)``; bf16, element
    by element: ``|got - want| <= 2^-7 |want| + 2^-8 mean|want| + 2^-14``,
    plus ``term`` (the tensor-core route's rounding) where given."""
    size = want.float().abs()
    err = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        bound = 2**-7 * size + (2**-8 * size.mean() + 2**-14)
        if term is not None:
            bound = bound + term
    else:
        bound = torch.full_like(size, rel * max(1.0, float(size.max())))
    over = int((err > bound).sum())
    assert over == 0, (f"{what}: {over} elements beyond the bound, max "
                       f"error {float(err.max())}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("s", [1, 127, 200, 4096])
def test_cuda_flash_matches_plain(s, d, causal, dtype):
    """B7, B8 and B9 against their plain versions on the same inputs
    (tolerances in the module docstring)."""
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(s + d)
    q, k, v, do = (torch.randn(3, s, d, generator=g).to(dev, dt)
                   for _ in range(4))
    scale = 1.0 / d ** 0.5
    fwd_tol, bwd_tol = 1e-4, 5e-4  # fp32 outputs; bf16 ones: see _close
    o, lse = flash.flash_fwd(q, k, v, scale, causal)
    o_ref, lse_ref = flash.flash_fwd_plain(q, k, v, scale, causal)
    delta = (do.float() * o_ref.float()).sum(-1)
    terms = flash.mma_rounding_terms(q, k, v, do, lse_ref, delta, scale,
                                     causal)
    _close(o, o_ref, fwd_tol, "o", terms["o"])
    _close(lse, lse_ref, 1e-4, "lse")
    dk, dv = flash.flash_dkdv(q, k, v, do, lse_ref, delta, scale, causal)
    dk_ref, dv_ref = flash.flash_dkdv_plain(q, k, v, do, lse_ref, delta,
                                            scale, causal)
    dq = flash.flash_dq(q, k, v, do, lse_ref, delta, scale, causal)
    dq_ref = flash.flash_dq_plain(q, k, v, do, lse_ref, delta, scale, causal)
    torch.cuda.synchronize()
    for got, want, what in ((dq, dq_ref, "dq"), (dk, dk_ref, "dk"),
                            (dv, dv_ref, "dv")):
        assert got.dtype == dt and got.shape == want.shape
        _close(got, want, bwd_tol, what, terms.get(what))


_FLASH = ("flash_fwd", "flash_dkdv", "flash_dq")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,routes", [
    ("bfloat16", dict.fromkeys(_FLASH, "wgmma_bf16")),
    ("float32", dict.fromkeys(_FLASH, "fp32"))],
    ids=["bfloat16", "float32"])
def test_cuda_flash_route_follows_type(dtype, routes):
    """A bf16 call of B7, B8 and B9 counts on the wgmma route, an fp32
    call of each on the CUDA-core one, and nothing else moves."""
    dev = _cuda()
    x = torch.randn(2, 100, 64, generator=torch.Generator().manual_seed(0)
                    ).to(dev, getattr(torch, dtype))
    stats = torch.zeros(2, 100, device=dev)
    flash.reset_launches()
    flash.flash_fwd(x, x, x, 0.125, True)
    flash.flash_dkdv(x, x, x, x, stats, stats, 0.125, True)
    flash.flash_dq(x, x, x, x, stats, stats, 0.125, True)
    torch.cuda.synchronize()
    assert flash.ROUTES == {
        name: {r: int(r == routes[name]) for r in flash.ROUTES[name]}
        for name in _FLASH}
    assert flash.LAUNCHES == {"flash_fwd": 1, "flash_dkdv": 1,
                              "flash_dq": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_writes_only_its_heads(causal, monkeypatch):
    """bf16 B7, B8 and B9 at BH 3, S 200 (a ragged last tile) and D 72 (72
    columns padded to 128) write every element of their outputs and nothing
    around them: each output the wrappers allocate lies between two guards
    filled with a sentinel, which stay as they were, no sentinel is left
    inside, and every head's rows are within the bound of the plain
    version. The kernels' tensor maps are 3-D, {D, S, BH}: a 2-D map over
    ``[BH S, D]`` would read the next head's rows into the ragged tile."""
    dev = _cuda()
    bh, s, d, guard, sentinel = 3, 200, 72, 64, -4096.0
    g = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn(bh, s, d, generator=g).to(dev, torch.bfloat16)
                   for _ in range(4))
    scale = 1.0 / d ** 0.5
    o_ref, lse_ref = flash.flash_fwd_plain(q, k, v, scale, causal)
    delta = (do.float() * o_ref.float()).sum(-1)
    dk_ref, dv_ref = flash.flash_dkdv_plain(q, k, v, do, lse_ref, delta,
                                            scale, causal)
    dq_ref = flash.flash_dq_plain(q, k, v, do, lse_ref, delta, scale, causal)
    terms = flash.mma_rounding_terms(q, k, v, do, lse_ref, delta, scale,
                                     causal)
    empty = torch.empty
    buffers = []

    def guarded(shape, dtype):
        n = int(np.prod(shape))
        buf = empty(n + 2 * guard, dtype=dtype, device=dev).fill_(sentinel)
        buffers.append((buf, n))
        return buf[guard:guard + n].view(tuple(shape))

    monkeypatch.setattr(torch, "empty_like",
                        lambda t, **kw: guarded(t.shape, t.dtype))
    monkeypatch.setattr(torch, "empty",
                        lambda shape, dtype=None, device=None:
                        guarded(shape, dtype))
    o, lse = flash.flash_fwd(q, k, v, scale, causal)
    dk, dv = flash.flash_dkdv(q, k, v, do, lse_ref, delta, scale, causal)
    dq = flash.flash_dq(q, k, v, do, lse_ref, delta, scale, causal)
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert len(buffers) == 5
    for buf, n in buffers:
        assert bool((buf[:guard] == sentinel).all())
        assert bool((buf[guard + n:] == sentinel).all())
        assert not bool((buf[guard:guard + n] == sentinel).any())
    _close(o, o_ref, 1e-4, "o", terms["o"])
    _close(lse, lse_ref, 1e-4, "lse")
    _close(dk, dk_ref, 5e-4, "dk", terms["dk"])
    _close(dv, dv_ref, 5e-4, "dv", terms["dv"])
    _close(dq, dq_ref, 5e-4, "dq", terms["dq"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash_fwd", "flash_dkdv", "flash_dq"])
def test_cuda_flash_refuses_misaligned_pointers(name):
    """A contiguous view that starts one element into its allocation is not
    16-byte aligned: the bf16 B7, B8 and B9 wrappers, whose kernels load
    their tiles with TMA, raise and launch nothing."""
    dev = _cuda()
    flat = torch.zeros(2 * 64 * 16 + 1, device=dev, dtype=torch.bfloat16)
    bad = flat[1:].view(2, 64, 16)
    good = torch.zeros(2, 64, 16, device=dev, dtype=torch.bfloat16)
    stats = torch.zeros(2, 64, device=dev)
    args = {"flash_fwd": (good, bad, good, 0.25, True),
            "flash_dkdv": (good, good, good, bad, stats, stats, 0.25, True),
            "flash_dq": (good, good, bad, good, stats, stats, 0.25, True)}
    flash.reset_launches()
    with pytest.raises(ValueError, match="16-byte aligned"):
        getattr(flash, name)(*args[name])
    assert flash.LAUNCHES[name] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash_fwd", "flash_dkdv", "flash_dq"])
def test_cuda_flash_cuda_core_kernels_take_offset_views(name):
    """The CUDA-core kernels (fp32) load one element at a time: a view one
    element into its allocation runs and matches the plain version."""
    dev = _cuda()
    gen = torch.Generator().manual_seed(3)
    flat = torch.randn(2 * 64 * 16 + 1, generator=gen).to(dev)
    x = flat[1:].view(2, 64, 16)
    stats = torch.zeros(2, 64, device=dev)
    args = {"flash_fwd": (x, x, x, 0.25, True)}.get(
        name, (x, x, x, x, stats, stats, 0.25, True))
    got = getattr(flash, name)(*args)
    want = getattr(flash, name + "_plain")(*args)
    if name == "flash_dq":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        _close(g, w, 5e-4, name)


def test_alignment_check_refuses_offset_views():
    """The check the CUDA path runs: an allocation passes, a view one
    element in does not."""
    flat = torch.zeros(65, dtype=torch.bfloat16)
    flash._check_aligned(flat[:64])
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash._check_aligned(flat[:64], flat[1:].view(8, 8))


def test_library_key_covers_headers(tmp_path):
    """The library's name hashes every ``.cu`` and ``.cuh`` under
    ``csrc``: an edit to a shared header alone gives a new library."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in cuda_build.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (csrc / src.name).write_bytes(src.read_bytes())
    assert {p.name for p in csrc.iterdir()} >= {
        p.name for p in cuda_build.SOURCES} | {"bucket_groups.cuh",
                                               "flash_attention_wgmma.cuh"}
    before = cuda_build.source_key(csrc)
    assert before == cuda_build.source_key()
    header = csrc / "flash_attention_wgmma.cuh"
    header.write_text(header.read_text() + "// edited\n")
    edited = cuda_build.source_key(csrc)
    assert edited != before
    (csrc / "notes.txt").write_text("not a source")
    assert cuda_build.source_key(csrc) == edited
