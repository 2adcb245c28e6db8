"""The port's dense collectives, held against the JAX package's eager ones.

``allreduce`` (unscaled) and ``grouped_allreduce`` (prescale 1/3,
postscale 0.1, two leaves fused) run for fp32, bf16, fp16 and int32 with
Sum, Average, Min, Max and Product at worlds 2 and 3: the port as 2 or 3
spawned gloo ranks (this file is also their worker: ``python <file>
--worker <dir>``, which imports no JAX), the JAX package on a 2- or
3-device sub-mesh of the 8-device CPU mesh, both on the same per-rank
numpy inputs.

Tolerances.

* Scaling is bitwise: the port's ``_apply_scale`` multiplies by the factor
  rounded to the tensor's dtype, as the reference's does (pinned on 1,001
  values in [-5, 5] at 1/3 and 0.1; the fault fixed here, C1 in ROADMAP,
  made 330 bf16 and 330 fp16 values differ at 1/3).
* Min and Max, and int32 Sum and Average, are exact.
* Float Sum and Average: gloo and XLA may add in other orders, and gloo
  rounds each hop in the tensor's dtype. With ``A = sum_r |x'_r|`` over the
  prescaled inputs and ``c`` the product of the later factors (1/n for
  Average, and the postscale), each side's error is at most
  ``(n - 1) u A |c|`` for the sum and ``u A |c|`` for each of the (at most
  two) later roundings, so the two sides agree to ``2 (n + 2) u A |c|``
  plus four subnormal steps, with u = 2^-24, 2^-8, 2^-11 for fp32, bf16,
  fp16. A world-3 Average of values whose 16-bit sums are exact (there
  the sum has no rounding, so C1 would show) is bitwise against the
  reference's scaling applied op by op, and against its compiled bf16
  program; its compiled fp16 program folds 1/n and the postscale into one
  fp16 factor (pinned here), which the tolerance above covers.
* Integer Product is the exact product (``dist.ReduceOp.PRODUCT``). The
  reference computes ``exp(psum(log|x|))`` and truncates: 7 * 11 * 1 is 76
  there, which a test records as the reference's fault (C2 in ROADMAP).
* Float Product is within rtol 1e-5 of the reference, its own test's
  tolerance, on values of modest magnitude; in 16 bits the port takes the
  product in fp32 and casts once, as the reference does, and each side
  rounds that fp32 product to 16 bits and scales it by the 16-bit
  postscale: 4u more. The port's 16-bit product is also bitwise the fp32
  product of the prescaled values rounded once to 16 bits and scaled as
  the reference scales (gloo and NCCL would round at each hop).
"""

import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch.ops import collectives as C

DTYPES = ("float32", "bfloat16", "float16", "int32")
OPS = ("sum", "average", "min", "max", "product")
FNS = ("allreduce", "grouped_allreduce")
WORLDS = (2, 3)
SCALES = {"allreduce": (1.0, 1.0), "grouped_allreduce": (1 / 3, 0.1)}
SHAPES = {"allreduce": [(37,)], "grouped_allreduce": [(5, 3), (11,)]}
UNIT = {"float32": 2.0**-24, "bfloat16": 2.0**-8, "float16": 2.0**-11}
TINY = {"float32": 2.0**-149, "bfloat16": 2.0**-133, "float16": 2.0**-24}
PROBE = np.linspace(-5, 5, 1001)
CASES = [(fn, dtype, op) for fn in FNS for dtype in DTYPES for op in OPS]


def _name(fn, dtype, op):
    return f"{fn}-{dtype}-{op}"


def _inputs(fn, dtype, op, rank):
    """One rank's leaves as float32 or int32 numpy arrays holding values of
    ``dtype``: uniform in [-5, 5] (ints in [-50, 50)), or for Product
    magnitudes in [0.5, 2] with random signs (ints in [-3, 3])."""
    rng = np.random.RandomState(zlib.crc32(f"{fn}{dtype}{op}{rank}".encode()))
    out = []
    for shape in SHAPES[fn]:
        if dtype == "int32":
            hi = 4 if op == "product" else 50
            out.append(rng.randint(-hi + 1 if op == "product" else -hi, hi,
                                   shape).astype(np.int32))
            continue
        if op == "product":
            v = rng.uniform(0.5, 2, shape) * rng.choice([-1, 1], shape)
        else:
            v = rng.uniform(-5, 5, shape)
        t = torch.from_numpy(v.astype(np.float32)).to(getattr(torch, dtype))
        out.append(t.float().numpy())
    return out


def _exact_inputs(dtype, rank):
    """Multiples of 1/8 in [-5, 5]: their 16-bit sums over 3 ranks are
    exact."""
    rng = np.random.RandomState(700 + rank)
    return (rng.randint(-40, 41, 29) / 8).astype(np.float32)


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _port_case(fn, dtype, op):
    rank = thvd.rank()
    leaves = [_torch(a, dtype) for a in _inputs(fn, dtype, op, rank)]
    reduce_op = C.ReduceOp[op.upper()]
    if fn == "allreduce":
        outs = [thvd.allreduce(leaves[0], op=reduce_op)]
    else:
        pre, post = SCALES[fn]
        outs = thvd.grouped_allreduce(leaves, op=reduce_op,
                                      prescale_factor=pre,
                                      postscale_factor=post)
    for out, leaf in zip(outs, leaves):
        assert out.dtype == leaf.dtype and out.shape == leaf.shape
    return {f"out{i}": (o.float() if o.is_floating_point() else o).numpy()
            for i, o in enumerate(outs)}


def _predivide_case(dtype):
    """A dense DistributedOptimizer step on a 16-bit parameter with
    ``gradient_predivide_factor`` 3: SGD at lr 1 from 0 leaves minus the
    reduced gradient, exactly."""
    grad = _torch(_inputs("allreduce", dtype, "sum", thvd.rank())[0], dtype)
    p = torch.nn.Parameter(torch.zeros_like(grad))
    opt = thvd.DistributedOptimizer(torch.optim.SGD([p], lr=1.0),
                                    gradient_predivide_factor=3.0)
    p.grad = grad
    opt.step()
    return {"out0": (-p.detach()).float().numpy()}


def _worker(out_dir):
    thvd.init(device="cpu")
    try:
        results = {_name(*case): _port_case(*case) for case in CASES}
        for dtype in ("bfloat16", "float16"):
            x = _torch(_exact_inputs(dtype, thvd.rank()), dtype)
            out = thvd.allreduce(x, op=thvd.Average, postscale_factor=0.1)
            results[f"exact-{dtype}"] = {"out0": out.float().numpy()}
            results[f"predivide-{dtype}"] = _predivide_case(dtype)
        product = thvd.allreduce(torch.tensor([[7], [11], [1]],
                                              dtype=torch.int32)[thvd.rank()],
                                 op=thvd.Product)
        results["int-product"] = {"out0": product.numpy()}
        for name, arrays in results.items():
            np.savez(os.path.join(out_dir, f"{name}.{thvd.rank()}.npz"),
                     **arrays)
    finally:
        thvd.shutdown()


def _spawn(n, out_dir):
    from conftest import free_port, subprocess_env
    port = free_port()
    procs = []
    for rank in range(n):
        env = subprocess_env()
        env.update({"HVDTPU_RANK": str(rank), "HVDTPU_SIZE": str(n),
                    "HVDTPU_LOCAL_RANK": str(rank),
                    "HVDTPU_LOCAL_SIZE": str(n),
                    "HVDTPU_CONTROLLER_ADDR": "127.0.0.1",
                    "HVDTPU_CONTROLLER_PORT": str(port)})
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", out_dir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every case's result on every rank, by world size: {n: {case: [rank
    arrays]}}."""
    out = {}
    for n in WORLDS:
        out_dir = str(tmp_path_factory.mktemp(f"torch_collectives_{n}"))
        _spawn(n, out_dir)
        names = {f.rsplit(".", 2)[0] for f in os.listdir(out_dir)}
        out[n] = {name: [dict(np.load(os.path.join(out_dir,
                                                   f"{name}.{r}.npz")))
                         for r in range(n)] for name in names}
    return out


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

def _jnp(a, dtype):
    import jax.numpy as jnp
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _jax_reduce(hvd, fn, dtype, op, per_rank, pre=1.0, post=1.0):
    """The JAX package's eager collective on rank-stacked leaves: the
    reduced leaves as numpy (float32 or int32)."""
    leaves = [hvd.shard_batch(_jnp(np.stack([r[i] for r in per_rank]),
                                   dtype))
              for i in range(len(per_rank[0]))]
    reduce_op = getattr(hvd, op.capitalize())
    if fn == "allreduce":
        outs = [hvd.allreduce(leaves[0], op=reduce_op, prescale_factor=pre,
                              postscale_factor=post)]
    else:
        outs = hvd.grouped_allreduce(leaves, op=reduce_op,
                                     prescale_factor=pre,
                                     postscale_factor=post)
    return [np.asarray(o.astype("float32") if dtype != "int32" else o)[0]
            for o in outs]


def _ref_scale(a, factor, dtype):
    """The reference's ``_apply_scale`` on numpy values of ``dtype``,
    returned as float64 (or int64)."""
    from horovod_tpu.ops.collectives import _apply_scale
    out = np.asarray(_apply_scale(_jnp(a, dtype), factor))
    return out.astype(np.int64 if dtype == "int32" else np.float64)


def _runtime(make_runtime, n):
    import jax
    return make_runtime(mesh_shape={"dp": n}, devices=jax.devices()[:n])


def _sum_tolerance(dtype, n, op, prescaled, post):
    """``2 (n + 2) u A |c| + 4 tiny`` (module docstring)."""
    c = abs(post) * (1.0 / n if op == "average" else 1.0)
    total = np.sum([np.abs(p) for p in prescaled], axis=0)
    return 2 * (n + 2) * UNIT[dtype] * total * c + 4 * TINY[dtype]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("fn,dtype,op", CASES)
def test_matches_jax(fn, dtype, op, world, worlds, make_runtime):
    by_rank = worlds[world][_name(fn, dtype, op)]
    per_rank = [_inputs(fn, dtype, op, r) for r in range(world)]
    pre, post = SCALES[fn]
    for got in by_rank[1:]:
        for key in got:
            np.testing.assert_array_equal(got[key], by_rank[0][key])
    port = [by_rank[0][f"out{i}"] for i in range(len(per_rank[0]))]
    if dtype == "int32" and op == "product":
        # The exact product, scaled as the reference scales.
        for i, got in enumerate(port):
            prescaled = [_ref_scale(r[i], pre, dtype) for r in per_rank]
            want = _ref_scale(np.prod(prescaled, axis=0).astype(np.int32),
                              post, dtype)
            np.testing.assert_array_equal(got, want)
        return
    want = _jax_reduce(_runtime(make_runtime, world), fn, dtype, op,
                       per_rank, pre, post)
    for i, (got, ref) in enumerate(zip(port, want)):
        msg = f"leaf {i}"
        if dtype == "int32" or op in ("min", "max"):
            np.testing.assert_array_equal(got, ref, err_msg=msg)
        elif op == "product":
            rtol = 1e-5 + (4 * UNIT[dtype] if dtype != "float32" else 0)
            np.testing.assert_allclose(got, ref, rtol=rtol, atol=0,
                                       err_msg=msg)
            if dtype != "float32":
                # The fp32 product (one rounding: a product of two 16-bit
                # values is exact in fp32) cast once, then the postscale.
                prescaled = [_ref_scale(r[i], pre, dtype) for r in per_rank]
                wide = np.prod(prescaled, axis=0).astype(np.float32)
                want = _ref_scale(_torch(wide, dtype).float().numpy(), post,
                                  dtype)
                np.testing.assert_array_equal(got, want, err_msg=msg)
        else:
            prescaled = [_ref_scale(r[i], pre, dtype) for r in per_rank]
            tol = _sum_tolerance(dtype, world, op, prescaled, post)
            diff = np.abs(got.astype(np.float64) - ref)
            assert (diff <= tol).all(), (msg, diff.max(), tol.min())


def _exact_average(dtype, make_runtime):
    """World 3, the exact-sum inputs: the reference's scaling applied op by
    op (``_apply_scale`` by 1/3, then by 0.1) to the exact sum, and the
    reference's compiled eager allreduce."""
    inputs = [_exact_inputs(dtype, r) for r in range(3)]
    total = np.sum(inputs, axis=0, dtype=np.float64).astype(np.float32)
    op_by_op = _ref_scale(
        _ref_scale(total, 1 / 3, dtype).astype(np.float32), 0.1, dtype)
    compiled = _jax_reduce(_runtime(make_runtime, 3), "allreduce", dtype,
                           "average", [[a] for a in inputs], 1.0, 0.1)[0]
    return total, op_by_op, compiled


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_exact_sum_average_is_bitwise(dtype, worlds, make_runtime):
    """World 3: an Average (1/3) with postscale 0.1 of values whose 16-bit
    sums are exact equals, bitwise, the reference's scaling applied op by
    op, and in bf16 its compiled program too. (In fp16 that program folds
    the two factors into one: next test.)"""
    _, op_by_op, compiled = _exact_average(dtype, make_runtime)
    got = worlds[3][f"exact-{dtype}"][0]["out0"]
    np.testing.assert_array_equal(got, op_by_op)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, compiled)


def test_compiled_fp16_average_folds_its_factors(make_runtime):
    """The premise of the test above: XLA's compiled CPU program of the
    reference's fp16 Average multiplies the sum by fp16(fp16(1/3) *
    fp16(0.1)) once, where op by op it rounds after each factor, so the two
    differ; both lie within the module's sum tolerance."""
    total, op_by_op, compiled = _exact_average("float16", make_runtime)
    f16 = np.float16
    folded = (total.astype(np.float64) * float(
        f16(float(f16(1 / 3)) * float(f16(0.1))))).astype(f16)
    np.testing.assert_array_equal(compiled, folded.astype(np.float64))
    assert (compiled != op_by_op).any()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_predivide_factor_matches_jax(dtype, world, worlds, make_runtime):
    """``gradient_predivide_factor`` 3 on a 16-bit gradient: the reference
    sums the gradients scaled by 3/n and scales the sum by 1/3."""
    per_rank = [[_inputs("allreduce", dtype, "sum", r)[0]]
                for r in range(world)]
    want = _jax_reduce(_runtime(make_runtime, world), "allreduce", dtype,
                       "sum", per_rank, 3.0 / world, 1 / 3)[0]
    prescaled = [_ref_scale(r[0], 3.0 / world, dtype) for r in per_rank]
    tol = _sum_tolerance(dtype, world, "sum", prescaled, 1 / 3)
    got = worlds[world][f"predivide-{dtype}"][0]["out0"]
    assert (np.abs(got.astype(np.float64) - want) <= tol).all()


def test_integer_product_is_exact_where_the_reference_truncates(
        worlds, make_runtime):
    """C2: 7 * 11 * 1 in int32 is 77 in the port and 76 in the reference,
    whose exp(psum(log|x|)) lands just below 77 and is truncated. The
    reference's value is recorded here as its fault; the port stays
    exact."""
    port = worlds[3]["int-product"]
    assert all(int(r["out0"][0]) == 77 for r in port)
    want = _jax_reduce(_runtime(make_runtime, 3), "allreduce", "int32",
                       "product", [[np.array(v, np.int32)]
                                   for v in (7, 11, 1)])[0]
    assert int(want) == 76


@pytest.mark.parametrize("factor", [1 / 3, 0.1, 0.125, 3.0])
@pytest.mark.parametrize("dtype", DTYPES)
def test_scale_is_the_references(dtype, factor):
    """``_apply_scale`` bitwise against the reference's on 1,001 values in
    [-5, 5] (ints: [-500, 500]); in 16 bits the product with the
    unrounded factor, what the port computed before (C1), differs at 1/3
    and 0.1."""
    a = (PROBE * 100).astype(np.int32) if dtype == "int32" else \
        PROBE.astype(np.float32)
    x = _torch(a, dtype)
    got = C._apply_scale(x, factor)
    assert got.dtype == x.dtype
    want = _ref_scale(x.float().numpy() if dtype != "int32" else a, factor,
                      dtype)
    np.testing.assert_array_equal(got.double().numpy(), want)
    if dtype in ("bfloat16", "float16") and factor in (1 / 3, 0.1):
        unrounded = (x * factor).double().numpy()
        assert (unrounded != want).sum() > 100


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2])
