"""The port's compressed reducers, held against the JAX package's.

Each case runs at world 1 in this process and at world 2 as two spawned
gloo ranks (this file is also their worker: ``python <file> --worker``,
which imports no JAX). The JAX reducers run inside ``hvd.run_step`` on a
1- and a 2-device CPU mesh with the same per-rank numpy inputs.

Tolerance. The port computes what the JAX package computes op by op:
``unit = (max-min)/levels`` as an IEEE quotient, and ``min + q*unit`` as a
rounded product and a rounded sum (``test_torch_port_quantize.py`` holds
that bitwise). Inside ``run_step``'s compiled program XLA instead multiplies
by ``fl(1/levels)`` and fuses ``min + q*unit`` into one FMA
(``test_jit_rewrites_the_quantizer_arithmetic`` pins both). So against the
compiled reducers every value agrees to 1e-6 (absolute, plus 1e-6 relative
for the sums) except where a value within an ulp of a rounding midpoint
took the neighbouring code: at most 1% of the values, each off by at most
one quantization unit of its bucket. One case runs the JAX reducer op by op
(``jax.disable_jit``, as slow as it is exact) and must agree to 1e-6
everywhere.

The cases with the normalized quantizer (4 bits, uniform levels, linf) are
held to the same rule with the unit of a level step: a value at the
midpoint of two levels may take the neighbour, which moves it by 1/7 of
its bucket's norm, at most 1/7 of the largest magnitude staged in the
case. The stochastic max-min quantizer draws other noise than the JAX
package, so its reducers are held by a property: each quantization stage
moves a value by less than one unit of its bucket, at most
``2 * M / levels`` where ``M`` bounds every partial sum (the sum over ranks
of their largest magnitude), and a value passes at most ``n + 1`` stages.
"""

import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch.compression import (MaxMinQuantizer,
                                           NormalizedQuantizer,
                                           compressed_allreduce,
                                           compressed_grouped_allreduce)

BITS, BUCKET = 4, 64
SHAPES = {"single": [(1001,)], "grouped": [(33, 7), (5,), (201,)]}
CASES = {
    # name: (reduction, op, shapes, residual, prescale, postscale,
    #        compressor)
    "allgather": ("allgather", "sum", "single", False, 1.0, 1.0, "maxmin"),
    "allgather-ef": ("allgather", "sum", "single", True, 1.0, 1.0,
                     "maxmin"),
    "scatter_allgather": ("scatter_allgather", "sum", "single", False, 1.0,
                          1.0, "maxmin"),
    "scatter_allgather-ef": ("scatter_allgather", "sum", "single", True, 1.0,
                             1.0, "maxmin"),
    "ps": ("ps", "sum", "single", False, 1.0, 1.0, "maxmin"),
    "ps-ef": ("ps", "sum", "single", True, 1.0, 1.0, "maxmin"),
    "ring": ("ring", "sum", "single", False, 1.0, 1.0, "maxmin"),
    "ring-ef": ("ring", "sum", "single", True, 1.0, 1.0, "maxmin"),
    "tree": ("tree", "sum", "single", False, 1.0, 1.0, "maxmin"),
    "tree-ef": ("tree", "sum", "single", True, 1.0, 1.0, "maxmin"),
    "grouped-scatter_allgather-avg-ef-scaled": (
        "scatter_allgather", "avg", "grouped", True, 0.5, 3.0, "maxmin"),
    "grouped-allgather-sum": ("allgather", "sum", "grouped", False, 1.0, 1.0,
                              "maxmin"),
    "grouped-ps-avg-ef": ("ps", "avg", "grouped", True, 1.0, 1.0, "maxmin"),
    "norm-allgather-ef": ("allgather", "sum", "single", True, 1.0, 1.0,
                          "norm"),
    "norm-scatter_allgather-ef": ("scatter_allgather", "sum", "single", True,
                                  1.0, 1.0, "norm"),
    "norm-ps": ("ps", "sum", "single", False, 1.0, 1.0, "norm"),
    "norm-ring-ef": ("ring", "sum", "single", True, 1.0, 1.0, "norm"),
    "norm-tree-ef": ("tree", "sum", "single", True, 1.0, 1.0, "norm"),
    "grouped-norm-ring-avg": ("ring", "avg", "grouped", False, 1.0, 1.0,
                              "norm"),
}
REDUCTIONS = ("allgather", "scatter_allgather", "ps", "ring", "tree")
TOL = 1e-6


def _inputs(name, rank):
    """This rank's leaves and residuals, from a seed of (case, rank)."""
    rng = np.random.RandomState(zlib.crc32(name.encode()) % 10000 + rank)
    shapes = SHAPES[CASES[name][2]]
    xs = [rng.randn(*s).astype(np.float32) for s in shapes]
    res = [0.05 * rng.randn(*s).astype(np.float32) for s in shapes]
    return xs, res


def _run_port(name, rank):
    reduction, op, kind, residual, pre, post, comp = CASES[name]
    xs, res = _inputs(name, rank)
    xs = [torch.from_numpy(x) for x in xs]
    res = [torch.from_numpy(r) for r in res] if residual else None
    quant = MaxMinQuantizer(BITS, BUCKET) if comp == "maxmin" else \
        NormalizedQuantizer(BITS, BUCKET)
    op = thvd.Sum if op == "sum" else thvd.Average
    if kind == "grouped":
        result = compressed_grouped_allreduce(
            xs, quant, reduction=reduction, op=op, residuals=res,
            prescale_factor=pre, postscale_factor=post)
        outs, new_res = result if residual else (result, None)
    else:
        result = compressed_allreduce(xs[0], quant, reduction=reduction,
                                      op=op,
                                      residual=res[0] if residual else None)
        outs, new_res = ([result[0]], [result[1]]) if residual else \
            ([result], None)
    arrays = {f"out{i}": o.numpy() for i, o in enumerate(outs)}
    if new_res is not None:
        arrays.update({f"res{i}": r.numpy() for i, r in enumerate(new_res)})
    return arrays


def _stochastic_input(rank):
    return np.random.RandomState(200 + rank).randn(1001).astype(np.float32)


def _run_stochastic(rank):
    """Every reducer with the stochastic max-min quantizer and a key,
    twice: the key fixes the result."""
    x = torch.from_numpy(_stochastic_input(rank))
    quant = MaxMinQuantizer(BITS, BUCKET, stochastic=True)
    out = {}
    for reduction in REDUCTIONS:
        runs = [compressed_allreduce(x, quant, reduction=reduction,
                                     op=thvd.Sum, key=17) for _ in range(2)]
        assert torch.equal(runs[0], runs[1]), reduction
        out[reduction] = runs[0].numpy()
    return out


def _run_without_unpack(rank):
    """Every reducer with the deterministic and the stochastic max-min
    quantizer, first as it is, then with ``unpack_bits`` raising wherever
    a module of the port holds it: B3 and B4 read the packed payload, so
    the receive path never unpacks and the results are the same. Only
    B4's plain version, which stands in for the kernel on the CPU (the
    kernel reads the packed bytes itself), may still call it. Any other
    call that reached ``unpack_bits`` is recorded as an error."""
    from horovod_tpu_torch.compression import kernels

    unpack = kernels.unpack_bits

    def refuse(*args, **kwargs):
        if sys._getframe(1).f_code is \
                kernels.maxmin_dequantize_plain.__code__:
            return unpack(*args, **kwargs)
        raise RuntimeError("unpack_bits called on the max-min receive path")

    holders = [m for name, m in sorted(sys.modules.items())
               if name.startswith("horovod_tpu_torch")
               and hasattr(m, "unpack_bits")]
    saved = [m.unpack_bits for m in holders]

    x = torch.from_numpy(_stochastic_input(rank))
    out = {}
    for stochastic in (False, True):
        quant = MaxMinQuantizer(BITS, BUCKET, stochastic=stochastic)
        for reduction in REDUCTIONS:
            name = f"{reduction}-{'stochastic' if stochastic else 'rne'}"
            out[name] = compressed_allreduce(x, quant, reduction=reduction,
                                             op=thvd.Sum, key=5).numpy()
            for m in holders:
                m.unpack_bits = refuse
            try:
                out[f"{name}-packed"] = compressed_allreduce(
                    x, quant, reduction=reduction, op=thvd.Sum,
                    key=5).numpy()
            except RuntimeError as exc:
                out[f"{name}-error"] = np.array(str(exc))
            finally:
                for m, fn in zip(holders, saved):
                    m.unpack_bits = fn
    return out


def _dense_inputs(rank):
    rng = np.random.RandomState(100 + rank)
    return {"a": rng.randn(3, 4).astype(np.float32),
            "b": rng.randn(5).astype(np.float32),
            "i": rng.randint(-50, 50, 6).astype(np.int32),
            "rows": rng.randn(4, 3).astype(np.float32)}


def _run_dense(rank):
    """The dense collectives and a dense DistributedOptimizer step."""
    d = {k: torch.from_numpy(v) for k, v in _dense_inputs(rank).items()}
    a, b = thvd.grouped_allreduce([d["a"], d["b"]], prescale_factor=0.5,
                                  postscale_factor=3.0)
    p = torch.nn.Parameter(torch.zeros(3, 4))
    opt = thvd.DistributedOptimizer(torch.optim.SGD([p], lr=1.0))
    p.grad = d["a"].clone()
    opt.step()
    # Rank-dependent state, then everything from rank 1.
    q = torch.nn.Parameter(torch.full((3,), float(rank)))
    sgd = torch.optim.SGD([q], lr=0.1 * (rank + 1), momentum=0.9)
    q.grad = torch.full((3,), rank + 1.0)
    sgd.step()
    thvd.broadcast_optimizer_state(sgd, root_rank=1)
    thvd.broadcast_parameters({"q": q}, root_rank=1)
    return {"bcast_state": np.array(
                [sgd.param_groups[0]["lr"],
                 *sgd.state[q]["momentum_buffer"].tolist(),
                 *q.detach().tolist()], dtype=np.float32),
            "grouped_a": a.numpy(), "grouped_b": b.numpy(),
            "sum_int": thvd.allreduce(d["i"], op=thvd.Sum).numpy(),
            "allgather": thvd.allgather(d["rows"]).numpy(),
            "broadcast": thvd.broadcast(d["rows"], root_rank=1).numpy(),
            "alltoall": thvd.alltoall(d["rows"]).numpy(),
            "optimizer": p.detach().numpy()}


def _worker(out_dir):
    thvd.init(device="cpu")
    try:
        rank = thvd.rank()
        for name in CASES:
            np.savez(os.path.join(out_dir, f"{name}.{rank}.npz"),
                     **_run_port(name, rank))
        np.savez(os.path.join(out_dir, f"dense.{rank}.npz"),
                 **_run_dense(rank))
        np.savez(os.path.join(out_dir, f"stochastic.{rank}.npz"),
                 **_run_stochastic(rank))
        np.savez(os.path.join(out_dir, f"no_unpack.{rank}.npz"),
                 **_run_without_unpack(rank))
    finally:
        thvd.shutdown()


def _run_jax(name, n, make_runtime, compiled=True):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.compression import MaxMinQuantizer as JaxMaxMin
    from horovod_tpu.compression import NormalizedQuantizer as JaxNorm
    from horovod_tpu.compression import compressed_allreduce as jax_car
    from horovod_tpu.compression import compressed_grouped_allreduce as \
        jax_cgar

    hvd = make_runtime(mesh_shape={"dp": n}, devices=jax.devices()[:n])
    reduction, op, kind, residual, pre, post, comp = CASES[name]
    per_rank = [_inputs(name, r) for r in range(n)]
    xs = tuple(jnp.asarray(np.stack([pr[0][i] for pr in per_rank]))
               for i in range(len(SHAPES[kind])))
    rs = tuple(jnp.asarray(np.stack([pr[1][i] for pr in per_rank]))
               for i in range(len(SHAPES[kind])))
    quant = JaxMaxMin(BITS, BUCKET, use_pallas=False) if comp == "maxmin" \
        else JaxNorm(BITS, BUCKET, use_pallas=False)
    op = hvd.Sum if op == "sum" else hvd.Average

    def reduce(leaves, res):
        if kind == "grouped":
            out = jax_cgar(leaves, quant, reduction=reduction, op=op,
                           residuals=res, prescale_factor=pre,
                           postscale_factor=post)
            return out if res is not None else (out, None)
        out = jax_car(leaves[0], quant, reduction=reduction, op=op,
                      residual=None if res is None else res[0])
        return ((out[0],), (out[1],)) if res is not None else ((out,), None)

    if residual:
        @hvd.run_step(in_specs=(P("dp"), P("dp")), out_specs=(P(), P("dp")))
        def step(x, r):
            outs, new_res = reduce(tuple(a[0] for a in x),
                                   tuple(a[0] for a in r))
            return tuple(outs), tuple(a[None] for a in new_res)
        with jax.disable_jit(not compiled):
            outs, new_res = step(xs, rs)
    else:
        @hvd.run_step(in_specs=P("dp"), out_specs=P())
        def step(x):
            return tuple(reduce(tuple(a[0] for a in x), None)[0])
        with jax.disable_jit(not compiled):
            outs, new_res = step(xs), None
    arrays = {f"out{i}": np.asarray(o) for i, o in enumerate(outs)}
    if new_res is not None:
        arrays.update({f"res{i}": np.asarray(r) for i, r in
                       enumerate(new_res)})
    return arrays


LEVELS = (1 << BITS) - 1
NORM_STEP = 1 / ((1 << (BITS - 1)) - 1)  # uniform levels, 4 bits
FLIP_SHARE = 0.01


def _assert_match(name, port_by_rank, jax_arrays, exact):
    """See the module docstring for the tolerance."""
    per_rank = [_inputs(name, r) for r in range(len(port_by_rank))]
    norm = CASES[name][6] == "norm"
    for key, want in jax_arrays.items():
        leaf = int(key[3:])
        for rank, port in enumerate(port_by_rank):
            got = port[key]
            if key.startswith("res"):
                want = jax_arrays[key][rank]
                # A flipped first-stage code moves the residual by one unit
                # of a bucket of x + residual.
                staged = per_rank[rank][0][leaf] + per_rank[rank][1][leaf]
            else:
                # ... and the output by one unit of a bucket of the sum.
                staged = want
            msg = f"{name}: {key} on rank {rank}"
            if exact:
                np.testing.assert_allclose(got, want, rtol=0, atol=TOL,
                                           err_msg=msg)
                continue
            diff = np.abs(got - want)
            off = diff > TOL + TOL * np.abs(want)
            if norm:
                unit = NORM_STEP * max(
                    np.abs(want).max(),
                    *(np.abs(p[0][leaf] + p[1][leaf]).max()
                      for p in per_rank))
            else:
                unit = np.ptp(staged) / LEVELS
            assert off.mean() <= FLIP_SHARE, (msg, off.sum())
            assert (diff[off] <= unit * 1.01 + TOL).all(), (msg, diff.max())


@pytest.fixture(scope="module")
def world1():
    thvd.init(device="cpu")
    yield
    thvd.shutdown()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    from conftest import free_port, subprocess_env
    out_dir = str(tmp_path_factory.mktemp("torch_port_world2"))
    port = free_port()
    procs = []
    for rank in range(2):
        env = subprocess_env()
        env.update({"HVDTPU_RANK": str(rank), "HVDTPU_SIZE": "2",
                    "HVDTPU_LOCAL_RANK": str(rank), "HVDTPU_LOCAL_SIZE": "2",
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
    return {name: [dict(np.load(os.path.join(out_dir, f"{name}.{r}.npz")))
                   for r in range(2)]
            for name in list(CASES) + ["dense", "stochastic", "no_unpack"]}


@pytest.mark.parametrize("name", list(CASES))
def test_world1_matches_jax(name, world1, make_runtime):
    _assert_match(name, [_run_port(name, 0)],
                  _run_jax(name, 1, make_runtime), exact=False)


@pytest.mark.parametrize("name", list(CASES))
def test_world2_matches_jax(name, world2, make_runtime):
    _assert_match(name, world2[name], _run_jax(name, 2, make_runtime),
                  exact=False)


def _dense_expected(rank):
    ins = [_dense_inputs(r) for r in range(2)]
    mean_a = (ins[0]["a"] * 0.5 + ins[1]["a"] * 0.5) / 2 * 3.0
    mean_b = (ins[0]["b"] * 0.5 + ins[1]["b"] * 0.5) / 2 * 3.0
    return {"grouped_a": mean_a, "grouped_b": mean_b,
            "sum_int": ins[0]["i"] + ins[1]["i"],
            "allgather": np.concatenate([ins[0]["rows"], ins[1]["rows"]]),
            "broadcast": ins[1]["rows"],
            "alltoall": np.concatenate([ins[0]["rows"][2 * rank:2 * rank + 2],
                                        ins[1]["rows"][2 * rank:2 * rank + 2]]),
            "optimizer": -(ins[0]["a"] + ins[1]["a"]) / 2,
            # rank 1's lr, momentum buffer (its gradient) and stepped param
            "bcast_state": np.array([0.2, 2, 2, 2, 0.6, 0.6, 0.6],
                                    np.float32)}


@pytest.mark.parametrize("key", ["grouped_a", "grouped_b", "sum_int",
                                 "allgather", "broadcast", "alltoall",
                                 "optimizer", "bcast_state"])
def test_world2_dense_collectives(key, world2):
    """Average with pre/postscale, integer Sum, allgather, broadcast from
    rank 1, alltoall, a dense DistributedOptimizer step, and
    broadcast_optimizer_state/broadcast_parameters from rank 1, against
    numpy (fp32 sums of two values: 1e-6)."""
    for rank in range(2):
        np.testing.assert_allclose(world2["dense"][rank][key],
                                   _dense_expected(rank)[key], rtol=1e-6,
                                   atol=1e-6, err_msg=f"rank {rank}")


def test_world2_matches_jax_op_by_op(world2, make_runtime):
    name = "allgather-ef"
    _assert_match(name, world2[name],
                  _run_jax(name, 2, make_runtime, compiled=False), exact=True)


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_stochastic_reducers_stay_within_their_stages(reduction, world,
                                                      world1, world2):
    """The bound of the module docstring, on rank 0's result against the
    exact sum; every rank returns the same result."""
    by_rank = ([_run_stochastic(0)] if world == 1 else world2["stochastic"])
    inputs = [_stochastic_input(r) for r in range(world)]
    exact = np.sum(inputs, axis=0, dtype=np.float64)
    bound = (world + 1) * 2 * sum(np.abs(x).max() for x in inputs) / LEVELS
    got = by_rank[0][reduction]
    assert np.abs(got - exact).max() <= bound
    for other in by_rank[1:]:
        np.testing.assert_array_equal(other[reduction], got)


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_maxmin_receive_path_never_unpacks(reduction, stochastic, world,
                                           world1, world2):
    """With ``unpack_bits`` raising, every reducer with the max-min
    quantizer still runs on every rank and gives the same result."""
    by_rank = ([_run_without_unpack(0)] if world == 1 else
               world2["no_unpack"])
    name = f"{reduction}-{'stochastic' if stochastic else 'rne'}"
    for out in by_rank:
        assert f"{name}-error" not in out, str(out[f"{name}-error"])
        np.testing.assert_array_equal(out[f"{name}-packed"], out[name])


def test_jit_rewrites_the_quantizer_arithmetic():
    """The premise of the tolerance: XLA's compiled CPU program divides by
    ``levels`` as a multiply by its reciprocal and fuses ``min + q*unit``
    into an FMA, while op-by-op JAX and the port round each step."""
    import jax
    rng = np.random.RandomState(0)
    d = (rng.rand(4096) * 3).astype(np.float32)
    q = rng.randint(0, 16, 4096).astype(np.float32)
    mn = -d
    np.testing.assert_array_equal(np.asarray(jax.jit(lambda a: a / 15)(d)),
                                  d * np.float32(1 / 15))
    assert (d * np.float32(1 / 15) != d / np.float32(15)).any()
    fused = np.asarray(jax.jit(lambda m, c, u: m + c * u)(mn, q, d))
    np.testing.assert_array_equal(
        fused, (mn.astype(np.float64) + q.astype(np.float64) *
                d.astype(np.float64)).astype(np.float32))
    assert (fused != mn + q * d).any()


def test_unported_reducers_and_ops_raise(world1):
    """An unknown reducer, a reduction op other than Sum/Average, and a
    compressor the reducers do not take, raise."""
    x = torch.ones(10)
    quant = MaxMinQuantizer(BITS, BUCKET)
    with pytest.raises(TypeError, match="MaxMinQuantizer"):
        compressed_allreduce(x, thvd.Compression.fp16)
    with pytest.raises(ValueError, match="unknown reduction"):
        compressed_allreduce(x, quant, reduction="bogus")
    with pytest.raises(ValueError, match="Sum/Average"):
        compressed_allreduce(x, quant, op=thvd.ReduceOp.MAX)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2])
