"""The port's device mesh and its two-axis reductions, held against the JAX
package on the same inputs.

This file is also the ranks' worker (``python <file> --worker <dir>``,
which imports no JAX). Three gloo worlds are spawned once for the module,
at the same time, each with its mesh: 4 ranks as ``{"dcn": 2, "ici": 2}``,
2 as ``{"dcn": 2, "ici": 1}`` and 3 as ``{"dcn": 1, "ici": 3}``. The JAX
side runs ``hvd.run_step`` on the same mesh over the first n devices of the
8-device CPU mesh, each rank's input the mesh position's shard
(``P(("dcn", "ici"))``: rank ``o * n_ici + i`` at ``(o, i)``).

Tolerances:

* hierarchical Sum and Average (lengths 64 and 37, which pads at 2 and 3
  inner ranks) against the port's flat allreduce and the JAX
  ``hierarchical_allreduce_p``: two fp32 sums of the same n values in
  different orders differ by at most ``2 (n - 1) 2^-24 Σ_r |x_r|`` an
  element, scaled like the result, plus one rounding of the scale
  (``2^-24 |result|``);
* Min, Max and the hierarchical allgather (equal and uneven dim 0):
  bitwise, in rank order;
* the hierarchical compressed allreduce (4-bit max-min, buckets of 64, with
  error feedback carried over two calls) against JAX
  ``hierarchical_compressed_allreduce_p``: the ``run_step`` rule of
  ``test_torch_port_reducers.py``. XLA's compiled quantizer multiplies by
  ``fl(1/levels)`` and fuses the decode into an FMA, so a value within an
  ulp of a rounding midpoint may take the neighbouring code; every value
  agrees within 1e-6 (plus 1e-6 of the output's magnitude; for a
  residual, the difference of two staged values, of the largest magnitude
  staged) except at most 1% of them, each within one quantization unit of
  the buckets that staged it (the largest range over ``levels`` of any
  rank's shard plus residual, or of the sum; over both axes' sizes for
  Average).

The small repairs of the collectives on an axis (the reduce-scatter's
output and Average's divisor taken from the group, descriptors agreed
within the group, point-to-point peers named by their rank in the group)
each have a case at 2x2. The flat-or-hierarchical calibration
(``parallel/strategy.py``) is held to the cases of ``tests/
test_strategy.py`` against injected bandwidth models at world 1, and at
2x2 for rank 0's timings deciding on every rank.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import horovod_tpu_torch as thvd
from horovod_tpu_torch.compression import (MaxMinQuantizer,
                                           hierarchical_compressed_allreduce)
from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.parallel import strategy

MESHES = {4: {"dcn": 2, "ici": 2}, 2: {"dcn": 2, "ici": 1},
          3: {"dcn": 1, "ici": 3}}
WORLDS = tuple(MESHES)
LENGTHS = (64, 37)
OPS = ("sum", "average")
REDUCTIONS = ("scatter_allgather", "allgather")
BITS, BUCKET = 4, 64
LEVELS = (1 << BITS) - 1
EPS = 2.0 ** -24
TOL, FLIP_SHARE = 1e-6, 0.01


def _values(world, shape, seed):
    """Every rank's input: row r is rank r's."""
    return np.random.RandomState(seed).randn(world, *shape).astype(
        np.float32)


def _op(name):
    return {"sum": thvd.Sum, "average": thvd.Average, "min": thvd.Min,
            "max": thvd.Max, "adasum": thvd.Adasum}[name]


# ---------------------------------------------------------------------------
# the ranks' cases (no JAX)
# ---------------------------------------------------------------------------

def _port_layout():
    return {"rank": thvd.rank(), "mesh": thvd.runtime.mesh_shape(),
            "axis_names": thvd.axis_names(), "dp_axis": thvd.dp_axis(),
            "groups": {axis: dist.get_process_group_ranks(
                           thvd.runtime.group(axis))
                       for axis in ("dcn", "ici")},
            "device_mesh": thvd.mesh().mesh.tolist()}


def _port_hierarchical(world, rank):
    out = {}
    for op in OPS:
        for n in LENGTHS:
            x = torch.from_numpy(_values(world, (n,), n)[rank])
            out[(op, n)] = {
                "hier": thvd.hierarchical_allreduce(
                    x, _op(op), "ici", "dcn").numpy(),
                "flat": thvd.allreduce(x, op=_op(op),
                                       axis=("dcn", "ici")).numpy()}
    for n in LENGTHS:
        x = torch.from_numpy(_values(world, (n,), n)[rank])
        out[("adasum", n)] = thvd.hierarchical_allreduce(
            x, thvd.Adasum, "ici", "dcn").numpy()
    x = torch.from_numpy(_values(world, (16,), 3)[rank])
    for op in ("min", "max"):
        out[op] = thvd.hierarchical_allreduce(x, _op(op), "ici",
                                              "dcn").numpy()
    rows = torch.from_numpy(_values(world, (3, 5), 13)[rank])
    out["gather"] = thvd.hierarchical_allgather(rows, "ici", "dcn").numpy()
    out["gather_kw"] = thvd.allgather(rows,
                                      hierarchical=("ici", "dcn")).numpy()
    out["gather_uneven"] = thvd.hierarchical_allgather(
        rows[:1 + rank % 3], "ici", "dcn").numpy()
    return out


def _port_compressed(world, rank):
    n_in = MESHES[world]["ici"]
    out = {}
    for reduction in REDUCTIONS:
        quant = MaxMinQuantizer(BITS, BUCKET)
        res = "init"
        steps = []
        for step in range(2):
            x = torch.from_numpy(_values(world, (200,), 40 + step)[rank])
            got, res = hierarchical_compressed_allreduce(
                x, quant, "ici", "dcn", reduction=reduction,
                op=thvd.Average, residual=res)
            steps.append({"out": got.numpy(), "res": res.numpy()})
        assert res.shape == (-(-200 // n_in),)
        out[reduction] = steps
    return out


ALL_REDUCTIONS = ("allgather", "scatter_allgather", "ring", "ps", "tree")


def _port_reducers_on_an_axis(world, rank):
    """Every compressed reducer over the dcn axis (4-bit max-min, Sum)."""
    from horovod_tpu_torch.compression import compressed_allreduce
    x = torch.from_numpy(_values(world, (300,), 77)[rank])
    quant = MaxMinQuantizer(BITS, BUCKET)
    return {r: compressed_allreduce(x, quant, reduction=r, op=thvd.Sum,
                                    axis="dcn").numpy()
            for r in ALL_REDUCTIONS}


def _port_repairs(world, rank):
    """The collectives on an axis: sizes, divisors, agreement and peers are
    the group's."""
    mesh = MESHES[world]
    o, i = divmod(rank, mesh["ici"])
    x = torch.full((4 * mesh["ici"], 3), float(rank))
    out = {"reducescatter": thvd.reducescatter(x, op=thvd.Average,
                                               axis="ici").numpy(),
           "allreduce_dcn": thvd.allreduce(torch.tensor([float(rank)]),
                                           op=thvd.Average,
                                           axis="dcn").numpy()}
    # Ranks of different ici groups pass different trailing dims: each
    # group agrees within itself.
    out["allgather_ici"] = thvd.allgather(
        torch.full((1 + i, 2 + o), float(rank)), axis="ici").numpy()
    n_dcn = mesh["dcn"]
    if n_dcn > 1:  # gloo has no send to oneself
        got = C.send_recv({"v": torch.tensor([float(rank)])},
                          (o + 1) % n_dcn, {"v": torch.zeros(1)},
                          (o - 1) % n_dcn, axis="dcn")
        out["send_recv_dcn"] = got["v"].numpy()
    out["broadcast_dcn"] = thvd.broadcast(torch.tensor([float(rank)]),
                                          root_rank=n_dcn - 1,
                                          axis="dcn").numpy()
    return out


def _bandwidth_model(outer_gbps, inner_gbps=100.0, latency_s=50e-6,
                     n_inner=4):
    """Step time of each program: flat sends every byte over the slow
    fabric (twice, a ring's reduce and gather); hierarchical only 1/n_inner
    of them, plus the two inner legs and more latency."""
    def measure(kind, nbytes, inner_axis, outer_axis, reps):
        if kind == "flat":
            return latency_s + 2 * nbytes / (outer_gbps * 1e9 / 8)
        ici = 2 * nbytes / (inner_gbps * 1e9 / 8)
        dcn = 2 * (nbytes / n_inner) / (outer_gbps * 1e9 / 8)
        return 3 * latency_s + ici + dcn
    return measure


def _port_strategy(world, rank):
    """Rank-dependent timings still give every rank rank 0's choices; the
    measured programs run; ("auto", ...) reduces to the mean either way,
    and Adasum ignores a flat calibration."""
    out = {}
    strategy.clear_hierarchical_decisions()
    slow = _bandwidth_model(3.0)
    fast = _bandwidth_model(100.0)
    res = thvd.autotune_hierarchical(
        "ici", "dcn", sizes=(1 << 20,),
        measure=slow if rank == 0 else fast)
    out["agreed"] = [res[1 << 20][0],
                     thvd.choose_hierarchical("ici", "dcn", 1 << 20)]
    real = thvd.autotune_hierarchical("ici", "dcn", sizes=(1 << 12,), reps=2)
    out["real"] = [(c, f > 0, h > 0) for c, f, h in real.values()]
    g = torch.from_numpy(_values(world, (16,), 5)[rank])
    for name, model in (("hier", slow), ("flat", fast)):
        strategy.clear_hierarchical_decisions()
        thvd.autotune_hierarchical("ici", "dcn", sizes=(16 << 20,),
                                   measure=model)
        out[f"auto_{name}"] = thvd.allreduce_gradients(
            {"g": g}, op=thvd.Average,
            hierarchical=("auto", "ici", "dcn"))["g"].numpy()
    out["adasum_auto"] = thvd.allreduce_gradients(
        [g], op=thvd.Adasum, hierarchical=("auto", "ici", "dcn"))[0].numpy()
    out["adasum_explicit"] = thvd.allreduce_gradients(
        [g], op=thvd.Adasum, hierarchical=("ici", "dcn"))[0].numpy()
    strategy.clear_hierarchical_decisions()
    return out


def _port_optimizer(world, rank):
    """Two SGD steps of a linear model, the dense buckets reduced
    hierarchically (one bucket a parameter), against the flat optimizer."""
    os.environ["HVDTPU_FUSION_THRESHOLD"] = "64"
    out = {}
    for name, kw in (("hier", dict(hierarchical=("ici", "dcn"))),
                     ("flat", dict(axis=("dcn", "ici")))):
        torch.manual_seed(0)
        model = torch.nn.Linear(5, 3)
        opt = thvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters(), **kw)
        for step in range(2):
            x = torch.from_numpy(_values(world, (4, 5), 60 + step)[rank])
            opt.zero_grad()
            model(x).pow(2).sum().backward()
            opt.step()
        out[name] = [p.detach().numpy().copy() for p in model.parameters()]
        out[f"{name}_units"] = len(opt._units)
    del os.environ["HVDTPU_FUSION_THRESHOLD"]
    return out


def _worker(out_dir):
    world = int(os.environ["HVDTPU_SIZE"])
    thvd.init(device="cpu", mesh_shape=MESHES[world])
    try:
        rank = thvd.rank()
        res = {"layout": _port_layout(),
               "hier": _port_hierarchical(world, rank),
               "compressed": _port_compressed(world, rank),
               "repairs": _port_repairs(world, rank),
               "reducers": _port_reducers_on_an_axis(world, rank),
               "strategy": _port_strategy(world, rank),
               "optimizer": _port_optimizer(world, rank)}
    finally:
        thvd.shutdown()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _start(n, out_dir):
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
    return procs


def _wait(procs):
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{n: [each rank's results]}; the worlds run at the same time."""
    dirs = {n: str(tmp_path_factory.mktemp(f"torch_mesh_{n}"))
            for n in WORLDS}
    started = {n: _start(n, d) for n, d in dirs.items()}
    for procs in started.values():
        _wait(procs)
    out = {}
    for n, out_dir in dirs.items():
        out[n] = []
        for r in range(n):
            with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as f:
                out[n].append(pickle.load(f))
    return out


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_mesh(world, make_runtime):
    import jax
    return make_runtime(mesh_shape=MESHES[world],
                        devices=jax.devices()[:world])


def _jax_hierarchical(world, fn, x, make_runtime, check_vma=True):
    """``fn(shard)`` in ``run_step`` over the world's mesh, each rank's
    shard a row of ``x``; the replicated result."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    hvd = _jax_mesh(world, make_runtime)
    step = hvd.run_step(fn, in_specs=P(("dcn", "ici")),
                        out_specs=hvd.REPLICATED, check_vma=check_vma)
    return np.asarray(step(jnp.asarray(x.reshape(-1, *x.shape[2:]))))


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_rank_layout_is_the_jax_one(world, worlds, make_runtime):
    """Rank o * n_ici + i sits at (o, i): its ici group is its row of the
    JAX mesh's device ids and its dcn group its column."""
    hvd = _jax_mesh(world, make_runtime)
    ids = np.vectorize(lambda d: d.id)(np.asarray(hvd.mesh().devices))
    assert ids.shape == tuple(MESHES[world].values())
    for rank, res in enumerate(worlds[world]):
        lay = res["layout"]
        o, i = np.argwhere(ids == rank)[0]
        assert lay["rank"] == rank
        assert lay["mesh"] == MESHES[world]
        assert lay["axis_names"] == ("dcn", "ici")
        assert lay["dp_axis"] == "dcn"  # no "dp" axis: the first one
        assert lay["groups"]["ici"] == ids[o].tolist()
        assert lay["groups"]["dcn"] == ids[:, i].tolist()
        assert lay["device_mesh"] == ids.tolist()


def test_mesh_shape_must_match_the_world():
    with pytest.raises(ValueError, match="does not match"):
        thvd.init(device="cpu", mesh_shape={"dcn": 2, "ici": 2})
    assert not thvd.is_initialized()


def test_mesh_shape_from_the_environment(monkeypatch):
    monkeypatch.setenv("HVDTPU_MESH_SHAPE", "dp=1,tp=1")
    thvd.init(device="cpu")
    try:
        assert thvd.runtime.mesh_shape() == {"dp": 1, "tp": 1}
        assert thvd.dp_axis() == "dp"
        assert thvd.parallel.axis_size("tp") == 1
        assert thvd.parallel.axis_bound("tp")
        assert not thvd.parallel.axis_bound("sp")
        with pytest.raises(ValueError, match="does not name"):
            thvd.allreduce(torch.ones(2), axis="sp")
    finally:
        thvd.shutdown()
    # A tuple of sizes takes its names from axis_names.
    thvd.init(device="cpu", mesh_shape=(1, 1), axis_names=("a", "b"),
              dp_axis="b")
    try:
        assert thvd.axis_names() == ("a", "b") and thvd.dp_axis() == "b"
    finally:
        thvd.shutdown()


# ---------------------------------------------------------------------------
# hierarchical allreduce and allgather
# ---------------------------------------------------------------------------

def _sum_bound(vals, scale):
    n = vals.shape[0]
    return 2 * (n - 1) * EPS * np.abs(vals).sum(0) * scale + \
        EPS * np.abs(vals.sum(0) * scale)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("op", OPS)
def test_hierarchical_matches_flat_and_jax(op, n, world, worlds,
                                           make_runtime):
    import horovod_tpu as hvd
    vals = _values(world, (n,), n)
    scale = 1.0 / world if op == "average" else 1.0
    jax_op = hvd.Average if op == "average" else hvd.Sum
    want = _jax_hierarchical(
        world, lambda x: hvd.hierarchical_allreduce_p(
            x, op=jax_op, inner_axis="ici", outer_axis="dcn"),
        vals, make_runtime)
    bound = _sum_bound(vals, scale)
    for res in worlds[world]:
        got = res["hier"][(op, n)]
        assert (np.abs(got["hier"] - got["flat"]) <= bound).all()
        assert (np.abs(got["hier"] - want) <= bound).all()
        assert (np.abs(got["hier"] - vals.sum(0) * scale) <= bound).all()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("n", LENGTHS)
def test_hierarchical_adasum_matches_jax(n, world, worlds, make_runtime):
    """Sum within the inner axis, Adasum across the outer one on each
    inner rank's part, with no division (JAX ``collectives.py:391-402``):
    against JAX and the float64 reference of each part (rtol 1e-4, atol
    1e-5)."""
    import horovod_tpu as hvd
    from horovod_tpu_torch.parallel import adasum_reference
    vals = _values(world, (n,), n)
    # Without the replication check: at one dcn rank adasum_p returns its
    # input as it is, which JAX cannot prove replicated over dcn.
    want = _jax_hierarchical(
        world, lambda x: hvd.hierarchical_allreduce_p(
            x, op=hvd.Adasum, inner_axis="ici", outer_axis="dcn"),
        vals, make_runtime, check_vma=False)
    n_in, n_out = MESHES[world]["ici"], MESHES[world]["dcn"]
    part = -(-n // n_in)
    sums = np.zeros((n_out, part * n_in), np.float32)
    sums[:, :n] = vals.reshape(n_out, n_in, n).sum(1)
    ref = np.concatenate([adasum_reference(list(sums[:, i * part:
                                                       (i + 1) * part]))
                          for i in range(n_in)])[:n]
    np.testing.assert_allclose(want, ref, rtol=1e-4, atol=1e-5)
    for res in worlds[world]:
        got = res["hier"][("adasum", n)]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_hierarchical_min_max_bitwise(world, worlds, make_runtime):
    import horovod_tpu as hvd
    vals = _values(world, (16,), 3)
    want = {op: _jax_hierarchical(
        world, lambda x, o=o: hvd.hierarchical_allreduce_p(
            x, op=o, inner_axis="ici", outer_axis="dcn"),
        vals, make_runtime) for op, o in (("min", hvd.Min),
                                          ("max", hvd.Max))}
    for res in worlds[world]:
        np.testing.assert_array_equal(res["hier"]["min"], vals.min(0))
        np.testing.assert_array_equal(res["hier"]["max"], vals.max(0))
        for op in ("min", "max"):
            np.testing.assert_array_equal(res["hier"][op], want[op])


@pytest.mark.parametrize("world", WORLDS)
def test_hierarchical_allgather_bitwise_in_rank_order(world, worlds,
                                                      make_runtime):
    import horovod_tpu as hvd
    vals = _values(world, (3, 5), 13)
    want = _jax_hierarchical(
        world, lambda x: hvd.hierarchical_allgather_p(
            x, inner_axis="ici", outer_axis="dcn"), vals, make_runtime)
    np.testing.assert_array_equal(want, vals.reshape(-1, 5))
    uneven = np.concatenate([vals[r][:1 + r % 3] for r in range(world)])
    for res in worlds[world]:
        np.testing.assert_array_equal(res["hier"]["gather"], want)
        np.testing.assert_array_equal(res["hier"]["gather_kw"], want)
        np.testing.assert_array_equal(res["hier"]["gather_uneven"], uneven)


def test_allgather_rejects_the_auto_form():
    thvd.init(device="cpu", mesh_shape={"dcn": 1, "ici": 1})
    try:
        with pytest.raises(ValueError, match="allreduce_gradients"):
            thvd.allgather(torch.ones(2), hierarchical=("auto", "ici", "dcn"))
        with pytest.raises(ValueError, match="inner_axis"):
            thvd.hierarchical_allreduce(torch.ones(2), thvd.Sum)
    finally:
        thvd.shutdown()


# ---------------------------------------------------------------------------
# hierarchical compressed allreduce
# ---------------------------------------------------------------------------

def _jax_compressed(world, reduction, make_runtime):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.compression import MaxMinQuantizer as JaxMaxMin
    from horovod_tpu.compression import hierarchical_compressed_allreduce_p
    hvd = _jax_mesh(world, make_runtime)
    quant = JaxMaxMin(BITS, BUCKET, use_pallas=False)
    spec = P(("dcn", "ici"))

    @hvd.run_step(in_specs=(spec, spec), out_specs=(hvd.REPLICATED, spec))
    def step(x, r):
        return hierarchical_compressed_allreduce_p(
            x, quant, inner_axis="ici", outer_axis="dcn",
            reduction=reduction, op=hvd.Average, residual=r)

    n_in = MESHES[world]["ici"]
    res = jnp.zeros((world * -(-200 // n_in),), jnp.float32)
    steps = []
    for s in range(2):
        out, res = step(jnp.asarray(_values(world, (200,), 40 + s)
                                    .reshape(-1)), res)
        steps.append({"out": np.asarray(out),
                      "res": np.asarray(res).reshape(world, -1)})
    return steps


def _staged_units(world, steps_res):
    """Each step's largest quantization unit a value can be moved by (the
    range over ``levels`` of any rank's shard of its inner sum plus its
    residual, or of the sum) and the largest magnitude staged."""
    mesh = MESHES[world]
    n_in, n_out = mesh["ici"], mesh["dcn"]
    units = []
    for s in range(2):
        vals = _values(world, (200,), 40 + s)
        chunk = -(-200 // n_in)
        biggest, largest = 0.0, np.abs(vals.sum(0)).max()
        for o in range(n_out):
            inner = np.zeros(chunk * n_in, np.float32)
            inner[:200] = vals[o * n_in:(o + 1) * n_in].sum(0)
            for i in range(n_in):
                prev = steps_res[s - 1][o * n_in + i] if s else 0.0
                staged = inner[i * chunk:(i + 1) * chunk] + prev
                biggest = max(biggest, np.ptp(staged))
                largest = max(largest, np.abs(staged).max())
        biggest = max(biggest, np.ptp(vals.sum(0)))
        units.append((biggest / LEVELS, largest))
    return units


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_hierarchical_compressed_matches_jax(reduction, world, worlds,
                                             make_runtime):
    want = _jax_compressed(world, reduction, make_runtime)
    units = _staged_units(world, [w["res"] for w in want])
    for rank, res in enumerate(worlds[world]):
        for s, got in enumerate(res["compressed"][reduction]):
            unit, largest = units[s]
            pairs = (("out", got["out"], want[s]["out"], unit / world,
                      np.abs(want[s]["out"])),
                     ("res", got["res"], want[s]["res"][rank], unit,
                      largest))
            for key, g, w, unit, scale in pairs:
                diff = np.abs(g - w)
                off = diff > TOL + TOL * scale
                msg = f"{reduction} step {s} {key} rank {rank}"
                assert off.mean() <= FLIP_SHARE, (msg, off.sum())
                assert (diff[off] <= unit * 1.01 + TOL).all(), \
                    (msg, diff.max(), unit)
            if s:  # the residual was carried: it moved
                assert not np.array_equal(
                    got["res"], res["compressed"][reduction][0]["res"])


def test_hierarchical_compressed_arguments():
    thvd.init(device="cpu", mesh_shape={"dcn": 1, "ici": 1})
    try:
        quant = MaxMinQuantizer(BITS, BUCKET)
        x = torch.randn(10)
        with pytest.raises(ValueError, match="Sum/Average"):
            hierarchical_compressed_allreduce(x, quant, "ici", "dcn",
                                              op=thvd.Max)
        with pytest.raises(ValueError, match="unknown reduction"):
            hierarchical_compressed_allreduce(x, quant, "ici", "dcn",
                                              reduction="bogus")
        out = hierarchical_compressed_allreduce(x, quant, "ici", "dcn")
        assert out.shape == x.shape
        out, res = hierarchical_compressed_allreduce(x, quant, "ici", "dcn",
                                                     residual=True)
        assert res.shape == (10,)
    finally:
        thvd.shutdown()


# ---------------------------------------------------------------------------
# the repairs of the collectives on an axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["reducescatter", "allreduce_dcn",
                                  "allgather_ici", "send_recv_dcn",
                                  "broadcast_dcn"])
def test_collectives_on_an_axis_take_the_group(case, worlds):
    """At 2x2: the reduce-scatter's output is sized and Average divided by
    the group's size, not the world's; the allgather's descriptors agree
    within the group (the two ici groups pass different trailing dims); a
    point-to-point peer and a broadcast root are ranks of the group."""
    world = 4
    mesh = MESHES[world]
    for rank, res in enumerate(worlds[world]):
        o, i = divmod(rank, mesh["ici"])
        row = [o * mesh["ici"] + j for j in range(mesh["ici"])]
        col = [p * mesh["ici"] + i for p in range(mesh["dcn"])]
        got = res["repairs"][case]
        if case == "reducescatter":
            want = np.full((4, 3), np.mean(row), np.float32)
        elif case == "allreduce_dcn":
            want = np.array([np.mean(col)], np.float32)
        elif case == "allgather_ici":
            want = np.concatenate([np.full((1 + j, 2 + o), float(r),
                                           np.float32)
                                   for j, r in enumerate(row)])
        elif case == "send_recv_dcn":
            want = np.array([col[(o - 1) % mesh["dcn"]]], np.float32)
        else:
            want = np.array([col[-1]], np.float32)
        np.testing.assert_array_equal(got, want, err_msg=f"rank {rank}")


@pytest.mark.parametrize("reduction", ALL_REDUCTIONS)
def test_compressed_reducers_on_an_axis(reduction, worlds):
    """At 2x2 each reducer runs over its dcn group: the ranks of a group
    get the same result, within the stages' bound of the group's exact
    sum (``test_torch_port_reducers.py``: each of at most n + 1
    quantization stages moves a value by less than one unit, at most
    ``2 M / levels``, ``M`` the sum of the group's largest magnitudes)."""
    world, mesh = 4, MESHES[4]
    vals = _values(world, (300,), 77)
    for i in range(mesh["ici"]):
        col = [o * mesh["ici"] + i for o in range(mesh["dcn"])]
        exact = vals[col].sum(0)
        bound = (len(col) + 1) * 2 * sum(np.abs(vals[r]).max()
                                         for r in col) / LEVELS
        got = [worlds[world][r]["reducers"][reduction] for r in col]
        for g in got[1:]:
            np.testing.assert_array_equal(g, got[0])
        assert np.abs(got[0] - exact).max() <= bound


@pytest.mark.parametrize("world", WORLDS)
def test_hierarchical_optimizer_matches_flat(world, worlds):
    """The linear model's two SGD steps with the buckets reduced
    hierarchically equal the flat optimizer's within the summation-order
    bound (values below 100: 1e-5)."""
    for res in worlds[world]:
        opt = res["optimizer"]
        assert opt["hier_units"] == opt["flat_units"] == 2
        for h, f in zip(opt["hier"], opt["flat"]):
            np.testing.assert_allclose(h, f, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# flat or hierarchical (the cases of tests/test_strategy.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def mesh11():
    strategy.clear_hierarchical_decisions()
    thvd.init(device="cpu", mesh_shape={"dcn": 1, "ici": 1})
    yield thvd
    strategy.clear_hierarchical_decisions()
    thvd.shutdown()


def _reshape(mesh_shape):
    thvd.shutdown()
    thvd.init(device="cpu", mesh_shape=mesh_shape)


OTHER_MESH = {"dcn": 1, "ici": 1, "tp": 1}


def test_picks_hierarchical_on_slow_outer_axis(mesh11):
    res = thvd.autotune_hierarchical(
        "ici", "dcn", sizes=(1 << 20, 16 << 20, 128 << 20),
        measure=_bandwidth_model(outer_gbps=3.0))
    assert all(choice == "hierarchical" for choice, _, _ in res.values())
    assert thvd.choose_hierarchical("ici", "dcn", 4 << 20) is True


def test_picks_flat_on_fast_outer_axis(mesh11):
    res = thvd.autotune_hierarchical(
        "ici", "dcn", sizes=(1 << 20, 16 << 20),
        measure=_bandwidth_model(outer_gbps=100.0))
    assert all(choice == "flat" for choice, _, _ in res.values())
    assert thvd.choose_hierarchical("ici", "dcn", 1 << 20) is False


def test_crossover_by_message_size(mesh11):
    def measure(kind, nbytes, inner_axis, outer_axis, reps):
        if kind == "flat":
            return 50e-6 + nbytes / 40e9
        return 200e-6 + nbytes / 160e9

    thvd.autotune_hierarchical("ici", "dcn", sizes=(1 << 16, 64 << 20),
                               measure=measure)
    assert thvd.choose_hierarchical("ici", "dcn", 1 << 16) is False
    assert thvd.choose_hierarchical("ici", "dcn", 64 << 20) is True
    # The nearest size in log space decides.
    assert thvd.choose_hierarchical("ici", "dcn", 1 << 17) is False
    assert thvd.choose_hierarchical("ici", "dcn", 32 << 20) is True


def test_uncalibrated_defaults_flat(mesh11):
    assert thvd.choose_hierarchical("ici", "dcn", 1 << 20) is False


def test_stale_table_does_not_govern_reshaped_mesh(mesh11):
    thvd.autotune_hierarchical("ici", "dcn", sizes=(16 << 20,),
                               measure=_bandwidth_model(outer_gbps=3.0))
    assert thvd.choose_hierarchical("ici", "dcn", 16 << 20) is True
    _reshape(OTHER_MESH)
    assert thvd.choose_hierarchical("ici", "dcn", 16 << 20) is False


def test_real_measurement_runs(mesh11):
    res = thvd.autotune_hierarchical("ici", "dcn", sizes=(1 << 16,), reps=2)
    (choice, flat_s, hier_s), = res.values()
    assert choice in ("flat", "hierarchical")
    assert flat_s > 0 and hier_s > 0


def test_measured_programs_run_their_collectives(mesh11, monkeypatch):
    """The timed programs move their bytes: flat one allreduce over both
    axes' group, hierarchical a reduce-scatter, an allreduce and an
    allgather."""
    calls = []
    for name in ("all_reduce", "reduce_scatter_tensor",
                 "all_gather_into_tensor"):
        fn = getattr(dist, name)
        monkeypatch.setattr(dist, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append((_n, k.get("group"))), _f(*a, **k))[1])
    x = torch.ones(1024)
    strategy._variant_fn("flat", "ici", "dcn")(x)
    assert calls == [("all_reduce", thvd.runtime.group(("ici", "dcn")))]
    del calls[:]
    strategy._variant_fn("hierarchical", "ici", "dcn")(x)
    ici, dcn = thvd.runtime.group("ici"), thvd.runtime.group("dcn")
    assert calls == [("reduce_scatter_tensor", ici), ("all_reduce", dcn),
                     ("all_gather_into_tensor", ici)]


def test_autotune_persists_and_restart_reloads(mesh11, tmp_path,
                                               monkeypatch):
    log = tmp_path / "autotune.json"
    monkeypatch.setenv("HVDTPU_AUTOTUNE_LOG", str(log))
    thvd.autotune_hierarchical("ici", "dcn", sizes=(16 << 20,),
                               measure=_bandwidth_model(outer_gbps=3.0))
    assert log.exists()
    strategy.clear_hierarchical_decisions()
    assert thvd.choose_hierarchical("ici", "dcn", 16 << 20) is True


def test_persisted_table_respects_mesh_signature(mesh11, tmp_path,
                                                 monkeypatch):
    log = tmp_path / "autotune.json"
    monkeypatch.setenv("HVDTPU_AUTOTUNE_LOG", str(log))
    thvd.autotune_hierarchical("ici", "dcn", sizes=(16 << 20,),
                               measure=_bandwidth_model(outer_gbps=3.0))
    strategy.clear_hierarchical_decisions()
    _reshape(OTHER_MESH)
    assert thvd.choose_hierarchical("ici", "dcn", 16 << 20) is False


def test_explicit_save_load_roundtrip(mesh11, tmp_path):
    thvd.autotune_hierarchical("ici", "dcn", sizes=(16 << 20,),
                               measure=_bandwidth_model(outer_gbps=3.0))
    path = thvd.save_hierarchical_decisions(str(tmp_path / "t.json"))
    strategy.clear_hierarchical_decisions()
    assert thvd.choose_hierarchical("ici", "dcn", 16 << 20) is False
    assert thvd.load_hierarchical_decisions(path) == 1
    assert thvd.choose_hierarchical("ici", "dcn", 16 << 20) is True


def test_save_without_path_is_noop(mesh11, monkeypatch):
    monkeypatch.delenv("HVDTPU_AUTOTUNE_LOG", raising=False)
    assert thvd.save_hierarchical_decisions() is None


def test_adasum_ignores_calibrated_flat_arm(mesh11):
    from horovod_tpu_torch.parallel.optimizer import _resolve
    thvd.autotune_hierarchical("ici", "dcn", sizes=(16 << 20,),
                               measure=_bandwidth_model(outer_gbps=100.0))
    assert thvd.choose_hierarchical("ici", "dcn", 16 << 20) is False
    auto = ("auto", "ici", "dcn")
    both = thvd.runtime.group(("ici", "dcn"))
    assert _resolve(None, auto, thvd.Adasum, 16 << 20) == \
        (both, ("ici", "dcn"))
    assert _resolve(None, auto, thvd.Average, 16 << 20) == (both, None)


def test_save_merges_tables_from_other_topologies(mesh11, tmp_path):
    path = str(tmp_path / "t.json")
    thvd.autotune_hierarchical("ici", "dcn", sizes=(16 << 20,),
                               measure=_bandwidth_model(outer_gbps=3.0))
    thvd.save_hierarchical_decisions(path)
    strategy.clear_hierarchical_decisions()
    _reshape(OTHER_MESH)
    thvd.autotune_hierarchical("ici", "dcn", sizes=(16 << 20,),
                               measure=_bandwidth_model(outer_gbps=3.0))
    thvd.save_hierarchical_decisions(path)
    strategy.clear_hierarchical_decisions()
    assert thvd.load_hierarchical_decisions(path) == 2
    with open(path) as f:
        assert len(json.load(f)["tables"]) == 2


def test_corrupt_log_warns_and_defaults_flat(mesh11, tmp_path, monkeypatch):
    bad = tmp_path / "bad.json"
    bad.write_text('{"tables": {"[\\"ici\\", \\"dcn\\", []]": 42}}')
    monkeypatch.setenv("HVDTPU_AUTOTUNE_LOG", str(bad))
    assert thvd.choose_hierarchical("ici", "dcn", 1 << 20) is False


def test_rank_zero_decides_on_every_rank(worlds):
    """Rank 0 measures a slow outer fabric, the others a fast one: every
    rank records rank 0's choice; the real measurement and ("auto", ...)
    run; both arms reduce to the mean; Adasum's auto-flat arm is its
    explicit hierarchical form."""
    world = 4
    vals = _values(world, (16,), 5)
    for res in worlds[world]:
        st = res["strategy"]
        assert st["agreed"] == ["hierarchical", True]
        assert [r[1:] for r in st["real"]] == [(True, True)]
        for arm in ("auto_hier", "auto_flat"):
            np.testing.assert_allclose(st[arm], vals.mean(0), rtol=1e-6,
                                       atol=1e-6)
        np.testing.assert_array_equal(st["adasum_auto"],
                                      st["adasum_explicit"])
    # Every rank recorded the same real choice, whatever it measured.
    assert len({tuple(r["strategy"]["real"][0]) for r in worlds[world]}) == 1


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2])
