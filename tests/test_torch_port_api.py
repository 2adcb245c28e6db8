"""The rest of the port's collective API at gloo worlds 2 and 3.

This file is also the ranks' worker (``python <file> --worker <dir>``,
which imports no JAX): each world is spawned once and runs every case;
the tests read what the ranks wrote. The cases, all on per-rank inputs
drawn from a seed with numpy:

* held against the JAX package's eager collectives on a 2- or 3-device
  sub-mesh of the 8-device CPU mesh: ``allreduce`` and ``grouped_allreduce``
  (fp32 Sum and Average, pre- and postscaled), ``allgather`` (even),
  ``broadcast``, ``reducescatter`` (Sum and Average) and ``alltoall`` (even,
  and with one splits vector shared by every rank, the only uneven case
  JAX's SPMD eager path computes, ``horovod_tpu/ops/collectives.py:813-866``).
  Tolerance: moving rows is exact; a float sum may add in another order
  and is held to ``test_torch_port_collectives.py``'s bound,
  ``2 (n + 2) u A |c|`` plus four subnormal steps;
* held against their definition in numpy, exactly: ``allgather`` with dim 0
  varying by rank (a scalar counting as one row), ``alltoall`` with splits
  that vary by rank, and an even ``alltoall`` whose dim 0 varies by rank;
* every async op bitwise against its synchronous twin, and the handles'
  errors;
* agreement: a mismatched dtype, shape, reduce op, root, operation, rank,
  splits or group raises ``HvdTpuInternalError`` on every rank with the
  reference's words (``horovod_tpu/native/core.cpp:2501-2600``), and the
  world works on after it;
* autograd through ``allreduce``, ``allgather``, ``broadcast`` and
  ``alltoall`` in float64 against central differences of the N-rank
  function ``L = sum_r <w_r, f_r(x_0, ..., x_{n-1})>`` computed from its
  numpy definition (the functions are linear: within 1e-9);
* ``broadcast_object``/``allgather_object`` round trips, ``callbacks``
  against the JAX package's schedules (within 1e-6 relative: JAX computes
  in float32), ``average_metrics``, ``is_homogeneous`` and the build flags.
"""

import os
import pickle
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch import callbacks
from horovod_tpu_torch.exceptions import HvdTpuInternalError

WORLDS = (2, 3)
# world -> the local_size each rank reports: world 3 runs two "nodes" of
# 2 and 1 ranks, so it is not homogeneous.
LOCAL_SIZES = {2: (2, 2), 3: (2, 2, 1)}
SHARED_SPLITS = {2: [1, 2], 3: [2, 0, 1]}
STEPS = (0, 1, 3, 5, 8, 13, 30)
U32 = 2.0 ** -24
TINY = 2.0 ** -149


def _x(name, rank, shape, dtype=np.float32):
    rng = np.random.RandomState(zlib.crc32(f"{name}/{rank}".encode()))
    return rng.uniform(-5, 5, shape).astype(dtype)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _varying_splits(rank, n):
    """Rows rank ``rank`` sends to each rank: 0 to 3, drawn from a seed."""
    return np.random.RandomState(40 + rank).randint(0, 4, n).tolist()


# ---------------------------------------------------------------------------
# the cases, as the ranks run them (no JAX)
# ---------------------------------------------------------------------------

def _jax_cases(n):
    """name -> (inputs of this rank -> the port's output), for the cases
    the JAX package computes; ``_jax_inputs`` gives each case's inputs."""
    sp = SHARED_SPLITS[n]
    return {
        "allreduce-sum": lambda a: thvd.allreduce(_t(a[0]), op=thvd.Sum),
        "allreduce-average-scaled": lambda a: thvd.allreduce(
            _t(a[0]), op=thvd.Average, prescale_factor=0.5,
            postscale_factor=3.0),
        "grouped-average": lambda a: thvd.grouped_allreduce(
            [_t(v) for v in a], op=thvd.Average),
        "allgather-even": lambda a: thvd.allgather(_t(a[0])),
        "broadcast-root1": lambda a: thvd.broadcast(_t(a[0]), root_rank=1),
        "reducescatter-sum": lambda a: thvd.reducescatter(_t(a[0])),
        "reducescatter-average": lambda a: thvd.reducescatter(
            _t(a[0]), op=thvd.Average),
        "alltoall-even": lambda a: thvd.alltoall(_t(a[0])),
        "alltoall-shared": lambda a: thvd.alltoall(_t(a[0]), splits=sp),
    }


def _jax_inputs(case, rank, n):
    shapes = {"allreduce-sum": [(5, 3)],
              "allreduce-average-scaled": [(5, 3)],
              "grouped-average": [(4,), (2, 3)],
              "allgather-even": [(2, 3)], "broadcast-root1": [(4,)],
              "reducescatter-sum": [(6, 3)],
              "reducescatter-average": [(6, 3)],
              "alltoall-even": [(2 * n, 2)],
              "alltoall-shared": [(sum(SHARED_SPLITS[n]), 2)]}[case]
    return [_x(f"{case}{i}", rank, s) for i, s in enumerate(shapes)]


def _definition_inputs(case, rank, n):
    if case == "allgather-uneven":
        return _x(case, rank, (rank + 1, 2))
    if case == "allgather-scalar":
        return np.float32(rank * 1.5 + 0.25)
    if case == "alltoall-varying":
        return _x(case, rank, (sum(_varying_splits(rank, n)), 3))
    return _x(case, rank, ((rank + 1) * n, 2))  # alltoall-even-varying


def _definition_cases(n):
    return {
        "allgather-uneven": lambda a: thvd.allgather(_t(a)),
        "allgather-scalar": lambda a: thvd.allgather(torch.tensor(a)),
        "alltoall-varying": lambda a: thvd.alltoall(
            _t(a), splits=torch.tensor(_varying_splits(thvd.rank(), n))),
        "alltoall-even-varying": lambda a: thvd.alltoall(_t(a)),
    }


def _async_cases(n, rank):
    """name -> (sync call, async call), on the same inputs."""
    x = _t(_x("async", rank, (5, 3)))
    xb = x.to(torch.bfloat16)
    rows = _t(_x("async-rows", rank, (rank + 1, 2)))
    sp = _varying_splits(rank, n)
    a2a = _t(_x("async-a2a", rank, (sum(sp), 3)))
    even = _t(_x("async-even", rank, (2 * n, 2)))
    group = [x, _t(_x("async-g", rank, (7,))), xb]
    scaled = dict(op=thvd.Average, prescale_factor=1 / 3,
                  postscale_factor=0.1)
    return {
        "allreduce-fp32": (lambda: thvd.allreduce(x, **scaled),
                           lambda: thvd.allreduce_async(x, **scaled)),
        "allreduce-bf16": (lambda: thvd.allreduce(xb, **scaled),
                           lambda: thvd.allreduce_async(xb, **scaled)),
        "allreduce-product-bf16": (
            lambda: thvd.allreduce(xb, op=thvd.Product),
            lambda: thvd.allreduce_async(xb, op=thvd.Product)),
        "allreduce-fp16-wire": (
            lambda: thvd.allreduce(x, compression=thvd.Compression.fp16),
            lambda: thvd.allreduce_async(
                x, compression=thvd.Compression.fp16)),
        "grouped": (lambda: thvd.grouped_allreduce(group, **scaled),
                    lambda: thvd.grouped_allreduce_async(group, **scaled)),
        "allgather-uneven": (lambda: thvd.allgather(rows),
                             lambda: thvd.allgather_async(rows)),
        "broadcast": (lambda: thvd.broadcast(x, root_rank=n - 1),
                      lambda: thvd.broadcast_async(x, root_rank=n - 1)),
        "alltoall-even": (lambda: thvd.alltoall(even),
                          lambda: thvd.alltoall_async(even)),
        # An async alltoall with splits returns the payload alone.
        "alltoall-splits": (lambda: thvd.alltoall(a2a, splits=sp)[0],
                            lambda: thvd.alltoall_async(a2a, splits=sp)),
    }


def _mismatches(n, rank):
    """name -> a call that disagrees across ranks."""
    one = torch.ones(3)
    other = rank != 0
    return {
        "dtype": lambda: thvd.allreduce(
            one.double() if other else one),
        "dtype-async": lambda: thvd.allreduce_async(
            one.double() if other else one),
        "shape": lambda: thvd.allreduce(torch.ones(4 if other else 3)),
        "op": lambda: thvd.allreduce(one, op=thvd.Average if other
                                     else thvd.Sum),
        "root": lambda: thvd.broadcast(one, root_rank=rank % 2),
        "operation": lambda: thvd.allgather(one) if other else
        thvd.allreduce(one),
        "allgather-rank": lambda: thvd.allgather(
            torch.ones(2) if other else torch.ones(2, 3)),
        "allgather-trailing": lambda: thvd.allgather(
            torch.ones(2, 4 if other else 3)),
        "reducescatter-dim0": lambda: thvd.reducescatter(
            torch.ones(n + 1, 2)),
        "alltoall-splits-sum": lambda: thvd.alltoall(
            torch.ones(n, 2), splits=[1] * (n - 1) + [2 if other else 1]),
        "alltoall-uneven": lambda: thvd.alltoall(torch.ones(n + 1, 2)),
        "group": lambda: thvd.grouped_allreduce(
            [torch.ones(2), torch.ones(3)] if other else
            [torch.ones(3), torch.ones(2)]),
    }


PREFIXES = {
    "dtype": "Mismatched data types",
    "dtype-async": "Mismatched data types",
    "shape": "Mismatched allreduce tensor shapes",
    "op": "Mismatched reduce ops",
    "root": "Mismatched broadcast root ranks",
    "operation": "Mismatched collective operations",
    "allgather-rank": "Mismatched allgather tensor ranks",
    "allgather-trailing": "Mismatched allgather tensor shapes beyond the "
                          "first dimension",
    "reducescatter-dim0": "reducescatter first dimension",
    "alltoall-splits-sum": "alltoall splits sum",
    "alltoall-uneven": "alltoall first dimension",
    "group": "Mismatched allreduce tensor shapes",
}

GRAD_CASES = ("allreduce-sum", "allreduce-average-scaled",
              "allgather-uneven", "broadcast-root1", "alltoall-varying")


def _grad_inputs(case, rank, n):
    rows = {"allgather-uneven": rank + 1,
            "alltoall-varying": sum(_varying_splits(rank, n))}.get(case, 4)
    x = _x(f"grad-x-{case}", rank, (rows, 2), np.float64)
    out_rows = {"allgather-uneven": n * (n + 1) // 2,
                "alltoall-varying": sum(_varying_splits(s, n)[rank]
                                        for s in range(n))}.get(case, 4)
    w = _x(f"grad-w-{case}", rank, (out_rows, 2), np.float64)
    return x, w


def _port_fn(case, n):
    return {
        "allreduce-sum": lambda x: thvd.allreduce(x, op=thvd.Sum),
        "allreduce-average-scaled": lambda x: thvd.allreduce(
            x, prescale_factor=0.5, postscale_factor=3.0),
        "allgather-uneven": thvd.allgather,
        "broadcast-root1": lambda x: thvd.broadcast(x, root_rank=1),
        "alltoall-varying": lambda x: thvd.alltoall(
            x, splits=_varying_splits(thvd.rank(), n))[0],
    }[case]


def _to_numpy(out):
    if isinstance(out, (list, tuple)):
        return [_to_numpy(o) for o in out]
    return out.float().numpy() if out.dtype == torch.bfloat16 or \
        out.dtype == torch.float16 else out.numpy()


def _worker(out_dir):
    thvd.init(device="cpu")
    n, rank = thvd.size(), thvd.rank()
    res = {"jax": {}, "definition": {}, "async": {}, "errors": {},
           "grads": {}}
    try:
        for case, fn in _jax_cases(n).items():
            res["jax"][case] = _to_numpy(fn(_jax_inputs(case, rank, n)))
        for case, fn in _definition_cases(n).items():
            res["definition"][case] = _to_numpy(
                fn(_definition_inputs(case, rank, n)))
        for case, (sync, start) in _async_cases(n, rank).items():
            handle = start()
            assert isinstance(thvd.poll(handle), bool)
            got, want = thvd.synchronize(handle), sync()
            res["async"][case] = (_to_numpy(got), _to_numpy(want),
                                  type(got) is type(want))
        res["handles"] = _handle_errors()
        for case, call in _mismatches(n, rank).items():
            try:
                out = call()
                res["errors"][case] = f"no error: {out!r}"
            except HvdTpuInternalError as e:
                res["errors"][case] = str(e)
            # The world goes on after a refused call.
            assert float(thvd.allreduce(torch.ones(1), op=thvd.Sum)) == n
        for case in GRAD_CASES:
            x, w = _grad_inputs(case, rank, n)
            xt = _t(x).requires_grad_(True)
            (_port_fn(case, n)(xt) * _t(w)).sum().backward()
            res["grads"][case] = xt.grad.numpy()
        res["broadcast_object"] = thvd.broadcast_object(
            {"from": rank, "blob": list(range(rank * 50))}, root_rank=1)
        res["allgather_object"] = thvd.allgather_object(
            ("rank", rank, "x" * (rank * 300)))
        res["metrics"] = {k: float(v) for k, v in callbacks.average_metrics(
            {"loss": rank * 1.0 + 0.5, "acc": 0.25 * rank}).items()}
        after = callbacks.lr_schedule(lambda epoch: 0.1 ** epoch,
                                      start_epoch=1, end_epoch=3,
                                      steps_per_epoch=4, scale_to_world=True)
        smooth = callbacks.lr_schedule(0.5, end_epoch=2, steps_per_epoch=4,
                                       staircase=False)
        res["schedules"] = {
            "warmup": [callbacks.warmup_schedule(5)(s) for s in STEPS],
            "warmup-after": [callbacks.warmup_schedule(5, after=after)(s)
                             for s in STEPS],
            "schedule": [after(s) for s in STEPS],
            "schedule-smooth": [smooth(s) for s in STEPS]}
        res["homogeneous"] = thvd.is_homogeneous()
        res["gloo_enabled"] = thvd.gloo_enabled()
    finally:
        thvd.shutdown()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _handle_errors():
    """What the handle API does with a consumed, released or unknown
    handle."""
    out = {}
    h = thvd.allreduce_async(torch.ones(2))
    thvd.synchronize(h)
    for name, call in (("synchronize-twice", lambda: thvd.synchronize(h)),
                       ("poll-consumed", lambda: thvd.poll(h)),
                       ("release-unknown", lambda: thvd.release_handle(h))):
        try:
            call()
            out[name] = "no error"
        except ValueError as e:
            out[name] = str(e)
    h = thvd.broadcast_async(torch.ones(2))
    thvd.release_handle(h)
    try:
        thvd.synchronize(h)
        out["synchronize-released"] = "no error"
    except ValueError as e:
        out["synchronize-released"] = str(e)
    return out


def _start(n, out_dir):
    """Spawn the n ranks of a world; they write into ``out_dir``."""
    from conftest import free_port, subprocess_env
    port = free_port()
    procs = []
    for rank in range(n):
        env = subprocess_env()
        env.update({"HVDTPU_RANK": str(rank), "HVDTPU_SIZE": str(n),
                    "HVDTPU_LOCAL_RANK": str(rank),
                    "HVDTPU_LOCAL_SIZE": str(LOCAL_SIZES[n][rank]),
                    "HVDTPU_CONTROLLER_ADDR": "127.0.0.1",
                    "HVDTPU_CONTROLLER_PORT": str(port)})
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", out_dir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return procs


def _wait(procs):
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
    """{n: [each rank's results]}; the worlds run at the same time."""
    dirs = {n: str(tmp_path_factory.mktemp(f"torch_api_{n}")) for n in WORLDS}
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
# against the JAX package
# ---------------------------------------------------------------------------

def _sharded(hvd, per_rank):
    """Rank arrays concatenated along dim 0, sharded over the mesh."""
    import jax.numpy as jnp
    return hvd.shard_batch(jnp.asarray(np.concatenate(per_rank)))


def _jax_result(hvd, case, n):
    """Each rank's expected output (a list of arrays per rank)."""
    ins = [_jax_inputs(case, r, n) for r in range(n)]
    if case.startswith("allreduce") or case == "grouped-average":
        stacked = [_sharded(hvd, [i[k][None] for i in ins])
                   for k in range(len(ins[0]))]
        if case == "grouped-average":
            outs = hvd.grouped_allreduce(stacked, op=hvd.Average)
        elif case == "allreduce-sum":
            outs = [hvd.allreduce(stacked[0], op=hvd.Sum)]
        else:
            outs = [hvd.allreduce(stacked[0], op=hvd.Average,
                                  prescale_factor=0.5, postscale_factor=3.0)]
        return [[np.asarray(o)[0] for o in outs]] * n
    x = _sharded(hvd, [i[0] for i in ins])
    if case == "allgather-even":
        return [[np.asarray(hvd.allgather(x))]] * n
    if case == "broadcast-root1":
        return [[np.asarray(hvd.broadcast(x, root_rank=1))]] * n
    if case.startswith("reducescatter"):
        op = hvd.Sum if case.endswith("sum") else hvd.Average
        full = np.asarray(hvd.reducescatter(x, op=op))
        part = full.shape[0] // n
        return [[full[r * part:(r + 1) * part]] for r in range(n)]
    if case == "alltoall-even":
        full = np.asarray(hvd.alltoall(x))
        part = full.shape[0] // n
        return [[full[r * part:(r + 1) * part]] for r in range(n)]
    # Rank r receives splits[r] rows from each rank; the global result
    # holds the ranks' outputs in rank order.
    sp = SHARED_SPLITS[n]
    full, recv = hvd.alltoall(x, splits=sp)
    full, recv = np.asarray(full), np.asarray(recv)
    offs = np.cumsum([0] + [n * s for s in sp])
    return [[full[offs[r]:offs[r + 1]], recv[r]] for r in range(n)]


def _sum_tolerance(case, n, per_rank_leaves):
    """``2 (n + 2) u A |c| + 4 tiny``: ``A`` sums the prescaled inputs'
    magnitudes, ``c`` is the product of the later factors."""
    pre, c = 1.0, 1.0
    if "average" in case:
        c = 1.0 / n
    if case == "allreduce-average-scaled":
        pre, c = 0.5, 3.0 / n
    total = np.sum([np.abs(a) * pre for a in per_rank_leaves], axis=0)
    return 2 * (n + 2) * U32 * total * c + 4 * TINY


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(_jax_cases(2)))
def test_matches_jax(case, world, worlds, make_runtime):
    import jax
    hvd = make_runtime(mesh_shape={"dp": world}, devices=jax.devices()[:world])
    want = _jax_result(hvd, case, world)
    ins = [_jax_inputs(case, r, world) for r in range(world)]
    for rank in range(world):
        got = worlds[world][rank]["jax"][case]
        got = list(got) if isinstance(got, (list, tuple)) else [got]
        assert len(got) == len(want[rank]), case
        for k, (g, w) in enumerate(zip(got, want[rank])):
            assert g.shape == w.shape, (case, k, g.shape, w.shape)
            if case.startswith(("allreduce", "grouped", "reducescatter")):
                leaves = [i[k] for i in ins]
                tol = _sum_tolerance(case, world, leaves)
                if case.startswith("reducescatter"):
                    part = tol.shape[0] // world
                    tol = tol[rank * part:(rank + 1) * part]
                diff = np.abs(g.astype(np.float64) - w)
                assert (diff <= tol).all(), (case, rank, diff.max())
            else:
                np.testing.assert_array_equal(g, w, err_msg=case)


# ---------------------------------------------------------------------------
# against the definition
# ---------------------------------------------------------------------------

def _definition(case, n, rank):
    ins = [_definition_inputs(case, r, n) for r in range(n)]
    if case == "allgather-uneven":
        return np.concatenate(ins)
    if case == "allgather-scalar":
        return np.stack(ins)
    if case == "alltoall-even-varying":
        return np.concatenate([np.split(x, n)[rank] for x in ins])
    parts = []
    for src, x in enumerate(ins):
        sp = _varying_splits(src, n)
        off = sum(sp[:rank])
        parts.append(x[off:off + sp[rank]])
    recv = np.array([_varying_splits(src, n)[rank] for src in range(n)],
                    np.int32)
    return [np.concatenate(parts), recv]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(_definition_cases(2)))
def test_matches_definition(case, world, worlds):
    for rank in range(world):
        got = worlds[world][rank]["definition"][case]
        want = _definition(case, world, rank)
        if isinstance(want, list):
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
        else:
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# async, handles, agreement
# ---------------------------------------------------------------------------

def _bits(a):
    if isinstance(a, list):
        return [_bits(x) for x in a]
    return (a.dtype, a.shape, a.tobytes())


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(_async_cases(2, 0)))
def test_async_is_its_sync_twin_bitwise(case, world, worlds):
    for rank in range(world):
        got, want, same_type = worlds[world][rank]["async"][case]
        assert same_type, case
        assert _bits(got) == _bits(want), (case, rank)


@pytest.mark.parametrize("world", WORLDS)
def test_handle_errors(world, worlds):
    for res in worlds[world]:
        assert all(msg.startswith("unknown handle")
                   for msg in res["handles"].values()), res["handles"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(PREFIXES))
def test_agreement_error_on_every_rank(case, world, worlds):
    msgs = [res["errors"][case] for res in worlds[world]]
    assert all(m.startswith(PREFIXES[case]) for m in msgs), msgs
    assert len(set(msgs)) == 1, msgs


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

def _numpy_fn(case, n, xs):
    """Each rank's output of the N-rank function, from its definition."""
    if case == "allreduce-sum":
        return [np.sum(xs, axis=0)] * n
    if case == "allreduce-average-scaled":
        return [np.sum(xs, axis=0) * 0.5 * 3.0 / n] * n
    if case == "allgather-uneven":
        return [np.concatenate(xs)] * n
    if case == "broadcast-root1":
        return [xs[1]] * n
    outs = []
    for rank in range(n):
        parts = []
        for src, x in enumerate(xs):
            sp = _varying_splits(src, n)
            off = sum(sp[:rank])
            parts.append(x[off:off + sp[rank]])
        outs.append(np.concatenate(parts))
    return outs


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", GRAD_CASES)
def test_autograd_matches_finite_differences(case, world, worlds):
    ins = [_grad_inputs(case, r, world) for r in range(world)]
    xs = [x for x, _ in ins]
    ws = [w for _, w in ins]

    def loss(xs):
        return sum(float(np.sum(w * o))
                   for w, o in zip(ws, _numpy_fn(case, world, xs)))

    h = 1e-3
    for rank in range(world):
        fd = np.zeros_like(xs[rank])
        for idx in np.ndindex(*xs[rank].shape):
            plus = [x.copy() for x in xs]
            minus = [x.copy() for x in xs]
            plus[rank][idx] += h
            minus[rank][idx] -= h
            fd[idx] = (loss(plus) - loss(minus)) / (2 * h)
        np.testing.assert_allclose(worlds[world][rank]["grads"][case], fd,
                                   rtol=0, atol=1e-9, err_msg=case)


# ---------------------------------------------------------------------------
# objects, callbacks, runtime facts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_object_round_trips(world, worlds):
    for res in worlds[world]:
        assert res["broadcast_object"] == {"from": 1,
                                           "blob": list(range(50))}
        assert res["allgather_object"] == [("rank", r, "x" * (r * 300))
                                           for r in range(world)]


@pytest.mark.parametrize("world", WORLDS)
def test_callbacks_match_jax(world, worlds, make_runtime):
    import jax
    import jax.numpy as jnp
    from horovod_tpu import callbacks as jcb
    make_runtime(mesh_shape={"dp": world}, devices=jax.devices()[:world])
    base = 0.2
    after = jcb.lr_schedule(base, lambda epoch: jnp.power(0.1, epoch),
                            start_epoch=1, end_epoch=3, steps_per_epoch=4,
                            scale_to_world=True)
    want = {"warmup": jcb.warmup_schedule(base, 5),
            "warmup-after": jcb.warmup_schedule(base, 5, after=after),
            "schedule": after,
            "schedule-smooth": jcb.lr_schedule(base, 0.5, end_epoch=2,
                                               steps_per_epoch=4,
                                               staircase=False)}
    for res in worlds[world]:
        for name, fn in want.items():
            np.testing.assert_allclose(
                base * np.asarray(res["schedules"][name]),
                [float(fn(s)) for s in STEPS], rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(
            [res["metrics"]["loss"], res["metrics"]["acc"]],
            [np.mean([r + 0.5 for r in range(world)]),
             np.mean([0.25 * r for r in range(world)])], rtol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_runtime_facts(world, worlds):
    for res in worlds[world]:
        assert res["homogeneous"] == (len(set(LOCAL_SIZES[world])) == 1)
        assert res["gloo_enabled"]


def test_build_flags():
    assert thvd.gloo_built() and thvd.nccl_built() in (True, False)
    assert thvd.cuda_built() == torch.backends.cuda.is_built()
    assert not any(f() for f in (thvd.mpi_built, thvd.mpi_enabled,
                                 thvd.mpi_threads_supported, thvd.ddl_built,
                                 thvd.ccl_built, thvd.rocm_built))


def test_best_checkpoint_and_early_stopping(tmp_path):
    ckpt = callbacks.BestModelCheckpoint(str(tmp_path / "best.pt"),
                                         monitor="val_loss")
    assert ckpt({"val_loss": 2.0}, {"w": torch.ones(2)})
    assert not ckpt({"val_loss": 3.0}, {"w": torch.zeros(2)})
    assert ckpt({"val_loss": 1.0}, {"w": torch.full((2,), 7.0)})
    assert torch.equal(ckpt.load()["w"], torch.full((2,), 7.0))
    stop = callbacks.EarlyStopping(monitor="val_loss", patience=1)
    stop.on_epoch_end(0, {"val_loss": 1.0})
    stop.on_epoch_end(1, {"val_loss": 1.5})
    with pytest.raises(callbacks.StopTraining):
        stop.on_epoch_end(2, {"val_loss": 1.2})
    with pytest.raises(KeyError):
        stop.on_epoch_end(3, {"loss": 1.0})


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2])
