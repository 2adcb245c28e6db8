"""The port's data-parallel variants (Adasum, ZeRO-1, SyncBatchNorm) and the
slice as a whole, held against the JAX package on the same inputs.

This file is also the ranks' worker (``python <file> --worker <dir>``,
which imports no JAX). Three gloo worlds are spawned once for the module,
at the same time: 4 ranks as the mesh ``{"dcn": 2, "ici": 2}``, 2 and 3 as
``{"dp": n}``. The JAX side runs ``hvd.run_step`` over the first n devices
of the 8-device CPU mesh (``{"dp": n}``, or the 2x2 mesh for the slice),
each rank's input its row of a seeded numpy array.

Tolerances (fp32 unless said):

* Adasum, against JAX ``adasum_p`` (through ``hvd.allreduce`` in
  ``run_step``, one ``adasum_p`` a tensor for the grouped form) and the
  float64 ``adasum_reference`` of each tensor: rtol 1e-4 and atol 1e-5 (the
  JAX tests' rtol; the dot products and norms sum in another order: the
  port's per-tensor partials are float64 prefix sums); bf16 within one
  bf16 step (2^-7 of the value) of JAX, both rounding an fp32 result.
  Identical inputs give the average (at 2 and 4 ranks), orthogonal ones
  the sum, zeros zeros.
* ZeRO-1, 3 steps against JAX ``ShardedDistributedOptimizer``: SGD with
  momentum within 1e-6 (the same fp32 operations, the gradient sums in
  another order), Adam within 2e-6 (torch divides by ``sqrt(v)/sqrt(bc2)``
  where optax divides by ``sqrt(v/bc2)``); 83 parameters, so every world
  pads; each rank holds ``ceil(83 / n)`` elements a state tensor.
* SyncBatchNorm, one training step, against flax ``SyncBatchNorm`` under
  ``jax.grad`` (parameters ``pvary``-ed, so weight and bias gradients are
  each rank's own, as the port's are): rtol 1e-4, atol 1e-5 for y, dx,
  dweight and dbias, 1e-6 for the running statistics; and against the
  port's ``BatchNorm`` on the concatenated batch (y, dx, the running
  statistics, and the ranks' summed weight and bias gradients) within the
  same bounds.
* The slice: 3 SGD-momentum steps of an MLP with ``SyncBatchNorm`` over both
  axes through ``DistributedOptimizer(op=Adasum, hierarchical=("ici",
  "dcn"))`` at 2x2, against the JAX optimizer with the same
  ``hierarchical`` on the same mesh: rtol 1e-4, atol 2e-5 for the
  parameters and the running statistics. Its dense layers keep flax's
  kernel layout, ``(in, out)``: hierarchical Adasum gives each inner
  rank's part of a flattened tensor its own coefficients, so the result
  depends on the layout, and a torch ``Linear`` (``(out, in)``) would be
  split differently (ROADMAP C, reference facts).
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
from horovod_tpu_torch.models.resnet import BatchNorm
from horovod_tpu_torch.parallel import adasum_reference

MESHES = {4: {"dcn": 2, "ici": 2}, 2: {"dp": 2}, 3: {"dp": 3}}
WORLDS = tuple(MESHES)
ADASUM_CASES = ("random", "identical", "orthogonal", "zeros", "one_zero")
GROUP_SHAPES = ((33, 7), (5,), (201,))
ZERO_SHAPES = {"dense.bias": (7,), "dense.kernel": (9, 7), "out": (13,)}
ZERO_LR = {"sgd": 0.1, "adam": 1e-2}
STEPS = 3
BN_SHAPE = (2, 4, 4, 3)  # NHWC, as flax takes it
SLICE_LR, SLICE_MOMENTUM = 0.1, 0.9
RTOL, ATOL = 1e-4, 1e-5


def _rng(*key):
    return np.random.RandomState(zlib.crc32(repr(key).encode()))


def _adasum_inputs(case, world):
    """Every rank's input of an Adasum case: row r is rank r's."""
    if case == "random":
        return _rng(case, world).randn(world, 37).astype(np.float32)
    if case == "identical":
        v = _rng(case).randn(33).astype(np.float32)
        return np.stack([v] * world)
    if case == "orthogonal":
        out = np.zeros((world, 8), np.float32)
        for r in range(world):
            out[r, r] = r + 1.0
        return out
    if case == "zeros":
        return np.zeros((world, 5), np.float32)
    vals = _rng(case, world).randn(world, 11).astype(np.float32)
    vals[0] = 0.0
    return vals


def _group_inputs(world):
    return [_rng("group", world, i).randn(world, *s).astype(np.float32)
            for i, s in enumerate(GROUP_SHAPES)]


def _zero_grads(world):
    """[step][name] -> every rank's gradient."""
    return [{k: _rng("zero", world, s, k).randn(world, *shape)
             .astype(np.float32) for k, shape in ZERO_SHAPES.items()}
            for s in range(STEPS)]


def _zero_params():
    return {k: _rng("zero-p", k).randn(*s).astype(np.float32)
            for k, s in ZERO_SHAPES.items()}


def _bn_inputs(world):
    rng = _rng("bn", world)
    x = (rng.randn(world, *BN_SHAPE) * 3 + 1.5).astype(np.float32)
    cot = rng.randn(world, *BN_SHAPE).astype(np.float32)
    scale = (1 + 0.5 * rng.randn(BN_SHAPE[-1])).astype(np.float32)
    bias = rng.randn(BN_SHAPE[-1]).astype(np.float32)
    return x, cot, scale, bias


def _slice_inputs():
    """The MLP's weights (flax layouts) and every step's per-rank batch."""
    rng = _rng("slice")
    weights = {"k0": rng.randn(6, 8).astype(np.float32) * 0.5,
               "b0": rng.randn(8).astype(np.float32) * 0.1,
               "scale": (1 + 0.1 * rng.randn(8)).astype(np.float32),
               "bias": (0.1 * rng.randn(8)).astype(np.float32),
               "k1": rng.randn(8, 3).astype(np.float32) * 0.5,
               "b1": rng.randn(3).astype(np.float32) * 0.1}
    batches = [(rng.randn(4, 5, 6).astype(np.float32),
                rng.randn(4, 5, 3).astype(np.float32)) for _ in range(STEPS)]
    return weights, batches


# ---------------------------------------------------------------------------
# the ranks' cases (no JAX)
# ---------------------------------------------------------------------------

def _port_adasum(world, rank):
    out = {case: thvd.allreduce(torch.from_numpy(
        _adasum_inputs(case, world)[rank]), op=thvd.Adasum).numpy()
        for case in ADASUM_CASES}
    group = [torch.from_numpy(v[rank]) for v in _group_inputs(world)]
    out["grouped"] = [t.numpy() for t in
                      thvd.grouped_allreduce(group, op=thvd.Adasum)]
    x = torch.from_numpy(_adasum_inputs("random", world)[rank])
    out["async_bitwise"] = torch.equal(
        thvd.synchronize(thvd.allreduce_async(x, op=thvd.Adasum)),
        thvd.allreduce(x, op=thvd.Adasum))
    out["bf16"] = thvd.allreduce(x.to(torch.bfloat16), op=thvd.Adasum) \
        .float().numpy()
    out["scaled"] = thvd.allreduce(x, op=thvd.Adasum, prescale_factor=0.5,
                                   postscale_factor=3.0).numpy()
    if world == 4:
        out["dcn"] = thvd.allreduce(x, op=thvd.Adasum, axis="dcn").numpy()
    return out


def _port_zero(world, rank):
    out = {}
    for name, cls in (("sgd", torch.optim.SGD), ("adam", torch.optim.Adam)):
        params = {k: torch.nn.Parameter(torch.from_numpy(v))
                  for k, v in _zero_params().items()}
        kw = dict(momentum=0.9) if name == "sgd" else {}
        opt = thvd.ShardedDistributedOptimizer(cls, params.values(),
                                               lr=ZERO_LR[name], **kw)
        for grads in _zero_grads(world):
            opt.zero_grad()
            for k, p in params.items():
                p.grad = torch.from_numpy(grads[k][rank])
            opt.step()
        out[name] = {
            "params": {k: p.detach().numpy().copy()
                       for k, p in params.items()},
            "state_numel": sorted(t.numel() for st in opt.optimizer.state
                                  .values() for t in st.values()
                                  if torch.is_tensor(t)),
            "state_bytes": opt.state_bytes(), "shard_len": opt.shard_len}
    return out


def _bn_step(module, x, cot):
    """One training forward and backward: y, dx, dweight, dbias and the
    running statistics (NHWC outputs)."""
    x = x.permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    y = module(x)
    (y * cot.permute(0, 3, 1, 2)).sum().backward()
    return {"y": y.detach().permute(0, 2, 3, 1).numpy(),
            "dx": x.grad.permute(0, 2, 3, 1).numpy(),
            "dweight": module.weight.grad.numpy().copy(),
            "dbias": module.bias.grad.numpy().copy(),
            "mean": module.running_mean.numpy().copy(),
            "var": module.running_var.numpy().copy()}


def _bn_module(cls, scale, bias, **kw):
    module = cls(BN_SHAPE[-1], **kw)
    with torch.no_grad():
        module.weight.copy_(torch.from_numpy(scale))
        module.bias.copy_(torch.from_numpy(bias))
    return module


def _port_sync_bn(world, rank):
    x, cot, scale, bias = _bn_inputs(world)
    axis = ("dcn", "ici") if world == 4 else None
    sync = _bn_step(_bn_module(thvd.SyncBatchNorm, scale, bias, axis=axis),
                    torch.from_numpy(x[rank]), torch.from_numpy(cot[rank]))
    # The port's BatchNorm on every rank's batch at once.
    full = _bn_step(_bn_module(BatchNorm, scale, bias),
                    torch.from_numpy(x.reshape(-1, *BN_SHAPE[1:])),
                    torch.from_numpy(cot.reshape(-1, *BN_SHAPE[1:])))
    # A state_dict carries across both ways.
    bn = BatchNorm(BN_SHAPE[-1])
    bn.load_state_dict(_bn_module(thvd.SyncBatchNorm, scale,
                                  bias).state_dict())
    return {"sync": sync, "full": full,
            "state_dict": bn.weight.detach().numpy().copy()}


class _Dense(torch.nn.Module):
    """flax's ``Dense``, its kernel kept ``(in, out)``: hierarchical Adasum
    gives each inner rank's part of a flattened tensor its own
    coefficients, so the parts, and the result, depend on the layout (a
    torch ``Linear`` stores the transpose)."""

    def __init__(self, kernel, bias):
        super().__init__()
        self.kernel = torch.nn.Parameter(torch.from_numpy(kernel.copy()))
        self.bias = torch.nn.Parameter(torch.from_numpy(bias.copy()))

    def forward(self, x):
        return x @ self.kernel + self.bias


class _MLP(torch.nn.Module):
    def __init__(self, weights):
        super().__init__()
        self.fc1 = _Dense(weights["k0"], weights["b0"])
        self.bn = thvd.SyncBatchNorm(8, axis=("dcn", "ici"))
        self.fc2 = _Dense(weights["k1"], weights["b1"])
        with torch.no_grad():
            self.bn.weight.copy_(torch.from_numpy(weights["scale"]))
            self.bn.bias.copy_(torch.from_numpy(weights["bias"]))

    def forward(self, x):
        return self.fc2(torch.relu(self.bn(self.fc1(x))))


def _port_slice(rank):
    weights, batches = _slice_inputs()
    model = _MLP(weights)
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=SLICE_LR,
                        momentum=SLICE_MOMENTUM),
        named_parameters=model.named_parameters(), op=thvd.Adasum,
        hierarchical=("ici", "dcn"))
    launched = []
    for x, y in batches:
        opt.zero_grad()
        loss = ((model(torch.from_numpy(x[rank])) -
                 torch.from_numpy(y[rank])) ** 2).mean()
        loss.backward()
        launched.append(opt.hook_launches)
        opt.step()
    return {"params": {k: v.detach().numpy().copy()
                       for k, v in model.state_dict().items()},
            "launched": launched, "units": len(opt._units)}


def _worker(out_dir):
    world = int(os.environ["HVDTPU_SIZE"])
    thvd.init(device="cpu", mesh_shape=MESHES[world])
    try:
        rank = thvd.rank()
        res = {"adasum": _port_adasum(world, rank),
               "zero": _port_zero(world, rank),
               "sync_bn": _port_sync_bn(world, rank)}
        if world == 4:
            res["slice"] = _port_slice(rank)
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
    dirs = {n: str(tmp_path_factory.mktemp(f"torch_variants_{n}"))
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


def _dp(world, make_runtime):
    import jax
    return make_runtime(mesh_shape={"dp": world},
                        devices=jax.devices()[:world])


# ---------------------------------------------------------------------------
# Adasum
# ---------------------------------------------------------------------------

def _jax_adasum(tensors, world, make_runtime, dtype=None):
    """Every tensor's ``hvd.allreduce(op=Adasum)`` in one ``run_step``
    (``tensors``: each a [world, ...] array of the ranks' rows)."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    hvd = _dp(world, make_runtime)

    @hvd.run_step(in_specs=P("dp"), out_specs=P())
    def step(xs):
        return tuple(hvd.allreduce(x[0], op=hvd.Adasum) for x in xs)

    arrays = tuple(jnp.asarray(t, dtype=dtype) for t in tensors)
    return [np.asarray(o, dtype=np.float32) for o in step(arrays)]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ADASUM_CASES)
def test_adasum_matches_jax_and_reference(case, world, worlds,
                                          make_runtime):
    vals = _adasum_inputs(case, world)
    want = _jax_adasum([vals], world, make_runtime)[0]
    ref = adasum_reference(list(vals))
    np.testing.assert_allclose(want, ref, rtol=RTOL, atol=ATOL)
    if case == "identical" and world in (2, 4):
        # (At 3 ranks the third folds into the first by plain addition
        # first, so the reference gives 1.5 v.)
        np.testing.assert_allclose(ref, vals[0], rtol=1e-6)
    elif case == "orthogonal":
        np.testing.assert_allclose(ref, vals.sum(0), rtol=1e-6)
    elif case == "zeros":
        np.testing.assert_array_equal(ref, 0.0)
    for res in worlds[world]:
        got = res["adasum"][case]
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(got, worlds[world][0]["adasum"][case])


@pytest.mark.parametrize("world", WORLDS)
def test_grouped_adasum_has_per_tensor_coefficients(world, worlds,
                                                    make_runtime):
    """The grouped form is one fused exchange, yet each tensor is combined
    with its own coefficients: equal to one ``adasum_p`` a tensor, and
    not to Adasum of the concatenation."""
    group = _group_inputs(world)
    want = _jax_adasum(group, world, make_runtime)
    fused = adasum_reference([np.concatenate([g[r].reshape(-1)
                                              for g in group])
                              for r in range(world)])
    for res in worlds[world]:
        got = res["adasum"]["grouped"]
        for g, w, vals in zip(got, want, group):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(g, adasum_reference(list(vals)),
                                       rtol=RTOL, atol=ATOL)
        flat = np.concatenate([g.reshape(-1) for g in got])
        assert np.abs(flat - fused).max() > 1e-3


@pytest.mark.parametrize("world", WORLDS)
def test_adasum_async_bf16_scaled_and_on_an_axis(world, worlds,
                                                 make_runtime):
    vals = _adasum_inputs("random", world)
    want16 = _jax_adasum([vals], world, make_runtime,
                         dtype="bfloat16")[0]
    ref = adasum_reference(list(vals))
    for res in worlds[world]:
        ada = res["adasum"]
        assert ada["async_bitwise"]
        np.testing.assert_allclose(ada["bf16"], want16, rtol=2 ** -7,
                                   atol=ATOL)
        # prescale 0.5 halves each rank's vector, which Adasum's combine
        # carries through; postscale 3.
        np.testing.assert_allclose(ada["scaled"], 1.5 * ref, rtol=RTOL,
                                   atol=ATOL)
    if world == 4:
        for rank, res in enumerate(worlds[world]):
            col = [rank % 2, 2 + rank % 2]
            np.testing.assert_allclose(
                res["adasum"]["dcn"],
                adasum_reference([vals[c] for c in col]), rtol=RTOL,
                atol=ATOL)


def test_adasum_fuses_the_reference_model_on_one_card():
    """``partials``/``combine`` (what every VHDD level runs) folded as
    ``adasum_reference`` folds four ranks, on a fused buffer of three
    tensors with their own coefficients (no exchange: world 1)."""
    from horovod_tpu_torch.parallel.adasum import (bounds, combine,
                                                   partials, segments)
    group = _group_inputs(4)
    sizes = [int(np.prod(s)) for s in GROUP_SHAPES]
    rows = [torch.from_numpy(np.concatenate([g[r].reshape(-1)
                                             for g in group]))
            for r in range(4)]
    ids, ends = segments(sizes, sum(sizes), "cpu")
    cuts = bounds(ends, 0, sum(sizes), "cpu")

    def pair(a, b):
        return combine(a, b, partials(a, b, cuts), ids)

    got = pair(pair(rows[0], rows[1]), pair(rows[2], rows[3])).numpy()
    want = np.concatenate([adasum_reference(list(g)).reshape(-1)
                           for g in group])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# ZeRO-1
# ---------------------------------------------------------------------------

def _jax_zero(name, world, make_runtime):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P
    hvd = _dp(world, make_runtime)
    inner = optax.sgd(ZERO_LR["sgd"], momentum=0.9) if name == "sgd" \
        else optax.adam(ZERO_LR["adam"])
    opt = hvd.ShardedDistributedOptimizer(inner)
    params = {k: jnp.asarray(v) for k, v in _zero_params().items()}
    state = opt.init(params)
    spec = opt.state_spec(state)

    @hvd.run_step(in_specs=(P(), spec, P()), out_specs=(P(), spec))
    def step(p, s, g_all):
        g = jax.tree.map(lambda t: hvd.pvary(t)[hvd.rank_in_step()], g_all)
        updates, s = opt.update(g, s, p)
        return optax.apply_updates(p, updates), s

    for grads in _zero_grads(world):
        params, state = step(params, state,
                             {k: jnp.asarray(v) for k, v in grads.items()})
    shards = [leaf.addressable_shards[0].data.size
              for leaf in jax.tree.leaves(state) if leaf.ndim >= 1]
    return {k: np.asarray(v) for k, v in params.items()}, shards


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_zero1_matches_jax(name, world, worlds, make_runtime):
    want, jax_shards = _jax_zero(name, world, make_runtime)
    atol = 1e-6 if name == "sgd" else 2e-6
    shard = -(-83 // world)
    assert sum(int(np.prod(s)) for s in ZERO_SHAPES.values()) == 83
    assert jax_shards == [shard] * len(jax_shards)
    for res in worlds[world]:
        got = res["zero"][name]
        for k in ZERO_SHAPES:
            np.testing.assert_allclose(got["params"][k], want[k], rtol=0,
                                       atol=atol, err_msg=k)
        vectors = [n for n in got["state_numel"] if n > 1]
        assert got["shard_len"] == shard
        assert vectors == [shard] * (1 if name == "sgd" else 2)
        # Adam adds its step count, one fp32 scalar.
        assert got["state_bytes"] == 4 * (sum(vectors) +
                                          (name == "adam"))


def test_zero1_arguments():
    thvd.init(device="cpu")
    try:
        p = torch.nn.Parameter(torch.ones(3))
        with pytest.raises(ValueError, match="Average or Sum"):
            thvd.ShardedDistributedOptimizer(torch.optim.SGD, [p],
                                             op=thvd.Max, lr=0.1)
        opt = thvd.ShardedDistributedOptimizer(torch.optim.SGD, [p],
                                               op=thvd.Sum, lr=0.5)
        p.grad = torch.full((3,), 2.0)
        opt.step()
        np.testing.assert_array_equal(p.detach().numpy(), [0.0, 0.0, 0.0])
        # The parameters changed outside: the next step starts from them.
        with torch.no_grad():
            p.fill_(4.0)
        p.grad = torch.ones(3)
        opt.step()
        np.testing.assert_array_equal(p.detach().numpy(), [3.5, 3.5, 3.5])
        assert opt.state_bytes() == 0  # plain SGD keeps no state
    finally:
        thvd.shutdown()


# ---------------------------------------------------------------------------
# SyncBatchNorm
# ---------------------------------------------------------------------------

def _jax_sync_bn(world, make_runtime):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    hvd = _dp(world, make_runtime)
    x, cot, scale, bias = _bn_inputs(world)
    bn = hvd.SyncBatchNorm(use_running_average=False)
    stats = bn.init(jax.random.PRNGKey(0), jnp.asarray(x[0]))["batch_stats"]
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}

    @hvd.run_step(in_specs=(P(), P("dp"), P("dp")),
                  out_specs=(P("dp"),) * 6)
    def step(p, xs, cs):
        def loss(p, x):
            y, mut = bn.apply({"params": p, "batch_stats": stats}, x,
                              mutable=["batch_stats"])
            return jnp.sum(y * cs), (y, mut["batch_stats"])
        (_, (y, new)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(hvd.pvary(p), xs)
        lead = lambda a: hvd.pvary(a)[None]  # noqa: E731
        return (y, gx, lead(gp["scale"]), lead(gp["bias"]),
                lead(new["mean"]), lead(new["var"]))

    y, dx, ds, db, mean, var = step(params,
                                    jnp.asarray(x.reshape(-1, *BN_SHAPE[1:])),
                                    jnp.asarray(cot.reshape(-1,
                                                            *BN_SHAPE[1:])))
    per_rank = lambda a: np.asarray(a).reshape(world, -1, *a.shape[1:])  # noqa
    return {"y": per_rank(y), "dx": per_rank(dx), "dweight": np.asarray(ds),
            "dbias": np.asarray(db), "mean": np.asarray(mean),
            "var": np.asarray(var)}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", ["y", "dx", "dweight", "dbias", "mean",
                                 "var"])
def test_sync_batch_norm_matches_flax(key, world, worlds, make_runtime):
    want = _jax_sync_bn(world, make_runtime)[key]
    tol = dict(rtol=1e-6, atol=1e-6) if key in ("mean", "var") else \
        dict(rtol=RTOL, atol=ATOL)
    for rank, res in enumerate(worlds[world]):
        got = res["sync_bn"]["sync"][key]
        np.testing.assert_allclose(got, want[rank], err_msg=key, **tol)


@pytest.mark.parametrize("world", WORLDS)
def test_sync_batch_norm_is_batch_norm_of_every_rank(world, worlds):
    ranks = worlds[world]
    full = ranks[0]["sync_bn"]["full"]
    b = BN_SHAPE[0]
    for rank, res in enumerate(ranks):
        sync = res["sync_bn"]["sync"]
        for key in ("y", "dx"):
            np.testing.assert_allclose(sync[key],
                                       full[key][rank * b:(rank + 1) * b],
                                       rtol=RTOL, atol=ATOL, err_msg=key)
        for key in ("mean", "var"):
            np.testing.assert_allclose(sync[key], full[key], rtol=1e-6,
                                       atol=1e-6, err_msg=key)
        np.testing.assert_array_equal(res["sync_bn"]["state_dict"],
                                      _bn_inputs(world)[2])
    for key in ("dweight", "dbias"):
        np.testing.assert_allclose(
            sum(r["sync_bn"]["sync"][key] for r in ranks), full[key],
            rtol=RTOL, atol=ATOL, err_msg=key)


def test_convert_sync_batchnorm_keeps_the_tensors():
    from horovod_tpu_torch.models import ResNet18
    model = ResNet18(num_classes=10)
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    weights = [m.weight for m in norms]
    stats = [m.running_var for m in norms]
    before = model.state_dict()
    thvd.SyncBatchNorm.convert_sync_batchnorm(model, axis="dp")
    synced = [m for m in model.modules() if isinstance(m, BatchNorm)]
    assert len(synced) == len(norms) == 20
    assert all(isinstance(m, thvd.SyncBatchNorm) and m.axis == "dp"
               for m in synced)
    assert all(a is b for a, b in zip(weights, [m.weight for m in synced]))
    assert all(a is b for a, b in zip(stats,
                                      [m.running_var for m in synced]))
    assert list(model.state_dict()) == list(before)


def test_sync_batch_norm_takes_flax_variables():
    """``flax_to_torch`` maps a flax ResNet's ``scale``, ``bias`` and
    ``batch_stats`` into a model whose batch norms are ``SyncBatchNorm``
    (the same names); at one rank its train-mode step is flax's (the
    bounds of ``test_torch_port_model.py``: loss rtol 1e-4, gradients
    rtol 1e-4 / atol 1e-5, statistics atol 1e-5)."""
    import jax
    import jax.numpy as jnp
    import optax
    import torch.nn.functional as F
    from test_torch_port_model import jax_resnet, random_variables
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.models.convert import flax_to_torch

    flax_model = jax_resnet.ResNet(
        stage_sizes=[1, 1], block_cls=jax_resnet.BottleneckResNetBlock,
        num_classes=10, num_filters=8, dtype=jnp.float32)
    rng = np.random.RandomState(4)
    x = rng.randn(4, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, 4)
    variables = random_variables(flax_model, x, 5)

    def loss_fn(params):
        logits, updates = flax_model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean(), updates

    (want_loss, updates), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    model = resnet.ResNet(stage_sizes=[1, 1],
                          block_cls=resnet.BottleneckResNetBlock,
                          num_classes=10, num_filters=8)
    thvd.SyncBatchNorm.convert_sync_batchnorm(model)
    model.load_state_dict(flax_to_torch(variables))
    thvd.init(device="cpu")
    try:
        loss = F.cross_entropy(model(torch.from_numpy(x)),
                               torch.from_numpy(y))
        loss.backward()
    finally:
        thvd.shutdown()
    assert sum(isinstance(m, thvd.SyncBatchNorm)
               for m in model.modules()) == 9
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    named = dict(model.named_parameters())
    for k, g in flax_to_torch(
            {"params": jax.tree.map(np.asarray, grads)}).items():
        np.testing.assert_allclose(named[k].grad.numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    buffers = dict(model.named_buffers())
    for k, v in flax_to_torch({"batch_stats": jax.tree.map(
            np.asarray, updates["batch_stats"])}).items():
        np.testing.assert_allclose(buffers[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_sync_batch_norm_keeps_the_reference_variance():
    """The JAX module's E[x^2] - mean^2 (kept, not improved): at a mean of
    1e4 and a spread of 1 in fp32 it loses the variance, as the JAX module
    does (ROADMAP C's reference facts); the port's BatchNorm does not."""
    x = (1e4 + np.random.RandomState(0).randn(64, 1)).astype(np.float32)
    thvd.init(device="cpu")
    try:
        sync = thvd.SyncBatchNorm(1)
        sync(torch.from_numpy(x))
    finally:
        thvd.shutdown()
    plain = BatchNorm(1)
    plain(torch.from_numpy(x))
    exact = 0.9 + 0.1 * x.astype(np.float64).var()
    assert abs(plain.running_var.item() - exact) < 1e-3
    assert abs(sync.running_var.item() - exact) > 1e-2


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------

def _jax_slice(make_runtime):
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P
    hvd = make_runtime(mesh_shape=MESHES[4], devices=jax.devices()[:4])
    weights, batches = _slice_inputs()

    class MLP(nn.Module):
        @nn.compact
        def __call__(self, x):
            x = nn.Dense(8)(x)
            x = hvd.SyncBatchNorm(use_running_average=False,
                                  axis=("dcn", "ici"))(x)
            return nn.Dense(3)(jax.nn.relu(x))

    model = MLP()
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((5, 6)))
    params = {"Dense_0": {"kernel": weights["k0"], "bias": weights["b0"]},
              "SyncBatchNorm_0": {"scale": weights["scale"],
                                  "bias": weights["bias"]},
              "Dense_1": {"kernel": weights["k1"], "bias": weights["b1"]}}
    params = jax.tree.map(jnp.asarray, params)
    stats = variables["batch_stats"]
    opt = hvd.DistributedOptimizer(
        optax.sgd(SLICE_LR, momentum=SLICE_MOMENTUM), op=hvd.Adasum,
        hierarchical=("ici", "dcn"))
    state = opt.init(params)
    spec = P(("dcn", "ici"))

    @hvd.run_step(in_specs=(P(), P(), P(), spec, spec),
                  out_specs=(P(), P(), P()))
    def step(p, s, bs, x, y):
        def loss(q):
            out, mut = model.apply({"params": q, "batch_stats": bs}, x,
                                   mutable=["batch_stats"])
            return jnp.mean((out - y) ** 2), mut["batch_stats"]
        (_, new_bs), grads = jax.value_and_grad(loss, has_aux=True)(
            hvd.pvary(hvd.pvary(p, "ici"), "dcn"))
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, new_bs

    for x, y in batches:
        params, state, stats = step(params, state, stats,
                                    jnp.asarray(x.reshape(-1, 6)),
                                    jnp.asarray(y.reshape(-1, 3)))
    return params, stats


def test_slice_matches_jax(worlds, make_runtime):
    """3 steps of the MLP with SyncBatchNorm through
    ``DistributedOptimizer(op=Adasum, hierarchical=("ici", "dcn"))`` at
    2x2, against the JAX optimizer; the one bucket launched from the hooks
    from the second step on."""
    params, stats = _jax_slice(make_runtime)
    want = {"fc1.kernel": params["Dense_0"]["kernel"],
            "fc1.bias": params["Dense_0"]["bias"],
            "bn.weight": params["SyncBatchNorm_0"]["scale"],
            "bn.bias": params["SyncBatchNorm_0"]["bias"],
            "bn.running_mean": stats["SyncBatchNorm_0"]["mean"],
            "bn.running_var": stats["SyncBatchNorm_0"]["var"],
            "fc2.kernel": params["Dense_1"]["kernel"],
            "fc2.bias": params["Dense_1"]["bias"]}
    for res in worlds[4]:
        got = res["slice"]
        assert got["units"] == 1 and got["launched"] == [0, 1, 1]
        for k, w in want.items():
            np.testing.assert_allclose(got["params"][k], np.asarray(w),
                                       rtol=RTOL, atol=2e-5, err_msg=k)


def test_adasum_optimizer_arguments():
    thvd.init(device="cpu", mesh_shape={"dcn": 1, "ici": 1})
    try:
        from horovod_tpu_torch.compression import MaxMinQuantizer
        p = torch.nn.Parameter(torch.ones(3))
        with pytest.raises(ValueError, match="compressor"):
            thvd.DistributedOptimizer(torch.optim.SGD([p], lr=0.1),
                                      hierarchical=("ici", "dcn"),
                                      compression=thvd.Compression.fp16)
        with pytest.raises(ValueError, match="quantized"):
            thvd.DistributedOptimizer(torch.optim.SGD([p], lr=0.1),
                                      op=thvd.Adasum,
                                      compression=MaxMinQuantizer(4, 64))
        opt = thvd.DistributedOptimizer(torch.optim.SGD([p], lr=0.5),
                                        op=thvd.Adasum,
                                        hierarchical=("ici", "dcn"))
        p.grad = torch.full((3,), 2.0)
        opt.step()
        np.testing.assert_array_equal(p.detach().numpy(), [0.0, 0.0, 0.0])
    finally:
        thvd.shutdown()


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2])
