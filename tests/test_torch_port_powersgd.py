"""The port's PowerSGD held against the JAX package's.

This file is also the ranks' worker (``python <file> --worker <dir>``,
which imports no JAX). Two gloo worlds are spawned for the module at once,
of 2 and of 3 ranks (``{"dp": n}``); the JAX side runs ``run_step`` on the
first n of the 8 CPU devices.

* ``powersgd_allreduce`` against ``powersgd_allreduce_p`` for 3 steps on
  gradients in flax's layout (a ``(3, 3, 4, 5)`` conv kernel, a ``(6, 7)``
  dense kernel, a bias), rank 2, the JAX initial state carried into the
  port by ``powersgd_state_from_jax`` and the state carried across steps on
  both sides: every step's average, and the last factors and this rank's
  rows of the residuals.
* ``PowerSGDOptimizer``: ``_dryrun_powersgd_dp``'s set-up (the MLP of
  widths 8 and 4 over 6 inputs, Adam 1e-2, rank 1, the dp axis), its
  kernels kept ``(in, out)`` and applied as ``x @ W`` on the port's side,
  trained 2 steps from the same initial factors: the losses and the
  parameters.
* Properties on the port alone: at full rank the average is the dense
  one; vectors take the dense Average (bitwise ``allreduce``); the leaf
  and rank mismatch errors; the residual cap and warning.

Tolerance: every value within 1e-5 of the largest magnitude of its JAX
counterpart (1e-4 for the optimizer's parameters). Both sides compute in
fp32 and differ in the order of their sums (XLA's products and norms
against PyTorch's); Gram-Schmidt divides by column norms of order 1, so an
error stays of the order of the terms' rounding, a few 1e-7.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch.compression import powersgd as psgd

WORLDS = (2, 3)
RANK, STEPS = 2, 3
SHAPES = {"bias": (5,), "conv": (3, 3, 4, 5), "dense": (6, 7)}
TOL, OPT_TOL = 1e-5, 1e-4
MLP_IN, MLP_WIDTHS, MLP_BATCH, OPT_LR, OPT_STEPS = 6, (8, 4), 2, 1e-2, 2


def _grads(world):
    """Every step's gradients of every rank: ``{name: [world, *shape]}``."""
    rng = np.random.RandomState(world)
    return [{k: rng.randn(world, *s).astype(np.float32)
             for k, s in SHAPES.items()} for _ in range(STEPS)]


def _mlp_data(world):
    rng = np.random.RandomState(10 + world)
    x = rng.randn(world * MLP_BATCH, MLP_IN).astype(np.float32)
    y = rng.randint(0, MLP_WIDTHS[-1], world * MLP_BATCH)
    return x, y


# ---------------------------------------------------------------------------
# the ranks' cases (no JAX)
# ---------------------------------------------------------------------------

class _FlaxMLP(torch.nn.Module):
    """flax's ``MLP`` with its ``(in, out)`` kernels, applied ``x @ W``;
    the parameters registered in ``jax.tree.leaves`` order (``Dense_0``'s
    bias, kernel, then ``Dense_1``'s)."""

    def __init__(self, params):
        super().__init__()
        self.b0, self.w0, self.b1, self.w1 = (
            torch.nn.Parameter(torch.from_numpy(np.array(params[f"Dense_{i}"]
                                                         [k])))
            for i in (0, 1) for k in ("bias", "kernel"))

    def forward(self, x):
        return torch.relu(x @ self.w0 + self.b0) @ self.w1 + self.b1


def _port_allreduce(world, rank, inputs):
    state = psgd.powersgd_state_from_jax(inputs["state"], rank, world)
    outs = []
    for step in _grads(world):
        grads = {k: torch.from_numpy(v[rank]) for k, v in step.items()}
        out, state = psgd.powersgd_allreduce(grads, state, axis="dp",
                                             rank=RANK)
        outs.append({k: v.numpy() for k, v in out.items()})
    return {"outs": outs, "qs": [None if q is None else q.numpy()
                                 for q in state.qs],
            "errors": [e.numpy() for e in state.errors]}


def _port_optimizer(world, rank, inputs):
    model = _FlaxMLP(inputs["mlp_params"]["params"])
    opt = thvd.PowerSGDOptimizer(torch.optim.Adam(model.parameters(),
                                                  lr=OPT_LR),
                                 rank=1, axis="dp")
    opt.powersgd_state = psgd.powersgd_state_from_jax(
        inputs["mlp_state"], rank, world)
    x, y = _mlp_data(world)
    part = slice(rank * MLP_BATCH, (rank + 1) * MLP_BATCH)
    x, y = torch.from_numpy(x[part]), torch.from_numpy(y[part])
    losses = []
    for _ in range(OPT_STEPS):
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        losses.append(float(thvd.allreduce(loss.detach())))
    return {"losses": losses,
            "params": {k: v.detach().numpy().copy()
                       for k, v in model.named_parameters()}}


def _port_properties(world, rank):
    out = {}
    rng = np.random.RandomState(50 + world)
    full = rng.randn(world, 4, 6).astype(np.float32)
    vec = rng.randn(world, 9).astype(np.float32)
    grads = {"m": torch.from_numpy(full[rank]),
             "v": torch.from_numpy(vec[rank])}
    state = psgd.powersgd_init(grads, rank=4, world_size=world)
    avg, _ = psgd.powersgd_allreduce(grads, state, axis="dp", rank=4)
    out["full_rank"] = avg["m"].numpy()
    out["dense_bitwise"] = torch.equal(
        avg["v"], thvd.allreduce(torch.from_numpy(vec[rank])))
    return out


def _worker(out_dir):
    rank = int(os.environ["HVDTPU_RANK"])
    world = int(os.environ["HVDTPU_SIZE"])
    with open(os.path.join(out_dir, f"inputs_{world}.pkl"), "rb") as f:
        inputs = pickle.load(f)
    thvd.init(device="cpu", mesh_shape={"dp": world})
    try:
        res = {"allreduce": _port_allreduce(world, rank, inputs),
               "optimizer": _port_optimizer(world, rank, inputs),
               "properties": _port_properties(world, rank)}
    finally:
        thvd.shutdown()
    with open(os.path.join(out_dir, f"{world}_{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_state_as_numpy(state):
    return psgd.PowerSGDState(
        qs=tuple(None if q is None else np.asarray(q) for q in state.qs),
        errors=tuple(np.asarray(e) for e in state.errors))


def _jax_runtime(world, make_runtime):
    import jax
    return make_runtime(mesh_shape={"dp": world},
                        devices=jax.devices()[:world])


def _jax_allreduce(world, make_runtime):
    """Every step's average and the final state, in ``run_step``."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.compression.powersgd import (powersgd_allreduce_p,
                                                  powersgd_init,
                                                  powersgd_state_specs)
    hvd = _jax_runtime(world, make_runtime)
    local = {k: jnp.zeros(s, jnp.float32) for k, s in SHAPES.items()}
    state = powersgd_init(local, rank=RANK, world_size=world)
    initial = _jax_state_as_numpy(state)
    specs = powersgd_state_specs(state, "dp")

    def body(grads, st):
        return powersgd_allreduce_p(grads, st, axis="dp", rank=RANK)

    step = hvd.run_step(body, in_specs=(P("dp"), specs),
                        out_specs=(hvd.REPLICATED, specs))
    outs = []
    for g in _grads(world):
        flat = {k: jnp.asarray(v.reshape(world * v.shape[1], *v.shape[2:]))
                for k, v in g.items()}
        out, state = step(flat, state)
        outs.append({k: np.asarray(v) for k, v in out.items()})
    return initial, outs, _jax_state_as_numpy(state)


def _jax_optimizer(world, make_runtime):
    """``_dryrun_powersgd_dp``'s step on the MLP: initial parameters and
    factors, the losses and the parameters after ``OPT_STEPS`` steps."""
    import jax
    import jax.numpy as jnp
    import optax
    from horovod_tpu.compression import (PowerSGDOptimizer,
                                         powersgd_state_specs)
    from horovod_tpu.models import MLP
    hvd = _jax_runtime(world, make_runtime)
    model = MLP(features=MLP_WIDTHS)
    x, y = _mlp_data(world)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    opt = PowerSGDOptimizer(optax.adam(OPT_LR), rank=1, axis="dp")
    inner, state = opt.init(params)
    initial = (jax.tree.map(np.asarray, params), _jax_state_as_numpy(state))
    sspec = (hvd.REPLICATED, powersgd_state_specs(state, "dp"))

    def train_step(p, s, batch):
        def loss_fn(q):
            logits = model.apply(q, batch[0])
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, batch[1]).mean()

        loss, grads = jax.value_and_grad(loss_fn)(hvd.pvary(p))
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, hvd.allreduce(loss)

    step = hvd.run_step(
        train_step, in_specs=(hvd.REPLICATED, sspec,
                              (hvd.batch_spec(), hvd.batch_spec())),
        out_specs=(hvd.REPLICATED, sspec, hvd.REPLICATED))
    batch = hvd.shard_batch((jnp.asarray(x), jnp.asarray(y)))
    s = (inner, state)
    losses = []
    for _ in range(OPT_STEPS):
        params, s, loss = step(params, s, batch)
        losses.append(float(loss))
    return initial, losses, jax.tree.map(np.asarray, params)


def _start(out_dir, world):
    from conftest import free_port, subprocess_env
    port = free_port()
    procs = []
    for rank in range(world):
        env = subprocess_env()
        env.update({"HVDTPU_RANK": str(rank), "HVDTPU_SIZE": str(world),
                    "HVDTPU_LOCAL_RANK": str(rank),
                    "HVDTPU_LOCAL_SIZE": str(world),
                    "HVDTPU_CONTROLLER_ADDR": "127.0.0.1",
                    "HVDTPU_CONTROLLER_PORT": str(port)})
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", out_dir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return procs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Per world: the JAX results and every rank's port results."""
    import horovod_tpu as hvd

    def make_runtime(**kw):
        hvd.shutdown()
        hvd.init(**kw)
        return hvd

    out_dir = str(tmp_path_factory.mktemp("torch_powersgd"))
    jax_side = {}
    try:
        for world in WORLDS:
            initial, outs, final = _jax_allreduce(world, make_runtime)
            (params, mlp_state), losses, trained = _jax_optimizer(
                world, make_runtime)
            jax_side[world] = {"outs": outs, "final": final,
                               "losses": losses, "trained": trained}
            with open(os.path.join(out_dir, f"inputs_{world}.pkl"),
                      "wb") as f:
                pickle.dump({"state": initial, "mlp_params": params,
                             "mlp_state": mlp_state}, f)
    finally:
        hvd.shutdown()
    procs = {w: _start(out_dir, w) for w in WORLDS}
    try:
        logs = {w: [p.communicate(timeout=240)[0] for p in ps]
                for w, ps in procs.items()}
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for w, ps in procs.items():
        for p, log in zip(ps, logs[w]):
            assert p.returncode == 0, log
    out = {}
    for w in WORLDS:
        ranks = []
        for r in range(w):
            with open(os.path.join(out_dir, f"{w}_{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        out[w] = {"jax": jax_side[w], "ranks": ranks}
    return out


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30), err_msg=msg)


@pytest.mark.parametrize("world", WORLDS)
def test_allreduce_matches_jax_over_steps(world, worlds):
    """Three steps, the state carried: each step's average on every rank,
    and the final factors and each rank's rows of the residuals."""
    res = worlds[world]
    final = res["jax"]["final"]
    for rank, got in enumerate(res["ranks"]):
        got = got["allreduce"]
        for step, (g, w) in enumerate(zip(got["outs"], res["jax"]["outs"])):
            for k in SHAPES:
                _close(g[k], w[k], msg=f"step {step} {k}")
        for i, (gq, wq) in enumerate(zip(got["qs"], final.qs)):
            assert (gq is None) == (wq is None)
            if wq is not None:
                _close(gq, wq, msg=f"Q {i}")
        for i, (ge, we) in enumerate(zip(got["errors"], final.errors)):
            if we.size:
                rows = we.shape[0] // world
                we = we[rank * rows:(rank + 1) * rows]
            assert ge.shape == we.shape
            if we.size:
                _close(ge, we, msg=f"residual {i}")


@pytest.mark.parametrize("world", WORLDS)
def test_optimizer_matches_jax(world, worlds):
    """``PowerSGDOptimizer`` (Adam, rank 1) against the JAX optimizer in
    ``_dryrun_powersgd_dp``'s set-up, 2 steps."""
    res = worlds[world]
    trained = res["jax"]["trained"]["params"]
    want = {"b0": trained["Dense_0"]["bias"],
            "w0": trained["Dense_0"]["kernel"],
            "b1": trained["Dense_1"]["bias"],
            "w1": trained["Dense_1"]["kernel"]}
    for got in res["ranks"]:
        got = got["optimizer"]
        np.testing.assert_allclose(got["losses"], res["jax"]["losses"],
                                   rtol=TOL)
        for k, v in want.items():
            _close(got["params"][k], v, OPT_TOL, k)


@pytest.mark.parametrize("world", WORLDS)
def test_full_rank_is_the_dense_average_and_vectors_go_dense(world, worlds):
    rng = np.random.RandomState(50 + world)
    full = rng.randn(world, 4, 6).astype(np.float32)
    for got in worlds[world]["ranks"]:
        _close(got["properties"]["full_rank"], full.mean(0))
        assert got["properties"]["dense_bitwise"]


def test_state_mismatch_raises():
    state = psgd.powersgd_init({"w": torch.zeros(4, 4)}, rank=2)
    x = torch.ones(4, 4)
    with pytest.raises(ValueError, match="rebuild"):
        psgd.powersgd_allreduce({"a": x, "b": x}, state)
    with pytest.raises(ValueError, match="rank"):
        psgd.powersgd_allreduce({"w": x}, state, rank=4)


def test_same_factors_from_the_same_seed():
    """Every rank draws the same Q from (seed, leaf index); another seed
    draws another."""
    grads = {"a": torch.zeros(5, 3, 2), "b": torch.zeros(7, 4)}
    one, two = (psgd.powersgd_init(grads, rank=2, seed=3) for _ in range(2))
    other = psgd.powersgd_init(grads, rank=2, seed=4)
    assert all(torch.equal(a, b) for a, b in zip(one.qs, two.qs))
    assert not any(torch.equal(a, b) for a, b in zip(one.qs, other.qs))
    assert [tuple(q.shape) for q in one.qs] == [(6, 2), (4, 2)]
    assert [tuple(e.shape) for e in one.errors] == [(5, 6), (7, 4)]


def test_vgg16_wire_floats():
    """VGG-16 at rank 4 in torch's layout: P and Q of its 16 weight
    matrices, its 16 biases dense."""
    from horovod_tpu_torch.models import VGG16
    with torch.device("meta"):
        params = list(VGG16().parameters())
    assert psgd.wire_floats(params, 4) == (320_524, 13_416)
    assert sum(p.numel() for p in params) == 138_357_544


def test_residual_cap_raises_as_the_reference():
    """The cap counts ``4 · world · rows · cols``: 8 · 64 · 64 · 4 =
    131072 bytes, over a 1000-byte cap, as the JAX package counts it."""
    from horovod_tpu.compression import powersgd_init as jax_init
    import jax.numpy as jnp
    grads = {"w": torch.zeros(64, 64)}
    with pytest.raises(ValueError, match="cap"):
        psgd.powersgd_init(grads, rank=2, world_size=8,
                           max_residual_bytes=1000)
    with pytest.raises(ValueError):
        jax_init({"w": jnp.zeros((64, 64))}, rank=2, world_size=8,
                 max_residual_bytes=1000)
    st = psgd.powersgd_init(grads, rank=2, world_size=8,
                            max_residual_bytes=131072)
    assert st.errors[0].shape == (64, 64)


def test_residual_cap_and_warning_from_the_environment(monkeypatch):
    from horovod_tpu_torch.utils import logging as tlog
    msgs = []
    monkeypatch.setattr(tlog, "warning", msgs.append)
    grads = {"w": torch.zeros(64, 64)}
    monkeypatch.setenv("HVDTPU_POWERSGD_RESIDUAL_WARN", "1000")
    psgd.powersgd_init(grads, rank=2, world_size=8)
    assert any("GiB globally" in m for m in msgs)
    msgs.clear()
    monkeypatch.setenv("HVDTPU_POWERSGD_RESIDUAL_WARN", "131072")
    psgd.powersgd_init(grads, rank=2, world_size=8)
    assert not msgs
    monkeypatch.setenv("HVDTPU_POWERSGD_RESIDUAL_CAP", "131071")
    with pytest.raises(ValueError, match="cap"):
        psgd.powersgd_init(grads, rank=2, world_size=8)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2])
