"""The port's hook-driven ``DistributedOptimizer`` at gloo worlds 2 and 3,
and its error paths at world 1.

This file is also the ranks' worker (``python <file> --worker <dir>``,
which imports no JAX); each world is spawned once and runs every case.

* **Against JAX.** 3 optimizer steps of SGD (lr 0.1, momentum 0.9) on a
  linear model, ``loss_r = sum_leaf <W_leaf, C_leaf,r>`` with per-rank
  ``C`` drawn from a seed, so both frameworks differentiate to the same
  exact gradients: dense, and 4-bit max-min (buckets of 64,
  ``scatter_allgather``) with error feedback, at
  ``backward_passes_per_step`` 1 and 2, against the JAX package's
  ``DistributedOptimizer`` inside ``hvd.run_step`` on an n-device mesh
  (every rank's parameters and state stacked on the mesh axis, so the
  gradients, the accumulator and the residuals are the rank's own).
  ``optax.MultiSteps`` averages the k micro-gradients where the port sums
  them, so the port scales each micro-batch's loss by 1/k.
  Tolerance (fp32): dense, every value within 2e-6 (a sum over 3 ranks in
  another order, the running mean of MultiSteps, three momentum steps, on
  values below 8). Max-min, the rule of ``test_torch_port_reducers.py``
  for ``run_step`` programs carried through the steps: XLA's compiled
  quantizer multiplies by ``fl(1/levels)`` and fuses the decode into an
  FMA, so a value within an ulp of a rounding midpoint may take the
  neighbouring code; every value agrees within 2e-6 except at most 1% of
  them, and each of those lies within ``lr (1 + 1.9 + 2.71) 2 U`` of the
  reference, ``U`` the largest unit a bucket of the case can have
  (``2 M / levels``, ``M`` bounding the sum of every rank's largest input
  plus its residual), a code moved at each of the three steps, carried by
  the momentum.
* **Hooks.** Dense buckets (``HVDTPU_FUSION_THRESHOLD`` small) of a small
  MLP launch before ``backward()`` returns, from the second step on (the
  first ``synchronize()`` checks the layout), and reduce to the mean of the
  ranks' gradients; a parameter without a gradient contributes zeros. A
  small GPT with ``remat="full"`` fires each parameter's hook exactly once
  a pass. The quantized group launches in the last of k passes. Ranks that
  build different buckets get ``HvdTpuInternalError`` on every rank.
* **Errors** (world 1): ``zero_grad`` with gradients pending, a second
  backward pass at ``backward_passes_per_step`` 1, ``skip_synchronize``,
  ``set_backward_passes_per_step`` and the ``load_state_dict`` reset.
"""

import os
import pickle
import subprocess
import sys
import warnings
import zlib

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch.compression import CompressionConfig, MaxMinQuantizer
from horovod_tpu_torch.exceptions import HvdTpuInternalError

WORLDS = (2, 3)
SHAPES = {"a": (7, 33), "b": (40,), "c": (3, 5, 8)}
LR, MOMENTUM, STEPS, BITS, BUCKET = 0.1, 0.9, 3, 4, 64
JAX_CASES = [(kind, k) for kind in ("dense", "maxmin") for k in (1, 2)]
FLIP_SHARE = 0.01


def _name(kind, k):
    return f"{kind}-k{k}"


def _params0():
    rng = np.random.RandomState(3)
    return {key: rng.randn(*s).astype(np.float32) for key, s in SHAPES.items()}


def _coefficients(step, rank):
    """The gradient of a micro-step's loss on a rank."""
    rng = np.random.RandomState(zlib.crc32(f"c{step}/{rank}".encode()))
    return {key: rng.randn(*s).astype(np.float32) for key, s in SHAPES.items()}


def _compression(kind):
    if kind == "dense":
        return None
    return CompressionConfig(MaxMinQuantizer(BITS, BUCKET),
                             reduction="scatter_allgather",
                             error_feedback=True)


# ---------------------------------------------------------------------------
# the ranks' cases (no JAX)
# ---------------------------------------------------------------------------

def _port_linear(kind, k):
    """The linear model's k * STEPS micro-steps; the stepped parameters,
    the residuals and the hook launches seen after each backward pass."""
    rank = thvd.rank()
    # Registered in the pytree's (sorted) order: the JAX package fuses the
    # quantized leaves in that order.
    params = {key: torch.nn.Parameter(torch.from_numpy(v))
              for key, v in sorted(_params0().items())}
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(params.values(), lr=LR, momentum=MOMENTUM),
        named_parameters=params.items(), compression=_compression(kind),
        backward_passes_per_step=k)
    launches = []
    for step in range(STEPS):
        opt.zero_grad()
        for micro in range(k):
            c = _coefficients(step * k + micro, rank)
            loss = sum((p * torch.from_numpy(c[key])).sum()
                       for key, p in params.items()) / k
            loss.backward()
            launches.append(opt.hook_launches)
        opt.step()
    out = {key: p.detach().numpy().copy() for key, p in params.items()}
    res = {key: opt.state[p]["hvd_residual"].numpy().copy()
           for key, p in params.items() if "hvd_residual" in opt.state[p]}
    return {"params": out, "residuals": res, "launches": launches}


class _MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.fc1 = torch.nn.Linear(6, 10)
        self.fc2 = torch.nn.Linear(10, 3)
        self.unused = torch.nn.Parameter(torch.ones(4))

    def forward(self, x):
        return self.fc2(torch.tanh(self.fc1(x)))


def _port_buckets():
    """Dense buckets of 4 floats and more: every parameter its own bucket
    here. Per step: the hook launches after backward, the local and the
    reduced gradients."""
    rank = thvd.rank()
    os.environ["HVDTPU_FUSION_THRESHOLD"] = "16"
    try:
        model = _MLP()
        opt = thvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.05),
            named_parameters=model.named_parameters())
    finally:
        del os.environ["HVDTPU_FUSION_THRESHOLD"]
    out = []
    for step in range(2):
        rng = np.random.RandomState(zlib.crc32(f"mlp{step}/{rank}".encode()))
        x = torch.from_numpy(rng.randn(5, 6).astype(np.float32))
        opt.zero_grad()
        model(x).square().mean().backward()
        launched = opt.hook_launches
        local = {k: (p.grad.numpy().copy() if p.grad is not None else None)
                 for k, p in model.named_parameters()}
        opt.synchronize()
        reduced = {k: p.grad.numpy().copy()
                   for k, p in model.named_parameters()}
        with opt.skip_synchronize():
            opt.step()
        out.append({"launched": launched, "local": local,
                    "reduced": reduced})
    return {"steps": out, "units": len(opt._units)}


def _port_gpt():
    """A small GPT with remat="full": each parameter's hook fires once a
    pass, and every bucket launches before backward() returns."""
    from horovod_tpu_torch.models import GPT, GPTConfig, loss_fn
    cfg = GPTConfig(vocab_size=64, num_layers=2, num_heads=2, head_dim=8,
                    embed_dim=16, mlp_dim=32, attention="flash",
                    remat="full", dtype=torch.float32)
    model = GPT(cfg, seed=0)
    os.environ["HVDTPU_FUSION_THRESHOLD"] = "4096"
    try:
        opt = thvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=1e-2),
            named_parameters=model.named_parameters())
    finally:
        del os.environ["HVDTPU_FUSION_THRESHOLD"]
    fired = {}
    for name, p in model.named_parameters():
        p.register_post_accumulate_grad_hook(
            lambda p, name=name: fired.__setitem__(name,
                                                   fired.get(name, 0) + 1))
    gen = torch.Generator().manual_seed(thvd.rank())
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen)
    counts, launched = [], []
    for _ in range(2):
        fired.clear()
        opt.zero_grad()
        loss_fn(model, tokens, torch.roll(tokens, -1, 1)).backward()
        counts.append(dict(fired))
        launched.append(opt.hook_launches)
        opt.step()
    return {"fired": counts, "launched": launched, "units": len(opt._units),
            "params": len(list(model.parameters()))}


def _port_layout_mismatch():
    width = 4 if thvd.rank() == 0 else 5
    params = [torch.nn.Parameter(torch.ones(3)),
              torch.nn.Parameter(torch.ones(width))]
    opt = thvd.DistributedOptimizer(torch.optim.SGD(params, lr=0.1))
    sum(p.sum() for p in params).backward()
    try:
        opt.step()
    except HvdTpuInternalError as e:
        return str(e)
    return "no error"


def _worker(out_dir):
    thvd.init(device="cpu")
    res = {}
    try:
        for kind, k in JAX_CASES:
            res[_name(kind, k)] = _port_linear(kind, k)
        res["buckets"] = _port_buckets()
        res["gpt"] = _port_gpt()
        res["layout"] = _port_layout_mismatch()
        # The world goes on after the refused layout.
        assert float(thvd.allreduce(torch.ones(1), op=thvd.Sum)) == \
            thvd.size()
    finally:
        rank = thvd.rank()
        thvd.shutdown()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _start(n, out_dir):
    """Spawn the n ranks of a world; they write into ``out_dir``."""
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
    dirs = {n: str(tmp_path_factory.mktemp(f"torch_hooks_{n}")) for n in WORLDS}
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
# against JAX
# ---------------------------------------------------------------------------

def _jax_linear(kind, k, n, make_runtime):
    """The JAX package's DistributedOptimizer on the same micro-steps:
    {"params": per-rank arrays, "residuals": per-rank arrays}."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.compression import CompressionConfig as JaxConfig
    from horovod_tpu.compression import MaxMinQuantizer as JaxMaxMin

    hvd = make_runtime(mesh_shape={"dp": n}, devices=jax.devices()[:n])
    comp = None if kind == "dense" else JaxConfig(
        JaxMaxMin(BITS, BUCKET, use_pallas=False),
        reduction="scatter_allgather", error_feedback=True)
    opt = hvd.DistributedOptimizer(optax.sgd(LR, momentum=MOMENTUM),
                                   compression=comp,
                                   backward_passes_per_step=k)
    params0 = {key: jnp.asarray(v) for key, v in _params0().items()}
    stack = lambda tree: jax.tree.map(  # noqa: E731
        lambda a: jnp.stack([jnp.asarray(a)] * n), tree)
    params, state = stack(params0), stack(opt.init(params0))

    def loss(p, c):
        return sum(jnp.sum(p[key] * c[key]) for key in p)

    @hvd.run_step(in_specs=(P("dp"), P("dp"), P("dp")),
                  out_specs=(P("dp"), P("dp")))
    def step(params, state, c):
        first = lambda tree: jax.tree.map(lambda a: a[0], tree)  # noqa
        p, s = first(params), first(state)
        updates, s = opt.update(jax.grad(loss)(p, first(c)), s, p)
        p = optax.apply_updates(p, updates)
        lead = lambda tree: jax.tree.map(lambda a: a[None], tree)  # noqa
        return lead(p), lead(s)

    for micro in range(STEPS * k):
        per_rank = [_coefficients(micro, r) for r in range(n)]
        c = {key: jnp.asarray(np.stack([pr[key] for pr in per_rank]))
             for key in SHAPES}
        params, state = step(params, state, c)
    out = {"params": {key: np.asarray(v) for key, v in params.items()}}
    if comp is not None:
        inner = state.inner_opt_state if k > 1 else state
        out["residuals"] = {key: np.asarray(v)
                            for key, v in inner[1].items()}
    return out


def _flip_bound(n, k):
    """``lr (1 + 1.9 + 2.71) 2 U`` with ``U = 2 M / levels`` (module
    docstring): ``M`` is the sum over ranks of the largest accumulated
    gradient, doubled for the residual, which stays below a unit."""
    levels = (1 << BITS) - 1
    m = 0.0
    for step in range(STEPS):
        acc = [sum(np.concatenate([v.reshape(-1) for v in
                                   _coefficients(step * k + i, r).values()])
                   for i in range(k)) / k for r in range(n)]
        m = max(m, sum(2 * np.abs(a).max() for a in acc))
    return LR * (1 + 1.9 + 2.71) * 2 * (2 * m / levels)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind,k", JAX_CASES)
def test_steps_match_jax(kind, k, world, worlds, make_runtime):
    want = _jax_linear(kind, k, world, make_runtime)
    bound = _flip_bound(world, k)
    for rank, res in enumerate(worlds[world]):
        got = res[_name(kind, k)]
        pairs = [(got["params"][key], want["params"][key][rank])
                 for key in SHAPES]
        if kind != "dense":
            pairs += [(got["residuals"][key], want["residuals"][key][rank])
                      for key in SHAPES]
        diff = np.concatenate([np.abs(g - w).reshape(-1) for g, w in pairs])
        if kind == "dense":
            assert diff.max() <= 2e-6, diff.max()
            continue
        far = diff > 2e-6
        assert far.mean() <= FLIP_SHARE, (far.sum(), diff.size)
        assert diff.max() <= bound, (diff.max(), bound)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind,k", JAX_CASES)
def test_hooks_launch_in_the_last_pass(kind, k, world, worlds):
    """The first window only counts (the layout is checked in its
    synchronize()); then the one unit of the case launches in the k-th
    backward pass of each step, none before it."""
    for res in worlds[world]:
        launches = res[_name(kind, k)]["launches"]
        assert launches == [0] * k + ([0] * (k - 1) + [1]) * (STEPS - 1)


@pytest.mark.parametrize("world", WORLDS)
def test_dense_buckets_launch_during_backward(world, worlds):
    ranks = worlds[world]
    units = ranks[0]["buckets"]["units"]
    assert units == 5  # fc2.bias, fc2.weight, fc1.bias, fc1.weight, unused
    for step in range(2):
        for res in ranks:
            # Every bucket but the unused parameter's, from step 2 on.
            assert res["buckets"]["steps"][step]["launched"] == \
                (units - 1 if step else 0)
        for key, got in ranks[0]["buckets"]["steps"][step]["reduced"].items():
            locals_ = [r["buckets"]["steps"][step]["local"][key]
                       for r in ranks]
            if key == "unused":
                assert all(g is None for g in locals_)
                np.testing.assert_array_equal(got, 0)
                continue
            np.testing.assert_allclose(got, np.mean(locals_, axis=0),
                                       rtol=1e-6, atol=1e-7, err_msg=key)
            for res in ranks[1:]:
                np.testing.assert_array_equal(
                    res["buckets"]["steps"][step]["reduced"][key], got)


@pytest.mark.parametrize("world", WORLDS)
def test_remat_fires_each_hook_once(world, worlds):
    for res in worlds[world]:
        gpt = res["gpt"]
        for fired in gpt["fired"]:
            assert len(fired) == gpt["params"]
            assert set(fired.values()) == {1}, fired
        assert gpt["units"] > 1
        assert gpt["launched"] == [0, gpt["units"]]


@pytest.mark.parametrize("world", WORLDS)
def test_mismatched_layouts_raise_on_every_rank(world, worlds):
    for res in worlds[world]:
        assert res["layout"].startswith(
            "Mismatched DistributedOptimizer layouts"), res["layout"]


# ---------------------------------------------------------------------------
# error paths, world 1
# ---------------------------------------------------------------------------

@pytest.fixture
def world1():
    thvd.init(device="cpu")
    yield
    thvd.shutdown()


def _one_param(**kwargs):
    p = torch.nn.Parameter(torch.ones(3))
    return p, thvd.DistributedOptimizer(torch.optim.SGD([p], lr=1.0),
                                        **kwargs)


def test_zero_grad_with_pending_gradients_raises(world1):
    p, opt = _one_param()
    p.sum().backward()
    with pytest.raises(AssertionError, match="zero_grad"):
        opt.zero_grad()
    opt.step()
    opt.zero_grad()


def test_second_backward_pass_raises(world1):
    p, opt = _one_param()
    p.sum().backward()
    with pytest.raises(AssertionError, match="already reduced"):
        p.sum().backward()


def test_skip_synchronize(world1):
    p, opt = _one_param(op=thvd.Sum, postscale_factor=2.0)
    (p * 3).sum().backward()
    opt.synchronize()
    with opt.skip_synchronize():
        opt.step()
    np.testing.assert_array_equal(p.detach().numpy(), 1.0 - 6.0)
    # step() after a manual synchronize() reduces again, with a warning.
    opt.zero_grad()
    (p * 3).sum().backward()
    opt.synchronize()
    with pytest.warns(UserWarning, match="skip_synchronize"):
        opt.step()
    np.testing.assert_array_equal(p.detach().numpy(), -5.0 - 12.0)


def test_accumulation_window_and_reset(world1):
    p, opt = _one_param(backward_passes_per_step=2)
    p.sum().backward()
    assert opt.hook_launches == 0
    # A step inside the window reduces the partial sum.
    opt.step()
    np.testing.assert_array_equal(p.detach().numpy(), 0.0)
    opt.set_backward_passes_per_step(3)
    opt.zero_grad()
    for _ in range(3):
        p.sum().backward()
    assert opt.hook_launches == 1
    opt.step()
    np.testing.assert_array_equal(p.detach().numpy(), -3.0)
    # load_state_dict drops the window: zero_grad is allowed again.
    opt.zero_grad()
    p.sum().backward()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        opt.load_state_dict(opt.state_dict())
    opt.zero_grad()
    for _ in range(3):
        p.sum().backward()
    opt.step()
    np.testing.assert_array_equal(p.detach().numpy(), -6.0)


def test_fusion_threshold_is_read(world1, monkeypatch):
    params = [torch.nn.Parameter(torch.ones(8)) for _ in range(4)]
    monkeypatch.setenv("HVDTPU_FUSION_THRESHOLD", "64")
    opt = thvd.DistributedOptimizer(torch.optim.SGD(params, lr=1.0))
    assert [len(u.params) for u in opt._units] == [2, 2]
    assert opt._units[0].params == params[::-1][:2]
    monkeypatch.delenv("HVDTPU_FUSION_THRESHOLD")
    opt = thvd.DistributedOptimizer(torch.optim.SGD(params, lr=1.0))
    assert len(opt._units) == 1


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2])
