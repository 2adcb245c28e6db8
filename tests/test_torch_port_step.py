"""The port's compiled step (``horovod_tpu_torch/step.py``) against the
JAX package's ``horovod_tpu/step.py`` on the CPU, where ``run_step`` runs
its step function eagerly at every call.

This file is also the ranks' worker (``python <file> --worker <dir>``,
which imports no JAX). One gloo world of 2 is spawned once and runs every
case; the JAX side runs on a 2-device CPU mesh. Inputs come from numpy
seeds.

* **Specs and placement.** ``REPLICATED``, ``batch_spec`` at dims 0-2,
  ``shard_batch`` at dims 0 and 1 over a pytree, and ``replicate``: each
  rank's block equals the shard JAX places on that rank's device, bitwise.
* **data_parallel_step against run_step**, 3 optimizer steps of
  ``test_torch_port_hooks.py``'s linear model (SGD 0.1, momentum 0.9):
  dense, and 4-bit max-min with error feedback, at
  ``backward_passes_per_step`` 1 and 2, each call one backward pass (the
  step zeroes the gradients at the window's start and steps when
  ``passes_in_window()`` says the window is full, as ``optax.MultiSteps``
  applies its update), the rank's coefficients cut from the global batch
  by ``shard_batch``. Tolerances, the hooks file's: dense within 2e-6;
  max-min within 2e-6 but for at most 1% of the values, each of those
  within that file's ``_flip_bound`` (XLA's compiled quantizer multiplies
  by ``fl(1/levels)`` and fuses the decode into an FMA, so a value within
  an ulp of a rounding midpoint may take the neighbouring code).
* **The slice as a whole**: a ResNet of ``models/`` (stages [1, 1], basic
  blocks, 4 filters, batch norm, 5 classes) on 2 x 2 images of 16x16 a
  rank, fp32, 3 steps through ``data_parallel_step`` against the same step
  written for ``hvd.run_step`` as ``examples/jax_synthetic_benchmark.py``
  writes it (dense ``DistributedOptimizer``, the batch statistics averaged
  over the ranks, the loss averaged), from the same weights
  (``flax_to_torch``). Tolerance: every parameter and statistic within
  1e-5 of its tensor's largest magnitude (at least 1), the losses within
  rtol 1e-6. Both sides sum in fp32 in other orders (XLA's convolutions
  against oneDNN's, a few 2^-24 a term over sums of up to 3·3·8 terms),
  carried through three momentum steps: they differ by 2.4e-7 and 1.7e-7
  here, while the three steps move the weights by 0.78 of their largest
  magnitude, so a wrong update or statistic fails by far.
* **In-step names.** ``rank_in_step``, ``size_in_step`` and
  ``in_named_trace`` inside a step equal JAX's inside ``run_step``;
  outside one ``in_named_trace`` is False and the other two raise
  ``NameError``, as JAX's do.
* **The cache.** A new batch shape adds a key and keeps the old one; so
  does a runtime initialized anew (world 1).
* **State in place** (world 1): over 3 steps of ``data_parallel_step`` every
  tensor of the model, of the optimizer's state (momentum, error-feedback
  residuals) and every fused bucket keeps its ``data_ptr()`` after the
  first step; a captured step reads and writes those addresses.
* **Errors** (world 1): ``donate_state=False``, and a step called in
  process mode, raise. Process mode is entered by the runtime's mode alone
  here (the native core's build is ``test_torch_port_process.py``'s);
  ``chip_smoke.py`` phase (o) calls a step in a real process-mode world.
* **Logging**: under the same environment the port's logger and the JAX
  package's have the same level and format the same record alike.
"""

import logging
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import horovod_tpu_torch as thvd
from horovod_tpu_torch import runtime
from horovod_tpu_torch.compression import CompressionConfig, MaxMinQuantizer
from horovod_tpu_torch.compression.config import LayerRule
from horovod_tpu_torch.models.resnet import ResNet, ResNetBlock

from test_torch_port_hooks import (BITS, BUCKET, JAX_CASES, LR, MOMENTUM,
                                   SHAPES, STEPS, _coefficients,
                                   _compression, _flip_bound, _jax_linear,
                                   _name, _params0)

WORLD = 2
FLIP_SHARE = 0.01
RESNET = dict(stage_sizes=[1, 1], num_classes=5, num_filters=4)
IMAGES, IMAGE = 4, 16  # the global batch: 2 images a rank
RESNET_TOL, LOSS_RTOL = 1e-5, 1e-6


def _global_batch(seed=11):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(4, 6, 3).astype(np.float32),
            "y": (rng.randn(2, 4).astype(np.float32),)}


def _resnet_data():
    rng = np.random.RandomState(7)
    return (rng.randn(IMAGES, IMAGE, IMAGE, 3).astype(np.float32),
            rng.randint(0, RESNET["num_classes"], IMAGES))


# ---------------------------------------------------------------------------
# the ranks' cases (no JAX)
# ---------------------------------------------------------------------------

def _port_specs():
    batch = _global_batch()
    dim0 = thvd.shard_batch(batch)
    dim1 = thvd.shard_batch(batch["x"], dim=1)
    whole = thvd.replicate(batch)
    return {"specs": [thvd.batch_spec(d) for d in range(3)],
            "replicated": thvd.REPLICATED,
            "dim0": {"x": dim0["x"].numpy(), "y": dim0["y"][0].numpy()},
            "dim1": dim1.numpy(),
            "whole": {"x": whole["x"].numpy(), "y": whole["y"][0].numpy()}}


def _linear_step(k):
    def train_step(model, opt, c):
        if opt.passes_in_window() == 0:
            opt.zero_grad()
        loss = sum((p * c[key][0]).sum() for key, p in model.items()) / k
        loss.backward()
        if opt.passes_in_window() == k:
            opt.step()
        return loss.detach()
    return thvd.data_parallel_step(train_step)


def _port_linear(kind, k):
    """The linear model's k * STEPS calls of data_parallel_step, each one
    backward pass on this rank's block of the global coefficients."""
    model = torch.nn.ParameterDict(
        {key: torch.nn.Parameter(torch.from_numpy(v))
         for key, v in sorted(_params0().items())})
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM),
        named_parameters=model.named_parameters(),
        compression=_compression(kind), backward_passes_per_step=k)
    step = _linear_step(k)
    for micro in range(STEPS * k):
        per_rank = [_coefficients(micro, r) for r in range(WORLD)]
        c = thvd.shard_batch({key: np.stack([pr[key] for pr in per_rank])
                              for key in SHAPES})
        step(model, opt, c)
    return {"params": {key: p.detach().numpy().copy()
                       for key, p in model.items()},
            "residuals": {key: opt.state[p]["hvd_residual"].numpy().copy()
                          for key, p in model.items()
                          if "hvd_residual" in opt.state[p]}}


def _resnet_step(model, opt, batch):
    images, labels = batch
    opt.zero_grad()
    loss = F.cross_entropy(model(images), labels)
    loss.backward()
    opt.step()
    # The batch statistics averaged over the ranks, as the JAX example's
    # step does (SyncBatchNorm's statistics).
    stats = list(model.buffers())
    for b, avg in zip(stats, thvd.grouped_allreduce(stats, op=thvd.Average)):
        b.copy_(avg)
    return thvd.allreduce(loss.detach(), op=thvd.Average)


def _port_resnet(state):
    model = ResNet(block_cls=ResNetBlock, **RESNET)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    model.train()
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM),
        named_parameters=model.named_parameters())
    step = thvd.data_parallel_step(_resnet_step)
    batch = thvd.shard_batch(_resnet_data())
    losses = [float(step(model, opt, batch)) for _ in range(STEPS)]
    return {"losses": losses,
            "state": {k: v.detach().numpy().copy()
                      for k, v in model.state_dict().items()}}


def _port_names():
    outside = {"in_named_trace": thvd.in_named_trace()}
    for name in ("rank_in_step", "size_in_step"):
        try:
            getattr(thvd, name)()
            outside[name] = "no error"
        except NameError as e:
            outside[name] = f"NameError: {e}"

    @thvd.run_step(in_specs=(thvd.REPLICATED,), out_specs=thvd.REPLICATED)
    def names(x):
        return (thvd.rank_in_step(), thvd.size_in_step(),
                thvd.in_named_trace(), thvd.in_named_trace("tp"), x + 1)

    inside = names(torch.zeros(2))
    return {"outside": outside, "inside": inside[:4]}


def _port_cache():
    step = thvd.run_step(lambda x: x * 2, in_specs=(thvd.REPLICATED,),
                         out_specs=thvd.REPLICATED)
    step(torch.ones(2, 3))
    first = step.keys()
    step(torch.ones(4, 3))
    out = step(torch.ones(2, 3))
    keys = step.keys()
    return {"first": first, "keys": keys,
            "calls": [step.entry(key).calls for key in keys],
            "out": out.numpy()}


def _worker(out_dir):
    thvd.init(device="cpu")
    with open(os.path.join(out_dir, "resnet_init.pkl"), "rb") as f:
        state = pickle.load(f)
    res = {}
    try:
        res["specs"] = _port_specs()
        for kind, k in JAX_CASES:
            res[_name(kind, k)] = _port_linear(kind, k)
        res["resnet"] = _port_resnet(state)
        res["names"] = _port_names()
        res["cache"] = _port_cache()
    finally:
        rank = thvd.rank()
        thvd.shutdown()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


# ---------------------------------------------------------------------------
# the world, spawned once; the JAX side
# ---------------------------------------------------------------------------

def _flax_resnet():
    import jax.numpy as jnp
    from horovod_tpu.models import resnet as jax_resnet
    return jax_resnet.ResNet(block_cls=jax_resnet.ResNetBlock,
                             dtype=jnp.float32, **RESNET)


@pytest.fixture(scope="module")
def initial():
    """The ResNet's flax variables, from a numpy seed."""
    import jax
    from test_torch_port_model import random_variables
    variables = random_variables(_flax_resnet(), _resnet_data()[0], 3)
    return jax.tree.map(np.asarray, variables)


@pytest.fixture(scope="module")
def world(tmp_path_factory, initial):
    from conftest import free_port, subprocess_env
    from horovod_tpu_torch.models.convert import flax_to_torch
    out_dir = str(tmp_path_factory.mktemp("torch_step"))
    with open(os.path.join(out_dir, "resnet_init.pkl"), "wb") as f:
        pickle.dump({k: v.numpy() for k, v in
                     flax_to_torch(initial).items()}, f)
    port = free_port()
    procs = []
    for rank in range(WORLD):
        env = subprocess_env()
        env.update({"HVDTPU_RANK": str(rank), "HVDTPU_SIZE": str(WORLD),
                    "HVDTPU_LOCAL_RANK": str(rank),
                    "HVDTPU_LOCAL_SIZE": str(WORLD),
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
    out = []
    for r in range(WORLD):
        with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture
def jhvd(make_runtime):
    """The JAX package on a 2-device CPU mesh."""
    import jax
    return make_runtime(mesh_shape={"dp": WORLD},
                        devices=jax.devices()[:WORLD])


def _shard(array, device):
    """The block of a JAX array on ``device``."""
    for shard in array.addressable_shards:
        if shard.device == device:
            return np.asarray(shard.data)
    raise AssertionError(device)


def test_specs_and_placement_match_jax(world, jhvd):
    import jax
    batch = _global_batch()
    dim0 = jhvd.shard_batch(batch)
    dim1 = jhvd.shard_batch(batch["x"], dim=1)
    whole = jhvd.replicate(batch)
    for rank, res in enumerate(world):
        got = res["specs"]
        assert got["specs"] == [tuple(jhvd.batch_spec(d)) for d in range(3)]
        assert got["replicated"] == tuple(jhvd.REPLICATED) == ()
        dev = jax.devices()[rank]
        np.testing.assert_array_equal(got["dim0"]["x"],
                                      _shard(dim0["x"], dev))
        np.testing.assert_array_equal(got["dim0"]["y"],
                                      _shard(dim0["y"][0], dev))
        np.testing.assert_array_equal(got["dim1"], _shard(dim1, dev))
        np.testing.assert_array_equal(got["whole"]["x"],
                                      _shard(whole["x"], dev))
        np.testing.assert_array_equal(got["whole"]["y"],
                                      _shard(whole["y"][0], dev))


@pytest.mark.parametrize("kind,k", JAX_CASES)
def test_data_parallel_step_matches_run_step(kind, k, world, make_runtime):
    want = _jax_linear(kind, k, WORLD, make_runtime)
    bound = _flip_bound(WORLD, k)
    for rank, res in enumerate(world):
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


def test_resnet_slice_matches_run_step(world, jhvd, initial):
    """The step of ``examples/jax_synthetic_benchmark.py:61-86`` in both
    packages, 3 steps from the same weights and batches."""
    import jax
    import jax.numpy as jnp
    import optax
    from horovod_tpu_torch.models.convert import flax_to_torch

    model = _flax_resnet()
    opt = jhvd.DistributedOptimizer(optax.sgd(LR, momentum=MOMENTUM))
    params, stats = initial["params"], initial["batch_stats"]
    opt_state = opt.init(params)

    def train_step(p, bstats, s, batch):
        imgs, lbls = batch

        def loss_fn(q):
            logits, updates = model.apply(
                {"params": q, "batch_stats": bstats}, imgs, train=True,
                mutable=["batch_stats"])
            loss = optax.softmax_cross_entropy_with_integer_labels(
                logits.astype(jnp.float32), lbls).mean()
            return loss, updates.get("batch_stats", {})

        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(p)
        updates, s = opt.update(grads, s, p)
        new_stats = jhvd.grouped_allreduce(new_stats, op=jhvd.Average)
        return (optax.apply_updates(p, updates), new_stats, s,
                jhvd.allreduce(loss, op=jhvd.Average))

    step = jhvd.run_step(
        train_step,
        in_specs=(jhvd.REPLICATED, jhvd.REPLICATED, jhvd.REPLICATED,
                  jhvd.batch_spec(0)),
        out_specs=jhvd.REPLICATED)
    data = jhvd.shard_batch(_resnet_data())
    losses = []
    for _ in range(STEPS):
        params, stats, opt_state, loss = step(params, stats, opt_state, data)
        losses.append(float(loss))
    want = {k: v.numpy() for k, v in flax_to_torch(jax.tree.map(
        np.asarray, {"params": params, "batch_stats": stats})).items()}
    for res in world:
        got = res["resnet"]
        np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
        assert set(got["state"]) == set(want)
        for key, value in want.items():
            np.testing.assert_allclose(
                got["state"][key], value, rtol=0,
                atol=RESNET_TOL * max(1.0, np.abs(value).max()), err_msg=key)
    # The ranks hold one model.
    for key, value in world[0]["resnet"]["state"].items():
        np.testing.assert_array_equal(world[1]["resnet"]["state"][key], value)


def test_in_step_names_match_jax(world, jhvd):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    @jhvd.run_step(in_specs=(P("dp"),), out_specs=(P("dp"), P(), P()))
    def names(x):
        return (jhvd.rank_in_step()[None], jhvd.size_in_step(),
                jnp.asarray(jhvd.in_named_trace()))

    ranks, size, inside = names(jnp.zeros(WORLD))
    assert not jhvd.in_named_trace()
    for name in ("rank_in_step", "size_in_step"):
        with pytest.raises(NameError, match="unbound axis name: dp"):
            getattr(jhvd, name)()
    for rank, res in enumerate(world):
        got = res["names"]
        assert got["inside"] == (int(ranks[rank]), int(size), bool(inside),
                                 False)
        assert got["outside"] == {
            "in_named_trace": False,
            "rank_in_step": "NameError: unbound axis name: dp",
            "size_in_step": "NameError: unbound axis name: dp"}


def test_new_shape_adds_a_cache_entry(world):
    for res in world:
        cache = res["cache"]
        assert len(cache["keys"]) == 2
        assert cache["keys"][0] == cache["first"][0]
        assert cache["calls"] == [2, 1]
        np.testing.assert_array_equal(cache["out"], 2)


# ---------------------------------------------------------------------------
# world 1
# ---------------------------------------------------------------------------

@pytest.fixture
def world1():
    thvd.init(device="cpu")
    yield
    thvd.shutdown()


def _pointers(model, opt):
    ptrs = {f"model.{k}": v.data_ptr()
            for k, v in model.state_dict(keep_vars=True).items()}
    for p, state in opt.state.items():
        for k, v in state.items():
            if torch.is_tensor(v):
                ptrs[f"state.{opt._names[id(p)]}.{k}"] = v.data_ptr()
    for i, unit in enumerate(opt._units):
        if unit.buffer is not None:
            ptrs[f"bucket.{i}"] = unit.buffer.data_ptr()
    return ptrs


def test_step_state_stays_in_place(world1):
    """One quantized group with error feedback and one dense bucket; SGD
    with momentum. After the first step every state tensor exists, and no
    later step moves one."""
    model = torch.nn.ParameterDict(
        {key: torch.nn.Parameter(torch.from_numpy(v))
         for key, v in sorted(_params0().items())})
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM),
        named_parameters=model.named_parameters(),
        compression=CompressionConfig(
            MaxMinQuantizer(BITS, BUCKET),
            rules=[LayerRule(re.compile("^b$"), ignore=True)],
            reduction="scatter_allgather", error_feedback=True))
    step = _linear_step(1)
    seen = []
    for micro in range(3):
        c = thvd.shard_batch({key: v[None] for key, v in
                              _coefficients(micro, 0).items()})
        step(model, opt, c)
        seen.append(_pointers(model, opt))
    kinds = {key.split(".")[0] for key in seen[0]}
    assert kinds == {"model", "state", "bucket"}, seen[0]
    assert {k for k in seen[0] if k.endswith("hvd_residual")} == {
        "state.a.hvd_residual", "state.c.hvd_residual"}
    for later in seen[1:]:
        assert later == seen[0]


def test_new_world_adds_a_cache_entry(world1):
    """A runtime initialized anew (an elastic reset) is another world, whose
    collectives a graph of the old one cannot run."""
    step = thvd.run_step(lambda x: x + 1, in_specs=(thvd.REPLICATED,),
                         out_specs=thvd.REPLICATED)
    step(torch.ones(2))
    thvd.reinit()
    step(torch.ones(2))
    assert len(step.keys()) == 2


def test_donate_state_false_raises(world1):
    with pytest.raises(ValueError, match="in place"):
        thvd.data_parallel_step(_resnet_step, donate_state=False)


def test_step_in_process_mode_raises(world1, monkeypatch):
    step = thvd.run_step(lambda x: x, in_specs=(thvd.REPLICATED,),
                         out_specs=thvd.REPLICATED)
    monkeypatch.setattr(runtime, "mode", lambda: "process")
    with pytest.raises(NotImplementedError, match="process mode"):
        step(torch.ones(1))


@pytest.mark.parametrize("level,hide", [("trace", None), ("debug", "1"),
                                        ("ERROR", "0"), (None, "true"),
                                        ("off", None)])
def test_loggers_agree(level, hide, monkeypatch):
    from horovod_tpu.utils import logging as jax_logging
    from horovod_tpu_torch.utils import logging as port_logging
    for name, value in (("HVDTPU_LOG_LEVEL", level),
                        ("HVDTPU_LOG_HIDE_TIME", hide)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    record = logging.LogRecord("x", port_logging.TRACE, __file__, 1,
                               "[0]: a message", (), None)
    made = []
    for module in (jax_logging, port_logging):
        logger = module.logger
        saved = list(logger.handlers), logger.level
        logger.handlers.clear()
        try:
            fresh = module._make_logger()
            made.append((fresh.level,
                         fresh.handlers[0].formatter.format(record)))
        finally:
            logger.handlers[:] = saved[0]
            logger.setLevel(saved[1])
    assert made[0] == made[1]
    assert port_logging.TRACE == jax_logging.TRACE
    assert callable(port_logging.trace) and callable(port_logging.error)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2])
