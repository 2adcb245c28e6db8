"""The port's model parallelism held against the JAX package's ``run_step``.

This file is also the ranks' worker (``python <file> --worker <dir>``,
which imports no JAX). One gloo world of 4 ranks is spawned for the module
and initializes the runtime anew on each mesh in turn: ``{"dp": 1, "tp": 2,
"sp": 2}``, ``{"dp": 1, "ep": 2, "sp": 2}``, ``{"dp": 2, "pp": 2}`` and
``{"dp": 2, "tp": 2}``. The JAX side runs ``hvd.run_step`` on the same mesh
over the first 4 of the 8 CPU devices.

The same global parameters (``gpt.init_params(PRNGKey(0))``, norm weights
drawn from numpy so that they matter, cut to each rank's shards by
``gpt_params_to_torch``) and the same numpy batch go through both, as
``_gpt_train_step`` in ``__graft_entry__.py`` drives them (fp32, tiny
widths, ``optax.sgd(0.1)`` behind ``DistributedOptimizer``); the port steps
with ``DistributedOptimizer(axis="dp")`` and
``gpt.sum_replica_grads``. Cases: GPT on tp x sp with ``ring``,
``ulysses``, ``dense`` and ``ulysses_flash`` (JAX in Pallas interpret mode,
the port's plain flash), 8 query heads over 4 kv heads; the switch-MoE GPT
on ep x sp (4 experts, capacity factor 1, so tokens are dropped); GPipe on
dp x pp (``_dryrun_pipeline_pp``'s stage and data, M = 4; also with
``remat=True``); GPT on dp x tp. The flax-style ``Transformer`` with
``make_ring_attention``/``make_ulysses_attention`` over sp is held to the
same model on the whole sequence (within 1e-5).
Each in-step operator's gradient is held against ``jax.grad`` of a
``shard_map`` body at 2 x 2, and the eager collectives' rules in their
place (the parent's ``_AllreduceFn`` as the tensor-parallel sum, its
``_BroadcastFn`` as the pipeline's broadcast) against the axis size times
the JAX gradient they give.

Tolerance: the losses within rtol 1e-5, and after two SGD steps every
parameter within 1e-5 of the largest magnitude of its JAX counterpart. Both
sides compute in fp32 and differ only in the order of their sums: XLA's
fused CPU reductions and einsums against PyTorch's, ring attention's
recurrence, the per-axis sums and the dp average done in the other order.
Each sum of n terms may move by a few n·2^-24 of its terms' magnitudes, a
few 1e-6 for the widths here; a missing or doubled sum over an axis of 2
moves a value by its own size. The operators' gradients are exact sums of
two or four values: within 1e-6.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch.models import gpt
from horovod_tpu_torch.models.convert import gpt_params_to_torch
from horovod_tpu_torch.ops import spmd
from horovod_tpu_torch.parallel import local_shard, mesh_coords
from horovod_tpu_torch.parallel.pipeline import pipeline_apply

WORLD = 4
MESHES = {"tp_sp": {"dp": 1, "tp": 2, "sp": 2},
          "ep_sp": {"dp": 1, "ep": 2, "sp": 2},
          "dp_pp": {"dp": 2, "pp": 2},
          "dp_tp": {"dp": 2, "tp": 2}}
DENSE = dict(vocab_size=64, num_layers=2, num_heads=8, num_kv_heads=4,
             head_dim=8, embed_dim=32, mlp_dim=32)
# Plain attention (``"dense"``) takes no GQA in either package: its k and
# v keep the query heads.
GPT_CASES = {
    **{att: ("tp_sp", dict(DENSE, tp_axis="tp", sp_axis="sp",
                           attention=att,
                           num_kv_heads=None if att == "dense" else 4))
       for att in ("ring", "ulysses", "dense", "ulysses_flash")},
    "moe": ("ep_sp", dict(vocab_size=64, num_layers=2, num_heads=4,
                          head_dim=8, embed_dim=32, mlp_dim=32, tp_axis=None,
                          sp_axis="sp", ep_axis="ep", attention="ring",
                          moe_every=2, num_experts=4, capacity_factor=1.0)),
    "dp_tp": ("dp_tp", dict(DENSE, tp_axis="tp", sp_axis=None,
                            attention="dense", num_kv_heads=None)),
}
STEPS, LR = 2, 0.1
PIPE_M, PIPE_MB, PIPE_D = 4, 2, 8
RTOL, OP_TOL = 1e-5, 1e-6
# The in-step operators at 2 x 2 ({"dp": 2, "tp": 2}): name -> the axis.
OP_CASES = ("psum", "psum_both", "pvary", "ppermute_ring", "ppermute_line",
            "all_to_all", "broadcast_p", "eager_allreduce", "eager_broadcast")


def _batch(name):
    """Global tokens, targets and positions of a GPT case."""
    mesh, kw = MESHES[GPT_CASES[name][0]], GPT_CASES[name][1]
    shards = mesh.get("dp", 1) * (mesh.get("ep", 1) if kw.get("ep_axis")
                                  else 1)
    B, S = 2 * shards, 8 * mesh.get("sp", 1)
    rng = np.random.RandomState(5)
    tokens = rng.randint(0, kw["vocab_size"], (B, S))
    targets = np.roll(tokens, -1, axis=1)
    targets[:, -1] = -1
    positions = np.broadcast_to(np.arange(S), (B, S)).copy()
    return tokens, targets, positions


def _op_inputs():
    rng = np.random.RandomState(9)
    return {"x": rng.randn(WORLD, 4).astype(np.float32),
            "w": rng.randn(WORLD, 4).astype(np.float32),
            "x_dp": rng.randn(2, 4).astype(np.float32),
            "x2": rng.randn(WORLD, 2, 4).astype(np.float32),
            "w2": rng.randn(WORLD, 4, 2).astype(np.float32)}


# ---------------------------------------------------------------------------
# the ranks' cases (no JAX)
# ---------------------------------------------------------------------------

def _port_gpt(name, params):
    mesh_name, kw = GPT_CASES[name]
    cfg = gpt.GPTConfig(dtype=torch.float32, **kw)
    model = gpt.GPT(cfg)
    model.load_state_dict(gpt_params_to_torch(params, cfg))
    opt = thvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LR),
        named_parameters=model.named_parameters(), axis="dp")
    spec = gpt.data_specs(cfg)
    tokens, targets, positions = (local_shard(torch.from_numpy(a), spec)
                                  for a in _batch(name))
    n_dp = MESHES[mesh_name]["dp"]
    losses = []
    for _ in range(STEPS):
        opt.zero_grad()
        loss = gpt.loss_fn(model, tokens, targets, positions)
        loss.backward()
        opt.synchronize()
        gpt.sum_replica_grads(model)
        with opt.skip_synchronize():
            opt.step()
        losses.append(float(thvd.allreduce(loss.detach(), op=thvd.Sum,
                                           axis="dp")) / n_dp)
    aux = [{k: float(v) for k, v in block.moe_aux.items()}
           for block in model.layers if block.moe is not None]
    return {"losses": losses, "aux": aux, "coords": mesh_coords(),
            "params": {k: v.numpy().copy()
                       for k, v in model.state_dict().items()}}


def _stage(w, h):
    return h + torch.tanh(h @ w)


def _port_pipeline(pipe, broadcast=None, remat=False):
    W = torch.nn.Parameter(local_shard(torch.from_numpy(pipe["W"]),
                                       ("pp",)).clone())
    x = local_shard(torch.from_numpy(pipe["x"]), (None, "dp"))
    opt = thvd.DistributedOptimizer(torch.optim.SGD([W], lr=LR),
                                    named_parameters=[("W", W)], axis="dp")
    opt.zero_grad()
    if broadcast is None:
        out = pipeline_apply(_stage, W, x, axis="pp", remat=remat)
    else:
        out = broadcast(pipeline_apply(_stage, W, x, axis="pp",
                                       broadcast_out=False))
    loss = (out ** 2).sum() / out.numel()
    loss.backward()
    opt.synchronize()
    grad = W.grad.clone()
    with opt.skip_synchronize():
        opt.step()
    return {"loss": float(thvd.allreduce(loss.detach(), axis="dp")),
            "W": W.detach().numpy().copy(), "grad": grad.numpy()}


def _port_sp_adapters():
    """The flax-style ``Transformer`` with ring and Ulysses attention over
    sp (``make_ring_attention``, ``make_ulysses_attention``) on this rank's
    sequence shard, against the same model on the whole sequence (plain
    attention, no collective): the largest difference of the shard's
    logits."""
    from horovod_tpu_torch.models import Transformer
    from horovod_tpu_torch.parallel import (make_ring_attention,
                                            make_ulysses_attention)
    rng = np.random.RandomState(8)
    tokens = torch.from_numpy(rng.randint(0, 64, (2, 16)))
    positions = torch.arange(16).expand(2, 16)
    shard = lambda t: local_shard(t, (None, "sp"))  # noqa: E731
    widths = dict(vocab_size=64, num_layers=2, num_heads=4, head_dim=8,
                  embed_dim=32, mlp_dim=32, dtype=torch.float32)
    full = Transformer(**widths)(tokens, positions)
    out = {}
    for name, attn_fn in (("ring", make_ring_attention()),
                          ("ulysses", make_ulysses_attention())):
        model = Transformer(**widths, attn_fn=attn_fn)
        got = model(shard(tokens), shard(positions))
        out[name] = float((got - shard(full)).abs().max())
    return out


def _grad(fn, x):
    x = torch.from_numpy(x).requires_grad_()
    out = fn(x)
    out.backward()
    return x.grad.numpy()


def _port_ops(ops, rank):
    """Each operator's forward sum and the gradient of its input."""
    w = torch.from_numpy(ops["w"][rank])
    w2 = torch.from_numpy(ops["w2"][rank])
    dp = thvd.parallel.axis_index("dp")
    cases = {
        "psum": (ops["x"][rank], lambda x: (w * spmd.pvary(
            spmd.psum(x, "tp"), "tp")).sum()),
        "psum_both": (ops["x"][rank], lambda x: (w * spmd.pvary(
            spmd.psum(x, ("dp", "tp")), ("dp", "tp"))).sum()),
        "pvary": (ops["x_dp"][dp], lambda x: (w * spmd.pvary(x, "tp")
                                              ).sum()),
        "ppermute_ring": (ops["x"][rank], lambda x: (w * spmd.ppermute(
            (x,), "tp", [(0, 1), (1, 0)])[0]).sum()),
        "ppermute_line": (ops["x"][rank], lambda x: (w * spmd.ppermute(
            (x,), "tp", [(0, 1)])[0]).sum()),
        "all_to_all": (ops["x2"][rank], lambda x: (w2 * spmd.all_to_all(
            x, "tp", split_axis=1, concat_axis=0)).sum()),
        "broadcast_p": (ops["x"][rank], lambda x: (w * spmd.pvary(
            spmd.broadcast_p(x, 1, "tp"), "tp")).sum()),
        # The eager collectives' gradient rules in place of the in-step
        # ones: an allreduce's grad is another allreduce, a broadcast's is
        # summed onto the root.
        "eager_allreduce": (ops["x"][rank], lambda x: (w * spmd.pvary(
            thvd.allreduce(x, op=thvd.Sum, axis="tp"), "tp")).sum()),
        "eager_broadcast": (ops["x"][rank], lambda x: (w * spmd.pvary(
            thvd.broadcast(x, 1, axis="tp"), "tp")).sum()),
    }
    return {name: _grad(fn, x) for name, (x, fn) in cases.items()}


def _worker(out_dir):
    rank = int(os.environ["HVDTPU_RANK"])
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    res = {"gpt": {}}
    for mesh_name, mesh in MESHES.items():
        os.environ["HVDTPU_CONTROLLER_PORT"] = str(inputs["ports"][mesh_name])
        thvd.init(device="cpu", mesh_shape=mesh)
        try:
            for name, (case_mesh, _) in GPT_CASES.items():
                if case_mesh == mesh_name:
                    res["gpt"][name] = _port_gpt(name, inputs["gpt"][name])
            if mesh_name == "tp_sp":
                res["sp_adapters"] = _port_sp_adapters()
            if mesh_name == "dp_pp":
                res["pipeline"] = _port_pipeline(inputs["pipeline"])
                res["pipeline_remat"] = _port_pipeline(inputs["pipeline"],
                                                       remat=True)
                res["pipeline_eager"] = _port_pipeline(
                    inputs["pipeline"],
                    lambda out: thvd.broadcast(out, 1, axis="pp"))
            if mesh_name == "dp_tp":
                res["ops"] = _port_ops(inputs["ops"], rank)
        finally:
            thvd.shutdown()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax_cfg(name):
    import jax.numpy as jnp
    from horovod_tpu.models import gpt as jax_gpt
    return jax_gpt.GPTConfig(dtype=jnp.float32, **GPT_CASES[name][1])


def _jax_params(name):
    """``init_params(PRNGKey(0))`` with numpy norm weights, as numpy."""
    import jax
    from horovod_tpu.models import gpt as jax_gpt
    params = jax.tree.map(np.asarray, jax_gpt.init_params(
        jax.random.PRNGKey(0), _jax_cfg(name)))
    rng = np.random.RandomState(3)
    for layer in params["layers"]:
        for key in ("attn_norm", "mlp_norm"):
            layer[key] = (1 + 0.2 * rng.randn(*layer[key].shape)).astype(
                np.float32)
    params["out_norm"] = (1 + 0.2 * rng.randn(*params["out_norm"].shape)
                          ).astype(np.float32)
    return params


def _pipeline_inputs():
    import jax
    import jax.numpy as jnp
    pp, dp = MESHES["dp_pp"]["pp"], MESHES["dp_pp"]["dp"]
    W = jax.random.normal(jax.random.PRNGKey(0), (pp, PIPE_D, PIPE_D),
                          jnp.float32) * 0.1
    x = jax.random.normal(jax.random.PRNGKey(1), (PIPE_M, PIPE_MB * dp,
                                                  PIPE_D), jnp.float32)
    return {"W": np.asarray(W), "x": np.asarray(x)}


def _start(out_dir):
    from conftest import free_port, subprocess_env
    procs = []
    port = free_port()
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
    return procs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's results; the JAX parameters and inputs they came from."""
    from conftest import free_port
    out_dir = str(tmp_path_factory.mktemp("torch_model_parallel"))
    inputs = {"gpt": {name: _jax_params(name) for name in GPT_CASES},
              "pipeline": _pipeline_inputs(), "ops": _op_inputs(),
              "ports": {m: free_port() for m in MESHES}}
    with open(os.path.join(out_dir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    procs = _start(out_dir)
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return {"ranks": ranks, "inputs": inputs}


def _jax_runtime(mesh_name, make_runtime):
    import jax
    return make_runtime(mesh_shape=MESHES[mesh_name],
                        devices=jax.devices()[:WORLD])


def _jax_gpt(name, params, make_runtime):
    """Two SGD steps of ``gpt.loss_fn`` in ``run_step``, as
    ``_gpt_train_step`` runs one: the losses and the updated global
    parameters."""
    import jax
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from horovod_tpu.models import gpt as jax_gpt

    mesh_name = GPT_CASES[name][0]
    hvd = _jax_runtime(mesh_name, make_runtime)
    cfg = _jax_cfg(name)
    n_dp = MESHES[mesh_name]["dp"]
    opt = hvd.DistributedOptimizer(optax.sgd(LR))
    data_spec = jax_gpt.data_specs(cfg)[0]

    def train_step(params, opt_state, tokens, targets, positions):
        loss, grads = jax.value_and_grad(
            lambda p: jax_gpt.loss_fn(p, tokens, targets, positions,
                                      cfg))(params)
        loss = hvd.allreduce_p(loss, op=hvd.ReduceOp.SUM, axis="dp") / n_dp
        updates, opt_state = opt.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        return params, opt_state, loss

    specs = jax_gpt.param_specs(cfg)
    step = hvd.run_step(
        train_step,
        in_specs=(specs, hvd.REPLICATED, data_spec, data_spec, data_spec),
        out_specs=(specs, hvd.REPLICATED, hvd.REPLICATED))
    mesh = hvd.mesh()
    state = jax.tree.map(lambda x: jax.device_put(x, NamedSharding(mesh, P())),
                         opt.init(params))
    params = jax.tree.map(
        lambda p, s: jax.device_put(p, NamedSharding(mesh, s)), params, specs)
    data = [jax.device_put(a, NamedSharding(mesh, data_spec))
            for a in _batch(name)]
    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, *data)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params)


def _check_params(got, want):
    for key, value in want.items():
        scale = float(np.abs(value).max())
        np.testing.assert_allclose(got[key], value, rtol=0,
                                   atol=RTOL * scale, err_msg=key)


@pytest.mark.parametrize("name", sorted(GPT_CASES))
def test_gpt_matches_run_step(name, world, make_runtime):
    """Loss and updated parameters after two SGD steps, every rank's shards
    against the JAX program's global parameters cut to that rank."""
    losses, params = _jax_gpt(name, world["inputs"]["gpt"][name],
                              make_runtime)
    cfg = gpt.GPTConfig(dtype=torch.float32, **GPT_CASES[name][1])
    for rank in world["ranks"]:
        res = rank["gpt"][name]
        np.testing.assert_allclose(res["losses"], losses, rtol=RTOL)
        want = {k: v.numpy() for k, v in gpt_params_to_torch(
            params, cfg, res["coords"]).items()}
        assert set(res["params"]) == set(want)
        _check_params(res["params"], want)
    assert losses[1] < losses[0]


def test_moe_drops_tokens_and_reports_aux(world):
    """At capacity factor 1 some tokens overflow their expert: the dropped
    fraction is positive on some rank, and the load-balance loss is at
    least 1 (its least value, a uniform router)."""
    aux = [a for rank in world["ranks"] for a in rank["gpt"]["moe"]["aux"]]
    assert aux and max(a["dropped_fraction"] for a in aux) > 0
    assert all(0 <= a["dropped_fraction"] < 1 for a in aux)
    assert all(a["load_balance_loss"] >= 1 - 1e-6 for a in aux)


def _jax_pipeline(pipe, make_runtime):
    """``_dryrun_pipeline_pp``'s step: the loss, W's gradient and W after
    one SGD step."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from horovod_tpu.parallel.pipeline import pipeline_apply as jax_pipe

    hvd = _jax_runtime("dp_pp", make_runtime)

    def stage(w, h):
        return h + jnp.tanh(h @ w)

    def train_step(W, x):
        def loss_fn(W):
            out = jax_pipe(stage, W, x, axis="pp")
            return jnp.sum(out ** 2) / out.size
        loss, grads = jax.value_and_grad(loss_fn)(W)
        grads = hvd.allreduce_p(grads, op=hvd.Average, axis="dp")
        loss = hvd.allreduce_p(loss, op=hvd.Average, axis="dp")
        return W - LR * grads, grads, loss

    step = hvd.run_step(train_step, in_specs=(P("pp"), P(None, "dp")),
                        out_specs=(P("pp"), P("pp"), hvd.REPLICATED))
    mesh = hvd.mesh()
    W, grads, loss = step(
        jax.device_put(pipe["W"], NamedSharding(mesh, P("pp"))),
        jax.device_put(pipe["x"], NamedSharding(mesh, P(None, "dp"))))
    return float(loss), np.asarray(grads), np.asarray(W)


def _pipe_rows(world, key):
    """Each rank's pp coordinate and its result."""
    pp = MESHES["dp_pp"]["pp"]
    return [(r % pp, rank[key]) for r, rank in enumerate(world["ranks"])]


def test_pipeline_matches_run_step(world, make_runtime):
    loss, grads, W = _jax_pipeline(world["inputs"]["pipeline"], make_runtime)
    for stage, res in _pipe_rows(world, "pipeline"):
        np.testing.assert_allclose(res["loss"], loss, rtol=RTOL)
        np.testing.assert_allclose(res["W"], W[stage:stage + 1],
                                   atol=RTOL * float(np.abs(W).max()))
        np.testing.assert_allclose(res["grad"], grads[stage:stage + 1],
                                   atol=RTOL * float(np.abs(grads).max()))


def test_pipeline_remat_matches_run_step(world, make_runtime):
    """``remat=True`` recomputes each tick's stage; the same loss, gradient
    and step."""
    loss, grads, W = _jax_pipeline(world["inputs"]["pipeline"], make_runtime)
    for stage, res in _pipe_rows(world, "pipeline_remat"):
        np.testing.assert_allclose(res["loss"], loss, rtol=RTOL)
        np.testing.assert_allclose(res["grad"], grads[stage:stage + 1],
                                   atol=RTOL * float(np.abs(grads).max()))


@pytest.mark.parametrize("name", ["ring", "ulysses"])
def test_sp_adapters_match_the_whole_sequence(name, world):
    """A ``Transformer`` over sp, with ``make_ring_attention`` or
    ``make_ulysses_attention``, gives each rank its shard of the
    whole-sequence model's logits."""
    diffs = [rank["sp_adapters"][name] for rank in world["ranks"]]
    assert max(diffs) < 1e-5, diffs


def test_pipeline_fails_with_the_eager_broadcast(world, make_runtime):
    """The eager broadcast sums the grads onto the last stage: its
    gradient is pp times JAX's (the forward is the same)."""
    loss, grads, _ = _jax_pipeline(world["inputs"]["pipeline"], make_runtime)
    pp = MESHES["dp_pp"]["pp"]
    for stage, res in _pipe_rows(world, "pipeline_eager"):
        np.testing.assert_allclose(res["loss"], loss, rtol=RTOL)
        np.testing.assert_allclose(res["grad"], pp * grads[stage:stage + 1],
                                   atol=RTOL * pp * float(np.abs(grads).max()))


def _jax_op_grads(ops, make_runtime):
    """``jax.grad`` of each operator's body inside ``run_step`` on the
    2 x 2 mesh: each rank's gradient (a row a rank)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P
    from horovod_tpu.ops import collectives as JC

    hvd = _jax_runtime("dp_tp", make_runtime)
    both = P(("dp", "tp"))
    bodies = {
        "psum": (ops["x"], both, lambda x: lax.psum(x, "tp")),
        "psum_both": (ops["x"], both, lambda x: lax.psum(x, ("dp", "tp"))),
        "pvary": (ops["x_dp"], P("dp"), lambda x: x),
        "ppermute_ring": (ops["x"], both, lambda x: lax.ppermute(
            x, "tp", [(0, 1), (1, 0)])),
        "ppermute_line": (ops["x"], both, lambda x: lax.ppermute(
            x, "tp", [(0, 1)])),
        "all_to_all": (ops["x2"].reshape(-1, 4), both,
                       lambda x: lax.all_to_all(x, "tp", 1, 0, tiled=True)),
        "broadcast_p": (ops["x"], both,
                        lambda x: JC.broadcast_p(x, 1, axis="tp")),
    }
    out = {}
    for name, (x, spec, op) in bodies.items():
        w = (ops["w2"].reshape(-1, 2) if name == "all_to_all"
             else ops["w"])

        def body(x, w, op=op):
            return jax.grad(lambda x: jnp.sum(w * op(x)))(x)

        step = hvd.run_step(body, in_specs=(spec, both), out_specs=spec)
        grad = np.asarray(step(jnp.asarray(x), jnp.asarray(w)))
        if name == "pvary":
            # Rank r's gradient is its dp row's.
            grad = grad[[r // 2 for r in range(WORLD)]]
        out[name] = grad.reshape((WORLD,) + ops[
            "x2" if name == "all_to_all" else "x"].shape[1:])
    return out


@pytest.mark.parametrize("name", OP_CASES)
def test_operator_gradient_matches_jax(name, world, make_runtime):
    """Each in-step operator's gradient against ``jax.grad`` of the same
    ``shard_map`` body; the eager collectives in the place of ``psum`` and
    ``broadcast_p`` give the axis size (2) times it."""
    key = {"eager_allreduce": "psum", "eager_broadcast": "broadcast_p"}
    want = _jax_op_grads(world["inputs"]["ops"], make_runtime)[
        key.get(name, name)]
    if name in key:
        want = 2 * want
    got = np.stack([rank["ops"][name] for rank in world["ranks"]])
    np.testing.assert_allclose(got, want, rtol=0, atol=OP_TOL)
    assert np.abs(want).max() > 0.1


if __name__ == "__main__" and "--worker" in sys.argv:
    _worker(sys.argv[sys.argv.index("--worker") + 1])
