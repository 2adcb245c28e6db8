"""The port's process mode (``init(mode="process")``: the native core)
against the JAX package's process mode, at worlds 2 and 3 on the CPU.

This file is also the ranks' worker: run as a script with
``HVDTPU_TEST_WORKER`` set to ``port`` (imports no JAX) or ``jax`` and
``HVDTPU_TEST_OUT`` to a directory, a rank runs every case below and
writes its results there. The module fixture starts four worlds at once
with ``conftest.launch_world`` (the port's and the JAX package's, of 2
and 3 ranks) and the tests compare what the ranks wrote. The inputs are
drawn from seeds with numpy; every name is the same in both packages, so
the two cores see the same requests.

* Bitwise between the packages: allreduce over fp32, bf16, fp16, int32
  and float64 with Sum, Average, Min, Max, Product and (floating types)
  Adasum (which both cores refuse for the 16-bit types, with the same
  error), and with pre- and postscale; grouped allreduce, broadcast,
  allgather with uneven first dimensions, alltoall with uneven splits and
  the splits received, reducescatter; ``join`` (the rank that joined last,
  and a reduction that only the last rank runs, to which the joined ranks
  give zeros); the three error classes with the core's messages; and the
  core's own wire compression (``HVDTPU_COMPRESSION`` fp16, int8, int4,
  each a re-initialized core) on allreduce, allgather, broadcast and
  reducescatter, with its ``wire_stats``.
* The eager compressed path: 4-bit max-min with error feedback on a fused
  buffer through ``compressed_grouped_allreduce``, two calls, the
  residual carried: payloads, outputs and residuals bitwise (the port is
  bitwise against JAX's eager quantizer, ROADMAP ground rules).
* Training a small ResNet (flax variables drawn from a seed, converted
  with ``flax_to_torch``) on each rank's own seed-made batch, 3 steps
  each: SGD with dense gradients, SGD with 4-bit max-min and error
  feedback, and ZeRO-1 Adam (the JAX ``ShardedDistributedOptimizer``'s
  ``_update_process``). Losses and weights within rtol 1e-4, atol 1e-5.
  The 4-bit case quantizes the whole fused gradient in one bucket, so
  that both packages' buckets hold the same values whatever their layouts
  (HWIO against OIHW) and orders of the leaves.
"""

import concurrent.futures
import os
import pickle
import time
import zlib

import numpy as np
import pytest

WORLDS = (2, 3)
DTYPES = ("float32", "bfloat16", "float16", "int32", "float64")
OPS = ("Average", "Sum", "Min", "Max", "Product", "Adasum")
WIRE_MODES = ("fp16", "int8", "int4")
IMAGE, BATCH, CLASSES, STEPS = 16, 4, 10, 3
# One bucket holds every gradient of the small ResNet (see the docstring).
WHOLE_BUCKET = 1 << 15
LR, ADAM_LR = 0.1, 1e-3
# Adam divides each gradient by its own size: a gradient that is zero up to
# rounding (the first batch norm's bias here, about 1e-9) would turn each
# package's rounding into a step of up to the learning rate. An eps well
# above it keeps that step below ADAM_LR * |g| / ADAM_EPS.
ADAM_EPS = 1e-3


def _x(name, rank, shape, dtype="float32"):
    """Values drawn for (name, rank): quarters in [-4, 4) for the 16-bit
    types (exact in bf16 and fp16), integers in [-5, 5] for int32."""
    rng = np.random.RandomState(zlib.crc32(f"{name}/{rank}".encode()))
    if dtype == "int32":
        return rng.randint(-5, 6, shape).astype(np.int32)
    v = rng.uniform(-4, 4, shape)
    if dtype in ("bfloat16", "float16"):
        v = np.round(v * 4) / 4
    return v.astype(np.float64 if dtype == "float64" else np.float32)


def _splits(rank, n):
    """Rows rank ``rank`` sends to each rank: 0 to 3."""
    return np.random.RandomState(60 + rank).randint(0, 4, n).tolist()


# ---------------------------------------------------------------------------
# the two packages, as the ranks see them
# ---------------------------------------------------------------------------

class _Port:
    def __init__(self):
        import torch

        import horovod_tpu_torch as hvd
        self.torch, self.hvd = torch, hvd

    def init(self):
        self.hvd.init(mode="process", device="cpu")

    def t(self, a, dtype="float32"):
        t = self.torch.from_numpy(np.ascontiguousarray(a))
        return t.to(self.torch.bfloat16) if dtype == "bfloat16" else t

    def n(self, t):
        if t.dtype == self.torch.bfloat16:
            t = t.float()
        return t.numpy().copy()

    def core(self):
        return self.hvd.runtime.core()

    def compressed(self, leaves, residuals):
        from horovod_tpu_torch.compression import MaxMinQuantizer
        from horovod_tpu_torch.compression import reducers
        return reducers.compressed_grouped_allreduce(
            [self.t(a) for a in leaves], MaxMinQuantizer(4, 512),
            reduction="allgather", op=self.hvd.Average,
            residuals=[self.t(a) for a in residuals])

    def payload(self, fused):
        from horovod_tpu_torch.compression import MaxMinQuantizer
        p, _ = MaxMinQuantizer(4, 512).compress(self.t(fused))
        return {k: self.n(v) for k, v in p.items()}


class _Jax:
    def __init__(self):
        import jax
        jax.config.update("jax_platforms", "cpu")
        import horovod_tpu as hvd
        self.hvd = hvd

    def init(self):
        self.hvd.init()
        assert self.hvd.mode() == "process"

    def t(self, a, dtype="float32"):
        if dtype == "bfloat16":
            import ml_dtypes
            return np.asarray(a).astype(ml_dtypes.bfloat16)
        return np.ascontiguousarray(a)

    def n(self, a):
        a = np.asarray(a)
        return a.astype(np.float32) if a.dtype.name == "bfloat16" else a.copy()

    def core(self):
        return self.hvd.runtime.core()

    def compressed(self, leaves, residuals):
        from horovod_tpu.compression import MaxMinQuantizer
        from horovod_tpu.compression import reducers
        out, res = reducers.compressed_grouped_allreduce(
            list(leaves), MaxMinQuantizer(4, 512, use_pallas=False),
            reduction="allgather", op=self.hvd.Average,
            residuals=list(residuals))
        return list(out), list(res)

    def payload(self, fused):
        import jax.numpy as jnp
        from horovod_tpu.compression import MaxMinQuantizer
        p, _ = MaxMinQuantizer(4, 512, use_pallas=False).compress(
            jnp.asarray(fused))
        return {k: np.asarray(v).copy() for k, v in p.items()}


def _outcome(fn):
    """``("ok", value)``, or ``("error", class name, message)``."""
    try:
        return ("ok", fn())
    except Exception as e:  # the error is the result being compared
        return ("error", type(e).__name__, str(e))


# ---------------------------------------------------------------------------
# the cases, as the ranks run them
# ---------------------------------------------------------------------------

def _dense_menu(P, r, n):
    hvd, out = P.hvd, {}
    for dt in DTYPES:
        for op in OPS:
            if op == "Adasum" and dt == "int32":
                continue
            name = f"ar.{dt}.{op}"
            x = P.t(_x(name, r, (6, 5), dt), dt)
            out[name] = _outcome(lambda: P.n(hvd.allreduce(
                x, op=getattr(hvd, op), name=name)))
        for op in ("Average", "Sum"):
            name = f"ar.{dt}.{op}.scaled"
            x = P.t(_x(name, r, (6, 5), dt), dt)
            out[name] = _outcome(lambda: P.n(hvd.allreduce(
                x, op=getattr(hvd, op), prescale_factor=0.5,
                postscale_factor=3.0, name=name)))
    grp = [P.t(_x("grp.a", r, (3, 4))), P.t(_x("grp.b", r, (5,))),
           P.t(_x("grp.c", r, (2, 2), "float64"))]
    out["grouped"] = [P.n(t) for t in hvd.grouped_allreduce(
        grp, op=hvd.Average, name="grp")]
    out["broadcast"] = P.n(hvd.broadcast(P.t(_x("bc", r, (4, 3))),
                                         root_rank=1, name="bc"))
    out["allgather"] = P.n(hvd.allgather(
        P.t(_x("ag", r, (r + 1, 2))), name="ag"))
    sp = _splits(r, n)
    got, recv = hvd.alltoall(P.t(_x("a2a", r, (sum(sp), 3))), splits=sp,
                             name="a2a")
    out["alltoall"] = (P.n(got), np.asarray(recv).astype(np.int64))
    for op in ("Sum", "Average"):
        out[f"reducescatter.{op}"] = P.n(hvd.reducescatter(
            P.t(_x("rs", r, (n * 3, 2))), op=getattr(hvd, op),
            name=f"rs.{op}"))
    out["err.shape"] = _outcome(lambda: hvd.allreduce(
        P.t(np.ones(r + 1, np.float32)), name="bad_shape"))
    out["err.dtype"] = _outcome(lambda: hvd.allreduce(
        P.t(np.ones(3, np.float32 if r == 0 else np.float64)),
        name="bad_dtype"))
    with hvd.grouped_enqueue():  # the first stays pending
        h = hvd.allreduce_async(P.t(np.ones(2, np.float32)), name="dup")
        out["err.duplicate"] = _outcome(lambda: hvd.allreduce_async(
            P.t(np.ones(2, np.float32)), name="dup"))
    out["dup.first"] = P.n(hvd.synchronize(h))
    if r == n - 1:
        # Only this rank runs "extra"; the joined ranks give it zeros. The
        # JAX package's core promotes a waiting request when another
        # request reaches the coordinator, not when a rank joins
        # (horovod_tpu/native/core.cpp:2427-2430), so until "extra"
        # completes this rank sends another request every 10 ms: whatever
        # order the joins arrive in, one of those comes after the last.
        h = hvd.allreduce_async(P.t(_x("extra", r, (4,))), op=hvd.Sum,
                                name="extra")
        pokes = []
        while not hvd.poll(h):
            pokes.append(hvd.allreduce_async(
                P.t(np.zeros(1, np.float32)), op=hvd.Sum,
                name=f"extra.poke.{len(pokes)}"))
            time.sleep(0.01)
        out["join.extra"] = P.n(hvd.synchronize(h))
        for poke in pokes:
            hvd.synchronize(poke)
    out["join"] = int(hvd.join())
    return out


def _join_pending(P, r, n):
    """The port's core only: the last rank's request already waits at the
    coordinator when the others join, and their joins complete it. The
    last rank enqueues "pending" before "before_join", so the coordinator
    has "pending" once "before_join" completes anywhere; only then do the
    others join. The JAX package's core would wait there for another
    request (ROADMAP C)."""
    hvd, out = P.hvd, {}
    if r == n - 1:
        h = hvd.allreduce_async(P.t(_x("pending", r, (5,))), op=hvd.Sum,
                                name="pending")
    hvd.allreduce(P.t(np.ones(1, np.float32)), op=hvd.Sum,
                  name="before_join")
    if r == n - 1:
        out["pending"] = P.n(hvd.synchronize(h))
    out["join"] = int(hvd.join())
    return out


def _wire_menu(P, r, n, mode):
    hvd, out = P.hvd, {}
    before = P.core().wire_stats()
    x = P.t(_x(f"wire.{mode}", r, (4096,)))
    for op in ("Sum", "Average"):
        out[f"allreduce.{op}"] = P.n(hvd.allreduce(
            x, op=getattr(hvd, op), name=f"wire.{mode}.{op}"))
    out["allgather"] = P.n(hvd.allgather(
        P.t(_x(f"wire.ag.{mode}", r, (512 * (r + 1),))),
        name=f"wire.{mode}.ag"))
    out["broadcast"] = P.n(hvd.broadcast(x, root_rank=n - 1,
                                         name=f"wire.{mode}.bc"))
    out["reducescatter"] = P.n(hvd.reducescatter(
        P.t(_x(f"wire.rs.{mode}", r, (n * 1024,))), op=hvd.Sum,
        name=f"wire.{mode}.rs"))
    out["wire_stats"] = tuple(
        a - b for a, b in zip(P.core().wire_stats(), before))
    return out


def _compressed_menu(P, r):
    leaves = [_x("cmp.a", r, (37, 20)), _x("cmp.b", r, (300,))]
    residuals = [np.zeros_like(a) for a in leaves]
    out = {"payload": P.payload(np.concatenate(
        [a.reshape(-1) for a in leaves]))}
    for call in range(2):
        reduced, residuals = P.compressed(leaves, residuals)
        out[f"out.{call}"] = [P.n(a) for a in reduced]
        out[f"res.{call}"] = [P.n(a) for a in residuals]
        residuals = [P.n(a) for a in residuals]
    return out


def _batch(r):
    rng = np.random.RandomState(100 + r)
    return (rng.randn(BATCH, IMAGE, IMAGE, 3).astype(np.float32),
            rng.randint(0, CLASSES, BATCH))


def _port_train(P, r, kind, state_dict):
    import torch.nn.functional as F

    from horovod_tpu_torch.compression import (CompressionConfig,
                                               MaxMinQuantizer)
    from horovod_tpu_torch.models import resnet
    torch, hvd = P.torch, P.hvd
    model = resnet.ResNet(stage_sizes=[1, 1],
                          block_cls=resnet.BottleneckResNetBlock,
                          num_classes=CLASSES, num_filters=8)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict.items()})
    model.train()
    if kind == "zero1":
        opt = hvd.ShardedDistributedOptimizer(
            torch.optim.Adam, model.parameters(), lr=ADAM_LR, eps=ADAM_EPS)
    else:
        comp = None if kind == "dense" else CompressionConfig(
            MaxMinQuantizer(4, WHOLE_BUCKET), reduction="allgather",
            error_feedback=True)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=LR),
            named_parameters=model.named_parameters(), compression=comp)
    x, y = _batch(r)
    losses = []
    for _ in range(STEPS):
        opt.zero_grad()
        loss = F.cross_entropy(model(torch.from_numpy(x)),
                               torch.from_numpy(y))
        loss.backward()
        opt.step()
        losses.append(loss.item())
    out = {"losses": losses,
           "params": {k: p.detach().numpy().copy()
                      for k, p in model.named_parameters()}}
    if kind == "zero1":
        out["state_bytes"] = opt.state_bytes()
    return out


def _jax_train(P, r, kind, variables):
    import jax
    import jax.numpy as jnp
    import optax

    from horovod_tpu.compression import CompressionConfig, MaxMinQuantizer
    from horovod_tpu.models import resnet
    hvd = P.hvd
    model = resnet.ResNet(stage_sizes=[1, 1],
                          block_cls=resnet.BottleneckResNetBlock,
                          num_classes=CLASSES, num_filters=8,
                          dtype=jnp.float32)
    x, y = _batch(r)

    def loss_fn(params, stats):
        logits, updates = model.apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(x),
            train=True, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()
        return loss, updates["batch_stats"]

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    if kind == "zero1":
        opt = hvd.ShardedDistributedOptimizer(optax.adam(ADAM_LR,
                                                         eps=ADAM_EPS))
    else:
        comp = None if kind == "dense" else CompressionConfig(
            MaxMinQuantizer(4, WHOLE_BUCKET, use_pallas=False),
            reduction="allgather", error_feedback=True)
        opt = hvd.DistributedOptimizer(optax.sgd(LR), compression=comp)
    params, stats = variables["params"], variables["batch_stats"]
    state = opt.init(params)
    losses = []
    for _ in range(STEPS):
        (loss, stats), grads = grad_fn(params, stats)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return {"losses": losses,
            "params": jax.tree.map(lambda a: np.asarray(a).copy(), params)}


def _next_world(P, tag):
    """Shut the core down and start another with ``HVDTPU_COMPRESSION``
    set to ``tag``, meeting at a port rank 0 found free (a new port, so no
    rank reaches the old core's listener). ``join`` first: a rank shut
    down while a peer still receives its last bytes breaks the peer."""
    import socket
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    port = P.n(P.hvd.broadcast(P.t(np.array([port], np.int64)), root_rank=0,
                               name=f"port.{tag}"))
    P.hvd.join()
    P.hvd.shutdown()
    os.environ["HVDTPU_CONTROLLER_PORT"] = str(int(port[0]))
    os.environ["HVDTPU_COMPRESSION"] = tag
    P.init()


def _worker(kind, out_dir):
    P = _Port() if kind == "port" else _Jax()
    P.init()
    r, n = P.hvd.rank(), P.hvd.size()
    res = {"dense": _dense_menu(P, r, n)}
    if kind == "port":
        res["join_pending"] = _join_pending(P, r, n)
    res["compressed"] = _compressed_menu(P, r)
    with open(os.path.join(out_dir, "model.pkl"), "rb") as f:
        variables, state_dict = pickle.load(f)
    res["train"] = {
        k: (_port_train(P, r, k, state_dict) if kind == "port"
            else _jax_train(P, r, k, variables))
        for k in ("dense", "maxmin4", "zero1")}
    for mode in WIRE_MODES:
        _next_world(P, mode)
        res[f"wire.{mode}"] = _wire_menu(P, r, n, mode)
    P.hvd.join()
    P.hvd.shutdown()
    with open(os.path.join(out_dir, f"{kind}.{r}.pkl"), "wb") as f:
        pickle.dump(res, f)
    print("ALL OK")


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _model_files(tmp_path_factory):
    """The flax variables of the small ResNet, drawn from a seed, and their
    ``flax_to_torch`` state dict, in a file both packages' ranks read."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import resnet as jax_resnet
    from horovod_tpu_torch.models.convert import flax_to_torch
    from test_torch_port_model import random_variables
    flax_model = jax_resnet.ResNet(
        stage_sizes=[1, 1], block_cls=jax_resnet.BottleneckResNetBlock,
        num_classes=CLASSES, num_filters=8, dtype=jnp.float32)
    variables = random_variables(flax_model, _batch(0)[0], 7)
    state_dict = {k: v.numpy() for k, v in flax_to_torch(variables).items()}
    assert sum(int(np.prod(v.shape)) for v in
               jax.tree.leaves(variables["params"])) < WHOLE_BUCKET
    path = tmp_path_factory.mktemp("torch_process_model")
    with open(path / "model.pkl", "wb") as f:
        pickle.dump((variables, state_dict), f)
    return path / "model.pkl"


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{(kind, n): [each rank's results]}; the four worlds run at once."""
    import shutil

    from conftest import assert_all_ok, launch_world
    from horovod_tpu import basics as jax_basics
    from horovod_tpu_torch.utils import native_build
    # Both cores are built here, once, so that no world spends its time
    # limit compiling.
    native_build.build()
    jax_basics._ensure_built()
    model = _model_files(tmp_path_factory)
    dirs = {}
    for kind in ("port", "jax"):
        for n in WORLDS:
            d = tmp_path_factory.mktemp(f"torch_process_{kind}_{n}")
            shutil.copy(model, d / "model.pkl")
            dirs[kind, n] = str(d)
    with concurrent.futures.ThreadPoolExecutor(len(dirs)) as pool:
        runs = {key: pool.submit(
                    launch_world, key[1], os.path.abspath(__file__),
                    {"HVDTPU_TEST_WORKER": key[0], "HVDTPU_TEST_OUT": d,
                     "HVDTPU_STALL_CHECK_TIME_SECONDS": "30"}, 300)
                for key, d in dirs.items()}
        results = {key: run.result() for key, run in runs.items()}
    out = {}
    for (kind, n), res in results.items():
        assert_all_ok(res)
        out[kind, n] = []
        for r in range(n):
            with open(os.path.join(dirs[kind, n], f"{kind}.{r}.pkl"),
                      "rb") as f:
                out[kind, n].append(pickle.load(f))
    return out


def _assert_bitwise(got, want, where):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_bitwise(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_bitwise(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        g = np.asarray(got)
        assert g.dtype == want.dtype and g.shape == want.shape, \
            (where, g.dtype, g.shape, want.dtype, want.shape)
        assert g.tobytes() == want.tobytes(), (where, g, want)
    else:
        assert got == want, (where, got, want)


def _errors_as_classes(res):
    """The error cases' outcomes without their messages, which name the
    ranks in the order their requests reached the coordinator."""
    return {k: v[:2] if k.startswith("err.") else v for k, v in res.items()}


@pytest.mark.parametrize("n", WORLDS)
def test_dense_menu_is_bitwise_the_references(worlds, n):
    for r in range(n):
        _assert_bitwise(_errors_as_classes(worlds["port", n][r]["dense"]),
                        _errors_as_classes(worlds["jax", n][r]["dense"]),
                        f"rank {r}")


@pytest.mark.parametrize("n", WORLDS)
def test_dense_menu_values(worlds, n):
    """What the core computed, held to its definition in numpy, so that the
    comparison above is not between two wrong answers."""
    ranks = worlds["port", n]
    for r, res in enumerate(ranks):
        d = res["dense"]
        want = sum(_x("ar.float64.Sum", q, (6, 5), "float64")
                   for q in range(n))
        assert d["ar.float64.Sum"][0] == "ok"
        np.testing.assert_allclose(d["ar.float64.Sum"][1], want, rtol=1e-12)
        want = np.min([_x("ar.int32.Min", q, (6, 5), "int32")
                       for q in range(n)], axis=0)
        np.testing.assert_array_equal(d["ar.int32.Min"][1], want)
        np.testing.assert_array_equal(d["broadcast"], _x("bc", 1, (4, 3)))
        np.testing.assert_array_equal(d["allgather"], np.concatenate(
            [_x("ag", q, (q + 1, 2)) for q in range(n)]))
        sent = [_splits(q, n) for q in range(n)]
        rows = [np.split(_x("a2a", q, (sum(sent[q]), 3)),
                         np.cumsum(sent[q])[:-1]) for q in range(n)]
        got, recv = d["alltoall"]
        np.testing.assert_array_equal(recv, [sent[q][r] for q in range(n)])
        np.testing.assert_array_equal(got, np.concatenate(
            [rows[q][r] for q in range(n)]))
        full = sum(_x("rs", q, (n * 3, 2)).astype(np.float64)
                   for q in range(n))
        np.testing.assert_allclose(d["reducescatter.Sum"],
                                   full[r * 3:(r + 1) * 3], rtol=1e-6)
        assert d["join"] == n - 1
        if r == n - 1:
            np.testing.assert_array_equal(d["join.extra"],
                                          _x("extra", r, (4,)))


@pytest.mark.parametrize("n", WORLDS)
def test_join_completes_a_request_already_waiting(worlds, n):
    """The last rank's own values, with zeros from the joined ranks, and
    that rank joined last."""
    for r, res in enumerate(worlds["port", n]):
        d = res["join_pending"]
        assert d["join"] == n - 1
        if r == n - 1:
            np.testing.assert_array_equal(d["pending"],
                                          _x("pending", r, (5,)))
        else:
            assert set(d) == {"join"}


@pytest.mark.parametrize("kind", ("port", "jax"))
@pytest.mark.parametrize("n", WORLDS)
def test_error_classes_on_every_rank(worlds, n, kind):
    """Each rank raises the class, with the core's message: the first rank
    whose request reached the coordinator against one that disagrees."""
    import re
    for res in worlds[kind, n]:
        d = res["dense"]
        assert d["err.shape"][:2] == ("error", "TensorShapeMismatchError")
        m = re.fullmatch(r"Mismatched allreduce tensor shapes: rank (\d) "
                         r"has \[(\d)\] but rank (\d) has \[(\d)\] for "
                         r"tensor 'bad_shape'", d["err.shape"][2])
        assert m and m[1] != m[3], d["err.shape"]
        assert (int(m[2]), int(m[4])) == (int(m[1]) + 1, int(m[3]) + 1)
        assert d["err.dtype"][:2] == ("error", "TensorDtypeMismatchError")
        assert re.fullmatch(r"Mismatched data types: rank \d has float(32|64) "
                            r"but rank \d has float(32|64) for tensor "
                            r"'bad_dtype'", d["err.dtype"][2]), d["err.dtype"]
        assert d["err.duplicate"] == (
            "error", "DuplicateNameError",
            "Requested to collective on tensor 'dup' which is already "
            "pending; tensor names must be unique among in-flight "
            "operations")


@pytest.mark.parametrize("mode", WIRE_MODES)
@pytest.mark.parametrize("n", WORLDS)
def test_wire_compression_is_bitwise_the_references(worlds, n, mode):
    for r in range(n):
        got = worlds["port", n][r][f"wire.{mode}"]
        _assert_bitwise(got, worlds["jax", n][r][f"wire.{mode}"],
                        f"rank {r}")
        raw, wire = got["wire_stats"]
        assert 0 < wire < raw, (mode, raw, wire)


@pytest.mark.parametrize("n", WORLDS)
def test_eager_compressed_path_is_bitwise_the_references(worlds, n):
    for r in range(n):
        _assert_bitwise(worlds["port", n][r]["compressed"],
                        worlds["jax", n][r]["compressed"], f"rank {r}")


@pytest.mark.parametrize("kind", ("dense", "maxmin4", "zero1"))
@pytest.mark.parametrize("n", WORLDS)
def test_training_matches_the_references(worlds, n, kind):
    import jax

    from horovod_tpu_torch.models.convert import flax_to_torch
    for r in range(n):
        got = worlds["port", n][r]["train"][kind]
        want = worlds["jax", n][r]["train"][kind]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
        assert got["losses"][-1] < got["losses"][0]
        want_params = flax_to_torch({"params": jax.tree.map(
            np.asarray, want["params"])})
        assert set(got["params"]) == set(want_params)
        for k, v in want_params.items():
            np.testing.assert_allclose(got["params"][k], v.numpy(),
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"rank {r} {k}")
        # Every rank holds the same weights.
        for k, v in got["params"].items():
            np.testing.assert_array_equal(
                v, worlds["port", n][0]["train"][kind]["params"][k])
    if kind == "zero1":
        total = sum(v.size for v in got["params"].values())
        shard = -(-total // n)
        # Adam's m and v over this rank's shard, and its step count.
        for res in worlds["port", n]:
            assert res["train"]["zero1"]["state_bytes"] == 2 * 4 * shard + 4


def test_a_backend_above_the_builtins_takes_what_it_implements(
        monkeypatch):
    """The dispatch registry at world 1 in process mode: a backend
    registered above the built-ins runs the operations it implements, one
    it lacks falls through to the mode's built-in, a mode it is not
    enabled in too, and once it is unregistered the built-in runs again."""
    import torch

    import horovod_tpu_torch as thvd
    from conftest import free_port
    from horovod_tpu_torch.ops import dispatch
    calls = []

    class Spy(dispatch.CollectiveBackend):
        name, priority = "spy", 1000

        def enabled(self, ctx):
            return ctx.mode == "process"

        def allreduce(self, x, op, prescale, postscale, compression, name,
                      axis):
            calls.append(name)
            return x + 1

    builtins = ["native_process", "torch_distributed"]
    assert [b.name for b in dispatch.backends()] == builtins
    monkeypatch.setenv("HVDTPU_CONTROLLER_PORT", str(free_port()))
    thvd.init(mode="process", device="cpu")
    x = torch.arange(4.0)
    try:
        dispatch.register_backend(Spy())
        try:
            assert [b.name for b in dispatch.backends()] == ["spy"] + builtins
            with pytest.raises(ValueError, match="already registered"):
                dispatch.register_backend(Spy())
            torch.testing.assert_close(thvd.allreduce(x, name="probe"), x + 1)
            assert calls == ["probe"]
            torch.testing.assert_close(thvd.allgather(x, name="ag"), x)
            process = dispatch.DispatchContext(mode="process", axis=None)
            spmd = dispatch.DispatchContext(mode="spmd", axis=None)
            assert dispatch.resolve("allgather", process).name == \
                "native_process"
            assert dispatch.resolve("allreduce", spmd).name == \
                "torch_distributed"
        finally:
            dispatch.unregister_backend("spy")
        torch.testing.assert_close(
            thvd.allreduce(x, op=thvd.Sum, name="after"), x)
        assert calls == ["probe"]
        assert [b.name for b in dispatch.backends()] == builtins
        with pytest.raises(KeyError):
            dispatch.unregister_backend("spy")
    finally:
        thvd.shutdown()


def test_process_mode_checks(monkeypatch):
    """At world 1 in this process: the mesh and axes process mode takes,
    the parts that need torch.distributed groups raise, and join returns
    this rank."""
    import torch

    import horovod_tpu_torch as thvd
    from conftest import free_port
    from horovod_tpu_torch.ops import spmd
    monkeypatch.setenv("HVDTPU_CONTROLLER_PORT", str(free_port()))
    with pytest.raises(ValueError, match="process mode runs one"):
        thvd.init(mode="process", device="cpu",
                  mesh_shape={"dp": 1, "tp": 1})
    assert not thvd.is_initialized()
    thvd.init(mode="process", device="cpu")
    try:
        assert thvd.mode() == "process" and thvd.size() == 1
        assert thvd.runtime.core() is not None
        x = torch.arange(4.0)
        torch.testing.assert_close(thvd.allreduce(x, axis="dp"), x)
        with pytest.raises(ValueError, match="over the \"dp\" axis"):
            thvd.allreduce(x, axis="tp")
        with pytest.raises(NotImplementedError, match="ROADMAP A8"):
            spmd.psum(x, "dp")
        with pytest.raises(NotImplementedError, match="ROADMAP A8"):
            thvd.hierarchical_allreduce(x, inner_axis="dp",
                                        outer_axis="dp")
        y = x.clone().requires_grad_()
        thvd.allreduce(y, op=thvd.Sum).sum().backward()
        torch.testing.assert_close(y.grad, torch.ones(4))
        assert thvd.join() == 0
    finally:
        thvd.shutdown()


if __name__ == "__main__" and os.environ.get("HVDTPU_TEST_WORKER"):
    _worker(os.environ["HVDTPU_TEST_WORKER"], os.environ["HVDTPU_TEST_OUT"])
