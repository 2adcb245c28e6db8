"""The port's torch frontend (``horovod_tpu_torch.torch``) against the JAX
package's (``horovod_tpu.torch``), in process mode at worlds 1, 2 and 3 on
the CPU.

This file is also the ranks' worker: run as a script with
``HVDTPU_TEST_WORKER`` set to ``port`` (imports no JAX) or ``jax`` and
``HVDTPU_TEST_OUT`` to a directory, a rank runs every case below and
writes its results there. The module fixture starts six worlds (each
package's, of 1, 2 and 3 ranks), four at a time. The inputs are drawn from
seeds with numpy; each package's ranks see the same values.

* Differentiable collectives (worlds 2 and 3): allgather with uneven first
  dimensions (and a scalar), broadcast from rank 1 (its cotangents summed
  onto the root, zeros elsewhere: the JAX frontend's ``summed * 0``, so a
  negative sum gives -0.0, compared bitwise too), alltoall with even parts
  of uneven dim 0 and with uneven splits; the forward outputs and the
  inputs' gradients of ``sum(out * w)``, bitwise.
* ``SyncBatchNorm`` (worlds 1, 2 and 3): uneven batches, 2 training steps
  then one in eval mode, for the default module (momentum 0.1),
  ``momentum=None`` (the cumulative average) and ``affine=False`` (and
  ``track_running_stats=False``); outputs, the input's, weight's and
  bias's gradients, the running statistics and ``num_batches_tracked``,
  bitwise: the arithmetic is the JAX frontend's, op for op, and both
  cores sum the same float32 values in the same order.
"""

import concurrent.futures
import os
import pickle
import zlib

import numpy as np
import pytest

WORLDS = (1, 2, 3)
WORLDS_AT_ONCE = 4
BN_CASES = {"default": {}, "momentum_none": {"momentum": None},
            "no_affine": {"affine": False},
            "no_running_stats": {"track_running_stats": False}}


def _x(name, rank, shape):
    """Quarters in [-4, 4) drawn for (name, rank), float32."""
    rng = np.random.RandomState(zlib.crc32(f"{name}/{rank}".encode()))
    return np.asarray(np.round(rng.uniform(-4, 4, shape) * 4) / 4,
                      dtype=np.float32)


def _splits(rank, n):
    """Rows rank ``rank`` sends to each rank: 0 to 3."""
    return np.random.RandomState(60 + rank).randint(0, 4, n).tolist()


# ---------------------------------------------------------------------------
# the cases, as the ranks run them
# ---------------------------------------------------------------------------

def _frontend(kind):
    if kind == "port":
        import horovod_tpu_torch.torch as hvd
        return hvd
    import jax
    jax.config.update("jax_platforms", "cpu")
    import horovod_tpu.torch as hvd
    return hvd


def _grad_case(hvd, torch, fn, x):
    """``fn(x)``'s output and the gradient of ``sum(out * w)`` at ``x``,
    ``w`` drawn from the output's shape and this rank (negative values
    included)."""
    x = torch.from_numpy(x).requires_grad_()
    out = fn(x)
    if isinstance(out, tuple):  # the port's alltoall with splits
        out = out[0]
    w = torch.from_numpy(_x(f"w{tuple(out.shape)}", hvd.rank(), out.shape))
    (out * w).sum().backward()
    return out.detach().numpy().copy(), x.grad.numpy().copy()


def _collectives(hvd, torch, r, n):
    out = {}
    out["allgather"] = _grad_case(hvd, torch, lambda t: hvd.allgather(
        t, name="fe.ag"), _x("ag", r, (r + 1, 3)))
    out["allgather_scalar"] = _grad_case(hvd, torch, lambda t: hvd.allgather(
        t, name="fe.ag0"), _x("ag0", r, ()))
    out["broadcast"] = _grad_case(hvd, torch, lambda t: hvd.broadcast(
        t, root_rank=1, name="fe.bc"), _x("bc", r, (4, 3)))
    out["alltoall_even"] = _grad_case(hvd, torch, lambda t: hvd.alltoall(
        t, name="fe.a2a"), _x("a2a", r, (n * (r + 1), 2)))
    sp = _splits(r, n)
    out["alltoall_splits"] = _grad_case(hvd, torch, lambda t: hvd.alltoall(
        t, splits=torch.tensor(sp, dtype=torch.int32), name="fe.a2av"),
        _x("a2av", r, (sum(sp), 3)))
    return out


def _sync_bn(hvd, torch, r, case, kwargs):
    """Two training steps and one eval forward of ``SyncBatchNorm(3)``
    on a batch of ``r + 2`` images of 4x5; ``weight`` and ``bias`` drawn
    from a seed."""
    bn = hvd.SyncBatchNorm(3, **kwargs)
    if bn.affine:
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(_x("bn.w", 0, (3,))))
            bn.bias.copy_(torch.from_numpy(_x("bn.b", 0, (3,))))
    res = []
    for step in range(2):
        x = torch.from_numpy(
            _x(f"bn.{case}.{step}", r, (r + 2, 3, 4, 5)) + 3.0
        ).requires_grad_()
        y = bn(x)
        dy = torch.from_numpy(_x(f"bn.dy.{step}", r, tuple(y.shape)))
        (y * dy).sum().backward()
        res.append({"y": y.detach().numpy().copy(),
                    "dx": x.grad.numpy().copy(),
                    "dw": None if bn.weight is None else
                    bn.weight.grad.numpy().copy(),
                    "db": None if bn.bias is None else
                    bn.bias.grad.numpy().copy()})
        if bn.affine:
            bn.weight.grad = bn.bias.grad = None
    res.append({name: None if buf is None else buf.numpy().copy()
                for name, buf in (("running_mean", bn.running_mean),
                                  ("running_var", bn.running_var),
                                  ("tracked", bn.num_batches_tracked))})
    bn.eval()
    with torch.no_grad():
        res.append(bn(torch.from_numpy(_x(f"bn.eval.{case}", r,
                                          (2, 3, 4, 5)))).numpy().copy())
    return res


def _worker(kind, out_dir):
    import torch
    hvd = _frontend(kind)
    hvd.init(**({"mode": "process", "device": "cpu"} if kind == "port"
                else {}))
    r, n = hvd.rank(), hvd.size()
    res = {"bn": {case: _sync_bn(hvd, torch, r, case, kw)
                  for case, kw in BN_CASES.items()}}
    if n > 1:
        res["collectives"] = _collectives(hvd, torch, r, n)
        if kind == "port":
            import horovod_tpu_torch as top
            x = torch.ones(n, 2, requires_grad=True)
            try:
                top.reducescatter(x)
                res["reducescatter"] = "no error"
            except NotImplementedError as e:
                res["reducescatter"] = str(e)
    hvd.join()
    hvd.shutdown()
    with open(os.path.join(out_dir, f"{kind}.{r}.pkl"), "wb") as f:
        pickle.dump(res, f)
    print("ALL OK")


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{(kind, n): [each rank's results]}."""
    from conftest import assert_all_ok, launch_world
    from horovod_tpu import basics as jax_basics
    from horovod_tpu_torch.utils import native_build
    native_build.build()
    jax_basics._ensure_built()
    dirs = {(kind, n): str(tmp_path_factory.mktemp(f"frontend_{kind}_{n}"))
            for n in WORLDS for kind in ("port", "jax")}
    with concurrent.futures.ThreadPoolExecutor(WORLDS_AT_ONCE) as pool:
        runs = {key: pool.submit(
                    launch_world, key[1], os.path.abspath(__file__),
                    {"HVDTPU_TEST_WORKER": key[0], "HVDTPU_TEST_OUT": d},
                    240)
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


def _bitwise(got, want, where):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _bitwise(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _bitwise(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        g = np.asarray(got)
        assert g.dtype == want.dtype and g.shape == want.shape, \
            (where, g.dtype, g.shape, want.dtype, want.shape)
        assert g.tobytes() == want.tobytes(), (where, g, want)
    else:
        assert got == want, (where, got, want)


@pytest.mark.parametrize("world", (2, 3))
@pytest.mark.parametrize("case", ("allgather", "allgather_scalar",
                                  "broadcast", "alltoall_even",
                                  "alltoall_splits"))
def test_differentiable_collectives_match_jax(case, world, worlds):
    for r in range(world):
        _bitwise(worlds["port", world][r]["collectives"][case],
                 worlds["jax", world][r]["collectives"][case],
                 f"{case} rank {r}")


@pytest.mark.parametrize("world", (2, 3))
def test_gradients_are_the_analytic_ones(world, worlds):
    """What the JAX frontend computes is the analytic gradient: an
    allgather's is this rank's rows of the ranks' summed cotangents, a
    broadcast's the sum on the root and zeros elsewhere, an alltoall's
    the cotangent parts sent home (held on the port's results)."""
    got = [worlds["port", world][r]["collectives"] for r in range(world)]
    w = [_x(f"w{got[0]['allgather'][0].shape}", r,
            got[0]["allgather"][0].shape) for r in range(world)]
    total = sum(w)
    offset = 0
    for r in range(world):
        np.testing.assert_array_equal(got[r]["allgather"][1],
                                      total[offset:offset + r + 1])
        offset += r + 1
    wb = sum(_x("w(4, 3)", r, (4, 3)) for r in range(world))
    for r in range(world):
        want = wb if r == 1 else np.zeros((4, 3), np.float32)
        np.testing.assert_array_equal(got[r]["broadcast"][1], want)
    # alltoall with splits: rank r's part for rank d comes back from d.
    sp = [_splits(r, world) for r in range(world)]
    recv_w = []
    for d in range(world):
        rows = sum(sp[s][d] for s in range(world))
        recv_w.append(_x(f"w{(rows, 3)}", d, (rows, 3)))
    for r in range(world):
        parts = []
        for d in range(world):
            start = sum(sp[s][d] for s in range(r))
            parts.append(recv_w[d][start:start + sp[r][d]])
        np.testing.assert_array_equal(got[r]["alltoall_splits"][1],
                                      np.concatenate(parts))


@pytest.mark.parametrize("world", (2, 3))
def test_reducescatter_still_refuses_grad(world, worlds):
    for r in range(world):
        assert "reducescatter" in worlds["port", world][r]["reducescatter"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_sync_batch_norm_matches_jax(case, world, worlds):
    for r in range(world):
        _bitwise(worlds["port", world][r]["bn"][case],
                 worlds["jax", world][r]["bn"][case], f"{case} rank {r}")


@pytest.mark.parametrize("world", (2, 3))
def test_sync_batch_norm_spans_the_ranks(world, worlds):
    """The training statistics are the whole batch's: rank 0's first
    output is the batch norm of every rank's batch, concatenated."""
    import torch
    xs = [_x("bn.default.0", r, (r + 2, 3, 4, 5)) + 3.0
          for r in range(world)]
    ref = torch.nn.BatchNorm2d(3)
    with torch.no_grad():
        ref.weight.copy_(torch.from_numpy(_x("bn.w", 0, (3,))))
        ref.bias.copy_(torch.from_numpy(_x("bn.b", 0, (3,))))
    want = ref(torch.from_numpy(np.concatenate(xs))).detach().numpy()
    got = np.concatenate([worlds["port", world][r]["bn"]["default"][0]["y"]
                          for r in range(world)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sync_batch_norm_in_spmd_mode():
    """SPMD mode (a world of one over gloo): torch's batch norm, the
    running statistics included; the top-level class stays the flax
    module's."""
    import torch

    import horovod_tpu_torch as thvd
    import horovod_tpu_torch.torch as ht
    from horovod_tpu_torch.parallel.sync_batch_norm import \
        SyncBatchNorm as FlaxSyncBatchNorm
    assert thvd.SyncBatchNorm is FlaxSyncBatchNorm
    assert issubclass(ht.SyncBatchNorm,
                      torch.nn.modules.batchnorm._BatchNorm)
    thvd.init(device="cpu")
    try:
        x = torch.from_numpy(_x("spmd", 0, (4, 3, 2, 2)))
        bn, ref = ht.SyncBatchNorm(3), torch.nn.BatchNorm2d(3)
        torch.testing.assert_close(bn(x), ref(x), rtol=0, atol=0)
        torch.testing.assert_close(bn.running_var, ref.running_var,
                                   rtol=0, atol=0)
    finally:
        thvd.shutdown()


def test_flax_sync_batch_norm_names_the_process_class(monkeypatch):
    import torch

    import horovod_tpu_torch as thvd
    from conftest import free_port
    monkeypatch.setenv("HVDTPU_CONTROLLER_PORT", str(free_port()))
    thvd.init(mode="process", device="cpu")
    try:
        with pytest.raises(NotImplementedError,
                           match="horovod_tpu_torch.torch.SyncBatchNorm"):
            thvd.SyncBatchNorm(3)(torch.ones(2, 3, 2, 2))
    finally:
        thvd.shutdown()


def test_convert_sync_batchnorm_shares_the_tensors():
    """The port's helper: the flax-style ``BatchNorm`` of the models (its
    momentum m becomes 1 - m) and torch's batch norms become
    ``SyncBatchNorm`` over the same parameters and buffers."""
    import torch

    import horovod_tpu_torch.torch as ht
    from horovod_tpu_torch.models.resnet import BatchNorm
    from horovod_tpu_torch.torch.sync_batch_norm import \
        convert_sync_batchnorm
    model = torch.nn.Sequential(BatchNorm(4), torch.nn.BatchNorm2d(4))
    weights = [m.weight for m in model]
    stats = [m.running_var for m in model]
    model = convert_sync_batchnorm(model)
    assert all(isinstance(m, ht.SyncBatchNorm) for m in model)
    assert [m.weight for m in model] == weights
    assert all(a is b for a, b in zip([m.running_var for m in model],
                                      stats))
    assert model[0].momentum == pytest.approx(0.1)
    assert model[1].momentum == 0.1


if __name__ == "__main__" and os.environ.get("HVDTPU_TEST_WORKER"):
    _worker(os.environ["HVDTPU_TEST_WORKER"], os.environ["HVDTPU_TEST_OUT"])
