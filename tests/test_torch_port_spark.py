"""The port's Spark layer and cluster integrations (``horovod_tpu_torch.
spark``, ``horovod_tpu_torch.integrations`` but the estimators) against the
JAX package's, on the CPU.

* The stores, the pandas-backed DataFrame, ``prepare_data``, the data-form
  dispatch, ``_rank_layout`` and ``_scoped_environ``: the same paths,
  bytes, row splits and errors as the JAX package's, on the same inputs.
* ``ParquetShardReader``: every batch of every rank's shard identical to
  the JAX reader's (dtype, shape and bytes) at 1, 2 and 3 ranks, sharded
  by fragment and by row, with scalar, list, weight and several label
  columns; a column with nulls takes the JAX reader's route and still
  agrees, and ragged lists fail in both readers alike. (The port reads numeric and equal-length list columns
  from Arrow's buffers, where the JAX reader builds a Python object a
  value.)
* ``_spark_task`` minus Spark: two tasks of each package (this file is
  their worker: ``HVDTPU_TEST_WORKER=port|jax``) against their package's
  KV server, the port's on the CPU, each running its package's
  ``Estimator._remote_fit`` on its parquet shard in process mode: the same
  rank layout, and the MLP's history and weights (the flax model's initial
  weights carried over with ``flax_to_torch``) within rtol 1e-5, atol
  1e-6: the flax loop runs jitted XLA programs, whose sums and fused
  multiply-adds round otherwise than torch's eager ops.
* ``run`` and ``run_elastic`` raise without pyspark; ``_elastic_spark_task``
  over ``HeartbeatRendezvous`` forms a world of two.
* ``Executor`` over ``hvd.run`` and ``RayExecutor`` against a synchronous
  stand-in for ray (the JAX tests' pattern): topology, executables,
  placement groups and the error without ray.
"""

import concurrent.futures
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

FEATURES = 2
ROWS, PARTS, BATCH, EPOCHS, LR = 64, 4, 32, 3, 0.05


def _packages():
    import horovod_tpu.spark as jax_spark
    import horovod_tpu_torch.spark as port_spark
    return port_spark, jax_spark


# ---------------------------------------------------------------------------
# the stores, frames and dispatch
# ---------------------------------------------------------------------------

def test_stores_match_jax(tmp_path):
    import pyarrow.fs as pafs
    for pkg, sub in zip(_packages(), ("port", "jax")):
        root = tmp_path / sub
        store = pkg.Store.create(str(root))
        assert type(store).__name__ == "LocalStore"
        assert type(pkg.Store.create("dbfs:/x")).__name__ == "DBFSLocalStore"
        paths = [getattr(store, f"get_{what}_path")("r1") for what in (
            "train_data", "val_data", "test_data", "checkpoint", "logs")]
        assert [os.path.relpath(p, root) for p in paths] == [
            "r1/train_data", "r1/val_data", "r1/test_data",
            "r1/checkpoint.pkl", "r1/logs"]
        assert store.exists(store.save("r1", b"blob"))
        assert store.load("r1") == b"blob"
        dbfs = pkg.DBFSLocalStore.__new__(pkg.DBFSLocalStore)
        assert dbfs._normalize("dbfs:/runs/a") == "/dbfs/runs/a"
        hdfs = pkg.HDFSStore(f"hdfs://nn:9000{root}/h",
                             filesystem=pafs.LocalFileSystem())
        ckpt = hdfs.get_checkpoint_path("r7")
        assert ckpt == f"{root}/h/r7/checkpoint.pkl"
        assert not hdfs.exists(ckpt)
        hdfs.save("r7", b"remote")
        assert hdfs.exists(ckpt) and hdfs.load("r7") == b"remote"


def test_pandas_frames_and_prepare_data_match_jax(tmp_path):
    import pandas as pd
    import pyarrow.parquet as pq
    rng = np.random.RandomState(4)
    pdf = pd.DataFrame({"a": rng.randn(23).astype(np.float32),
                        "b": np.arange(23)})
    metas, tables = [], []
    for pkg, sub in zip(_packages(), ("port", "jax")):
        df = pkg.PandasDataFrame(pdf, partitions=3)
        splits = df.randomSplit([0.7, 0.2, 0.1], seed=5)
        tables.append([s._pdf["b"].tolist() for s in splits])
        store = pkg.LocalStore(str(tmp_path / sub))
        from importlib import import_module
        util = import_module(f"{pkg.__name__}.util")
        meta = util.prepare_data(df, store, "run", validation=0.25,
                                 partitions=2)
        metas.append({k: (os.path.relpath(v, tmp_path / sub)
                          if isinstance(v, str) else v)
                      for k, v in meta.items()})
        tables.append(sorted(pq.read_table(meta["val_data_path"])
                             .column("b").to_pylist()))
        with pytest.raises(FileExistsError):
            df.write.parquet(meta["train_data_path"])
    assert metas[0] == metas[1]
    assert tables[:2] == tables[2:]


def test_fit_dispatch_matches_jax():
    import pandas as pd
    from horovod_tpu.spark import fit_dispatch as jax_fd
    from horovod_tpu_torch.spark import fit_dispatch as port_fd
    frame = pd.DataFrame({"a": [1.0, 2.0]})
    cases = [((np.ones(3), np.ones(3)), None, None), ("/data", "/val", None),
             ("/data", None, 2), (frame, 0.5, None),
             ((np.ones(3),), None, 2), (frame, None, 2), ("/data", 0.3, None)]
    for data, val, num_proc in cases:
        got = []
        for fd in (port_fd, jax_fd):
            try:
                kind, _, v = fd.resolve_fit_data(data, val, num_proc)
                got.append((kind, type(v).__name__))
            except ValueError as e:
                got.append(("error", str(e)))
        assert got[0] == got[1], (data, val, num_proc, got)


def test_rank_layout_and_scoped_environ_match_jax(monkeypatch):
    port, jax_spark = _packages()
    for hosts in (["a", "a", "a"], ["a", "b", "a", "b"], ["x", "y", "y"]):
        for r in range(len(hosts)):
            assert port._rank_layout(hosts, r) == \
                jax_spark._rank_layout(hosts, r)
    monkeypatch.setenv("HVDTPU_TEST_KEEP", "before")
    monkeypatch.delenv("HVDTPU_TEST_NEW", raising=False)
    with port._scoped_environ({"HVDTPU_TEST_KEEP": "in",
                               "HVDTPU_TEST_NEW": "in"}):
        assert os.environ["HVDTPU_TEST_KEEP"] == "in"
    assert os.environ["HVDTPU_TEST_KEEP"] == "before"
    assert "HVDTPU_TEST_NEW" not in os.environ


@pytest.mark.parametrize("what", ("run", "run_elastic"))
def test_run_without_pyspark_raises(what):
    try:
        import pyspark  # noqa: F401
        pytest.skip("pyspark is installed")
    except ImportError:
        pass
    port, _ = _packages()
    with pytest.raises(ImportError, match="horovod_tpu_torch.spark"):
        getattr(port, what)(lambda: None, num_proc=2)


def test_spark_namespace_estimators():
    import horovod_tpu_torch.spark as s
    from horovod_tpu_torch.integrations.estimator import Estimator
    from horovod_tpu_torch.torch.estimator import TorchEstimator
    assert s.Estimator is Estimator and s.TorchEstimator is TorchEstimator


# ---------------------------------------------------------------------------
# the parquet shard reader
# ---------------------------------------------------------------------------

def _columns(n, seed):
    import pyarrow as pa
    rng = np.random.RandomState(seed)
    vec = rng.randn(n, 5).astype(np.float32)
    ragged = [list(range(i % 3 + 1)) for i in range(n)]
    with_null = [None if i % 7 == 3 else float(i) for i in range(n)]
    return {
        "f0": pa.array(rng.randn(n).astype(np.float32)),
        "f1": pa.array(rng.randn(n)),
        "i32": pa.array(rng.randint(-9, 9, n).astype(np.int32)),
        "flag": pa.array(rng.rand(n) > 0.5),
        "vec": pa.ListArray.from_arrays(
            pa.array(np.arange(0, 5 * n + 1, 5, dtype=np.int32)),
            pa.array(vec.reshape(-1))),
        "fixed": pa.FixedSizeListArray.from_arrays(
            pa.array(rng.randn(3 * n)), 3),
        "label": pa.array(rng.randint(0, 4, n).astype(np.int64)),
        "label2": pa.array(rng.randn(n).astype(np.float32)),
        "w": pa.array(rng.rand(n).astype(np.float32)),
        "ragged": pa.array(ragged),
        "with_null": pa.array(with_null),
    }


@pytest.fixture(scope="module")
def parquet_dirs(tmp_path_factory):
    """Two stores of the same 41 rows: four fragments, and one."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    base = tmp_path_factory.mktemp("reader")
    parts = [11, 10, 12, 8]
    for d, cut in (("four", parts), ("one", [sum(parts)])):
        os.makedirs(base / d)
        for i, n in enumerate(cut):
            cols = _columns(n, 100 + i if d == "four" else 99)
            pq.write_table(pa.table(cols), str(base / d / f"part-{i}.parquet"))
    return base


def _bitwise(got, want, where):
    if isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _bitwise(g, w, f"{where}[{i}]")
        return
    assert isinstance(got, np.ndarray) and isinstance(want, np.ndarray), \
        where
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (where, got.dtype, got.shape, want.dtype, want.shape)
    if want.dtype == object:
        assert got.tolist() == want.tolist(), where
    else:
        assert got.tobytes() == want.tobytes(), where
    assert got.flags.writeable, where


READS = {"scalars": (["f0", "f1", "i32", "flag"], "label", None),
         "list": (["vec"], "label", "w"),
         "list_and_scalar": (["vec", "f0"], ["label", "label2"], None),
         "fixed_list": (["fixed"], "label2", "w"),
         "fallback": (["f0", "i32"], "with_null", None)}


@pytest.mark.parametrize("store", ("four", "one"))
@pytest.mark.parametrize("size", (1, 2, 3))
@pytest.mark.parametrize("read", sorted(READS))
def test_reader_matches_jax(read, size, store, parquet_dirs):
    from horovod_tpu.spark.util import ParquetShardReader as JaxReader
    from horovod_tpu_torch.spark.util import ParquetShardReader
    features, label, weight = READS[read]
    for rank in range(size):
        readers = [cls(str(parquet_dirs / store), features, label,
                       batch_size=4, rank=rank, size=size, weight_col=weight)
                   for cls in (ParquetShardReader, JaxReader)]
        assert readers[0].rows() == readers[1].rows()
        got, want = (list(r.batches()) for r in readers)
        assert len(got) == len(want) > 0
        _bitwise(got, want, f"{read} {store} rank {rank}/{size}")


def test_list_columns_come_from_buffers(parquet_dirs):
    """The list column of an image-sized row is read from Arrow's buffers,
    not through a Python object a value; the fallback keeps to_pylist's
    arrays for what the buffers cannot give."""
    import pyarrow.parquet as pq

    from horovod_tpu.spark import util as jax_util
    from horovod_tpu_torch.spark import util
    table = pq.read_table(str(parquet_dirs / "four"))
    for name in ("f0", "i32", "flag", "vec", "fixed", "label"):
        assert util._from_buffers(table.column(name).combine_chunks()) \
            is not None, name
    for name in ("ragged", "with_null"):
        assert util._from_buffers(table.column(name).combine_chunks()) \
            is None, name
    _bitwise(util._column_to_array(table.column("with_null")),
             jax_util._column_to_array(table.column("with_null")), "nulls")
    # Ragged rows make no array in either reader.
    for mod in (util, jax_util):
        with pytest.raises(ValueError):
            mod._column_to_array(table.column("ragged"))
    _bitwise(util.table_to_xy(table, ["vec", "f1"], "label"),
             jax_util.table_to_xy(table, ["vec", "f1"], "label"), "xy")


# ---------------------------------------------------------------------------
# the Spark task body and _remote_fit, in processes
# ---------------------------------------------------------------------------

def _spark_fit(kind, data_dir, store_dir, state_file):
    """What each task runs under its package's runtime: the Estimator's
    ``_remote_fit`` on this rank's shard; rank 0 also reads the best
    weights back from the store."""
    if kind == "port":
        import torch

        from horovod_tpu_torch import runtime as rt
        from horovod_tpu_torch.integrations import Estimator, LocalStore
        from horovod_tpu_torch.integrations.estimator import (
            EstimatorModel, _remote_fit)
        from horovod_tpu_torch.models import MLP
        model = MLP(features=(16, 1), in_features=FEATURES)
        with open(state_file, "rb") as f:
            model.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in pickle.load(f).items()})
        est = Estimator(model, lambda p: torch.optim.SGD(p, lr=LR),
                        lambda p, t: ((p[:, 0] - t) ** 2).mean(),
                        LocalStore(store_dir), epochs=EPOCHS,
                        batch_size=BATCH, run_id="spark",
                        feature_cols=["f0", "f1"], label_col="label",
                        metrics={"mae": lambda p, t: (p[:, 0] - t).abs()
                                 .mean()}, device="cpu")
        history, _ = _remote_fit(est, data_dir)
        params = None
        if rt.rank() == 0:
            params = {k: v.numpy() for k, v in EstimatorModel.load(
                model, est.store, "spark", device="cpu").params.items()}
        return {"history": history, "logs": est._last_logs,
                "params": params, "size": rt.size(),
                "local": (rt.local_rank(), rt.local_size(), rt.cross_rank(),
                          rt.cross_size())}
    import jax.numpy as jnp
    import optax

    import horovod_tpu as hvd
    from horovod_tpu.integrations import Estimator, LocalStore
    from horovod_tpu.integrations.estimator import _remote_fit
    from horovod_tpu.models import MLP
    est = Estimator(MLP(features=(16, 1)), optax.sgd(LR),
                    lambda p, t: ((p[:, 0] - t) ** 2).mean(),
                    LocalStore(store_dir), epochs=EPOCHS, batch_size=BATCH,
                    run_id="spark", feature_cols=["f0", "f1"],
                    label_col="label",
                    sample_input=np.zeros((1, FEATURES), np.float32),
                    metrics={"mae": lambda p, t: jnp.abs(p[:, 0] - t)
                             .mean()})
    history, _ = _remote_fit(est, data_dir)
    params = None
    if hvd.rank() == 0:
        params = pickle.loads(est.store.load("spark"))["params"]
    return {"history": history, "logs": est._last_logs, "params": params,
            "size": hvd.size(),
            "local": (hvd.local_rank(), hvd.local_size(), hvd.cross_rank(),
                      hvd.cross_size())}


def _worker(kind, out_dir):
    rank, n, kv_port = (int(os.environ[k]) for k in (
        "SPARK_TEST_RANK", "SPARK_TEST_SIZE", "SPARK_TEST_KV_PORT"))
    args = (kind, os.path.join(out_dir, "..", "data"),
            os.path.join(out_dir, "store"),
            os.path.join(out_dir, "..", "state.pkl"))
    payload = pickle.dumps((_spark_fit, args, {}))
    if kind == "port":
        from horovod_tpu_torch.spark import _spark_task
        got, res = _spark_task(rank, n, "127.0.0.1", kv_port, payload, 60.0,
                               None, device="cpu")
    else:
        import jax
        jax.config.update("jax_platforms", "cpu")
        from horovod_tpu.spark import _spark_task
        got, res = _spark_task(rank, n, "127.0.0.1", kv_port, payload, 60.0,
                               None)
    res["rank"] = got
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    print("ALL OK")


def _elastic_train():
    """An elastic task's function: three committed allreduces."""
    import torch

    import horovod_tpu_torch as hvd
    state = hvd.elastic.ObjectState(batches=0, total=0.0)

    @hvd.elastic.run
    def loop(state):
        while state.batches < 3:
            out = hvd.allreduce(torch.ones(4), op=hvd.Sum,
                                name=f"spark.e{state.batches}")
            state.total += float(out[0])
            state.batches += 1
            state.commit()
        return hvd.size(), state.total
    return loop(state)


def _elastic_worker(out_dir):
    from horovod_tpu_torch.spark import _elastic_spark_task
    index = int(os.environ["SPARK_TEST_RANK"])
    rank, result = _elastic_spark_task(
        index, "127.0.0.1", int(os.environ["SPARK_TEST_KV_PORT"]),
        pickle.dumps((_elastic_train, (), {})), None, device="cpu")
    with open(os.path.join(out_dir, f"elastic.{index}.pkl"), "wb") as f:
        pickle.dump((rank, result), f)
    print("ALL OK")


def _spawn(kind, n, out_dir, kv_port, env_extra=None):
    from conftest import subprocess_env
    procs = []
    for r in range(n):
        env = subprocess_env()
        env.update({"HVDTPU_TEST_WORKER": kind, "HVDTPU_TEST_OUT": out_dir,
                    "SPARK_TEST_RANK": str(r), "SPARK_TEST_SIZE": str(n),
                    "SPARK_TEST_KV_PORT": str(kv_port), **(env_extra or {})})
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0 and "ALL OK" in out, f"{kind} task {r}:\n{err}\n{out}"


def _task_world(kind, base):
    from horovod_tpu_torch.runner.http_kv import KVStoreServer
    out = str(base / kind)
    os.makedirs(out)
    server = KVStoreServer(port=0)
    server.start()
    try:
        _spawn(kind, 2, out, server.port)
    finally:
        server.stop()
    res = []
    for r in range(2):
        with open(os.path.join(out, f"{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


def _elastic_world(base):
    from horovod_tpu_torch.spark.elastic import HeartbeatRendezvous
    out = str(base / "elastic")
    os.makedirs(out)
    driver = HeartbeatRendezvous(min_np=2, max_np=2)
    driver.start()
    try:
        _spawn("elastic", 2, out, driver.port,
               {"HVDTPU_ELASTIC_TIMEOUT": "60"})
    finally:
        driver.stop()
    res = []
    for r in range(2):
        with open(os.path.join(out, f"elastic.{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


def _executor_run():
    from horovod_tpu_torch.integrations import Executor

    def fn(scale=3):
        from horovod_tpu_torch import runtime
        return runtime.rank() * scale, runtime.mode()

    ex = Executor(num_workers=2, device="cpu")
    ex.start()
    try:
        return ex.run(fn, kwargs={"scale": 5})
    finally:
        ex.shutdown()


@pytest.fixture(scope="module")
def task_worlds(tmp_path_factory):
    """Both packages' task worlds, the elastic world and the executor's
    job, three at a time."""
    import jax

    import pyarrow as pa
    import pyarrow.parquet as pq
    from horovod_tpu import basics as jax_basics
    from horovod_tpu.models import MLP as FlaxMLP
    from horovod_tpu_torch.models.convert import flax_to_torch
    from horovod_tpu_torch.utils import native_build
    native_build.build()
    jax_basics._ensure_built()
    base = tmp_path_factory.mktemp("spark_tasks")
    os.makedirs(base / "data")
    rng = np.random.RandomState(3)
    w = rng.randn(FEATURES).astype(np.float32)
    for part in range(PARTS):
        f = rng.randn(ROWS, FEATURES).astype(np.float32)
        pq.write_table(pa.table({"f0": f[:, 0], "f1": f[:, 1],
                                 "label": (f @ w).astype(np.float32)}),
                       str(base / "data" / f"part-{part}.parquet"))
    variables = FlaxMLP(features=(16, 1)).init(
        jax.random.PRNGKey(0), np.zeros((1, FEATURES), np.float32))
    with open(base / "state.pkl", "wb") as f:
        pickle.dump({k: v.numpy() for k, v in
                     flax_to_torch(variables).items()}, f)
    jobs = {"port": lambda: _task_world("port", base),
            "jax": lambda: _task_world("jax", base),
            "elastic": lambda: _elastic_world(base),
            "executor": _executor_run}
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        futures = {k: pool.submit(job) for k, job in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


def test_spark_task_layout_matches_jax(task_worlds):
    for r in range(2):
        port, jax_res = task_worlds["port"][r], task_worlds["jax"][r]
        assert port["rank"] == jax_res["rank"] == r
        assert port["size"] == jax_res["size"] == 2
        assert port["local"] == jax_res["local"]


def test_remote_fit_matches_jax(task_worlds):
    """The histories and logs (rank-averaged loss and mae) and the best
    epoch's weights, within the tolerance of the module docstring."""
    from horovod_tpu_torch.models.convert import flax_to_torch
    for r in range(2):
        port, jax_res = task_worlds["port"][r], task_worlds["jax"][r]
        np.testing.assert_allclose(port["history"], jax_res["history"],
                                   rtol=1e-5, atol=1e-6)
        for got, want in zip(port["logs"], jax_res["logs"]):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           atol=1e-6)
    assert task_worlds["port"][0]["history"][-1] < \
        task_worlds["port"][0]["history"][0]
    want = {k: v.numpy() for k, v in flax_to_torch(
        task_worlds["jax"][0]["params"]).items()}
    got = task_worlds["port"][0]["params"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)


def test_elastic_spark_task_forms_a_world(task_worlds):
    assert sorted(task_worlds["elastic"]) == [(0, (2, 6.0)), (1, (2, 6.0))]


def test_executor_runs_over_the_ports_runner(task_worlds):
    assert task_worlds["executor"] == [(0, "spmd"), (5, "spmd")]


# ---------------------------------------------------------------------------
# RayExecutor against a stand-in for ray
# ---------------------------------------------------------------------------

def _fake_ray(monkeypatch, hostnames):
    from test_integrations import _FakeRay
    fake = _FakeRay(hostnames)
    monkeypatch.setitem(sys.modules, "ray", fake)
    return fake


def test_ray_without_ray_raises_actionable_error():
    try:
        import ray  # noqa: F401
        pytest.skip("ray is installed")
    except ImportError:
        pass
    from horovod_tpu_torch.integrations import RayExecutor
    with pytest.raises(ImportError, match="horovod_tpu_torch.integrations"):
        RayExecutor(num_workers=2)


def test_ray_topology_env_matches_jax(monkeypatch):
    from horovod_tpu.integrations.ray import RayExecutor as JaxRayExecutor
    from horovod_tpu_torch.integrations import RayExecutor
    envs = []
    for cls in (RayExecutor, JaxRayExecutor):
        fake = _fake_ray(monkeypatch, ["hostA", "hostA", "hostB"])
        ex = cls(num_workers=3)
        saved = dict(os.environ)
        try:
            ex.start(extra_env_vars={"MY_FLAG": "1"})
        finally:
            os.environ.clear()
            os.environ.update(saved)
        got = [args[0] for name, args, _ in fake.calls if name == "set_env"]
        for e in got:
            e.pop("HVDTPU_CONTROLLER_PORT")
        envs.append(got)
    assert envs[0] == envs[1] and len(envs[0]) == 3
    assert envs[0][2]["HVDTPU_CROSS_RANK"] == "1"


def test_ray_executable_and_execute_paths(monkeypatch):
    from horovod_tpu_torch.integrations import RayExecutor
    fake = _fake_ray(monkeypatch, ["h0"])
    ex = RayExecutor(num_workers=2, device="cpu")

    class Trainer:
        def __init__(self, base):
            self.base = base

    saved = dict(os.environ)
    try:
        ex.start(executable_cls=Trainer, executable_args=[10])
        assert ex.execute(lambda t: t.base + 1) == [11, 11]
        assert ex.execute_single(lambda t: t.base) == 10
    finally:
        os.environ.clear()
        os.environ.update(saved)
    # Outside the topology env the wrapped function's runtime is a world of
    # one in process mode, on the CPU.
    from conftest import free_port
    monkeypatch.setenv("HVDTPU_CONTROLLER_PORT", str(free_port()))

    def fn(a, b):
        from horovod_tpu_torch import runtime
        return a * b, runtime.mode(), runtime.size()
    assert fake.get(ex.run_remote(fn, args=(3, 4))) == \
        [(12, "process", 1)] * 2
    ex.shutdown()
    assert ex.workers == []


def test_ray_placement_group_strategy(monkeypatch):
    import types
    created = {}

    class _PG:
        def ready(self):
            from test_integrations import _FakeRef
            return _FakeRef(True)

    def placement_group(bundles, strategy=None):
        created.update(bundles=bundles, strategy=strategy)
        return _PG()

    class _Strategy:
        def __init__(self, placement_group=None,
                     placement_group_bundle_index=None):
            self.index = placement_group_bundle_index

    pg_mod = types.ModuleType("ray.util.placement_group")
    pg_mod.placement_group = placement_group
    pg_mod.remove_placement_group = lambda pg: None
    ss_mod = types.ModuleType("ray.util.scheduling_strategies")
    ss_mod.PlacementGroupSchedulingStrategy = _Strategy
    monkeypatch.setitem(sys.modules, "ray.util.placement_group", pg_mod)
    monkeypatch.setitem(sys.modules, "ray.util.scheduling_strategies", ss_mod)
    fake = _fake_ray(monkeypatch, ["n0", "n0", "n1", "n1"])
    from horovod_tpu_torch.integrations import RayExecutor
    ex = RayExecutor(num_hosts=2, num_slots=2)
    saved = dict(os.environ)
    try:
        ex.start()
    finally:
        os.environ.clear()
        os.environ.update(saved)
    assert created["strategy"] == "STRICT_SPREAD"
    assert [o["scheduling_strategy"].index for o in fake.remote_opts] == \
        [0, 0, 1, 1]
    with pytest.raises(ValueError):
        RayExecutor(num_workers=2, num_hosts=1)


if __name__ == "__main__" and os.environ.get("HVDTPU_TEST_WORKER"):
    if os.environ["HVDTPU_TEST_WORKER"] == "elastic":
        _elastic_worker(os.environ["HVDTPU_TEST_OUT"])
    else:
        _worker(os.environ["HVDTPU_TEST_WORKER"],
                os.environ["HVDTPU_TEST_OUT"])
