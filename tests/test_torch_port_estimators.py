"""The port's estimators against the JAX package's, on the CPU.

* ``horovod_tpu_torch.torch.TorchEstimator`` against
  ``horovod_tpu.torch.TorchEstimator`` at a world of one, in this process:
  the same ``nn.Module`` and optimizer factory on the same numpy data from
  a seed give bitwise the same history, trained weights and predictions
  (both run the same torch ops on the CPU): metrics and a validation
  fraction, sample weights, two heads with loss weights,
  ``transformation_fn``, a cap on the steps of an epoch, early stopping,
  a DataFrame and a parquet path, and checkpoint resume by ``run_id``.
* ``_remote_fit_torch`` at a world of two in process mode, each package's
  ranks on their parquet shards (this file is the worker:
  ``HVDTPU_TEST_WORKER=port|jax|spmd``): the rank-averaged history and
  rank 0's trained weights, bitwise (the same torch arithmetic; each
  core averages the gradients in float32 the same way).
* ``horovod_tpu_torch.integrations.Estimator`` against the flax
  ``Estimator`` on an MLP, the flax model's initial weights carried over
  with ``flax_to_torch``: arrays with a validation fraction, sample
  weights, a DataFrame, a parquet path, resume and early stopping;
  histories, logs, the best epoch's weights and ``transform`` within rtol
  1e-5, atol 1e-6 (the flax estimator's jitted XLA steps sum and fuse
  otherwise than torch's eager ops). The JAX runtime here is a mesh of
  one CPU device: the flax estimator's SPMD step weighs each device's part
  of a batch by itself (a mean of the parts' weighted means), as the
  port's ranks do, so only a mesh of one is the port's world of one. The
  port's SPMD path at a world of two (each rank half of every batch, over
  gloo) agrees with its world of one within the same tolerance
  (unweighted).
"""

import concurrent.futures
import os
import pickle

import numpy as np
import pytest

ROWS, BATCH, EPOCHS, LR = 256, 32, 4, 0.05
TOL = dict(rtol=1e-5, atol=1e-6)


def _data(seed=0, n=ROWS):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 2).astype(np.float32)
    y = (x @ np.array([1.5, -2.0], np.float32) + 0.5).astype(np.float32)
    w = rng.rand(n).astype(np.float32)
    return x, y, w


# ---------------------------------------------------------------------------
# TorchEstimator at a world of one
# ---------------------------------------------------------------------------

def _linear(heads=1):
    import torch
    torch.manual_seed(7)
    if heads == 1:
        return torch.nn.Linear(2, 1)

    class Two(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.a = torch.nn.Linear(2, 1)
            self.b = torch.nn.Linear(2, 1)

        def forward(self, x):
            return self.a(x), self.b(x)
    return Two()


def _torch_estimator(pkg, store_dir, model, **kw):
    import torch
    import torch.nn.functional as F
    est_mod = __import__(f"{pkg}.torch.estimator", fromlist=["x"])
    store_mod = __import__(f"{pkg}.spark", fromlist=["LocalStore"])
    args = dict(model=model,
                optimizer=lambda p: torch.optim.Adam(p, lr=LR),
                loss=lambda out, lab: F.mse_loss(out[:, 0], lab),
                store=store_mod.LocalStore(store_dir), epochs=EPOCHS,
                batch_size=BATCH,
                metrics={"mae": lambda out, lab: (out[:, 0] - lab).abs()
                         .mean()})
    args.update(kw)
    if pkg == "horovod_tpu_torch":
        args["device"] = "cpu"
    return est_mod.TorchEstimator(**args), est_mod


def _weights(model):
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def _torch_case(case, tmp_path):
    """(history, weights, predictions) of each package for ``case``."""
    import pandas as pd
    import torch
    import torch.nn.functional as F
    x, y, w = _data()
    out = []
    for pkg in ("horovod_tpu_torch", "horovod_tpu"):
        store = str(tmp_path / pkg)
        kw, data, model = {}, (x, y), _linear()
        fit_kw = {}
        if case == "validation":
            fit_kw["validation"] = 0.25
        elif case == "weights":
            kw["loss"] = lambda out, lab: F.mse_loss(out[:, 0], lab,
                                                     reduction="none")
            data = (x, y, w)
        elif case == "two_heads":
            model = _linear(2)
            kw.update(loss=[lambda o, t: F.mse_loss(o[:, 0], t)] * 2,
                      loss_weights=[1.0, 0.5], label_cols=["a", "b"],
                      metrics={})
            data = (x, np.stack([y, -y]).T)

            def split(xb, yb, wb):
                return xb, [yb[:, 0], yb[:, 1]], wb
            kw["transformation_fn"] = split
        elif case == "transformation_and_cap":
            kw.update(transformation_fn=lambda a, b, c: (a * 2.0, b, c),
                      train_steps_per_epoch=3)
        elif case == "early_stopping":
            cb = __import__(f"{pkg}.torch.estimator",
                            fromlist=["x"]).EarlyStopping
            kw["callbacks"] = [cb(monitor="loss", min_delta=10.0,
                                  patience=0)]
        elif case == "dataframe":
            kw.update(feature_cols=["f0", "f1"], label_cols=["label"])
            data = pd.DataFrame({"f0": x[:, 0], "f1": x[:, 1], "label": y})
            fit_kw["validation"] = 0.2
        elif case == "parquet":
            import pyarrow as pa
            import pyarrow.parquet as pq
            d = tmp_path / f"{pkg}.data"
            os.makedirs(d)
            for i in range(2):
                sl = slice(i * ROWS // 2, (i + 1) * ROWS // 2)
                pq.write_table(pa.table({"f0": x[sl, 0], "f1": x[sl, 1],
                                         "label": y[sl]}),
                               str(d / f"part-{i}.parquet"))
            kw.update(feature_cols=["f0", "f1"], label_cols=["label"])
            data = str(d)
        elif case == "resume":
            est, _ = _torch_estimator(pkg, store, _linear(), epochs=2)
            est.fit((x, y))
        est, _ = _torch_estimator(pkg, store, model, **kw)
        fitted = est.fit(data, **fit_kw)
        pred = fitted.transform(x[:10], batch_size=4)
        out.append((fitted.history, _weights(fitted.model), pred))
    return out


TORCH_CASES = ("plain", "validation", "weights", "two_heads",
               "transformation_and_cap", "early_stopping", "dataframe",
               "parquet", "resume")


@pytest.mark.parametrize("case", TORCH_CASES)
def test_torch_estimator_matches_jax(case, tmp_path):
    (hist, weights, pred), (jhist, jweights, jpred) = _torch_case(case,
                                                                   tmp_path)
    assert hist == jhist
    assert set(weights) == set(jweights)
    for k in weights:
        assert weights[k].tobytes() == jweights[k].tobytes(), k
    if isinstance(pred, list):
        for p, jp in zip(pred, jpred):
            assert p.tobytes() == jp.tobytes()
    else:
        assert pred.tobytes() == jpred.tobytes()
    if case == "early_stopping":
        assert len(hist) == 2  # the first epoch sets the best
    elif case == "resume":
        assert len(hist) == EPOCHS
    if case == "validation":
        assert "val_loss" in hist[-1] and "val_mae" in hist[-1]


def test_torch_model_load_runs_on_its_device(tmp_path):
    import torch

    from horovod_tpu_torch.torch import TorchModel
    x, y, _ = _data()
    est, _ = _torch_estimator("horovod_tpu_torch", str(tmp_path), _linear())
    fitted = est.fit((x, y))
    loaded = TorchModel.load(_linear(), est.store, est.run_id, device="cpu")
    assert loaded.device == torch.device("cpu")
    np.testing.assert_array_equal(loaded.transform(x[:5]),
                                  fitted.transform(x[:5]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            TorchModel.load(_linear(), est.store, est.run_id)


# ---------------------------------------------------------------------------
# the flax Estimator's counterpart at a world of one
# ---------------------------------------------------------------------------

def _mlp_pair():
    """The flax MLP, its initial variables, and the port's MLP holding
    them."""
    import jax
    import torch

    from horovod_tpu.models import MLP as FlaxMLP
    from horovod_tpu_torch.models import MLP
    from horovod_tpu_torch.models.convert import flax_to_torch
    flax_model = FlaxMLP(features=(16, 1))
    variables = flax_model.init(jax.random.PRNGKey(0),
                                np.zeros((1, 2), np.float32))
    model = MLP(features=(16, 1), in_features=2)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in
                           flax_to_torch(variables).items()})
    return flax_model, variables, model


def _estimators(tmp_path, case, **kw):
    """The port's and the flax Estimator for ``case``, over the same
    store layout."""
    import jax.numpy as jnp
    import optax
    import torch

    from horovod_tpu.integrations import Estimator as FlaxEstimator
    from horovod_tpu.spark import LocalStore as FlaxStore
    from horovod_tpu_torch.integrations import Estimator, LocalStore
    flax_model, variables, model = _mlp_pair()
    weighted = case == "weights"

    def port_loss(p, t):
        err = (p[:, 0] - t) ** 2
        return err if weighted else err.mean()

    def flax_loss(p, t):
        err = (p[:, 0] - t) ** 2
        return err if weighted else err.mean()
    common = dict(epochs=EPOCHS, batch_size=BATCH, run_id=case, **kw)
    port = Estimator(model, lambda p: torch.optim.SGD(p, lr=LR), port_loss,
                     LocalStore(str(tmp_path / "port")),
                     metrics={"mae": lambda p, t: (p[:, 0] - t).abs()
                              .mean()}, **common)
    flax = FlaxEstimator(flax_model, optax.sgd(LR), flax_loss,
                         FlaxStore(str(tmp_path / "jax")),
                         metrics={"mae": lambda p, t: jnp.abs(p[:, 0] - t)
                                  .mean()}, **common)
    return port, flax


def _close(got, want, where):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _close(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{where}[{i}]")
    elif want is None:
        assert got is None, where
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   err_msg=where, **TOL)


ESTIMATOR_CASES = ("validation", "weights", "dataframe", "parquet",
                   "resume", "early_stopping")


@pytest.fixture(scope="module")
def runtimes():
    """Both packages' SPMD runtimes in this process: the port's world of
    one over gloo, the JAX package's mesh of one CPU device."""
    import jax

    import horovod_tpu as jhvd
    import horovod_tpu_torch as thvd
    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:1])
    thvd.init(device="cpu")
    yield
    thvd.shutdown()
    jhvd.shutdown()


@pytest.mark.parametrize("case", ESTIMATOR_CASES)
def test_estimator_matches_flax(case, tmp_path, runtimes):
    import pandas as pd

    from horovod_tpu.callbacks import EarlyStopping as FlaxStop
    from horovod_tpu_torch.callbacks import EarlyStopping
    from horovod_tpu_torch.models.convert import flax_to_torch
    x, y, w = _data()
    kw = {}
    if case in ("dataframe", "parquet"):
        kw = dict(feature_cols=["f0", "f1"], label_col="label")
    port, flax = _estimators(tmp_path, case, **kw)
    data, fit_kw = (x, y), {"validation": 0.25}
    if case == "weights":
        data = (x, y, w)
        fit_kw = {}
    elif case == "dataframe":
        data = pd.DataFrame({"f0": x[:, 0], "f1": x[:, 1], "label": y})
        fit_kw = {}
    elif case == "parquet":
        import pyarrow as pa
        import pyarrow.parquet as pq
        os.makedirs(tmp_path / "data")
        pq.write_table(pa.table({"f0": x[:, 0], "f1": x[:, 1], "label": y}),
                       str(tmp_path / "data" / "part-0.parquet"))
        data, fit_kw = str(tmp_path / "data"), {}
    elif case == "resume":
        for est in _estimators(tmp_path, case, **kw):
            est.epochs = 2
            est.fit(data, **fit_kw)
    elif case == "early_stopping":
        port.callbacks = [EarlyStopping(monitor="loss", min_delta=10.0,
                                        patience=0)]
        flax.callbacks = [FlaxStop(monitor="loss", min_delta=10.0,
                                   patience=0)]
    got, want = port.fit(data, **fit_kw), flax.fit(data, **fit_kw)
    _close(got.history, want.history, "history")
    _close(got.val_history, want.val_history, "val_history")
    _close(got.logs, want.logs, "logs")
    _close({k: v.numpy() for k, v in got.params.items()},
           {k: v.numpy() for k, v in flax_to_torch(want.params).items()},
           "params")
    _close(got.transform(x[:10], batch_size=4),
           np.asarray(want.transform(x[:10], batch_size=4)), "transform")
    if case == "early_stopping":
        assert len(got.history) == 2  # the first epoch sets the best
    elif case == "resume":
        assert len(got.history) == EPOCHS
    if case == "dataframe":
        frame = pd.DataFrame({"f0": x[:6, 0], "f1": x[:6, 1]})
        _close(got.transform(frame)["label__output"].to_numpy(),
               want.transform(frame)["label__output"].to_numpy(),
               "transform(DataFrame)")


def test_estimator_model_load_and_resume_guard(tmp_path, runtimes):
    import torch

    from horovod_tpu_torch.integrations import EstimatorModel, LocalStore
    from horovod_tpu_torch.models import MLP
    x, y, _ = _data()
    port, _ = _estimators(tmp_path, "load")
    fitted = port.fit((x, y))
    loaded = EstimatorModel.load(MLP(features=(16, 1), in_features=2),
                                 LocalStore(str(tmp_path / "port")), "load",
                                 device="cpu")
    np.testing.assert_array_equal(loaded.transform(x[:7]),
                                  fitted.transform(x[:7]))
    assert loaded.history == fitted.history
    other = type(port)(MLP(features=(8, 1), in_features=2),
                       lambda p: torch.optim.SGD(p, lr=LR), port.loss,
                       port.store, epochs=EPOCHS + 1, batch_size=BATCH,
                       run_id="load")
    with pytest.raises(ValueError, match="different model"):
        other.fit((x, y))


def test_estimator_forwards_compression(tmp_path, runtimes):
    """``gradient_compression`` reaches the DistributedOptimizer: a max-min
    quantizer with error feedback trains through the port's plain
    versions of B1, B3 and B4 here (their kernels on the card)."""
    from horovod_tpu_torch.compression import (CompressionConfig,
                                               MaxMinQuantizer, kernels)
    x, y, _ = _data()
    port, _ = _estimators(tmp_path, "compressed", gradient_compression=(
        CompressionConfig(MaxMinQuantizer(bits=4, bucket_size=64),
                          reduction="scatter_allgather",
                          error_feedback=True)))
    kernels.reset_launches()
    calls = []
    original = kernels.maxmin_quantize

    def counted(*a, **k):
        calls.append(1)
        return original(*a, **k)
    try:
        kernels.maxmin_quantize = counted
        fitted = port.fit((x, y))
    finally:
        kernels.maxmin_quantize = original
    assert calls and fitted.history[-1] < fitted.history[0]


# ---------------------------------------------------------------------------
# worlds of two: _remote_fit_torch in process mode, the Estimator in SPMD
# ---------------------------------------------------------------------------

def _worker(kind, out_dir):
    import torch
    import torch.nn.functional as F
    data_dir = os.path.join(out_dir, "..", "data")
    if kind == "spmd":
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.integrations import Estimator, LocalStore
        from horovod_tpu_torch.models import MLP
        hvd.init(device="cpu")
        model = MLP(features=(16, 1), in_features=2)
        with open(os.path.join(out_dir, "..", "mlp.pkl"), "rb") as f:
            model.load_state_dict({k: torch.as_tensor(v)
                                   for k, v in pickle.load(f).items()})
        est = Estimator(model, lambda p: torch.optim.SGD(p, lr=LR),
                        lambda p, t: ((p[:, 0] - t) ** 2).mean(),
                        LocalStore(os.path.join(out_dir, "store")),
                        epochs=EPOCHS, batch_size=BATCH, run_id="spmd")
        x, y, _ = _data()
        fitted = est.fit((x, y), validation=0.25)
        res = {"history": fitted.history, "val": fitted.val_history,
               "params": {k: v.numpy() for k, v in fitted.params.items()},
               "rank": hvd.rank()}
        hvd.shutdown()
    else:
        pkg = "horovod_tpu_torch" if kind == "port" else "horovod_tpu"
        if kind == "jax":
            import jax
            jax.config.update("jax_platforms", "cpu")
        hvd = __import__(f"{pkg}.torch", fromlist=["x"])
        hvd.init(**({"mode": "process", "device": "cpu"}
                    if kind == "port" else {}))
        est, est_mod = _torch_estimator(
            pkg, os.path.join(out_dir, "store"), _linear(),
            feature_cols=["f0", "f1"], label_cols=["label"], run_id="w2")
        history = est_mod._remote_fit_torch(est, data_dir,
                                            os.path.join(data_dir, "..",
                                                         "val"))
        res = {"history": history, "rank": hvd.rank()}
        if hvd.rank() == 0:
            res["weights"] = _weights(est_mod.TorchModel.load(
                _linear(), est.store, "w2", **(
                    {"device": "cpu"} if kind == "port" else {})).model)
        hvd.shutdown()
    with open(os.path.join(out_dir, f"{kind}.{res['rank']}.pkl"),
              "wb") as f:
        pickle.dump(res, f)
    print("ALL OK")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    import pyarrow as pa
    import pyarrow.parquet as pq

    from conftest import assert_all_ok, launch_world
    from horovod_tpu import basics as jax_basics
    from horovod_tpu_torch.utils import native_build
    native_build.build()
    jax_basics._ensure_built()
    base = tmp_path_factory.mktemp("estimator_worlds")
    x, y, _ = _data()
    for name, (lo, hi, parts) in {"data": (0, 192, 4),
                                  "val": (192, ROWS, 2)}.items():
        os.makedirs(base / name)
        bounds = np.linspace(lo, hi, parts + 1).astype(int)
        for i in range(parts):
            sl = slice(bounds[i], bounds[i + 1])
            pq.write_table(pa.table({"f0": x[sl, 0], "f1": x[sl, 1],
                                     "label": y[sl]}),
                           str(base / name / f"part-{i}.parquet"))
    _, _, model = _mlp_pair()
    with open(base / "mlp.pkl", "wb") as f:
        pickle.dump(_weights(model), f)
    dirs = {}
    for kind in ("port", "jax", "spmd"):
        dirs[kind] = str(base / kind)
        os.makedirs(dirs[kind])
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        runs = {kind: pool.submit(launch_world, 2, os.path.abspath(__file__),
                                  {"HVDTPU_TEST_WORKER": kind,
                                   "HVDTPU_TEST_OUT": d}, 240)
                for kind, d in dirs.items()}
        results = {kind: run.result() for kind, run in runs.items()}
    out = {}
    for kind, res in results.items():
        assert_all_ok(res)
        out[kind] = []
        for r in range(2):
            with open(os.path.join(dirs[kind], f"{kind}.{r}.pkl"),
                      "rb") as f:
                out[kind].append(pickle.load(f))
    return out


def test_remote_fit_torch_matches_jax_at_world_two(worlds):
    for r in range(2):
        assert worlds["port"][r]["history"] == worlds["jax"][r]["history"]
    got, want = worlds["port"][0]["weights"], worlds["jax"][0]["weights"]
    assert set(got) == set(want)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k
    hist = worlds["port"][0]["history"]
    assert hist[-1]["loss"] < hist[0]["loss"] and "val_mae" in hist[-1]


def test_estimator_spmd_world_two_matches_world_one(worlds, tmp_path,
                                                    runtimes):
    import torch

    from horovod_tpu_torch.integrations import Estimator, LocalStore
    _, _, model = _mlp_pair()
    est = Estimator(model, lambda p: torch.optim.SGD(p, lr=LR),
                    lambda p, t: ((p[:, 0] - t) ** 2).mean(),
                    LocalStore(str(tmp_path)), epochs=EPOCHS,
                    batch_size=BATCH, run_id="one")
    x, y, _ = _data()
    one = est.fit((x, y), validation=0.25)
    for r in range(2):
        got = worlds["spmd"][r]
        _close(got["history"], one.history, "history")
        _close(got["val"], one.val_history, "val_history")
        _close(got["params"], {k: v.numpy() for k, v in one.params.items()},
               "params")


if __name__ == "__main__" and os.environ.get("HVDTPU_TEST_WORKER"):
    _worker(os.environ["HVDTPU_TEST_WORKER"], os.environ["HVDTPU_TEST_OUT"])
