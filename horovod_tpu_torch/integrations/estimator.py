"""Estimator API: ``fit(data) -> model`` with store-backed checkpoints.

Counterpart of ``horovod_tpu/integrations/estimator.py`` (reference shape:
the Spark estimators, ``horovod/spark/keras/estimator.py:105``
``KerasEstimator.fit(df) → TransformerModel``, backed by a ``Store``,
``horovod/spark/common/store.py``). The JAX estimator trains a flax module
with an optax optimizer in jitted steps; this one trains a
``torch.nn.Module`` eagerly with a torch optimizer wrapped in the port's
``DistributedOptimizer`` (``gradient_compression`` forwarded: a
``CompressionConfig`` or a max-min quantizer runs the hand-written
kernels), and checkpoints the best epoch to the store.
``EstimatorModel.transform`` serves predictions, mirroring the Spark
``TransformerModel``. Weights cross from a flax model with
:func:`horovod_tpu_torch.models.convert.flax_to_torch`.

``fit`` accepts three data forms:

* ``(x, y)`` in-memory arrays: every rank holds the whole data and trains
  on its part of each global batch over the data-parallel axis (the JAX
  estimator's SPMD path over the mesh);
* a **parquet directory path** — batches stream through
  :class:`~horovod_tpu_torch.spark.util.ParquetShardReader`;
* a **Spark DataFrame** — materialized to the store as parquet
  (:func:`~horovod_tpu_torch.spark.util.prepare_data`) and, when
  ``num_proc`` is set, trained distributed via
  :func:`horovod_tpu_torch.spark.run` with one process-mode rank per Spark
  task (:func:`_remote_fit` on each rank's shard).

The model trains on ``device`` (``"cpu"`` to ask for the CPU), else the
runtime's device; ``transform`` and ``load`` run there too. ``fit`` on
arrays or a local parquet path initializes the runtime (``init()``) when it
is not, on that device.
"""

from __future__ import annotations

import copy
import io
import itertools
from typing import Callable, Optional

import numpy as np
import torch

from .. import runtime
from ..ops import collectives as C
# Store hierarchy lives with the Spark integration (reference:
# horovod/spark/common/store.py); re-exported here as in the JAX package.
from ..spark.store import (Store, FilesystemStore, LocalStore,  # noqa: F401
                           HDFSStore, DBFSLocalStore)
from ..torch.estimator import build_optimizer, resolve_device


def _cpu_state(model: torch.nn.Module) -> dict:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def _to_cpu(obj):
    """``obj`` (an optimizer ``state_dict``) with every tensor on the
    host, for the store."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _save(obj) -> bytes:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _load(blob: bytes, device="cpu"):
    return torch.load(io.BytesIO(blob), map_location=device,
                      weights_only=False)


class EstimatorModel:
    """Trained-model wrapper (reference: TransformerModel — holds the best
    checkpoint and serves ``transform``). ``params`` is the best epoch's
    ``state_dict`` (host tensors); ``model`` is a copy of the module that
    holds it, on ``device``."""

    def __init__(self, model, params, run_id: str, history,
                 val_history=None, logs=None, feature_cols=None,
                 label_col=None, device=None):
        self.device = resolve_device(device)
        self.model = copy.deepcopy(model).to(self.device)
        self.model.load_state_dict(params)
        self.params = params
        self.run_id = run_id
        self.history = history  # list of per-epoch train losses
        self.val_history = val_history  # per-epoch val losses, or None
        # Per-epoch logs dicts (loss/val_loss + any metrics) — the richer
        # view the callbacks receive (reference: Keras History.history).
        self.logs = logs or []
        self.feature_cols = feature_cols
        self.label_col = label_col

    @torch.no_grad()
    def _apply(self, arr, batch_size):
        self.model.eval()
        x = torch.as_tensor(np.ascontiguousarray(arr), dtype=torch.float32)
        if batch_size is None or x.shape[0] <= batch_size:
            return self.model(x.to(self.device)).cpu()
        return torch.cat([self.model(x[i:i + batch_size].to(self.device))
                          .cpu() for i in range(0, x.shape[0], batch_size)])

    def transform(self, x, batch_size=None):
        """Predict on ``self.device`` (eval mode). An array predicts
        directly (a numpy array back); a pandas DataFrame returns a copy
        with a ``<label>__output`` column (reference:
        ``TransformerModel.transform`` adds output columns to the Spark
        DataFrame; same semantics as ``TorchModel.transform``).
        ``batch_size`` scores in chunks so a large input never
        materializes one giant activation set."""
        try:
            import pandas as pd
            is_df = isinstance(x, pd.DataFrame)
        except ImportError:
            is_df = False
        if not is_df:
            return self._apply(np.asarray(x), batch_size).numpy()
        if not self.feature_cols:
            raise ValueError("transform(DataFrame) needs feature_cols "
                             "(fit with feature_cols, or set them)")
        # Same column semantics as the training reader (table_to_x):
        # scalar columns stack; a single list-typed column is used as-is.
        cols = [np.asarray(x[c].tolist()) for c in self.feature_cols]
        if len(cols) == 1:
            xa = cols[0]
        else:
            cols = [c[..., None] if c.ndim == 1 else c for c in cols]
            xa = np.concatenate(cols, axis=-1)
        out = self._apply(xa, batch_size).numpy()
        out_df = x.copy()
        name = f"{self.label_col or 'pred'}__output"
        out_df[name] = list(out) if out.ndim > 1 and out.shape[-1] > 1 \
            else np.asarray(out).reshape(len(out_df), -1)[:, 0]
        return out_df

    @classmethod
    def load(cls, model, store: Store, run_id: str,
             device=None) -> "EstimatorModel":
        """The best epoch's weights from the store, in a copy of ``model``
        on ``device``."""
        blob = _load(store.load(run_id))
        return cls(model, blob["params"], run_id, blob.get("history", []),
                   val_history=blob.get("val_history"),
                   logs=blob.get("logs"),
                   feature_cols=blob.get("feature_cols"),
                   label_col=blob.get("label_col"), device=device)


def _remote_fit(estimator: "Estimator", train_path: str,
                val_path: Optional[str] = None):
    """Per-rank training body for the distributed (Spark) path: read this
    rank's parquet shard, train with cross-rank gradient averaging through
    the native core, rank 0 checkpoints the best epoch (reference: the
    estimators' remote training fns, ``spark/keras/remote.py`` /
    ``spark/torch/remote.py``). Initializes the runtime in process mode
    when it is not."""
    from ..spark.util import ParquetShardReader

    if not runtime.is_initialized():
        runtime.init(mode="process", device=estimator.device)
    reader = ParquetShardReader(
        train_path, estimator.feature_cols, estimator.label_col,
        batch_size=estimator.batch_size, rank=runtime.rank(),
        size=runtime.size(),
        weight_col=getattr(estimator, "sample_weight_col", None))
    # Every step issues blocking cross-rank collectives, so all ranks MUST
    # run the same number of steps; shards can be uneven (fragment sizes,
    # dropped partials) — agree on the minimum full-batch count.
    local_steps = reader.rows() // estimator.batch_size
    val_batches = val_local_steps = None
    if val_path:
        val_reader = ParquetShardReader(
            val_path, estimator.feature_cols, estimator.label_col,
            batch_size=estimator.batch_size, rank=runtime.rank(),
            size=runtime.size(),
            weight_col=getattr(estimator, "sample_weight_col", None))
        val_batches = lambda: val_reader.batches()  # noqa: E731
        val_local_steps = val_reader.rows() // estimator.batch_size
    return estimator._fit_loop(lambda _epoch: reader.batches(),
                               distributed=True, local_steps=local_steps,
                               val_batches=val_batches,
                               val_local_steps=val_local_steps)


class Estimator:
    """Train a ``torch.nn.Module`` data-parallel and checkpoint the best
    epoch.

    Reference constructor shape (spark/keras/estimator.py): model +
    optimizer + loss + store + epochs/batch_size; ``fit`` returns the
    trained model loaded from the best checkpoint. Port differences from
    the JAX estimator: ``model`` carries its initial weights (``fit``
    trains a copy; ``seed`` seeds torch's generators and ``sample_input``
    is accepted and not needed); ``optimizer`` is a torch optimizer bound
    to ``model``'s parameters, or a factory ``callable(params) ->
    Optimizer``; ``loss(pred, y)`` and the ``metrics`` are torch functions
    (a per-sample loss vector for ``sample_weight_col``).
    """

    def __init__(self, model, optimizer, loss: Callable, store: Store,
                 epochs: int = 5, batch_size: int = 32,
                 run_id: Optional[str] = None, seed: int = 0,
                 feature_cols: Optional[list] = None,
                 label_col: Optional[str] = None,
                 sample_input=None,
                 metrics: Optional[dict] = None,
                 callbacks: Optional[list] = None,
                 resume: bool = True,
                 gradient_compression=None,
                 sample_weight_col: Optional[str] = None,
                 verbose: int = 0, device=None):
        self.model = model
        self.optimizer = optimizer
        self.loss = loss
        self.store = store
        self.epochs = epochs
        self.batch_size = batch_size
        self.run_id = run_id or "run"
        self.seed = seed
        self.feature_cols = feature_cols
        self.label_col = label_col
        self.sample_input = sample_input
        # ``{name: fn(pred, y) -> scalar}`` averaged over the epoch and
        # across ranks into the epoch logs (reference: estimator
        # ``metrics`` param + MetricAverageCallback semantics).
        self.metrics = dict(metrics or {})
        # Objects with optional on_train_begin(logs)/on_epoch_end(epoch,
        # logs); raise callbacks.StopTraining (e.g. EarlyStopping) to stop.
        # Run on rank 0; the stop decision is broadcast in process mode.
        self.callbacks = list(callbacks or [])
        # Resume from the per-epoch training checkpoint under the same
        # run_id (reference: _load_checkpoint → last_checkpoint_state).
        self.resume = resume
        # Forwarded to hvd.DistributedOptimizer (fp16/bf16, a quantizer,
        # a Compressor, or a CompressionConfig).
        self.gradient_compression = gradient_compression
        # Per-row weight column (reference: sample_weight_col). Weighted
        # training needs a PER-SAMPLE loss: ``loss(pred, y)`` must return
        # a vector, which the loop weight-averages.
        self.sample_weight_col = sample_weight_col
        self.verbose = verbose
        self.device = device

    # ------------------------------------------------------------------
    def fit(self, data, num_proc: Optional[int] = None,
            validation=None) -> EstimatorModel:
        """Train and return the best-checkpoint model. ``num_proc`` > 0 with
        a Spark DataFrame trains distributed via
        ``horovod_tpu_torch.spark.run``.

        ``validation`` selects the best epoch by validation loss
        (reference: the estimators' ``validation`` param,
        spark/common/params.py): a ``(x, y)`` pair or float fraction for
        array data, a Spark DataFrame with a DataFrame input, a parquet
        directory path with a path input.
        """
        from ..spark.fit_dispatch import resolve_fit_data
        kind, payload, validation = resolve_fit_data(data, validation,
                                                     num_proc)
        if kind == "df":
            from ..spark.util import prepare_data
            if not self.feature_cols or not self.label_col:
                raise ValueError(
                    "fitting a Spark DataFrame requires feature_cols and "
                    "label_col (reference estimators require the same "
                    "params)")
            meta = prepare_data(payload, self.store, self.run_id,
                                validation=validation, partitions=num_proc)
            return self.fit_on_parquet(meta["train_data_path"],
                                       num_proc=num_proc,
                                       val_path=meta.get("val_data_path"))
        if kind == "path":
            return self.fit_on_parquet(payload, num_proc=num_proc,
                                       val_path=validation)
        return self._fit_arrays(*data, validation=validation)

    def fit_on_parquet(self, train_path: str,
                       num_proc: Optional[int] = None,
                       val_path: Optional[str] = None) -> EstimatorModel:
        """Train from a materialized parquet directory. With ``num_proc``,
        fan out over Spark tasks (process mode); otherwise read the whole
        directory here and train each global batch over the runtime's
        data-parallel axis."""
        if not self.feature_cols or not self.label_col:
            raise ValueError("parquet training requires feature_cols and "
                             "label_col")
        if num_proc:
            from .. import spark as hvd_spark
            histories = hvd_spark.run(_remote_fit,
                                      args=(self, train_path, val_path),
                                      num_proc=num_proc, device=self.device)
            history, val_history = histories[0]
        else:
            from ..spark.util import ParquetShardReader
            self._ensure_runtime()
            # Batches must tile the data axis (same rounding as the
            # in-memory path).
            n_shards = self._shards()[1]
            bs = max(self.batch_size // n_shards * n_shards, n_shards)
            reader = ParquetShardReader(
                train_path, self.feature_cols, self.label_col,
                batch_size=bs, rank=0, size=1,
                weight_col=self.sample_weight_col)
            val_batches = None
            if val_path:
                val_reader = ParquetShardReader(
                    val_path, self.feature_cols, self.label_col,
                    batch_size=bs, rank=0, size=1,
                    weight_col=self.sample_weight_col)
                val_batches = lambda: val_reader.batches()  # noqa: E731
            history, val_history = self._fit_loop(
                lambda _e: reader.batches(), distributed=False,
                val_batches=val_batches)
        return self._best_model(history, val_history)

    # ------------------------------------------------------------------
    def _ensure_runtime(self) -> None:
        if not runtime.is_initialized():
            runtime.init(device=self.device)

    @staticmethod
    def _shards():
        """This rank's part and the parts of a global batch: its rank and
        size on the data-parallel axis (every rank in process mode)."""
        group = None if runtime.mode() == "process" else runtime.group(None)
        return C._rank(group), C._size(group)

    def _best_model(self, history, val_history) -> EstimatorModel:
        blob = _load(self.store.load(self.run_id))
        return EstimatorModel(self.model, blob["params"], self.run_id,
                              history, val_history=val_history,
                              logs=blob.get("logs"),
                              feature_cols=self.feature_cols,
                              label_col=self.label_col,
                              device=resolve_device(self.device))

    def _fit_arrays(self, x, y, w=None, validation=None) -> EstimatorModel:
        self._ensure_runtime()
        arrays = [np.asarray(x), np.asarray(y)]
        if w is not None:
            arrays.append(np.asarray(w))
        val_arrays = None
        if isinstance(validation, float):
            # Fraction split (reference: validation as a ratio,
            # spark/common/params.py validation docs).
            n = len(arrays[0])
            n_val = int(n * validation)
            if not 0 < n_val < n:
                raise ValueError(f"validation fraction {validation} leaves "
                                 "no train or no val rows")
            val_arrays = [a[-n_val:] for a in arrays]
            arrays = [a[:-n_val] for a in arrays]
        elif validation is not None:
            if not (isinstance(validation, (tuple, list))
                    and len(validation) in (2, 3)):
                raise ValueError(
                    "validation for array data must be a float fraction or "
                    "an (x, y[, weights]) tuple")
            val_arrays = [np.asarray(a) for a in validation]
        # Batches must tile the data axis evenly; trim the remainder (the
        # reference's Petastorm loader repartitions for the same reason).
        n_shards = self._shards()[1]
        bs = max(self.batch_size // n_shards * n_shards, n_shards)

        def batches(_epoch):
            n = len(arrays[0])
            for i in range(0, n - bs + 1, bs):
                yield tuple(a[i:i + bs] for a in arrays)

        val_batches = None
        if val_arrays is not None:
            nv = len(val_arrays[0]) // n_shards * n_shards
            if nv == 0:
                raise ValueError("validation set smaller than the mesh")

            def val_batches():
                yield tuple(a[:nv] for a in val_arrays)

        history, val_history = self._fit_loop(batches, distributed=False,
                                              val_batches=val_batches)
        return self._best_model(history, val_history)

    def _fit_loop(self, batches: Callable, distributed: bool,
                  local_steps: Optional[int] = None,
                  val_batches: Optional[Callable] = None,
                  val_local_steps: Optional[int] = None):
        """Shared epoch loop; returns ``(history, val_history)``.

        ``batches(epoch)`` yields host ``(x, y[, w])`` batches — the global
        batch when not ``distributed``, of which each rank of the
        data-parallel axis trains on its part, and this rank's local batch
        when ``distributed`` (a process-mode rank on its shard). The
        gradients are averaged by the ``DistributedOptimizer`` and the loss
        and metrics across the ranks. In distributed mode ``local_steps``
        (this rank's full-batch count) is MIN-agreed across ranks and the
        epoch is truncated to it: every step runs blocking collectives, so
        a rank with extra batches would deadlock the world.
        ``val_batches()`` yields validation batches evaluated after each
        epoch, whole on every rank when not ``distributed`` and averaged
        across ranks when it is (same MIN agreement via
        ``val_local_steps``)."""
        from .. import (Average, DistributedOptimizer, Min,
                        broadcast_object, broadcast_parameters)
        from ..callbacks import StopTraining
        from ..ops.collectives import allreduce

        dev = resolve_device(self.device)
        part, parts = (0, 1) if distributed else self._shards()

        def agreed_min(value: int, name: str) -> int:
            return int(allreduce(torch.tensor([value], dtype=torch.int64,
                                              device=dev),
                                 op=Min, name=name)[0])

        steps_per_epoch = val_steps_per_epoch = None
        if distributed and local_steps is not None:
            steps_per_epoch = agreed_min(local_steps, "estimator.steps")
            if steps_per_epoch == 0:
                raise ValueError(
                    "a rank has zero full batches (shard smaller than "
                    "batch_size); use more data, fewer ranks, or a smaller "
                    "batch_size")
        if distributed and val_local_steps is not None:
            val_steps_per_epoch = agreed_min(val_local_steps,
                                             "estimator.val_steps")
            if val_steps_per_epoch == 0:
                raise ValueError(
                    "a rank has zero full validation batches (val shard "
                    "smaller than batch_size); use a bigger validation set "
                    "or a smaller batch_size")

        torch.manual_seed(self.seed)
        model = copy.deepcopy(self.model).to(dev)
        opt = DistributedOptimizer(
            build_optimizer(self.optimizer, self.model, model),
            named_parameters=model.named_parameters(),
            compression=self.gradient_compression)
        loss_fn = self.loss
        metric_items = tuple(self.metrics.items())

        def tensors(b):
            """A host batch on the device: float features, weights and
            labels in float32 (as JAX takes numpy's float64 without x64),
            integer labels as they are."""
            b = tuple(b) if len(b) == 3 else (b[0], b[1], None)
            x, y, w = (None if a is None else torch.as_tensor(
                np.ascontiguousarray(a)) for a in b)
            if y.is_floating_point():
                y = y.to(torch.float32)
            return (x.to(dev, torch.float32), y.to(dev),
                    None if w is None else w.to(dev, torch.float32))

        def combined_loss(pred, yb, wb):
            l = loss_fn(pred, yb)
            if wb is not None:
                if l.dim() == 0:
                    raise ValueError(
                        "sample weights need a per-sample loss: "
                        "loss(pred, y) must return a vector (no mean) "
                        "so weights can be applied")
                return (l * wb).sum() / torch.clamp(wb.sum(), min=1e-38)
            return l if l.dim() == 0 else l.mean()

        def mean_across(values: dict, prefix: str) -> dict:
            """Each value averaged over the ranks of the data axis, in one
            fused allreduce."""
            if parts == 1 and not distributed:
                return {k: float(v.detach()) for k, v in values.items()}
            keys = sorted(values)
            stacked = torch.stack([values[k].detach().float().reshape(())
                                   for k in keys])
            out = allreduce(stacked, op=Average, name=prefix)
            return {k: float(v) for k, v in zip(keys, out.tolist())}

        def run_batch(b):
            xb, yb, wb = tensors(b)
            if not distributed:
                n = xb.shape[0] // parts
                cut = slice(part * n, (part + 1) * n)
                xb, yb = xb[cut], yb[cut]
                wb = None if wb is None else wb[cut]
            opt.zero_grad(set_to_none=True)
            pred = model(xb)
            l = combined_loss(pred, yb, wb)
            l.backward()
            opt.step()
            with torch.no_grad():
                values = {name: fn(pred, yb) for name, fn in metric_items}
            values["\0loss"] = l
            out = mean_across(values, "est.m")
            return out.pop("\0loss"), out

        @torch.no_grad()
        def run_val(it):
            model.eval()
            losses, msums = [], {}
            try:
                for b in it:
                    xv, yv, wv = tensors(b)
                    pred = model(xv)
                    values = {name: fn(pred, yv)
                              for name, fn in metric_items}
                    values["\0loss"] = combined_loss(pred, yv, wv)
                    if distributed:
                        values = mean_across(values, "est.vm")
                    else:
                        values = {k: float(v) for k, v in values.items()}
                    losses.append(values.pop("\0loss"))
                    for k, v in values.items():
                        msums[k] = msums.get(k, 0.0) + v
            finally:
                model.train()
            if not losses:
                # A silent 0.0 would win best-epoch selection at epoch 0
                # and freeze the untrained params.
                raise ValueError(
                    "validation produced zero full batches (val set smaller "
                    "than batch_size)")
            return (float(np.mean(losses)),
                    {k: v / len(losses) for k, v in msums.items()})

        # Resume from the per-epoch training checkpoint (reference:
        # _load_checkpoint -> remote last_checkpoint_state). The training
        # state (params + optimizer + epoch) lives NEXT TO the final model
        # blob: store.save(run_id) owns get_checkpoint_path itself.
        start_epoch, best = 0, float("inf")
        history = []
        val_history = [] if val_batches is not None else None
        logs_list = []
        train_ckpt = self.store.get_checkpoint_path(
            self.run_id) + ".training"
        if self.resume and self.store.exists(train_ckpt):
            blob = _load(self.store.read(train_ckpt), dev)
            fresh = model.state_dict()
            loaded = blob["params"]
            # A stale checkpoint from a DIFFERENT model under the same
            # run_id would otherwise fail deep inside load_state_dict.
            if list(fresh) != list(loaded) or any(
                    fresh[k].shape != loaded[k].shape for k in fresh):
                raise ValueError(
                    f"run_id {self.run_id!r} has a training checkpoint for "
                    "a different model (param tree/shape mismatch); use a "
                    "new run_id or pass resume=False to restart")
            model.load_state_dict(loaded)
            opt.load_state_dict(blob["opt_state"])
            start_epoch = blob["epoch"] + 1
            best = blob.get("best", float("inf"))
            history = list(blob.get("history", []))
            logs_list = list(blob.get("logs", []))
            if val_history is not None:
                val_history = list(blob.get("val_history") or [])
        if distributed:
            broadcast_parameters(model.state_dict(), root_rank=0)

        rank0 = runtime.rank() == 0
        for cb in self.callbacks:
            if rank0 and hasattr(cb, "on_train_begin"):
                cb.on_train_begin({})

        model.train()
        stop = False
        cb_error = None
        for epoch in range(start_epoch, self.epochs):
            epoch_losses, msums = [], {}
            it = batches(epoch)
            if steps_per_epoch is not None:
                it = itertools.islice(it, steps_per_epoch)
            for b in it:
                l, metr = run_batch(b)
                epoch_losses.append(l)
                for k, v in metr.items():
                    msums[k] = msums.get(k, 0.0) + v
            if not epoch_losses:
                # A silent loss=0.0 epoch would win best-epoch selection
                # and checkpoint the untrained params.
                raise ValueError(
                    "training produced zero full batches (dataset smaller "
                    "than batch_size); use more data or a smaller "
                    "batch_size")
            epoch_loss = float(np.mean(epoch_losses))
            history.append(epoch_loss)
            logs = {"loss": epoch_loss}
            logs.update({k: v / len(epoch_losses)
                         for k, v in msums.items()})
            # Best-epoch selection on validation loss when given, training
            # loss otherwise (reference: estimators checkpoint on the
            # monitored metric, BestModelCheckpoint).
            monitored = epoch_loss
            if val_batches is not None:
                vit = val_batches()
                if val_steps_per_epoch is not None:
                    vit = itertools.islice(vit, val_steps_per_epoch)
                val_loss, val_metr = run_val(vit)
                val_history.append(val_loss)
                logs["val_loss"] = val_loss
                logs.update({f"val_{k}": v for k, v in val_metr.items()})
                monitored = val_loss
            logs_list.append(logs)
            if self.verbose and rank0:
                print(f"[estimator {self.run_id}] epoch {epoch}: "
                      + " ".join(f"{k}={v:.5f}" for k, v in logs.items()),
                      flush=True)
            if rank0:
                host_params = _cpu_state(model)
                if monitored < best:
                    best = monitored
                    self.store.save(self.run_id, _save(
                        {"params": host_params, "history": history,
                         "val_history": val_history, "logs": logs_list,
                         "feature_cols": self.feature_cols,
                         "label_col": self.label_col}))
                self.store.write(train_ckpt, _save(
                    {"params": host_params,
                     "opt_state": _to_cpu(opt.state_dict()),
                     "epoch": epoch, "best": min(best, monitored),
                     "history": history, "val_history": val_history,
                     "logs": logs_list}))
                try:
                    for cb in self.callbacks:
                        if hasattr(cb, "on_epoch_end"):
                            cb.on_epoch_end(epoch, dict(logs))
                except StopTraining:
                    stop = True
                except Exception as exc:
                    # A broken callback must not wedge the world: the
                    # other ranks are about to block in the stop
                    # broadcast, so release them before re-raising.
                    cb_error = exc
                    stop = True
            if distributed or runtime.size() > 1:
                stop = bool(broadcast_object(stop, root_rank=0,
                                             name="est.stop"))
            if cb_error is not None:
                raise cb_error
            if stop:
                break
        self._last_logs = logs_list
        return history, val_history
