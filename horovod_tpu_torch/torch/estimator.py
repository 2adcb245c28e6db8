"""TorchEstimator: ``fit(data) -> TorchModel`` over the store-backed data
plane, with the reference remote loop's training features.

Counterpart of ``horovod_tpu/torch/estimator.py`` (reference
``horovod/spark/torch/estimator.py:84`` ``TorchEstimator`` and
``horovod/spark/torch/remote.py:36`` ``RemoteTrainer``: per-epoch
checkpoint and resume, metric groups averaged across ranks,
sample-weighted losses, multi-head losses, ``transformation_fn``,
steps-per-epoch caps). The data plane is the port's parquet shard reader
(:mod:`horovod_tpu_torch.spark.util`), the collectives and
``DistributedOptimizer`` are the port's, and the store is
:mod:`horovod_tpu_torch.spark.store`.

Unlike the JAX package's, which trains on the host, the model trains on a
device: ``device`` (``"cpu"`` to ask for the CPU), else the runtime's
device when it is initialized, else the first CUDA device; without CUDA
that raises. ``transform`` and ``load`` run there too.
"""

from __future__ import annotations

import copy
import io
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..spark.store import Store


# Shared with the other estimator (both families accept the same callback
# protocol); re-exported here for the torch-facing surface.
from ..callbacks import EarlyStopping, StopTraining  # noqa: E402,F401

_StopTraining = StopTraining  # back-compat alias


def resolve_device(device=None) -> torch.device:
    """Where an estimator trains and its model predicts: ``device`` when
    given, else the runtime's device when it is initialized, else the first
    CUDA device; without CUDA that raises (pass ``device="cpu"``)."""
    from .. import runtime
    if device is not None:
        return torch.device(device)
    if runtime.is_initialized():
        return runtime.device()
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the estimators run on a CUDA device by default, and CUDA is "
            "not available here; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def build_optimizer(optimizer, source: torch.nn.Module,
                    model: torch.nn.Module) -> torch.optim.Optimizer:
    """The training copy ``model``'s optimizer: ``optimizer(params)`` for a
    factory; for an instance bound to ``source``'s parameters, the same
    class over ``model``'s, group by group."""
    if callable(optimizer) and not isinstance(
            optimizer, torch.optim.Optimizer):
        return optimizer(model.parameters())
    # Instance bound to source: rebuild the same class on the
    # training copy's params (the reference serializes the optimizer
    # class + state and reconstructs remotely, spark/torch/remote.py:95
    # train(serialized_model, optimizer_cls)). Param groups are mapped
    # param-by-param so per-group options (lr/weight_decay overrides)
    # survive the rebuild.
    opt = optimizer
    id_map = {id(o): n for o, n in zip(source.parameters(),
                                       model.parameters())}
    groups = []
    for g in opt.param_groups:
        g2 = {k: v for k, v in g.items() if k != "params"}
        try:
            g2["params"] = [id_map[id(p)] for p in g["params"]]
        except KeyError:
            raise ValueError(
                "the optimizer instance references parameters that are "
                "not model parameters — pass a factory "
                "callable(params) -> Optimizer instead")
        groups.append(g2)
    return type(opt)(groups, **opt.defaults)


class TorchModel:
    """Trained-model wrapper (reference: ``TorchModel``,
    ``spark/torch/estimator.py:304`` — holds the fitted module and serves
    ``transform``)."""

    def __init__(self, model: torch.nn.Module, run_id: str,
                 history: List[Dict[str, float]],
                 feature_cols: Optional[List[str]] = None,
                 label_cols: Optional[List[str]] = None, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.run_id = run_id
        self.history = history
        self.feature_cols = feature_cols
        self.label_cols = label_cols

    @torch.no_grad()
    def transform(self, data, batch_size: Optional[int] = None):
        """Predict. A numpy array / tensor returns predictions directly; a
        pandas DataFrame returns a copy with one ``<label>__output`` column
        per head (reference: ``TorchModel.transform`` adds output columns to
        the Spark DataFrame). ``batch_size`` scores in chunks so a large
        input never materializes one giant activation set. The model runs
        on ``self.device``; the predictions come back as numpy."""
        self.model.eval()
        try:
            import pandas as pd
            is_df = isinstance(data, pd.DataFrame)
        except ImportError:
            is_df = False
        if is_df:
            if not self.feature_cols:
                raise ValueError("transform(DataFrame) needs feature_cols "
                                 "(fit with feature_cols, or set them)")
            # Same column semantics as the training reader (table_to_x):
            # scalar columns stack into a trailing feature axis; a single
            # list-typed column is used as-is (plain .to_numpy() would
            # produce an object array torch cannot convert).
            cols = [np.asarray(data[c].tolist())
                    for c in self.feature_cols]
            if len(cols) == 1:
                xa = cols[0]
            else:
                cols = [c[..., None] if c.ndim == 1 else c for c in cols]
                xa = np.concatenate(cols, axis=-1)
            x = torch.as_tensor(np.ascontiguousarray(xa),
                                dtype=torch.float32)
            outputs = self._forward_batched(x, batch_size)
            if not isinstance(outputs, (tuple, list)):
                outputs = [outputs]
            out_df = data.copy()
            labels = self.label_cols or [
                f"head{i}" for i in range(len(outputs))]
            for name, out in zip(labels, outputs):
                o = out.detach().cpu().numpy()
                out_df[f"{name}__output"] = list(o) if o.ndim > 1 \
                    else o
            return out_df
        x = torch.as_tensor(np.asarray(data), dtype=torch.float32)
        out = self._forward_batched(x, batch_size)
        if isinstance(out, (tuple, list)):
            return [o.detach().cpu().numpy() for o in out]
        return out.detach().cpu().numpy()

    def _forward_batched(self, x, batch_size):
        if batch_size is None or len(x) <= batch_size:
            return self.model(x.to(self.device))
        chunks = [self.model(x[i:i + batch_size].to(self.device))
                  for i in range(0, len(x), batch_size)]
        if isinstance(chunks[0], (tuple, list)):
            return [torch.cat([c[h] for c in chunks])
                    for h in range(len(chunks[0]))]
        return torch.cat(chunks)

    @classmethod
    def load(cls, model: torch.nn.Module, store: Store,
             run_id: str, device=None) -> "TorchModel":
        """Rehydrate the fitted weights from the store onto ``device``
        (reference: ``TorchModel`` read path via the params writable
        mixins)."""
        device = resolve_device(device)
        blob = torch.load(io.BytesIO(store.load(run_id)),
                          map_location=device, weights_only=False)
        model = copy.deepcopy(model).to(device)
        model.load_state_dict(blob["model"])
        return cls(model, run_id, blob.get("history", []),
                   feature_cols=blob.get("feature_cols"),
                   label_cols=blob.get("label_cols"), device=device)


def _remote_fit_torch(estimator: "TorchEstimator", train_path: str,
                      val_path: Optional[str] = None):
    """Per-rank distributed training body (reference: ``RemoteTrainer``,
    ``spark/torch/remote.py:36``): read this rank's parquet shard, train
    with cross-rank gradient averaging through the torch binding, rank 0
    checkpoints each epoch."""
    from .. import init, is_initialized, rank, size
    from ..spark.util import ParquetShardReader

    if not is_initialized():
        init(mode="process", device=estimator.device)
    reader = ParquetShardReader(
        train_path, estimator.feature_cols, estimator._label_arg(),
        batch_size=estimator.batch_size, rank=rank(), size=size(),
        weight_col=estimator.sample_weight_col)
    local_steps = reader.rows() // estimator.batch_size
    val_batches = val_local_steps = None
    if val_path:
        val_reader = ParquetShardReader(
            val_path, estimator.feature_cols, estimator._label_arg(),
            batch_size=estimator.batch_size, rank=rank(), size=size(),
            weight_col=estimator.sample_weight_col)
        val_batches = lambda: val_reader.batches()  # noqa: E731
        val_local_steps = val_reader.rows() // estimator.batch_size
    return estimator._fit_loop(
        lambda e: estimator._shuffled_batches(reader.batches(), e),
        distributed=True, local_steps=local_steps,
        val_batches=val_batches, val_local_steps=val_local_steps)


class TorchEstimator:
    """Train a ``torch.nn.Module`` over the parquet/DataFrame data plane
    and checkpoint each epoch to the store.

    Parameters mirror the reference estimator
    (``spark/torch/estimator.py:146``):

    * ``model`` — the module (never mutated; ``fit`` trains a deep copy).
    * ``optimizer`` — a ``torch.optim.Optimizer`` bound to ``model``'s
      params, or a factory ``callable(params) -> Optimizer``.
    * ``loss`` — ``callable(outputs, labels) -> scalar`` or a LIST of such
      callables for multi-head models (reference ``loss_constructors``),
      combined with ``loss_weights``.
    * ``metrics`` — ``{name: callable(outputs, labels) -> scalar tensor}``,
      averaged over the epoch and across ranks into the epoch logs.
    * ``sample_weight_col`` — per-row weight column; losses are computed
      per-sample and weight-averaged (reference ``remote.py`` loss path).
    * ``callbacks`` — objects with optional ``on_train_begin(logs)`` /
      ``on_epoch_end(epoch, logs)``; raise :class:`_StopTraining` (e.g.
      :class:`EarlyStopping`) to stop. Run on rank 0; the decision is
      broadcast.
    * ``transformation_fn`` — host-batch hook ``fn(x, y, w) -> (x, y, w)``
      applied before tensors are built (reference ``transformation_fn`` on
      the Petastorm reader).
    * ``train_steps_per_epoch`` / ``validation_steps_per_epoch`` — caps
      (reference params of the same names).
    * ``gradient_compression`` / ``backward_passes_per_step`` — forwarded
      to the port's ``DistributedOptimizer`` (a ``CompressionConfig`` or a
      max-min quantizer runs its hand-written kernels).
    * ``device`` — where the model trains (``"cpu"`` to ask for the CPU);
      the runtime's device in the distributed loop.

    Checkpoint/resume: after every epoch rank 0 writes
    ``{model, optimizer, epoch, history}`` to the store's checkpoint path;
    a later ``fit`` with the same ``run_id`` resumes after the last
    completed epoch (reference: ``_load_checkpoint`` → RemoteTrainer
    ``last_checkpoint_state``).
    """

    def __init__(self, model: torch.nn.Module, optimizer, loss, store: Store,
                 epochs: int = 5, batch_size: int = 32,
                 metrics: Optional[Dict[str, Callable]] = None,
                 loss_weights: Optional[Sequence[float]] = None,
                 sample_weight_col: Optional[str] = None,
                 feature_cols: Optional[List[str]] = None,
                 label_cols=None,
                 callbacks: Optional[List[Any]] = None,
                 gradient_compression=None,
                 backward_passes_per_step: int = 1,
                 train_steps_per_epoch: Optional[int] = None,
                 validation_steps_per_epoch: Optional[int] = None,
                 transformation_fn: Optional[Callable] = None,
                 run_id: Optional[str] = None, seed: int = 0,
                 shuffle: bool = True, verbose: int = 0, device=None):
        self.model = model
        self.device = device
        self.optimizer = optimizer
        self.loss = loss
        self.store = store
        self.epochs = epochs
        self.batch_size = batch_size
        self.metrics = dict(metrics or {})
        self.loss_weights = list(loss_weights) if loss_weights else None
        self.sample_weight_col = sample_weight_col
        self.feature_cols = feature_cols
        if isinstance(label_cols, str):
            label_cols = [label_cols]
        self.label_cols = label_cols
        self.callbacks = list(callbacks or [])
        self.gradient_compression = gradient_compression
        self.backward_passes_per_step = backward_passes_per_step
        self.train_steps_per_epoch = train_steps_per_epoch
        self.validation_steps_per_epoch = validation_steps_per_epoch
        self.transformation_fn = transformation_fn
        self.run_id = run_id or "torch-run"
        self.seed = seed
        self.shuffle = shuffle
        # Reference param of the same name: 1 prints per-epoch logs on
        # rank 0 (spark/torch/estimator.py verbose).
        self.verbose = verbose
        if isinstance(loss, (list, tuple)):
            if not label_cols or len(label_cols) != len(loss):
                raise ValueError(
                    "a list of losses needs label_cols of the same length "
                    "(one head per label; reference loss_constructors)")

    # -- data-form dispatch (same shapes the JAX estimator accepts) -------
    def fit(self, data, num_proc: Optional[int] = None,
            validation=None) -> TorchModel:
        """Train and return the fitted model. Accepts ``(x, y)`` (or
        ``(x, y, w)``) arrays, a pandas/Spark DataFrame, or a parquet
        directory path; ``num_proc`` with a DataFrame fans out via
        ``horovod_tpu_torch.spark.run``."""
        from ..spark.fit_dispatch import resolve_fit_data
        kind, payload, validation = resolve_fit_data(data, validation,
                                                     num_proc)
        if kind == "df":
            from ..spark.util import prepare_data
            if not self.feature_cols or not self.label_cols:
                raise ValueError("fitting a DataFrame requires feature_cols "
                                 "and label_cols")
            meta = prepare_data(payload, self.store, self.run_id,
                                validation=validation, partitions=num_proc)
            return self.fit_on_parquet(meta["train_data_path"],
                                       num_proc=num_proc,
                                       val_path=meta.get("val_data_path"))
        if kind == "path":
            return self.fit_on_parquet(payload, num_proc=num_proc,
                                       val_path=validation)
        return self._fit_arrays(payload, validation=validation)

    def fit_on_parquet(self, train_path: str,
                       num_proc: Optional[int] = None,
                       val_path: Optional[str] = None) -> TorchModel:
        if not self.feature_cols or not self.label_cols:
            raise ValueError("parquet training requires feature_cols and "
                             "label_cols")
        # history round-trips through the store blob rank 0 saves each
        # epoch — TorchModel.load below reads it back.
        if num_proc:
            from .. import spark as hvd_spark
            hvd_spark.run(_remote_fit_torch,
                          args=(self, train_path, val_path),
                          num_proc=num_proc, device=self.device)
        else:
            from ..spark.util import ParquetShardReader
            reader = ParquetShardReader(
                train_path, self.feature_cols, self._label_arg(),
                batch_size=self.batch_size,
                weight_col=self.sample_weight_col)
            val_batches = None
            if val_path:
                val_reader = ParquetShardReader(
                    val_path, self.feature_cols, self._label_arg(),
                    batch_size=self.batch_size,
                    weight_col=self.sample_weight_col)
                val_batches = lambda: val_reader.batches()  # noqa: E731
            self._fit_loop(
                lambda e: self._shuffled_batches(reader.batches(), e),
                distributed=False, val_batches=val_batches)
        return TorchModel.load(self.model, self.store, self.run_id,
                               self.device)

    def _label_arg(self):
        if not self.label_cols:
            return None
        return self.label_cols if len(self.label_cols) > 1 \
            else self.label_cols[0]

    def _shuffled_batches(self, it, epoch: int, buffer_batches: int = 64):
        """Bounded batch-order shuffle for the streaming parquet path
        (reference: the estimators' ``shuffle_buffer_size`` over the
        Petastorm reader — here at batch granularity so memory stays
        bounded at ``buffer_batches`` batches)."""
        if not self.shuffle:
            yield from it
            return
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch]))
        buf = []
        for b in it:
            buf.append(b)
            if len(buf) >= buffer_batches:
                i = int(rng.integers(len(buf)))
                buf[i], buf[-1] = buf[-1], buf[i]
                yield buf.pop()
        while buf:
            i = int(rng.integers(len(buf)))
            buf[i], buf[-1] = buf[-1], buf[i]
            yield buf.pop()

    def _fit_arrays(self, data, validation=None) -> TorchModel:
        arrays = [np.asarray(a) for a in data]
        if len(arrays) not in (2, 3):
            raise ValueError("array data must be (x, y) or (x, y, weights)")
        val_arrays = None
        if isinstance(validation, float):
            n = len(arrays[0])
            n_val = int(n * validation)
            if not 0 < n_val < n:
                raise ValueError(f"validation fraction {validation} leaves "
                                 "no train or no val rows")
            val_arrays = [a[-n_val:] for a in arrays]
            arrays = [a[:-n_val] for a in arrays]
        elif validation is not None:
            val_arrays = [np.asarray(a) for a in validation]

        rng = np.random.default_rng(self.seed)

        def batches(epoch):
            n = len(arrays[0])
            order = rng.permutation(n) if self.shuffle else np.arange(n)
            for i in range(0, n - self.batch_size + 1, self.batch_size):
                idx = order[i:i + self.batch_size]
                yield tuple(a[idx] for a in arrays)

        val_batches = None
        if val_arrays is not None:
            def val_batches():
                n = len(val_arrays[0])
                bs = min(self.batch_size, n)
                for i in range(0, n - bs + 1, bs):
                    yield tuple(a[i:i + bs] for a in val_arrays)

        self._fit_loop(batches, distributed=False, val_batches=val_batches)
        return TorchModel.load(self.model, self.store, self.run_id,
                               self.device)

    # -- the training loop (reference: remote.py train()) ------------------
    def _build_optimizer(self, model: torch.nn.Module):
        return build_optimizer(self.optimizer, self.model, model)

    def _losses(self):
        if isinstance(self.loss, (list, tuple)):
            return list(self.loss)
        return [self.loss]

    def _combined_loss(self, outputs, labels, weights):
        losses = self._losses()
        if not isinstance(outputs, (tuple, list)):
            outputs = [outputs]
        if not isinstance(labels, (tuple, list)):
            labels = [labels]
        if len(outputs) != len(losses):
            if len(losses) == 1 and len(outputs) > 1:
                raise ValueError(
                    f"model returned {len(outputs)} heads but one loss was "
                    "given — pass a list of losses (loss_constructors)")
            raise ValueError(f"{len(outputs)} model heads vs "
                             f"{len(losses)} losses")
        lw = self.loss_weights or [1.0] * len(losses)
        total = None
        for fn, out, lab, w in zip(losses, outputs, labels, lw):
            term = fn(out, lab)
            if weights is not None:
                if term.dim() == 0:
                    raise ValueError(
                        "sample_weight_col needs per-sample losses: use a "
                        "loss with reduction='none' so weights can be "
                        "applied (reference remote.py weights the "
                        "per-sample loss)")
                term = (term * weights).sum() / weights.sum().clamp_min(
                    torch.finfo(weights.dtype).tiny)
            elif term.dim() != 0:
                term = term.mean()
            total = term * w if total is None else total + term * w
        return total

    def _fit_loop(self, batches: Callable, distributed: bool,
                  local_steps: Optional[int] = None,
                  val_batches: Optional[Callable] = None,
                  val_local_steps: Optional[int] = None):
        import itertools

        hvd = None
        rank0 = True
        if distributed:
            from .. import torch as hvd
            rank0 = hvd.rank() == 0
        dev = hvd.runtime.device() if distributed else \
            resolve_device(self.device)

        model = copy.deepcopy(self.model).to(dev)
        torch.manual_seed(self.seed)
        opt = self._build_optimizer(model)
        if distributed:
            # Wrap BEFORE loading checkpoint state: wrapping rebuilds the
            # optimizer from its param groups, which would drop a state
            # dict loaded earlier.
            opt = hvd.DistributedOptimizer(
                opt, named_parameters=model.named_parameters(),
                compression=self.gradient_compression,
                backward_passes_per_step=self.backward_passes_per_step)

        # Resume from the last completed epoch's checkpoint (reference:
        # estimator _load_checkpoint → remote last_checkpoint_state). The
        # training state (model+optimizer) lives NEXT TO the final model
        # blob: ``store.save(run_id)`` owns get_checkpoint_path itself.
        start_epoch, history = 0, []
        ckpt_path = self.store.get_checkpoint_path(
            self.run_id) + ".training"
        ckpt_blob = None
        if rank0 and self.store.exists(ckpt_path):
            ckpt_blob = self.store.read(ckpt_path)
        if distributed:
            ckpt_blob = hvd.broadcast_object(ckpt_blob, root_rank=0,
                                             name="torch_est.ckpt")
        if ckpt_blob is not None:
            state = torch.load(io.BytesIO(ckpt_blob), map_location=dev,
                               weights_only=False)
            model.load_state_dict(state["model"])
            opt.load_state_dict(state["optimizer"])
            start_epoch = state["epoch"] + 1
            history = list(state.get("history", []))

        if distributed:
            hvd.broadcast_parameters(model.state_dict(), root_rank=0)
            hvd.broadcast_optimizer_state(opt, root_rank=0)
            if local_steps is not None:
                agreed = hvd.allreduce(
                    torch.tensor([local_steps], dtype=torch.int64,
                                 device=dev),
                    op=hvd.Min, name="torch_est.steps")
                local_steps = int(agreed[0])
                if local_steps == 0:
                    raise ValueError(
                        "a rank has zero full batches (shard smaller than "
                        "batch_size)")
            if val_local_steps is not None:
                agreed = hvd.allreduce(
                    torch.tensor([val_local_steps], dtype=torch.int64,
                                 device=dev),
                    op=hvd.Min, name="torch_est.val_steps")
                val_local_steps = int(agreed[0])

        steps_cap = self.train_steps_per_epoch
        if local_steps is not None:
            steps_cap = min(steps_cap, local_steps) \
                if steps_cap else local_steps
        val_cap = self.validation_steps_per_epoch
        if val_local_steps is not None:
            val_cap = min(val_cap, val_local_steps) \
                if val_cap else val_local_steps

        def to_tensors(batch):
            if self.transformation_fn is not None:
                x, y, w = self.transformation_fn(*self._unpack(batch))
            else:
                x, y, w = self._unpack(batch)
            xt = torch.as_tensor(np.ascontiguousarray(x),
                                 dtype=torch.float32).to(dev)
            if isinstance(y, (tuple, list)):
                yt = [torch.as_tensor(np.ascontiguousarray(a)).to(dev)
                      for a in y]
            else:
                yt = torch.as_tensor(np.ascontiguousarray(y)).to(dev)
            wt = None if w is None else torch.as_tensor(
                np.ascontiguousarray(w), dtype=torch.float32).to(dev)
            return xt, yt, wt

        def mean_across_ranks(value: float, name: str) -> float:
            if not distributed:
                return value
            return float(hvd.allreduce(torch.tensor([value], device=dev),
                                       op=hvd.Average, name=name)[0])

        def run_metrics(outputs, labels, sums, count):
            for name, fn in self.metrics.items():
                sums[name] = sums.get(name, 0.0) + float(
                    fn(outputs, labels).detach())
            return count + 1

        for cb in self.callbacks:
            if rank0 and hasattr(cb, "on_train_begin"):
                cb.on_train_begin({})

        stop = False
        cb_error = None
        for epoch in range(start_epoch, self.epochs):
            model.train()
            losses, msums, mcount = [], {}, 0
            it = batches(epoch)
            if steps_cap is not None:
                it = itertools.islice(it, steps_cap)
            for batch in it:
                xt, yt, wt = to_tensors(batch)
                opt.zero_grad()
                outputs = model(xt)
                loss = self._combined_loss(outputs, yt, wt)
                loss.backward()
                opt.step()
                losses.append(float(loss.detach()))
                mcount = run_metrics(outputs, yt, msums, mcount)
            if not losses:
                # A silent loss=0.0 would checkpoint an untrained model
                # that looks converged.
                raise ValueError(
                    "training produced zero full batches (dataset smaller "
                    "than batch_size); use more data or a smaller "
                    "batch_size")
            logs = {"loss": mean_across_ranks(
                float(np.mean(losses)), "torch_est.loss")}
            for name, total in msums.items():
                logs[name] = mean_across_ranks(total / max(mcount, 1),
                                               f"torch_est.{name}")

            if val_batches is not None:
                model.eval()
                vlosses, vsums, vcount = [], {}, 0
                vit = val_batches()
                if val_cap is not None:
                    vit = itertools.islice(vit, val_cap)
                with torch.no_grad():
                    for batch in vit:
                        xt, yt, wt = to_tensors(batch)
                        outputs = model(xt)
                        vlosses.append(float(
                            self._combined_loss(outputs, yt, wt)))
                        vcount = run_metrics(outputs, yt, vsums, vcount)
                if not vlosses:
                    raise ValueError("validation produced zero full batches")
                logs["val_loss"] = mean_across_ranks(
                    float(np.mean(vlosses)), "torch_est.val_loss")
                for name, total in vsums.items():
                    logs[f"val_{name}"] = mean_across_ranks(
                        total / max(vcount, 1), f"torch_est.val_{name}")

            history.append(logs)
            if self.verbose and rank0:
                print(f"[torch-estimator {self.run_id}] epoch {epoch}: "
                      + " ".join(f"{k}={v:.5f}" for k, v in logs.items()),
                      flush=True)

            if rank0:
                # Per-epoch checkpoint for resume (reference: remote.py
                # save_checkpoint every epoch) + the final model blob.
                buf = io.BytesIO()
                torch.save({"model": model.state_dict(),
                            "optimizer": opt.state_dict(),
                            "epoch": epoch, "history": history}, buf)
                self.store.write(ckpt_path, buf.getvalue())
                buf = io.BytesIO()
                torch.save({"model": model.state_dict(),
                            "history": history,
                            "feature_cols": self.feature_cols,
                            "label_cols": self.label_cols}, buf)
                self.store.save(self.run_id, buf.getvalue())
                try:
                    for cb in self.callbacks:
                        if hasattr(cb, "on_epoch_end"):
                            cb.on_epoch_end(epoch, dict(logs))
                except _StopTraining:
                    stop = True
                except Exception as exc:
                    # A broken callback must not wedge the world: the other
                    # ranks are about to block in the stop broadcast, so
                    # release them with stop=True BEFORE re-raising.
                    cb_error = exc
                    stop = True
            if distributed:
                stop = bool(hvd.broadcast_object(
                    stop, root_rank=0, name="torch_est.stop"))
            if cb_error is not None:
                raise cb_error
            if stop:
                break
        return history

    def _unpack(self, batch):
        if len(batch) == 3:
            return batch
        x, y = batch
        return x, y, None
