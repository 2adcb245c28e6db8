"""Training helpers: metric averaging, learning-rate schedules, the best
checkpoint and early stopping.

Counterpart of ``horovod_tpu/callbacks.py`` (:27-205); reference:
``horovod/_keras/callbacks.py`` (``MetricAverageCallback`` :48, the
learning-rate warm-up and schedule :66+) and ``BestModelCheckpoint``
(``horovod/keras/callbacks.py:157``). The schedules are functions of the
step that ``torch.optim.lr_scheduler.LambdaLR`` takes: they return the
factor by which the optimizer's initial learning rate is multiplied, so
that rate times the factor is the value of the JAX package's schedule of
the same ``base_lr`` at that step.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch

from . import runtime
from .ops import collectives as C


def average_metrics(metrics: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Average scalar metrics across ranks, in one fused allreduce
    (reference: ``MetricAverageCallback``, ``_keras/callbacks.py:48``).
    Every rank passes the same names in the same order."""
    dev = runtime.device()
    names = list(metrics)
    values = [torch.as_tensor(metrics[k], device=dev) for k in names]
    return dict(zip(names, C.grouped_allreduce(values, op=C.Average,
                                               name="metrics")))


def _world(scale_to_world: bool) -> int:
    return runtime.size() if scale_to_world and runtime.is_initialized() \
        else 1


def warmup_schedule(warmup_steps: int,
                    scale_to_world: bool = True,
                    after: Optional[Callable[[int], float]] = None
                    ) -> Callable[[int], float]:
    """Warm the learning rate up from its initial value to ``size`` times it
    over ``warmup_steps`` (reference: ``LearningRateWarmupCallbackImpl``,
    ``_keras/callbacks.py:66+``: the linear-scaling rule of the Horovod
    paper). ``after``, a factor of the step (for example
    :func:`lr_schedule`'s), takes over from ``warmup_steps`` on."""
    target = _world(scale_to_world)

    def factor(step: int) -> float:
        if after is not None and step >= warmup_steps:
            return float(after(step))
        frac = min(max(step / max(warmup_steps, 1), 0.0), 1.0)
        return 1.0 + (target - 1.0) * frac

    return factor


def lr_schedule(multiplier, start_epoch: int = 0,
                end_epoch: Optional[int] = None,
                steps_per_epoch: Optional[int] = None,
                staircase: bool = True, scale_to_world: bool = False
                ) -> Callable[[int], float]:
    """``multiplier(epoch)`` (a callable or a constant) times the learning
    rate within ``[start_epoch, end_epoch)``, and the learning rate itself
    outside (reference: ``LearningRateScheduleCallbackImpl``,
    ``_keras/callbacks.py:66+``). ``steps_per_epoch`` maps the step to the
    epoch, whole with ``staircase`` and fractional without; it is required
    whenever the epoch matters. ``scale_to_world`` multiplies by the world
    size, as :func:`warmup_schedule` does after its warm-up."""
    if (callable(multiplier) or start_epoch > 0 or end_epoch is not None) \
            and not steps_per_epoch:
        raise ValueError(
            "steps_per_epoch (> 0) is required to map the step counter to "
            "epochs (callable multiplier or epoch window in use)")
    if not callable(multiplier):
        value = float(multiplier)
        multiplier = lambda _epoch: value  # noqa: E731
    world = _world(scale_to_world)

    def factor(step: int) -> float:
        epoch = step / steps_per_epoch if steps_per_epoch else 0.0
        if steps_per_epoch and staircase:
            epoch = math.floor(epoch)
        in_window = epoch >= start_epoch and (end_epoch is None or
                                              epoch < end_epoch)
        return world * float(multiplier(epoch)) if in_window else world

    return factor


class BestModelCheckpoint:
    """Keep the best checkpoint by a monitored metric; rank 0 writes it
    with ``torch.save`` (reference: ``horovod/keras/callbacks.py:157``)."""

    def __init__(self, path: str, monitor: str = "val_loss",
                 mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.path = path
        self.monitor = monitor
        self.mode = mode
        self.best: Optional[float] = None

    def __call__(self, metrics: Dict[str, Any], state: Any) -> bool:
        """Save ``state`` (a ``state_dict``, say) if ``metrics[monitor]``
        improved; True when this rank wrote a checkpoint."""
        value = float(metrics[self.monitor])
        if self.best is not None and (value >= self.best if self.mode ==
                                      "min" else value <= self.best):
            return False
        self.best = value
        if runtime.is_initialized() and runtime.rank() != 0:
            return False
        torch.save(state, self.path)
        return True

    def load(self) -> Any:
        return torch.load(self.path, map_location="cpu")


class StopTraining(Exception):
    """Raised by a callback's ``on_epoch_end`` to end training after the
    current epoch (reference: Keras ``model.stop_training``)."""


class EarlyStopping:
    """Stop when a monitored metric stops improving: ``on_epoch_end``
    raises :class:`StopTraining` after ``patience`` epochs without an
    improvement of more than ``min_delta``."""

    def __init__(self, monitor: str = "val_loss", min_delta: float = 0.0,
                 patience: int = 0):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.on_train_begin()

    def on_train_begin(self, logs=None) -> None:
        self._best = float("inf")
        self._wait = 0

    def on_epoch_end(self, epoch: int, logs: Dict[str, float]) -> None:
        value = logs.get(self.monitor)
        if value is None:
            raise KeyError(
                f"EarlyStopping monitors {self.monitor!r} but the epoch "
                f"logs only have {sorted(logs)}")
        if value < self._best - self.min_delta:
            self._best = value
            self._wait = 0
        else:
            self._wait += 1
            if self._wait > self.patience:
                raise StopTraining()
