"""Cluster integrations, the counterpart of ``horovod_tpu/integrations``
(reference: SURVEY.md §2.6 — ``horovod.spark`` / ``horovod.ray``), keeping
the reference's API shapes over the port's runner:

- :class:`Executor` — programmatic multi-process execution with per-rank
  results (the role of ``RayExecutor.run`` / ``horovod.spark.run``), over
  ``hvd.run``.
- :class:`RayExecutor` — the reference's Ray API
  (``horovod/ray/runner.py:246``), available when ``ray`` is installed;
  import-gated otherwise.
- :class:`Estimator` / :class:`LocalStore` — the Spark-estimator shape
  (``horovod/spark/keras/estimator.py``, ``spark/common/store.py``):
  ``fit(data) -> EstimatorModel`` with checkpointing to a store, over a
  ``torch.nn.Module``.
"""

from .executor import Executor
from .estimator import Estimator, EstimatorModel, LocalStore, Store
from .ray import RayExecutor

__all__ = ["Executor", "RayExecutor", "Estimator", "EstimatorModel",
           "Store", "LocalStore"]
