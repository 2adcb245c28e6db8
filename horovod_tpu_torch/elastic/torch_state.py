"""Elastic state of a torch model and optimizer (counterpart of
``horovod_tpu/torch/elastic.py``: ``TorchState`` :20; reference:
``horovod/torch/elastic.py`` ``TorchState`` :51).
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from .state import DurableStateMixin, ObjectState


def _compact(obj):
    """``obj`` with every tensor that views a larger storage cloned (a
    ``DistributedOptimizer``'s error-feedback residuals view one fused
    buffer): pickling a view writes the whole storage it views."""
    if isinstance(obj, torch.Tensor):
        whole = obj.untyped_storage().nbytes()
        return obj.clone() if whole > obj.numel() * obj.element_size() \
            else obj
    if isinstance(obj, dict):
        return type(obj)((k, _compact(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_compact(v) for v in obj)
    return obj


class TorchState(DurableStateMixin, ObjectState):
    """A model's and an optimizer's ``state_dict`` (by deep copy) and any
    picklable attributes::

        state = hvd.elastic.TorchState(model, optimizer, batch=0)

        @hvd.elastic.run
        def train(state):
            while state.batch < steps:
                ...
                state.batch += 1
                state.commit()

    The optimizer's ``state_dict`` holds a ``DistributedOptimizer``'s
    error-feedback residuals too, so a restore returns them to the commit.
    ``checkpoint_dir`` also writes every ``checkpoint_every``-th commit to
    disk (:class:`DurableStateMixin`), and :meth:`load_from_checkpoint`
    starts a new job from the last one.
    """

    def __init__(self, model: Optional[torch.nn.Module] = None,
                 optimizer: Optional[torch.optim.Optimizer] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1,
                 checkpoint_keep: Optional[int] = 5, **kwargs):
        self._saved = {}
        self.model = model
        self.optimizer = optimizer
        self._init_durable(checkpoint_dir, checkpoint_every,
                           checkpoint_keep)
        super().__init__(**kwargs)
        self._ckpt_armed = False
        self.save()
        self._ckpt_armed = True

    def save(self) -> None:
        if self.model is not None:
            self._saved["model"] = copy.deepcopy(self.model.state_dict())
        if self.optimizer is not None:
            self._saved["optimizer"] = copy.deepcopy(
                self.optimizer.state_dict())
        super().save()
        self._maybe_durable_save(
            lambda: {"saved": self._saved, "attrs": self._saved_state})

    def load_from_checkpoint(self) -> bool:
        """Load the last commit on disk into the model, the optimizer and
        the attributes; False when there is none (a fresh start)."""
        if self._ckpt_dir is None or not self._latest_durable:
            return False
        from ..checkpoint import restore_checkpoint
        tree = restore_checkpoint(self._ckpt_dir, step=self._latest_durable)
        self._saved = tree["saved"]
        self._saved_state.update(tree["attrs"])
        self.restore()
        self._commit_count = self._latest_durable
        return True

    def restore(self) -> None:
        if self.model is not None and "model" in self._saved:
            self.model.load_state_dict(copy.deepcopy(self._saved["model"]))
        if self.optimizer is not None and "optimizer" in self._saved:
            self.optimizer.load_state_dict(
                copy.deepcopy(self._saved["optimizer"]))
        super().restore()

    def sync(self) -> None:
        """Rank 0's model and optimizer state on every rank, then a new
        in-memory snapshot of it (not written to disk: the first sync
        comes before any training)."""
        from .. import runtime
        from ..functions import broadcast_object
        from ..parallel.optimizer import broadcast_parameters
        if self.model is not None:
            broadcast_parameters(self.model.state_dict(), root_rank=0)
        if self.optimizer is not None:
            state = broadcast_object(_compact(self.optimizer.state_dict()),
                                     root_rank=0,
                                     name="elastic.torch.optimizer")
            if runtime.rank() != 0:
                self.optimizer.load_state_dict(state)
        super().sync()
        self._ckpt_armed = False
        try:
            self.save()
        finally:
            self._ckpt_armed = True
