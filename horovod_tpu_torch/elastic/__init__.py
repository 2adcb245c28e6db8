"""Elastic training (counterpart of ``horovod_tpu/elastic`` and
``horovod_tpu/torch/elastic.py``; reference: ``horovod/common/elastic.py``,
``horovod/torch/elastic.py``): ``hvd.elastic.run``, the states, and the
exceptions of its retry loop."""

from ..exceptions import HostsUpdatedInterrupt  # noqa: F401
from .state import ObjectState, State, run, run_fn  # noqa: F401
from .torch_state import TorchState  # noqa: F401
