"""Data-parallel training of the PyTorch port: the optimizer and its
reductions (flat, hierarchical, Adasum), ZeRO-1, synchronized batch norm,
and the flat-or-hierarchical calibration."""

from .adasum import adasum, adasum_reference  # noqa: F401
from .axes import axis_bound, axis_size  # noqa: F401
from .optimizer import (DistributedOptimizer,  # noqa: F401
                        allreduce_gradients, broadcast_optimizer_state,
                        broadcast_parameters)
from .sharded_optimizer import ShardedDistributedOptimizer  # noqa: F401
from .strategy import (autotune_hierarchical,  # noqa: F401
                       choose_hierarchical, clear_hierarchical_decisions,
                       load_hierarchical_decisions,
                       save_hierarchical_decisions)
from .sync_batch_norm import SyncBatchNorm  # noqa: F401
