"""Parallel training of the PyTorch port: the data-parallel optimizer and
its reductions (flat, hierarchical, Adasum), ZeRO-1, synchronized batch
norm, the flat-or-hierarchical calibration, and sequence (ring attention,
Ulysses), expert (switch MoE) and pipeline (GPipe) parallelism."""

from .adasum import adasum, adasum_reference  # noqa: F401
from .axes import (axis_bound, axis_index, axis_size,  # noqa: F401
                   local_shard, mesh_coords)
from .optimizer import (DistributedOptimizer,  # noqa: F401
                        allreduce_gradients, broadcast_optimizer_state,
                        broadcast_parameters)
from .sharded_optimizer import ShardedDistributedOptimizer  # noqa: F401
from .strategy import (autotune_hierarchical,  # noqa: F401
                       choose_hierarchical, clear_hierarchical_decisions,
                       load_hierarchical_decisions,
                       save_hierarchical_decisions)
from .sync_batch_norm import SyncBatchNorm  # noqa: F401
from .ring_attention import (ring_attention, ring_attention_p,  # noqa: F401
                             make_ring_attention)
from .ulysses import (ulysses_attention, ulysses_attention_p,  # noqa: F401
                      make_ulysses_attention)
from .moe import switch_moe  # noqa: F401
from .pipeline import pipeline_apply, stage_partition  # noqa: F401
