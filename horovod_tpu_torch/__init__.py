"""horovod_tpu_torch — the PyTorch and CUDA port of ``horovod_tpu``.

Horovod's synchronous data-parallel training on NVIDIA GPUs: one process
per GPU over ``torch.distributed`` (NCCL on the card, gloo on the CPU), the
gradients reduced by ``DistributedOptimizer`` while backward runs,
optionally through the IST-DASLab quantized allreduce (max-min or
normalized quantizers), whose kernels are hand-written CUDA for Hopper
(``horovod_tpu_torch/csrc``). The ranks form a device mesh with named axes,
over which the collectives, the hierarchical and Adasum reductions, ZeRO-1
(``ShardedDistributedOptimizer``) and ``SyncBatchNorm`` run. The JAX package ``horovod_tpu`` is the
reference it is tested against; this package imports nothing of it.

Usage::

    import horovod_tpu_torch as hvd
    hvd.init()                      # cuda:{local_rank}; device="cpu" on CPU
    # or hvd.init(mesh_shape={"dcn": nodes, "ici": gpus_per_node})
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), 0.1),
                                   named_parameters=model.named_parameters(),
                                   backward_passes_per_step=1)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    handle = hvd.allreduce_async(t)  # ... hvd.synchronize(handle)
"""

from .compression import Compression, set_quantization_levels  # noqa: F401
from .exceptions import HvdTpuInternalError  # noqa: F401
from .functions import allgather_object, broadcast_object  # noqa: F401
from .ops.collectives import (Adasum, Average, Max, Min,  # noqa: F401
                              Product, ReduceOp, Sum, allgather,
                              allgather_async, allreduce, allreduce_async,
                              alltoall, alltoall_async, broadcast,
                              broadcast_, broadcast_async, grouped_allreduce,
                              grouped_allreduce_async,
                              hierarchical_allgather, hierarchical_allreduce,
                              poll, reducescatter, release_handle,
                              synchronize)
from .parallel import (DistributedOptimizer,  # noqa: F401
                       ShardedDistributedOptimizer, SyncBatchNorm,
                       allreduce_gradients, autotune_hierarchical,
                       broadcast_optimizer_state, broadcast_parameters,
                       choose_hierarchical, clear_hierarchical_decisions,
                       load_hierarchical_decisions,
                       save_hierarchical_decisions)
from .runtime import (axis_names, ccl_built, cross_rank,  # noqa: F401
                      cross_size, cuda_built, ddl_built, device, dp_axis,
                      gloo_built, gloo_enabled, init, is_homogeneous,
                      is_initialized, local_rank, local_size, mesh,
                      mpi_built, mpi_enabled, mpi_threads_supported,
                      nccl_built, rank, rocm_built, shutdown, size)
