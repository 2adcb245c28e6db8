"""horovod_tpu_torch — the PyTorch and CUDA port of ``horovod_tpu``.

Horovod's synchronous data-parallel training on NVIDIA GPUs: one process
per GPU over ``torch.distributed`` (NCCL on the card, gloo on the CPU), the
gradients reduced by ``DistributedOptimizer`` while backward runs,
optionally through the IST-DASLab quantized allreduce (max-min or
normalized quantizers), whose kernels are hand-written CUDA for Hopper
(``horovod_tpu_torch/csrc``). The JAX package ``horovod_tpu`` is the
reference it is tested against; this package imports nothing of it.

Usage::

    import horovod_tpu_torch as hvd
    hvd.init()                      # cuda:{local_rank}; device="cpu" on CPU
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), 0.1),
                                   named_parameters=model.named_parameters(),
                                   backward_passes_per_step=1)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    handle = hvd.allreduce_async(t)  # ... hvd.synchronize(handle)
"""

from .compression import Compression, set_quantization_levels  # noqa: F401
from .exceptions import HvdTpuInternalError  # noqa: F401
from .functions import allgather_object, broadcast_object  # noqa: F401
from .ops.collectives import (Average, Max, Min, Product,  # noqa: F401
                              ReduceOp, Sum, allgather, allgather_async,
                              allreduce, allreduce_async, alltoall,
                              alltoall_async, broadcast, broadcast_,
                              broadcast_async, grouped_allreduce,
                              grouped_allreduce_async, poll, reducescatter,
                              release_handle, synchronize)
from .parallel import (DistributedOptimizer,  # noqa: F401
                       broadcast_optimizer_state, broadcast_parameters)
from .runtime import (ccl_built, cross_rank, cross_size,  # noqa: F401
                      cuda_built, ddl_built, device, gloo_built,
                      gloo_enabled, init, is_homogeneous, is_initialized,
                      local_rank, local_size, mpi_built, mpi_enabled,
                      mpi_threads_supported, nccl_built, rank, rocm_built,
                      shutdown, size)
