"""horovod_tpu_torch — the PyTorch and CUDA port of ``horovod_tpu``.

Horovod's synchronous data-parallel training on NVIDIA GPUs: one process
per GPU over ``torch.distributed`` (NCCL on the card, gloo on the CPU), the
gradients reduced by ``DistributedOptimizer``, optionally through the
IST-DASLab quantized allreduce (max-min or normalized quantizers), whose
kernels are hand-written CUDA for Hopper (``horovod_tpu_torch/csrc``). The
JAX package ``horovod_tpu`` is the reference it is tested against; this
package imports nothing of it.

Usage::

    import horovod_tpu_torch as hvd
    hvd.init()                      # cuda:{local_rank}; device="cpu" on CPU
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), 0.1),
                                   named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
"""

from .compression import Compression, set_quantization_levels  # noqa: F401
from .ops.collectives import (Average, Max, Min, Product,  # noqa: F401
                              ReduceOp, Sum, allgather, allreduce, alltoall,
                              broadcast, grouped_allreduce)
from .parallel import (DistributedOptimizer,  # noqa: F401
                       broadcast_optimizer_state, broadcast_parameters)
from .runtime import (cross_rank, cross_size, device, init,  # noqa: F401
                      is_initialized, local_rank, local_size, rank,
                      shutdown, size)
