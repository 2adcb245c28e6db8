"""``horovod_tpu_torch.torch``: the counterpart of ``import
horovod_tpu.torch as hvd``, the JAX package's PyTorch frontend
(reference: ``import horovod.torch as hvd``).

It is the port's own surface under the frontend's names: the lifecycle and
topology, the collectives with their async handles (differentiable in
process mode as well: allreduce, allgather, broadcast and alltoall), the
object and parameter broadcasts, ``DistributedOptimizer``, the compressors,
the build flags and the exceptions are those of ``horovod_tpu_torch``;
``elastic`` holds ``TorchState`` and ``run``. Two names differ from the
top level:

* ``SyncBatchNorm`` is the torch ``_BatchNorm`` of
  :mod:`.sync_batch_norm` (momentum the weight of the new statistic, the
  unbiased running variance, ``affine`` and ``track_running_stats``),
  which runs in process mode too; the top-level one is the flax module's
  counterpart;
* ``TorchEstimator``, ``TorchModel`` and ``EarlyStopping`` come from
  :mod:`.estimator`.

Unlike the JAX frontend, which bridges every tensor through numpy on the
host, the tensors stay on the rank's device (process mode stages them
through pinned host memory for the core). ``alltoall`` with ``splits``
returns ``(output, received_splits)``, as the port's top level does.
"""

from .. import elastic  # noqa: F401
from .. import (Adasum, Average, Compression, Compressor,  # noqa: F401
                FP16Compressor, FP32Compressor, HostsUpdatedInterrupt,
                HvdTpuInternalError, Max, Min, NoneCompressor,
                NotInitializedError, Product, ReduceOp, Sum,
                DistributedOptimizer, allgather, allgather_async,
                allgather_object, allreduce, allreduce_, allreduce_async,
                allreduce_async_, alltoall, alltoall_async, broadcast,
                broadcast_, broadcast_async, broadcast_async_,
                broadcast_object, broadcast_optimizer_state,
                broadcast_parameters, ccl_built, cross_rank, cross_size,
                cuda_built, ddl_built, gloo_built, gloo_enabled, init,
                is_homogeneous, is_initialized, join, local_rank,
                local_size, mpi_built, mpi_enabled, mpi_threads_supported,
                nccl_built, poll, rank, rocm_built, set_quantization_levels,
                shutdown, size, start_timeline, stop_timeline, synchronize)
from .. import runtime  # noqa: F401
from .estimator import EarlyStopping, TorchEstimator, TorchModel  # noqa: F401
from .sync_batch_norm import SyncBatchNorm  # noqa: F401

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "is_homogeneous",
    "start_timeline", "stop_timeline",
    "ReduceOp", "Average", "Sum", "Adasum", "Min", "Max", "Product",
    "allreduce", "allreduce_", "allreduce_async", "allreduce_async_",
    "allgather", "allgather_async", "broadcast", "broadcast_",
    "broadcast_async", "broadcast_async_", "alltoall", "alltoall_async",
    "join", "poll", "synchronize",
    "broadcast_parameters", "broadcast_optimizer_state", "broadcast_object",
    "allgather_object", "DistributedOptimizer", "Compression",
    "Compressor", "NoneCompressor", "FP16Compressor", "FP32Compressor",
    "SyncBatchNorm", "TorchEstimator", "TorchModel", "EarlyStopping",
    "HvdTpuInternalError", "HostsUpdatedInterrupt", "NotInitializedError",
    "set_quantization_levels",
    "mpi_threads_supported", "mpi_enabled", "mpi_built", "gloo_enabled",
    "gloo_built", "nccl_built", "ddl_built", "ccl_built", "cuda_built",
    "rocm_built", "elastic",
]
