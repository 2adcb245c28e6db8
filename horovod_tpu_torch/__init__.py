"""horovod_tpu_torch — the PyTorch and CUDA port of ``horovod_tpu``.

Horovod's synchronous data-parallel training on NVIDIA GPUs: one process
per GPU over ``torch.distributed`` (NCCL on the card, gloo on the CPU), the
gradients reduced by ``DistributedOptimizer`` while backward runs,
optionally through the IST-DASLab quantized allreduce (max-min or
normalized quantizers), whose kernels are hand-written CUDA for Hopper
(``horovod_tpu_torch/csrc``). The ranks form a device mesh with named axes,
over which the collectives, the hierarchical and Adasum reductions, ZeRO-1
(``ShardedDistributedOptimizer``) and ``SyncBatchNorm`` run. PowerSGD
(``PowerSGDOptimizer``) is the low-rank alternative to quantization, and
``autotune_compressed`` times the two against dense on the live mesh.
``save_checkpoint``/``restore_checkpoint`` write and read trees of tensors
and DTensors over ``torch.distributed.checkpoint``. The JAX package
``horovod_tpu`` is the reference it is tested against; this package
imports nothing of it.

Usage::

    import horovod_tpu_torch as hvd
    hvd.init()                      # cuda:{local_rank}; device="cpu" on CPU
    # or hvd.init(mesh_shape={"dcn": nodes, "ici": gpus_per_node})
    # or hvd.init(mode="process"): the native core instead of
    # torch.distributed (negotiation, fusion, join, wire compression)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), 0.1),
                                   named_parameters=model.named_parameters(),
                                   backward_passes_per_step=1)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    handle = hvd.allreduce_async(t)  # ... hvd.synchronize(handle)
    step = hvd.data_parallel_step(train_step)  # one CUDA graph a step
    loss = step(model, opt, hvd.shard_batch(batch))

Launch with ``hvdrun-torch -np 4 python train.py`` (or ``python -m
horovod_tpu_torch.runner.launch``). An elastic job
(``hvdrun-torch --host-discovery-script S --min-np 2 --max-np 4 ...``)
wraps its loop in ``hvd.elastic.run`` over an ``hvd.elastic.TorchState``
that it commits; ``hvd.run(fn, np=2)`` runs a function on workers and
returns their results.
"""

from .checkpoint import (checkpoint_metadata,  # noqa: F401
                         latest_checkpoint_step, restore_checkpoint,
                         save_checkpoint)
from .compression import (Compression, Compressor,  # noqa: F401
                          FP16Compressor, FP32Compressor, NoneCompressor,
                          PowerSGDOptimizer, PowerSGDState,
                          autotune_compressed, crossover_gbps, payload_nbytes,
                          powersgd_allreduce, powersgd_init,
                          projected_step_seconds, set_quantization_levels)
from .models import MLP, VGG, VGG16, VGG19, InceptionV3  # noqa: F401
from .exceptions import (DuplicateNameError,  # noqa: F401
                         HostsUpdatedInterrupt, HvdTpuInternalError,
                         NotInitializedError, TensorDtypeMismatchError,
                         TensorShapeMismatchError)
from .functions import allgather_object, broadcast_object  # noqa: F401
from .ops.collectives import (Adasum, Average, Max, Min,  # noqa: F401
                              Product, ReduceOp, Sum, allgather,
                              allgather_async, allreduce, allreduce_,
                              allreduce_async, allreduce_async_, alltoall,
                              alltoall_async, broadcast, broadcast_,
                              broadcast_async, broadcast_async_,
                              grouped_allreduce, grouped_allreduce_async,
                              grouped_enqueue,
                              hierarchical_allgather, hierarchical_allreduce,
                              in_named_trace, join, poll, rank_in_step,
                              reducescatter, release_handle, size_in_step,
                              synchronize)
from .parallel import (DistributedGradientTape,  # noqa: F401
                       DistributedOptimizer, ShardedDistributedOptimizer,
                       SyncBatchNorm, allreduce_gradients,
                       autotune_hierarchical, broadcast_optimizer_state,
                       broadcast_parameters, choose_hierarchical,
                       clear_hierarchical_decisions,
                       load_hierarchical_decisions,
                       save_hierarchical_decisions)
from .runtime import (axis_names, ccl_built, cross_rank,  # noqa: F401
                      cross_size, cuda_built, ddl_built, debugz, device,
                      dp_axis, flightrec_dump, gloo_built, gloo_enabled,
                      grad_report, init, is_homogeneous, is_initialized,
                      local_rank, local_size, mesh, metrics, metrics_dump,
                      metrics_server, mode, mpi_built, mpi_enabled,
                      mpi_threads_supported, nccl_built, perf_report,
                      prof_snapshot, prof_start, prof_stop, profile, rank,
                      reinit, rocm_built, shutdown, size, start_timeline,
                      start_trace, stop_timeline, stop_trace)
from .step import (REPLICATED, batch_spec,  # noqa: F401
                   data_parallel_step, replicate, run_step, shard_batch)
from .callbacks import (BestModelCheckpoint, average_metrics,  # noqa: F401
                        lr_schedule, warmup_schedule)
from .ops.flash_attention import flash_attention  # noqa: F401
from .parallel.ring_attention import (make_ring_attention,  # noqa: F401
                                      ring_attention)
from .parallel.ulysses import (make_ulysses_attention,  # noqa: F401
                               ulysses_attention)
from . import elastic  # noqa: F401,E402
from .runner import run  # noqa: F401,E402
