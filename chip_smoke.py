#!/usr/bin/env python3
"""Smoke run of ``horovod_tpu_torch`` on one NVIDIA GPU (written for the
H100).

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py [--parent DIR]

It builds the CUDA kernels from the checkout's sources and holds each
kernel against its plain PyTorch version on the card. Then it drives the
port's paths, each with the launch counts set to 0 just before it and read
just after:

* ResNet-50: ``hvd.init()`` (NCCL, a world of one), full-width ResNet-50 in
  bf16 autocast over ``channels_last``, and ``DistributedOptimizer``
  sending the gradients through the 4-bit max-min ``scatter_allgather``
  reducer with error feedback (kernels B1, B3, B4);
* the same ResNet-50 path with the fork's normalized quantizer, what
  ``make_compressor("uni")`` builds (4 bits, buckets of 512, uniform
  levels, linf norm: kernels B5, B6);
* the same ResNet-50 path with stochastic 4-bit max-min rounding (kernel
  B2, and B3, B4 on the receive side);
* the max-min ResNet-50 path with ``backward_passes_per_step=2``: each
  step two half-batches of 32 images, each loss scaled by 1/2 (batch norm
  sees 32 images, so it is not compared with the batch-64 phase);
* GPT: the ``gpt_long_context_flash`` configuration of ``bench.py`` (6
  layers, d512, 8 heads of 64, MLP 2048, vocab 32000, 2 x 4096 tokens, bf16,
  ``remat="full"``) with flash attention (kernels B7, B8, B9, in bf16 on
  the tensor cores as ``wgmma`` fed by TMA and a producer warp), through
  the dense ``DistributedOptimizer`` (Average, four buckets of at most 64
  MiB) and SGD;
* the collective API on the card: every async op bitwise against its
  sync twin, ``reducescatter``, ``alltoall`` with splits, ``allgather``,
  autograd through ``allreduce``, and agreement errors (a dtype mismatch
  from a second rank's descriptor, splits that do not sum to dim 0);
* three phases on a device mesh, each with the runtime initialized anew
  (2 warm-up and 5 timed steps): ResNet-50 with ``SyncBatchNorm`` in
  place of its 53 batch norms, through
  ``DistributedOptimizer(op=Adasum, hierarchical=("ici", "dcn"))`` on a
  ``{"dcn": 1, "ici": 1}`` mesh; ResNet-50 with its fused gradients reduced
  by ``hierarchical_compressed_allreduce`` (4-bit max-min, buckets of 512,
  ``scatter_allgather``, error feedback carried across steps: kernels B1,
  B3, B4) on the same mesh; and the GPT path under ZeRO-1
  (``ShardedDistributedOptimizer(torch.optim.Adam)``) on a ``{"dp": 1}``
  mesh (B7, B8, B9), whose Adam state must be the computed bytes. Before
  them, the fused per-tensor Adasum combine (each tensor's partials and
  coefficients) folds 4 synthetic rank vectors in ResNet-50's 161-tensor
  layout on the card and is held against the float64
  ``adasum_reference`` of each tensor.
* six model-parallel phases at full width, each on a runtime initialized
  anew (2 warm-up and 5 timed steps), every mesh axis of size 1: (a) the
  GPT path with ``attention="ulysses_flash"`` on ``{"dp": 1, "tp": 1,
  "sp": 1}`` (B7, B8, B9 behind the all-to-alls, with the tensor-parallel
  sums), (b) the same with ring attention (no kernel), (c) the switch-MoE
  GPT on ``{"dp": 1, "ep": 1}`` (8 experts, capacity factor 1.25, every
  second block; the dropped fraction and load-balance loss reported),
  (d) ``remat`` none, full and dots: the same loss and gradients, bitwise,
  on the same inputs, full's step peak memory lowest and none's highest, then
  each trained, (e) GPipe over the GPT blocks on ``{"dp": 1, "pp": 1}``
  (2 micro-batches of one 4096-token sequence), (f) the encoder (the JAX
  ``Encoder``'s defaults, the non-causal kernels, ``masked_lm_loss`` at
  15% of 2 x 4096 positions from ``--seed``, Adam). Each checks its exact
  B7, B8 and B9 launches a step (``MP_LAUNCHES``), all on the tensor
  cores, and its trained model against a CPU copy.
* four vision phases at full width, each on a runtime initialized anew
  (2 warm-up and 10 timed steps): (g) VGG-16 (138,357,544 parameters,
  batch 64, 224x224, bf16) through 4-bit max-min (``scatter_allgather``,
  error feedback, buckets of 512: B1, B3, B4) with cuDNN deterministic;
  after timed step 5 ``save_checkpoint`` stores the model's and the
  optimizer's ``state_dict`` (the residuals through ``stack_ranks``), and a
  fresh model and optimizer restored from it must repeat steps 6-10 with
  the same losses and weights, bitwise; then the trained model against its
  CPU copy; (h) VGG-16 through ``PowerSGDOptimizer(SGD(momentum=0.9),
  rank=4)``: no kernel, 320,524 factor and 13,416 dense floats a step
  against 138,357,544; (i) Inception V3 (299x299, batch 64) through the
  normalized quantizer (B5, B6); (j) ``autotune_compressed("ici", "dcn")``
  on ``{"dcn": 1, "ici": 1}`` at 1 MiB and 16 MiB (B1, B3, B4 through
  ``hierarchical_compressed_allreduce``), its table and the crossover link
  speed from the measured compressed call (at a world of one no byte
  crosses a link, so the table names no real winner). B1, B3 and B4 are
  also held bitwise at VGG-16's 138,357,544 values, B5 and B6 at
  Inception's 23,834,568, and timed there.
* phase (k), the process-mode native core: the port's static launcher
  (``python -m horovod_tpu_torch.runner.launch -np 2 -H localhost:2``)
  starts the script twice (``--process-worker``, with the ``HVDTPU_*``
  topology variables it exports, which each rank checks), two ranks of ``hvd.init(mode="process",
  device="cuda:0")`` sharing the card (one rank if its compute mode allows
  one context), the core built from ``horovod_tpu_torch/native`` by the
  parent beside the kernels. On tensors on the card, staged through pinned
  host memory: (k1) the collective menu (allreduce over fp32, bf16, fp16
  and int32 with Sum, Average, Min and Max, fp32 Adasum, pre- and
  postscale; grouped allreduce, broadcast, allgather with uneven rows,
  alltoall with splits and the splits received, reducescatter, the object
  collectives), every result equal to what the host computes, and a
  shape mismatch, a dtype mismatch and a duplicate name each raising its
  own class on every rank; then full-width ResNet-50 (batch 64 a rank,
  synthetic data from ``--seed`` plus the rank), 2 warm-up and 5 timed
  steps each: (k2) the dense ``DistributedOptimizer`` through the core
  (the weights bitwise equal across the ranks; step, backward and the
  hooks' stream wait, peak memory, bytes staged each way, the core's wire
  bytes and transports), (k5) ``join``: the last rank takes one step more,
  its reduction is its own gradient over the world, and ``join()``
  returns that rank everywhere, (k3) 4-bit max-min with error feedback
  through the eager process-compressed path (B1 once and B4 ranks + 1
  times a step, B4 on the packed route; weights bitwise equal), (k6)
  ZeRO-1 Adam over the core's reduce-scatter and allgather (weights
  bitwise equal; the Adam state of the shard, published to the core's
  gauge), and (k4) the core's int4 wire on a world of its own (2 + 3
  steps; fewer bytes sent than raw).

* phase (l), elastic training: the port's elastic launcher
  (``python -m horovod_tpu_torch.runner.launch -np 2 --min-np 2 --max-np
  3 --host-discovery-script S``) runs this script's ``--elastic-worker``:
  ``hvd.init(device="cuda:0")`` in process mode under the driver,
  full-width ResNet-50 (batch 64 a rank, bf16 autocast, synthetic data
  from ``--seed``, the batch and the rank) through 4-bit max-min with
  error feedback (B1, B4), an ``hvd.elastic.TorchState`` committed every
  batch, for 12 batches. ``S`` prints ``localhost:2``; after its commit of
  batch 3 rank 0 adds ``127.0.0.1:1``, the ranks commit until the
  driver's new round interrupts them, and the world of 3 syncs from rank
  0; the worker of ``127.0.0.1`` dies (``os._exit(7)``) before its step of
  batch 6; the survivors get ``HvdTpuInternalError``, restore their
  commit and go on as a world of 2, the driver having blacklisted
  ``127.0.0.1``. Checked: the launcher exits 0, the two finishers are on
  ``localhost`` at batch 12 with the same weights, every sync leaves
  every rank the same weights, each survivor's weights after the restore
  are its commit of batch 6, every step launched B1 once and B4 size + 1
  times, and no segment is left in ``/dev/shm``. Logged: the median step
  ms at each world size, the scale-up seconds (hosts file rewritten ->
  first step at size 3), and the recovery seconds as
  ``hvdtpu_recovery_seconds`` records them and as the driver sees them
  (failure -> world of 2 formed). Where the card allows one context only,
  its ``solo`` form runs instead: one worker, commits also on disk, the
  worker dies before batch 5 and the one that replaces it resumes from
  the disk with the committed weights, bitwise.

``DistributedOptimizer`` reduces from gradient hooks: every timed step of
a training phase must launch its reductions before ``loss.backward()``
returns (the quantized group of a ResNet-50 phase, in the second pass with
``backward_passes_per_step=2`` and none in the first; at least 3 dense
buckets of the GPT path). Each path takes 2 warm-up and 10 timed steps. The script checks that the
loss is finite and falls, that the steps launched each kernel of the path
as often as the path requires (and no other kernel; every B7, B8 and B9
launch of the GPT path on its tensor-core route, every B5 launch on the
packed bisection route and every B2 launch on the packed route), and that
the trained model of the first ResNet-50 path and of the GPT path agrees
with a CPU copy of itself on a small input; every B3 and B4 launch of the
max-min phases must read the packed payload (route ``packed``). Then it
times each kernel, its plain version and, where one exists, the PyTorch
call that computes the same function, at the shapes of the path (the
attention kernels and B4 in alternating rounds with that call; B2, B5, B3
and B4 in alternating rounds with their packed route on an input that is
not aligned, with the card's clocks read before and after).
``--parent DIR``, a checkout of the parent commit, adds the parent's B9
(the ``mma.sync`` design this tree's ``wgmma`` kernel replaces), built
from its own sources, to the attention rounds, causal and non-causal,
beside this tree's B9 and SDPA's backward, and holds it to the same bound
of the plain version. B7, B8
and B9 are held against their plain versions at
each shape the paths give them (the GPT path's, the encoder's non-causal
one and the pipeline's micro-batch), and also timed non-causal at the
encoder's shape (the GPT path's), beside ``scaled_dot_product_attention
(is_causal=False)``: the ``noncausal_*`` fields of their rows.

Output: the card's name and power limit as ``nvidia-smi`` reports them, a
``{"kernels": [...]}`` JSON line, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before the
JSON lines; so does a machine without CUDA, or a directory without the
package.
"""

from __future__ import annotations

import argparse
import collections
import copy
import dataclasses
import gc
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

BITS, BUCKET = 4, 512
RESNET50_PARAMS = 25_557_032  # the fused gradient buffer of the path
BATCH, IMAGE = 64, 224
WARMUP, STEPS = 2, 10
LR = 0.1 * BATCH / 256  # linear scaling: 10 steps without warm-up
# bench.py's gpt_long_context_flash phase, at full width and depth.
GPT_CONFIG = dict(vocab_size=32000, num_layers=6, num_heads=8, head_dim=64,
                  embed_dim=512, mlp_dim=2048, attention="flash",
                  remat="full")
GPT_PARAMS = 51_649_024
GPT_BATCH, GPT_SEQ, GPT_LR = 2, 4096, 1e-3
# The least number of the GPT path's dense buckets (206.6 MB of fp32
# gradients, buckets of 64 MiB) that must launch before backward returns.
GPT_HOOK_LAUNCHES = 3
REPLACES = {
    "maxmin_quantize":
        "horovod_tpu/compression/pallas_kernels.py:163",
    "maxmin_quantize_stochastic":
        "horovod_tpu/compression/pallas_kernels.py:228",
    "maxmin_dequantize_sum":
        "horovod_tpu/compression/pallas_kernels.py:283",
    "maxmin_dequantize":
        "horovod_tpu/compression/pallas_kernels.py:317",
    "norm_quantize": "horovod_tpu/compression/pallas_kernels.py:75",
    "norm_dequantize": "horovod_tpu/compression/pallas_kernels.py:132",
    "flash_fwd": "horovod_tpu/ops/flash_attention.py:93",
    "flash_dkdv": "horovod_tpu/ops/flash_attention.py:146",
    "flash_dq": "horovod_tpu/ops/flash_attention.py:192",
}
SOURCES = {"maxmin": "horovod_tpu_torch/csrc/maxmin.cu",
           "norm": "horovod_tpu_torch/csrc/norm.cu",
           "flash": "horovod_tpu_torch/csrc/flash_attention.cu",
           "flash_wgmma": "horovod_tpu_torch/csrc/flash_attention_wgmma.cu"}
# The kernel that runs each attention wrapper at the GPT path's shape (bf16,
# on the tensor cores, as the route counts confirm).
FLASH_KERNELS = {
    "flash_fwd": ("flash_fwd_wgmma_kernel<64>", "flash_wgmma"),
    "flash_dkdv": ("flash_dkdv_wgmma_kernel<64>", "flash_wgmma"),
    "flash_dq": ("flash_dq_wgmma_kernel<64>", "flash_wgmma"),
}
# The route of every bf16 launch of each attention kernel (every fp32
# launch: "fp32").
BF16_ROUTES = dict.fromkeys(("flash_fwd", "flash_dkdv", "flash_dq"),
                           "wgmma_bf16")
# Launches a step of each path (the launch counts of every other kernel
# must stay 0): the max-min reducer quantizes the rows and the reduced
# chunk, decodes the rows for the residual and the gathered chunks, and
# sums the exchanged rows in one B3; the normalized quantizer's generic
# dequantize-sum decodes every rank's row in one B6 launch.
PATH_LAUNCHES = {
    "resnet": {"maxmin_quantize": 2, "maxmin_dequantize_sum": 1,
               "maxmin_dequantize": 2},
    "vgg16": {"maxmin_quantize": 2, "maxmin_dequantize_sum": 1,
              "maxmin_dequantize": 2},
    "resnet_uni": {"norm_quantize": 2, "norm_dequantize": 3},
    "inception_v3": {"norm_quantize": 2, "norm_dequantize": 3},
    "vgg16_powersgd": {},
    "resnet_stochastic": {"maxmin_quantize_stochastic": 2,
                          "maxmin_dequantize_sum": 1,
                          "maxmin_dequantize": 2},
}
# The route every launch of a phase's packed kernels must take: the
# buckets of 512 are read once into registers and the codes written packed;
# the uniform table is searched by bisection; B3 and B4 read the packed
# payload as it crossed the wire.
DECODE_ROUTES = {"maxmin_dequantize_sum": "packed",
                 "maxmin_dequantize": "packed"}
PATH_ROUTES = {"resnet": DECODE_ROUTES, "vgg16": DECODE_ROUTES,
               "resnet_uni": {"norm_quantize": "packed_search"},
               "inception_v3": {"norm_quantize": "packed_search"},
               "resnet_stochastic": {"maxmin_quantize_stochastic": "packed",
                                     **DECODE_ROUTES}}
# The mesh phases: 2 warm-up and 5 timed steps each.
MESH_WARMUP, MESH_STEPS = 2, 5
# The model-parallel phases' B7, B8 and B9 launches a step (every other
# kernel's 0, every launch on the tensor cores): B7 once a layer in the
# forward and once more in the recompute of remat "full" or "dots" (the
# kernel's outputs are never kept), B8 and B9 once a layer in backward. The
# Ulysses phase runs them behind its all-to-alls and the MoE phase beside
# its switch blocks; ring attention is plain PyTorch and launches none; the
# pipeline recomputes its 6 layers at each of 2 micro-batches
# (``remat=True``, blocks without remat of their own); the encoder's 4
# layers run without recompute, non-causal.
GPT_LAYERS = GPT_CONFIG["num_layers"]
MP_LAUNCHES = {
    "gpt_ulysses_flash": {"flash_fwd": 2 * GPT_LAYERS,
                          "flash_dkdv": GPT_LAYERS, "flash_dq": GPT_LAYERS},
    "gpt_ring": {},
    "gpt_moe": {"flash_fwd": 2 * GPT_LAYERS, "flash_dkdv": GPT_LAYERS,
                "flash_dq": GPT_LAYERS},
    "gpt_remat_none": {"flash_fwd": GPT_LAYERS, "flash_dkdv": GPT_LAYERS,
                       "flash_dq": GPT_LAYERS},
    "gpt_remat_full": {"flash_fwd": 2 * GPT_LAYERS,
                       "flash_dkdv": GPT_LAYERS, "flash_dq": GPT_LAYERS},
    "gpt_remat_dots": {"flash_fwd": 2 * GPT_LAYERS,
                       "flash_dkdv": GPT_LAYERS, "flash_dq": GPT_LAYERS},
    "gpt_pipeline": {"flash_fwd": 2 * 2 * GPT_LAYERS,
                     "flash_dkdv": 2 * GPT_LAYERS, "flash_dq": 2 * GPT_LAYERS},
    "encoder": {"flash_fwd": 4, "flash_dkdv": 4, "flash_dq": 4},
}
# The switch phase (JAX defaults): 8 experts, capacity factor 1.25, every
# second block; 8,192 tokens give each expert ceil(8192 * 1.25 / 8) slots.
MOE = dict(moe_every=2, num_experts=8, capacity_factor=1.25)
MOE_CAPACITY = 1280
# The mesh and GPTConfig fields of the model-parallel GPT phases (a)-(c).
MP_PATHS = {
    "gpt_ulysses_flash": ({"dp": 1, "tp": 1, "sp": 1},
                          dict(attention="ulysses_flash")),
    "gpt_ring": ({"dp": 1, "tp": 1, "sp": 1}, dict(attention="ring")),
    "gpt_moe": ({"dp": 1, "ep": 1}, dict(ep_axis="ep", **MOE)),
}
PIPE_MICRO = 2  # micro-batches of one 4096-token sequence
# The JAX Encoder's defaults, trained on 2 x 4096 tokens with 15% masked.
ENCODER_CONFIG = dict(vocab_size=32000, num_layers=4, num_heads=8,
                      head_dim=64, embed_dim=512, mlp_dim=2048)
ENCODER_LR, MASK_SHARE, MASK_ID = 1e-3, 0.15, 0
# The vision phases (g)-(j): VGG-16 (138,357,544 parameters) through
# 4-bit max-min and through PowerSGD, Inception V3 (23,834,568 in 284
# leaves, 299x299) through the normalized quantizer, and the A/B
# calibration of the compressed hierarchical allreduce, each 2 warm-up and
# 10 timed steps (the calibration: its own calls). VGG's learning rate is
# chosen once, SGD's 0.01 with momentum 0.9 (the paper's, for a batch of
# 256): without batch norm at lecun-normal init the loss falls slowly.
VGG16_PARAMS = 138_357_544
VGG_CFG = None  # VGG-16's (a rehearsal on the CPU narrows it)
VGG_IMAGE, VGG_LR, VGG_RESUME_AT = 224, 0.01, 5
INCEPTION_PARAMS, INCEPTION_LEAVES = 23_834_568, 284
INCEPTION_IMAGE = 299
POWERSGD_RANK = 4
# Floats a rank sends a step under PowerSGD at rank 4 (P and Q of the 16
# weight matrices in torch's layout, and the 16 biases dense), against the
# dense gradients' 138,357,544.
POWERSGD_WIRE = (320_524, 13_416)
# autotune_compressed's calls of the compressed allreduce: a warm-up and
# AUTOTUNE_REPS timed calls at each of the two sizes; each is the max-min
# reducer without a residual: B1 twice (the rows and the reduced chunk),
# B3 once and B4 once (the gathered chunks; no residual to decode).
AUTOTUNE_SIZES, AUTOTUNE_REPS = (1 << 20, 16 << 20), 5
AUTOTUNE_CALLS = len(AUTOTUNE_SIZES) * (1 + AUTOTUNE_REPS)
AUTOTUNE_LAUNCHES = {"maxmin_quantize": 2, "maxmin_dequantize_sum": 1,
                     "maxmin_dequantize": 1}
# Suffixes of the fields each path's shape gives a kernel row: the main
# path's (ResNet-50's buffer) has none; (j)'s are its two sizes in fp32
# values (262,144 and 4,194,304: 512 and 8,192 buckets).
SHAPES = {RESNET50_PARAMS: "", VGG16_PARAMS: "_at_vgg16",
          INCEPTION_PARAMS: "_at_inception_v3",
          **{n // 4: f"_at_autotune_{n >> 20}mib" for n in AUTOTUNE_SIZES}}
# The other paths' buffers whose kernels are timed beside the main path's:
# suffix: (values, phase, kernels).
AT_SHAPES = {
    "_at_vgg16": (VGG16_PARAMS, "vgg16", (
        "maxmin_quantize", "maxmin_dequantize_sum", "maxmin_dequantize")),
    "_at_inception_v3": (INCEPTION_PARAMS, "inception_v3", (
        "norm_quantize", "norm_dequantize"))}
SYNC_BN_LAYERS = 53  # ResNet-50's batch norms
ZERO_LR = 1e-3
# Adam keeps two fp32 state tensors of the shard's length: at a world of
# one the shard is every parameter, 2 x 51,649,024 x 4 bytes.
ZERO_STATE_BYTES = 2 * GPT_PARAMS * 4
# The fused Adasum combine on the card against the float64 reference: each
# tensor's result within 1e-5 of its largest magnitude. The partials are
# float64 prefix sums rounded once to fp32; the combine rounds a·coeff and
# b·coeff and their sum in fp32 (a few 2^-24 of the magnitude), and the
# reference's first pairs are rounded to fp32 by nothing.
ADASUM_TOL = 1e-5
ADASUM_RANKS = 4
# B3 at a world of 4: the scatter_allgather chunk of the ResNet path's
# gradient buffer (12,480 buckets of 512) from each of 4 ranks.
B3_RANKS, B3_RANK_BUCKETS = 4, 12_480
# The least work B2's function needs a value, in issue slots (one warp
# instruction a lane; an FMA takes one): Philox4x32-10 is 10 rounds of two
# 32x32->64-bit multiplies, which the card issues at half rate (2 slots
# each), and two three-input XORs, shared by the 4 values of a counter;
# then the subtraction of the bucket's min, the division by its unit (a
# multiply and two FMAs on a reciprocal the bucket shares), the noise (the
# 24-bit mask and its conversion; its scale by 2^-24 joins the add in one
# FMA), the code (that FMA, floor, two clamps, the conversion), its packing
# (one shift-or), and the bucket's min and max. Whatever a build adds to
# this is the kernel's cost, not the function's.
B2_SLOTS = {"philox": 10 * (2 * 2 + 2) / 4, "subtract min": 1, "divide": 3,
            "noise": 2, "code": 5, "pack": 1, "min and max": 2}
# Data-sheet rates (dense, no sparsity): device-memory bytes/s, fp32
# operations/s outside the tensor cores, bf16 tensor-core operations/s.
RATES = {"H100 PCIe": (2.0e12, 51e12, 756e12),
         "H100 NVL": (3.9e12, 60e12, 835e12),
         "H100": (3.35e12, 67e12, 989e12),
         "H200": (4.8e12, 67e12, 989e12)}
# Attention kernels against their plain versions (both fp32 math on the
# same unit-normal inputs). fp32 outputs: within 1e-4 (forward, and lse
# always) and 5e-4 (backward) of the largest reference value, taken as at
# least 1. bf16 outputs, element by element: both sides round an fp32 value
# to bf16, so they may land one bf16 step apart, which is at most 2^-7 of
# the value; plus 2^-8 of the mean |value| and 2^-14 for values near zero,
# where the fp32 sums differ by more than a bf16 step of the value (at S 1,
# dK and dQ are zero in exact arithmetic and rounding noise in both). bf16
# B7, B8 and B9 run on the tensor cores, which round P and dS to bf16
# before their products: o, dK, dV and dQ also get flash.mma_rounding_terms
# (4 x 2^-8 times the root-sum-square of rounded operand x other operand of
# each product). At the path's shape a 2% error planted in the rows with
# the longest sums must fail that bound.
FLASH_TOL = (1e-4, 5e-4)
PLANTED = 0.02
FLASH_ROUNDS = 5  # alternating timing rounds of each attention kernel
GRAPH_REPLAYS = 5  # replays of a captured graph of timed calls
# Copies of a timed decode's inputs, and its outputs kept alive, that its
# calls cycle through: B3 at 4 ranks moves 38 MB a call, under the card's
# 50 MB L2, so one buffer reused would be timed from the cache.
ROTATE = 4
BF16_TOL = (2**-7, 2**-8, 2**-14)  # of |value|, of mean |value|, absolute
# Phase (k), the process-mode native core: two ranks share the card (one
# where its compute mode allows one context), 2 warm-up and MESH_STEPS
# timed steps a sub-phase, the int4 wire world PROCESS_WIRE_STEPS; the
# ranks must finish within PROCESS_TIMEOUT seconds.
PROCESS_RANKS, PROCESS_WIRE_STEPS, PROCESS_TIMEOUT = 2, 3, 420
# Phase (l): batches of the elastic job, the batch whose commit adds the
# third worker and the one before which it dies (the solo form's death),
# how long the ranks wait for the driver's new round, and the whole job's
# limit in seconds.
ELASTIC_BATCHES, ELASTIC_GROW_AT, ELASTIC_DIE_AT = 12, 3, 6
ELASTIC_SOLO_DIE_AT, ELASTIC_GROW_WAIT, ELASTIC_TIMEOUT = 5, 60, 300


def log(msg: str) -> None:
    print(msg, flush=True)


def card_rates(name: str):
    for key in sorted(RATES, key=len, reverse=True):
        if all(word in name for word in key.split()):
            return RATES[key]
    raise RuntimeError(f"no data-sheet rates for {name!r}")


def time_ms(fn, iters: int = 20, graph: bool = False) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls.
    With ``graph`` the calls are captured once in a CUDA graph and the
    graph is replayed ``GRAPH_REPLAYS`` times, so that the host's cost of
    launching them (the wrappers' checks and allocations, comparable to a
    kernel of 0.05 ms) is not timed: what is left is the device's time."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            for _ in range(iters):
                fn()
        captured.replay()
        torch.cuda.synchronize()
        start.record()
        for _ in range(GRAPH_REPLAYS):
            captured.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (iters * GRAPH_REPLAYS)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bitwise(got, want) -> bool:
    """Equal values, and NaN exactly where the other has NaN."""
    return got.shape == want.shape and bool(
        (torch.eq(got, want) | (torch.isnan(got) & torch.isnan(want))).all()
        if got.is_floating_point() else torch.equal(got, want))


def check_kernels(kernels, dev, sizes):
    """Every kernel against its plain version on the card; returns the
    largest error of each at the shape of each path (``sizes``: values of
    the fused buffer; the errors keyed by name and ``SHAPES`` suffix). B1
    bitwise: at the paths' shapes, on random values and on ones (the
    constant buckets ``autotune_compressed`` feeds), then ragged sizes
    with a constant first bucket and, where there is room, a bucket
    holding a NaN and one holding an inf, at 1, 2, 4 and 8 bits and
    buckets of 64, 512 and 100 (not a multiple of 8). B4
    bitwise on each of B1's results in four forms, all decoding to the same
    values: packed as ``compress`` packs it (one row), the byte codes at 8
    bits, the packed row one byte into a buffer, and packed in rows as
    ``compress_rows`` packs them (:func:`decode_rows`). B3 bitwise at 1 to
    4 ranks: at the path's shape, on B1's payload of the path's inputs at
    one rank, then at 1, 2, 4 and 8 bits, buckets of 64, 512 and 100,
    aligned and one byte into a buffer. Every B3 and B4
    launch on the route its bucket asks for."""
    from horovod_tpu_torch.compression.quantize import pack_bits

    gen = torch.Generator(device=dev).manual_seed(1)
    errors = {}
    cases = [(n, BITS, BUCKET, values) for n in sizes
             for values in ("random", "ones")] + [
        (n, bits, bucket, "special") for n in (1, 511, 513, 100_003)
        for bits in (1, 2, 4, 8) for bucket in (64, 512, 100)]
    for n, bits, bucket, values in cases:
        where = f"n={n} bits={bits} bucket={bucket} values={values}"
        special = values == "special"
        x = special_values(gen, dev, n, bucket) if special else \
            torch.ones(n, device=dev) if values == "ones" else \
            torch.randn(n, generator=gen, device=dev) * 1e-2
        got = kernels.maxmin_quantize(x, bits, bucket)
        want = kernels.maxmin_quantize_plain(x, bits, bucket)
        for g, w, what in zip(got, want, ("codes", "min", "unit")):
            if not bitwise(g, w):
                raise AssertionError(f"B1 {what} differ at {where}")
        q, mn, unit = got
        packed = pack_bits(q.view(1, -1), bits)
        rows = decode_rows(q.shape[0])
        forms = {"packed": (packed, bits), "bytes": (q, 8),
                 "misaligned": (at_offset(packed, 1), bits),
                 f"{rows} rows": (pack_bits(q.view(rows, -1), bits), bits)}
        decoded = []
        for form, (codes, width) in forms.items():
            back, route = routed(kernels, "maxmin_dequantize",
                                 lambda: kernels.maxmin_dequantize(
                                     codes, mn, unit, width, bucket))
            check_route("B4", route, bucket, f"{where} {form}")
            if not bitwise(back, kernels.maxmin_dequantize_plain(
                    codes, mn, unit, width, bucket)):
                raise AssertionError(f"B4 differs at {where} {form}")
            decoded.append(back)
        if not all(bitwise(d, decoded[0]) for d in decoded):
            raise AssertionError(f"B4's forms decode differently at {where}")
        if special and n > 2 * bucket and not (
                torch.isnan(back[1:3]).all() and
                torch.isfinite(back[0]).all()):
            raise AssertionError(f"a NaN or inf bucket decoded to a number "
                                 f"at {where}")
        if special:
            continue
        summed, route = routed(kernels, "maxmin_dequantize_sum",
                               lambda: kernels.maxmin_dequantize_sum(
                                   packed, mn[None], unit[None], bits,
                                   bucket))
        check_route("B3", route, bucket, where)
        plain_sum = kernels.maxmin_dequantize_sum_plain(
            packed, mn[None], unit[None], bits, bucket)
        if not bitwise(summed, plain_sum):
            raise AssertionError(f"B3 differs on B1's payload at {where}")
        for name, err in (
                ("maxmin_dequantize_sum", float(
                    (summed - plain_sum).nan_to_num(0.0).abs().max())),
                ("maxmin_quantize", max(float((g.float() - w.float()).abs()
                                              .max())
                                        for g, w in zip(got, want))),
                ("maxmin_dequantize", float(
                    (decoded[0] - kernels.maxmin_dequantize_plain(
                        packed, mn, unit, bits, bucket)).abs().max()))):
            key = name + SHAPES[n]
            errors[key] = max(errors.get(key, 0.0), err)
    path_buckets = {-(-n // BUCKET): n for n in sizes}
    sums = [(n_ranks, buckets, BITS, BUCKET, 0) for buckets in path_buckets
            for n_ranks in (1, 2, 3, 4)] + [
        (n_ranks, 1001, bits, bucket, shift)
        for n_ranks in (1, 2, 3, 4) for bits in (1, 2, 4, 8)
        for bucket in (64, 512, 100) for shift in (0, 1)]
    for n_ranks, buckets, bits, bucket, shift in sums:
        where = (f"n_ranks={n_ranks} n_buckets={buckets} bits={bits} "
                 f"bucket={bucket} shift={shift}")
        q, mn, unit = packed_ranks(gen, dev, n_ranks, buckets, bits, bucket)
        q = at_offset(q, shift)
        got, route = routed(kernels, "maxmin_dequantize_sum",
                            lambda: kernels.maxmin_dequantize_sum(
                                q, mn, unit, bits, bucket))
        check_route("B3", route, bucket, where)
        want = kernels.maxmin_dequantize_sum_plain(q, mn, unit, bits, bucket)
        if not bitwise(got, want):
            raise AssertionError(f"B3 differs at {where}")
        if buckets in path_buckets and n_ranks == 1 and bits == BITS:
            # Bitwise, NaN for NaN: the largest error of the numbers.
            key = "maxmin_dequantize_sum" + SHAPES[path_buckets[buckets]]
            errors[key] = max(errors[key], float(
                (got - want).nan_to_num(0.0).abs().max()))
    torch.cuda.synchronize()
    return errors


def check_route(kernel: str, route: str, bucket: int, where: str) -> None:
    """B3 and B4 take the packed route for a bucket of a multiple of 8, at
    any address, and the generic one for any other."""
    if route != ("packed" if bucket % 8 == 0 else "generic"):
        raise AssertionError(f"{kernel} took route {route} at {where}")


def decode_rows(n_buckets: int) -> int:
    """Rows of a ``compress_rows``-like payload of ``n_buckets`` buckets:
    the first of 7, 3 and 2 that divides it (at 1 bit and buckets of 100
    a row of an odd count of buckets ends inside a byte), else 1."""
    return next((r for r in (7, 3, 2) if n_buckets % r == 0), 1)


def packed_ranks(gen, dev, n_ranks: int, n_buckets: int, bits: int,
                 bucket: int):
    """B3's input: each rank's packed row of random codes, ``min`` and
    ``unit`` ``[n_ranks, n_buckets]``, with a NaN min and an infinite unit
    in rank 0's first and last buckets."""
    from horovod_tpu_torch.compression.quantize import pack_bits

    codes = torch.randint(0, 1 << bits, (n_ranks, n_buckets * bucket),
                          generator=gen, device=dev, dtype=torch.uint8)
    mn = torch.randn(n_ranks, n_buckets, generator=gen, device=dev)
    unit = torch.rand(n_ranks, n_buckets, generator=gen,
                      device=dev) / ((1 << bits) - 1)
    mn[0, 0], unit[0, -1] = float("nan"), float("inf")
    return pack_bits(codes, bits), mn, unit


def special_values(gen, dev, n: int, bucket: int) -> torch.Tensor:
    """Small gradient-like values; where there is room, a constant first
    bucket, a bucket holding a NaN and one holding an inf."""
    x = torch.randn(n, generator=gen, device=dev) * 1e-2
    x[:bucket] = 0.25
    x[bucket + 1:bucket + 2] = float("nan")
    x[2 * bucket + 3:2 * bucket + 4] = float("inf")
    return x


def at_offset(x: torch.Tensor, shift: int) -> torch.Tensor:
    """``x`` as a view ``shift`` elements into a new buffer (at shift 1 the
    address of fp32 values is not a multiple of 16 bytes, that of uint8
    codes not a multiple of 2, 4 or 8)."""
    buf = x.new_zeros(x.numel() + shift)
    buf[shift:] = x.reshape(-1)
    return buf[shift:].view(x.shape)


# Divisors that are hard for a division through a refined reciprocal
# (hvd_groups::divide): significands of all ones, just above 1 and just
# below 2 and 1.5, over magnitudes inside the range it checks (2^-40 to
# 2^40), at both of its ends and outside them (where __fdiv_rn runs).
HARD_SIGNIFICANDS = (2 - 2**-23, 1 + 2**-23, 1 + 2**-22, 2 - 2**-22,
                     1.5 - 2**-23, 1.5 + 2**-23, 1.75 + 2**-23, 1.0)
HARD_EXPONENTS = (-100, -60, -41, -40, -39, -20, -1, 0, 1, 20, 39, 40, 41,
                  60, 100)
HARD_TARGETS = 25


def hard_divisors(bucket: int, seed: int):
    """Values that pin B5's quotient ``|x| / norm`` to the ulp, with their
    level table: one bucket for each divisor of ``HARD_SIGNIFICANDS`` x
    ``HARD_EXPONENTS``, holding that divisor (the linf norm), values
    fl(q d) for ``HARD_TARGETS`` quotients q, random signs, and a few
    zeros and values below 2^-40 d (the per-value range check). The table
    holds each q and the 2 fp32 values on either side of it, and 0: every
    quotient that is fl(q d) / d rounded lands on an entry, and so does
    each of its fp32 neighbours, so the code of every such value tells its
    quotient to the ulp. Returns float32 numpy arrays (x, table)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    f32 = np.float32
    # Quotients in [2^-5, 1) away from the ends of their binade.
    q = np.ldexp(1 + rng.randint(8, 2**23 - 8, HARD_TARGETS) / 2.0**23,
                 -rng.randint(1, 6, HARD_TARGETS)).astype(f32)
    near = [q]
    for direction in (np.inf, -np.inf):
        step = q
        for _ in range(2):
            step = np.nextafter(step, f32(direction))
            near.append(step)
    table = np.unique(np.concatenate(near + [np.zeros(1, f32)]))[::-1]
    if table.shape[0] != 5 * HARD_TARGETS + 1:
        raise AssertionError("hard_divisors: targets overlap")
    divisors = np.array([np.ldexp(s, e) for s in HARD_SIGNIFICANDS
                         for e in HARD_EXPONENTS])
    pick = rng.randint(0, HARD_TARGETS, (divisors.shape[0], bucket))
    x = (q[pick].astype(np.float64) * divisors[:, None]).astype(f32)
    x[:, bucket // 2:bucket // 2 + 2] = 0
    x[:, 3] = (divisors * 2.0**-45).astype(f32)
    x[:, 0] = divisors.astype(f32)
    x *= rng.choice(np.array([-1, 1], f32), x.shape)
    return x.reshape(-1), np.ascontiguousarray(table)


def routed(module, name: str, fn):
    """``fn()`` and the route its one launch of kernel ``name`` took."""
    before = dict(module.ROUTES[name])
    out = fn()
    taken = [r for r, count in module.ROUTES[name].items()
             if count != before[r]]
    if len(taken) != 1:
        raise AssertionError(f"{name}: routes {before} -> "
                             f"{module.ROUTES[name]}")
    return out, taken[0]


def check_stochastic(kernels, dev, n_values: int):
    """B2 bitwise against its plain version (the same Philox words): at the
    path's shape, then ragged sizes with special buckets, buckets whose
    counters straddle two buckets (125, the byte-code route), views at an
    offset of one value (read one value at a time on the packed route),
    64-bit seeds and offsets, and buckets whose units are the divisors of
    :func:`hard_divisors` (min 0, max the divisor: at 1 bit the unit is the
    divisor itself). Min, unit and byte codes are bitwise; the packed
    route's payload is bitwise against ``pack_bits`` of the plain codes.
    Returns the largest error at the path's shape and the launches by
    route."""
    from horovod_tpu_torch.compression.quantize import pack_bits

    gen = torch.Generator(device=dev).manual_seed(2)
    cases = [(n_values, BITS, BUCKET, 0, 0, False, 0)] + [
        (n, bits, bucket, seed, offset, True, shift)
        for n in (1, 511, 513, 100_003) for bits in (1, 2, 4, 8)
        for bucket in (64, 125, 512)
        for seed, offset, shift in ((0, 0, 0), (2**40 + 3, 2**33 + 1, 0),
                                    (5, 7, 1))] + [
        (None, bits, bucket, 9, 0, "hard", shift) for bits in (1, 8)
        for bucket in (64, 512) for shift in (0, 1)]
    error, routes = None, {}
    for n, bits, bucket, seed, offset, special, shift in cases:
        if special == "hard":
            # min 0 (the zeros), max the divisor
            x = torch.from_numpy(abs(hard_divisors(bucket, bits)[0])).to(dev)
            n = x.shape[0]
        elif special:
            x = special_values(gen, dev, n, bucket)
        else:
            x = torch.randn(n, generator=gen, device=dev) * 1e-2
        where = (f"n={n} bits={bits} bucket={bucket} seed={seed} "
                 f"offset={offset} shift={shift} values={special}")
        x = at_offset(x, shift)
        got, route = routed(kernels, "maxmin_quantize_stochastic",
                            lambda: kernels.maxmin_quantize_stochastic(
                                x, bits, bucket, seed, offset))
        want = kernels.maxmin_quantize_stochastic_plain(x, bits, bucket,
                                                        seed, offset)
        if route != ("packed" if bucket % 8 == 0 else "bytes"):
            raise AssertionError(f"B2 took route {route} at {where}")
        routes[route] = routes.get(route, 0) + 1
        if route == "packed":
            want = (pack_bits(want[0], bits),) + want[1:]
        for g, w, what in zip(got, want, ("codes", "min", "unit")):
            if not bitwise(g, w):
                raise AssertionError(f"B2 {what} differ at {where}")
        if error is None:
            error = max(float((g.float() - w.float()).abs().max())
                        for g, w in zip(got, want))
    torch.cuda.synchronize()
    return error, routes


def norm_tables(bits: int):
    """The level tables ``check_norm`` codes against: uniform and
    exponential (bisection), and two that take the scan: the uniform table
    rotated by one (unsorted) and one with equal neighbours."""
    import numpy as np
    from horovod_tpu_torch.compression.quantize import default_levels

    uni = default_levels(bits, "uni")
    return {"uni": uni, "exp": default_levels(bits, "exp"),
            "unsorted": np.roll(uni, 1),
            "equal": np.repeat(uni[::2], 2)[:uni.shape[0]]}


def planted(table, gen, dev, n: int, bucket: int) -> torch.Tensor:
    """Buckets whose largest magnitude is 1, so the linf ratio is |x|
    itself, filled with the table's levels, the midpoints of neighbouring
    levels and the fp32 neighbours of both, with random signs: every tie
    and near-tie of the search."""
    import numpy as np

    lv = torch.from_numpy(np.sort(table)[::-1].copy()).to(dev)
    mid = (lv[1:] + lv[:-1]) / 2
    probes = torch.cat([lv, mid])
    probes = torch.cat([probes, torch.nextafter(probes, probes + 1),
                        torch.nextafter(probes, probes - 1)])
    probes = probes[probes.abs() <= 1]
    pick = torch.randint(0, probes.shape[0], (n,), generator=gen,
                         device=dev)
    sign = torch.randint(0, 2, (n,), generator=gen, device=dev) * 2 - 1
    x = probes[pick] * sign
    x[::bucket] = 1.0
    return x


def level_steps(levels: torch.Tensor, got: torch.Tensor,
                want: torch.Tensor) -> torch.Tensor:
    """How many distinct level values apart the levels of two code arrays
    are: the index step of a descending table, and the step between the
    values of a table that is unsorted or repeats a level."""
    distinct = torch.unique(levels)
    ranks = [torch.searchsorted(distinct, levels[(q >> 1).long()])
             for q in (got, want)]
    return (ranks[0] - ranks[1]).abs()


def check_norm(norm_kernels, dev, sizes):
    """B5 and B6 against their plain versions: at each path's shape
    (``sizes``, the main path's first: 4 bits, uniform levels, linf),
    then n in {1, 511, 513, 100003} x bits {2, 4, 8} x uniform or exponential levels x linf or l2 x buckets of 64, 125 or
    512, with special buckets, and l2 and 8 bits at the path's shape; then
    at 100003 values, for each bits and norm: the two scan tables of
    :func:`norm_tables`, a view at an offset of one value (the packed
    route, read one value at a time), and buckets planted with every level,
    midpoint and their neighbours (:func:`planted`); last, at 8 bits and
    linf, the quotients of :func:`hard_divisors`, each pinned to the ulp by
    its table, in buckets of 64 and 512, aligned and at an offset. The
    kernel gets each searchable table as a ``LevelTable`` and the others
    as a plain tensor, which it checks itself. linf codes and norms are
    bitwise, the packed payload against ``pack_bits`` of the plain codes;
    l2 norms sum in another order and agree to rtol 1e-6, and a code may
    then take the neighbouring level (by value: :func:`level_steps`) where
    the ratio lies within a few ulp of a midpoint (never another sign). B6
    is bitwise on the kernel's codes, and with a 2-entry table (the clip).
    Returns the largest errors at the path's shape, the count of l2
    midpoint codes over all cases and the launches by route."""
    from horovod_tpu_torch.compression.quantize import pack_bits, unpack_bits

    gen = torch.Generator(device=dev).manual_seed(3)
    n_values = sizes[0]
    cases = [(n, 4, "uni", "linf", BUCKET, "path", 0) for n in sizes] + [
             (n_values, 4, "uni", "l2", BUCKET, "path", 0),
             (n_values, 8, "uni", "linf", BUCKET, "path", 0)] + [
        (n, bits, kind, norm, bucket, "special", 0)
        for n in (1, 511, 513, 100_003) for bits in (2, 4, 8)
        for kind in ("uni", "exp") for norm in ("linf", "l2")
        for bucket in (64, 125, 512)] + [
        (100_003, bits, kind, norm, BUCKET, values, shift)
        for bits in (2, 4, 8) for norm in ("linf", "l2")
        for kind, values, shift in (
            ("unsorted", "special", 0), ("equal", "special", 0),
            ("uni", "special", 1), ("uni", "planted", 0),
            ("exp", "planted", 0), ("uni", "planted", 1))] + [
        (None, 8, "hard", "linf", bucket, "hard", shift)
        for bucket in (64, 512) for shift in (0, 1)]
    errors, midpoints, routes = {}, 0, {}
    for n, bits, kind, norm, bucket, values, shift in cases:
        if values == "hard":
            x, table = hard_divisors(bucket, bucket + shift)
            x = torch.from_numpy(x).to(dev)
            n = x.shape[0]
        else:
            table = norm_tables(bits)[kind]
        if values == "planted":
            x = planted(table, gen, dev, n, bucket)
        elif values == "special":
            x = special_values(gen, dev, n, bucket)
        elif values == "path":
            x = torch.randn(n, generator=gen, device=dev) * 1e-2
        x = at_offset(x, shift)
        where = (f"n={n} bits={bits} levels={kind} norm={norm} "
                 f"bucket={bucket} values={values} shift={shift}")
        search = norm_kernels.searchable(table)
        levels = torch.from_numpy(table).to(dev)
        given = norm_kernels.LevelTable(table, dev) if search else levels
        (q, nrm), route = routed(
            norm_kernels, "norm_quantize",
            lambda: norm_kernels.norm_quantize(x, given, bucket,
                                               norm == "l2", bits))
        packed = bucket % 8 == 0
        want_route = ("packed_search" if search else "packed_scan") \
            if packed else "bytes"
        if route != want_route:
            raise AssertionError(f"B5 took route {route} at {where}")
        routes[route] = routes.get(route, 0) + 1
        codes = unpack_bits(q, bits, bucket) if packed else q
        wq, wnrm = norm_kernels.norm_quantize_plain(x, levels, bucket,
                                                    norm == "l2")
        if norm == "linf":
            if not (bitwise(q, pack_bits(wq, bits) if packed else wq) and
                    bitwise(nrm, wnrm)):
                raise AssertionError(f"B5 differs at {where}")
        else:
            torch.testing.assert_close(nrm, wnrm, rtol=1e-6, atol=0,
                                       equal_nan=True, msg=where)
            step = level_steps(levels, codes, wq)
            if not torch.equal(codes & 1, wq & 1) or int(step.max()) > 1:
                raise AssertionError(f"B5 codes differ at {where}")
            midpoints += int((step > 0).sum())
        back = norm_kernels.norm_dequantize(codes, levels, nrm)
        short = levels[:2].contiguous()
        if not (bitwise(back, norm_kernels.norm_dequantize_plain(
                codes, levels, nrm)) and bitwise(
                norm_kernels.norm_dequantize(codes, short, nrm),
                norm_kernels.norm_dequantize_plain(codes, short, nrm))):
            raise AssertionError(f"B6 differs at {where}")
        if values == "path" and "norm_quantize" + SHAPES[n] not in errors:
            errors["norm_quantize" + SHAPES[n]] = max(
                float((codes.float() - wq.float()).abs().max()),
                float((nrm - wnrm).abs().max()))
            errors["norm_dequantize" + SHAPES[n]] = float(
                (back - norm_kernels.norm_dequantize_plain(codes, levels,
                                                           nrm))
                .abs().max())
    torch.cuda.synchronize()
    return errors, midpoints, routes


def flash_inputs(dev, bh: int, s: int, d: int, dtype, seed: int):
    """q, k, v and an output gradient ``[bh, s, d]``, unit normals."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(bh, s, d, generator=gen, device=dev).to(dtype)
            for _ in range(4)]


def flash_errors(flash, q, k, v, do, causal: bool, plant: bool = False):
    """B7, B8 and B9 against their plain versions on the same inputs (the
    backward kernels get the plain ``lse`` and ``delta``); raises beyond
    ``FLASH_TOL`` (bf16: ``BF16_TOL`` and the tensor-core route's rounding
    terms). With ``plant``, also raises unless the kernel's ``o``, dK, dV
    and dQ, each made ``PLANTED`` larger in the quarter of rows with the
    longest sums (the last queries for ``o`` and dQ, the first keys for dK
    and dV), fail the bound. Returns each
    kernel's largest absolute error and each output's largest error over
    its bound."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    o_ref, lse_ref = flash.flash_fwd_plain(q, k, v, scale, causal)
    delta = (do.float() * o_ref.float()).sum(dim=-1)
    terms = flash.mma_rounding_terms(q, k, v, do, lse_ref, delta, scale,
                                     causal) if q.dtype == torch.bfloat16 \
        else {}
    got = {"flash_fwd": flash.flash_fwd(q, k, v, scale, causal),
           "flash_dkdv": flash.flash_dkdv(q, k, v, do, lse_ref, delta, scale,
                                          causal),
           "flash_dq": (flash.flash_dq(q, k, v, do, lse_ref, delta, scale,
                                       causal),)}
    want = {"flash_fwd": (o_ref, lse_ref),
            "flash_dkdv": flash.flash_dkdv_plain(q, k, v, do, lse_ref, delta,
                                                 scale, causal),
            "flash_dq": (flash.flash_dq_plain(q, k, v, do, lse_ref, delta,
                                              scale, causal),)}
    torch.cuda.synchronize()
    fwd_tol, bwd_tol = FLASH_TOL
    outputs = {"flash_fwd": (("o", fwd_tol), ("lse", fwd_tol)),
               "flash_dkdv": (("dk", bwd_tol), ("dv", bwd_tol)),
               "flash_dq": (("dq", bwd_tol),)}
    errors, ratios = {}, {}
    for name in got:
        errors[name] = 0.0
        for g, w, (what, rel) in zip(got[name], want[name], outputs[name]):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"{name} {what}: {g.dtype} "
                                     f"{tuple(g.shape)} against {w.dtype} "
                                     f"{tuple(w.shape)}")
            err = (g.float() - w.float()).abs()
            size = w.float().abs()
            if g.dtype == torch.bfloat16:
                of_value, of_mean, floor = BF16_TOL
                bound = of_value * size + (of_mean * size.mean() + floor)
                if what in terms:
                    bound = bound + terms[what]
            else:
                bound = torch.full_like(size,
                                        rel * max(1.0, float(size.max())))
            if not bool((err <= bound).all()):
                worst = int((err - bound).nan_to_num(math.inf).argmax())
                raise AssertionError(
                    f"{name} {what} differs from its plain version by "
                    f"{float(err.flatten()[worst])} at element {worst} "
                    f"(reference {float(w.flatten()[worst])}, bound "
                    f"{float(bound.flatten()[worst])}) at {tuple(q.shape)} "
                    f"{q.dtype} causal={causal}")
            errors[name] = max(errors[name], float(err.max()))
            ratios[what] = float((err / bound).max())
            if plant and what in terms:
                n = q.shape[1]
                rows = (slice(n - n // 4, n) if what in ("o", "dq")
                        else slice(0, n // 4))
                planted = g.float().clone()
                planted[:, rows] *= 1 + PLANTED
                if bool(((planted - w.float()).abs() <= bound).all()):
                    raise AssertionError(f"{name} {what}: an error of "
                                         f"{PLANTED} planted in rows {rows} "
                                         f"passes the bound")
    return errors, ratios


def check_flash(flash, dev):
    """The attention kernels against their plain versions: at each shape
    the main path gives them (bf16, S 4096, D 64: BH 16 causal for the GPT
    path, Ulysses with flash, MoE and remat, B 2 x H 8; BH 16 non-causal
    for the encoder; BH 8 causal for the pipeline's micro-batches of 1 x
    H 8), each with a planted error that must fail, and at S in {1, 127,
    200, 4096} x D in {16, 64, 128} x causal or not x fp32 or bf16 (bf16
    on the tensor cores, fp32 on the CUDA cores, as the route counts of
    B7, B8 and B9 confirm). Returns the errors at the GPT path's shape and
    at the encoder's."""
    flash.reset_launches()
    heads, d = GPT_CONFIG["num_heads"], GPT_CONFIG["head_dim"]
    errors = {}

    def at_path_shape(path, bh, causal, seed):
        errors[path], ratios = flash_errors(flash, *flash_inputs(
            dev, bh, GPT_SEQ, d, torch.bfloat16, seed), causal, plant=True)
        log(f"kernels: attention at the {path} path's shape (BH {bh}, S "
            f"{GPT_SEQ}, D {d}, bf16, causal={causal}), largest error over "
            f"its bound {ratios}; a {PLANTED} error planted in o, dk, dv "
            f"and dq fails it")

    at_path_shape("gpt", GPT_BATCH * heads, True, 0)
    seed = 1
    for s in (1, 127, 200, 4096):
        for dim in (16, 64, 128):
            for causal in (True, False):
                for dtype in (torch.float32, torch.bfloat16):
                    flash_errors(flash, *flash_inputs(dev, 3, s, dim, dtype,
                                                      seed), causal)
                    seed += 1
    at_path_shape("encoder", GPT_BATCH * heads, False, seed)
    at_path_shape("pipeline", GPT_BATCH // PIPE_MICRO * heads, True,
                  seed + 1)
    # the 3 path shapes + 24 cases each
    for name in flash.ROUTES:
        want = {route: 27 if route == BF16_ROUTES[name] else 0
                for route in flash.ROUTES[name]}
        want["fp32"] = 24
        if flash.ROUTES[name] != want:
            raise AssertionError(f"{name} routes {flash.ROUTES[name]}, "
                                 f"expected {want}")
    return errors["gpt"], errors["encoder"]


def kernel_modules():
    from horovod_tpu_torch.compression import kernels, norm_kernels
    from horovod_tpu_torch.ops import flash_attention as flash
    return kernels, norm_kernels, flash


def reset_launches() -> None:
    for module in kernel_modules():
        module.reset_launches()


def read_launches():
    """Every kernel's launch count."""
    return {name: count for module in kernel_modules()
            for name, count in module.LAUNCHES.items()}


def read_routes():
    """Launches by route of the kernels that count them (B2–B5)."""
    kernels, norm_kernels, _ = kernel_modules()
    return {name: dict(counts) for module in (kernels, norm_kernels)
            for name, counts in module.ROUTES.items()}


def check_launches(path: str, launches, per_step, steps: int = None,
                   routes=None, want_routes=()) -> None:
    """A phase's exact launches in ``steps`` steps (``STEPS`` by default):
    ``per_step`` of each kernel a step, 0 of every other; and every launch
    of each kernel of ``want_routes`` on its route (``routes``: the
    phase's launches by route)."""
    steps = STEPS if steps is None else steps
    want = {name: per_step.get(name, 0) * steps for name in launches}
    if launches != want:
        raise AssertionError(f"{path}: launches {launches}, expected {want}")
    for name, route in dict(want_routes).items():
        want = {r: launches[name] if r == route else 0 for r in routes[name]}
        if routes[name] != want:
            raise AssertionError(f"{path}: {name} routes {routes[name]}, "
                                 f"expected {want}")
        log(f"{path}: every {name} launch on the {route} route "
            f"{routes[name]}")


def resnet_compressors():
    """The ResNet-50 path's compressor of each phase."""
    from horovod_tpu_torch.compression import MaxMinQuantizer, make_compressor
    return {"resnet": MaxMinQuantizer(bits=BITS, bucket_size=BUCKET),
            "resnet_uni": make_compressor("uni"),
            "resnet_stochastic": MaxMinQuantizer(bits=BITS,
                                                 bucket_size=BUCKET,
                                                 stochastic=True)}


def make_slice(hvd, dev, compressor=None, backward_passes_per_step=1):
    """The main path's model, optimizer and fixed synthetic batch;
    ``compressor`` (4-bit max-min by default) sends the gradients through
    the ``scatter_allgather`` reducer with error feedback."""
    from horovod_tpu_torch.compression import CompressionConfig
    from horovod_tpu_torch.models import ResNet50

    if compressor is None:
        compressor = resnet_compressors()["resnet"]
    torch.manual_seed(0)
    model = ResNet50(num_classes=1000).to(dev,
                                          memory_format=torch.channels_last)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9),
        named_parameters=model.named_parameters(),
        compression=CompressionConfig(
            compressor, reduction="scatter_allgather", error_feedback=True),
        backward_passes_per_step=backward_passes_per_step)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    images = torch.randn(BATCH, IMAGE, IMAGE, 3, generator=gen, device=dev)
    labels = torch.randint(0, 1000, (BATCH,), generator=gen, device=dev)
    return model, opt, images, labels


def forward_backward(model, opt, images, labels, scale: float = 1.0,
                     zero: bool = True):
    if zero:
        opt.zero_grad(set_to_none=True)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        logits = model(images)
    loss = F.cross_entropy(logits, labels)
    (loss * scale if scale != 1.0 else loss).backward()
    return loss.detach()


def check_hook_launches(path: str, launched, want) -> None:
    """``launched``: the reductions each timed step's backward passes had
    launched by the time ``loss.backward()`` returned; ``want`` the least
    (a list: one count a pass)."""
    if any(got < least for step in launched
           for got, least in zip(step, want)) or \
            any(len(step) != len(want) for step in launched):
        raise AssertionError(f"{path}: reductions launched in backward "
                             f"{launched}, expected at least {want} a step")


def check_losses(losses) -> None:
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")


def train(hvd, dev, path: str = "resnet", check_copy: bool = True):
    """One ResNet-50 phase (``path`` names its compressor): 2 warm-up and
    10 timed steps, the launch counts of the timed steps, and, when
    ``check_copy``, the trained model against a CPU copy of itself."""
    compressor = resnet_compressors()[path]
    model, opt, images, labels = make_slice(hvd, dev, compressor)
    n_params = sum(p.numel() for p in model.parameters())

    launched = []

    def step():
        loss = forward_backward(model, opt, images, labels)
        launched.append([opt.hook_launches])
        opt.step()
        return loss

    losses = [step() for _ in range(WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    del launched[:]
    t0 = time.perf_counter()
    losses += [step() for _ in range(STEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    routes = read_routes()
    losses = [float(v) for v in losses]
    log(f"{path}: ResNet-50, {n_params} parameters, batch {BATCH}, "
        f"{IMAGE}x{IMAGE}, lr {LR}, {compressor!r}; losses {losses}")
    log(f"{path}: reductions launched before backward() returned, each "
        f"timed step: {launched}")
    log(f"{path}: step {seconds / STEPS * 1e3:.3f} ms, "
        f"{BATCH * STEPS / seconds:.1f} images/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, launches in "
        f"{STEPS} steps {launches}")
    if n_params != RESNET50_PARAMS:
        raise AssertionError(f"ResNet-50 has {n_params} parameters")
    check_losses(losses)
    check_hook_launches(path, launched, [1])
    check_launches(path, launches, PATH_LAUNCHES[path], routes=routes,
                   want_routes=PATH_ROUTES.get(path, {}))
    if not check_copy:
        return launches

    check_vision_copy(path, model, images[:2, :64, :64].contiguous())
    return launches


def train_accumulated(hvd, dev):
    """The max-min ResNet-50 path with ``backward_passes_per_step=2``: 2
    warm-up and 10 timed steps of two half-batches of ``BATCH // 2``
    images, each loss scaled by 1/2. The launch counts and routes a step
    are the batch-64 phase's; no reduction is launched by the first
    backward pass of a step, and the quantized group by the second."""
    path, half = "resnet_accumulated", BATCH // 2
    model, opt, images, labels = make_slice(hvd, dev,
                                            backward_passes_per_step=2)
    launched = []

    def step():
        losses, passes = [], []
        for i in range(2):
            part = slice(i * half, (i + 1) * half)
            losses.append(forward_backward(model, opt, images[part],
                                           labels[part], scale=0.5,
                                           zero=i == 0))
            passes.append(opt.hook_launches)
        launched.append(passes)
        opt.step()
        return (losses[0] + losses[1]) / 2

    losses = [step() for _ in range(WARMUP)]
    torch.cuda.synchronize()
    reset_launches()
    del launched[:]
    t0 = time.perf_counter()
    losses += [step() for _ in range(STEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, routes = read_launches(), read_routes()
    losses = [float(v) for v in losses]
    log(f"{path}: ResNet-50, backward_passes_per_step=2 of {half} images; "
        f"losses {losses}")
    log(f"{path}: step {seconds / STEPS * 1e3:.3f} ms, launches in {STEPS} "
        f"steps {launches}; reductions launched by each backward pass "
        f"{launched}")
    check_losses(losses)
    if any(passes != [0, 1] for passes in launched):
        raise AssertionError(f"{path}: reductions launched by the two "
                             f"passes {launched}, expected [0, 1] a step")
    check_launches(path, launches, PATH_LAUNCHES["resnet"], routes=routes,
                   want_routes=PATH_ROUTES["resnet"])
    return launches


def same_bits(got, want) -> bool:
    """The same dtype, shape and bytes (a list: each of its tensors)."""
    if isinstance(got, (list, tuple)):
        return len(got) == len(want) and all(
            same_bits(g, w) for g, w in zip(got, want))
    return got.dtype == want.dtype and got.shape == want.shape and \
        torch.equal(got.contiguous().view(torch.uint8),
                    want.contiguous().view(torch.uint8))


def check_api(hvd, dev):
    """The collective API on the card at a world of one: every async op
    bitwise against its synchronous twin; ``reducescatter``, ``alltoall``
    with splits and ``allgather`` (each the identity at one rank); the
    gradient through ``allreduce``; and two agreement errors: a dtype
    mismatch from a second rank's descriptor (this rank's gathered on the
    card, the other's a copy naming float64) and splits that do not sum to
    dim 0."""
    from horovod_tpu_torch.exceptions import HvdTpuInternalError
    from horovod_tpu_torch.ops import collectives as C

    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(4096, 1024, generator=gen, device=dev)
    xb = x.to(torch.bfloat16)
    rows = torch.randn(3, 1024, generator=gen, device=dev)
    scaled = dict(op=hvd.Average, prescale_factor=1 / 3,
                  postscale_factor=0.1)
    fp16 = dict(compression=hvd.Compression.fp16)
    pairs = {
        "allreduce fp32": (lambda: hvd.allreduce(x, **scaled),
                           lambda: hvd.allreduce_async(x, **scaled)),
        "allreduce bf16": (lambda: hvd.allreduce(xb, **scaled),
                           lambda: hvd.allreduce_async(xb, **scaled)),
        "allreduce bf16 product": (
            lambda: hvd.allreduce(xb, op=hvd.Product),
            lambda: hvd.allreduce_async(xb, op=hvd.Product)),
        "allreduce fp16 wire": (lambda: hvd.allreduce(x, **fp16),
                                lambda: hvd.allreduce_async(x, **fp16)),
        "grouped_allreduce": (
            lambda: hvd.grouped_allreduce([x, xb, rows], **scaled),
            lambda: hvd.grouped_allreduce_async([x, xb, rows], **scaled)),
        "allgather": (lambda: hvd.allgather(rows),
                      lambda: hvd.allgather_async(rows)),
        "broadcast": (lambda: hvd.broadcast(x, root_rank=0),
                      lambda: hvd.broadcast_async(x, root_rank=0)),
        "alltoall": (lambda: hvd.alltoall(x), lambda: hvd.alltoall_async(x)),
        "alltoall splits": (lambda: hvd.alltoall(rows, splits=[3])[0],
                            lambda: hvd.alltoall_async(rows, splits=[3])),
    }
    for name, (sync, start) in pairs.items():
        handle = start()
        if not isinstance(hvd.poll(handle), bool):
            raise AssertionError(f"api: poll of {name} is not a bool")
        got, want = hvd.synchronize(handle), sync()
        if not same_bits(got, want):
            raise AssertionError(f"api: async {name} differs from its sync "
                                 "twin")
    out, received = hvd.alltoall(rows, splits=[3])
    checks = {"reducescatter": hvd.reducescatter(x),
              "reducescatter average": hvd.reducescatter(x, op=hvd.Average),
              "allgather": hvd.allgather(x), "alltoall splits": out}
    for name, got in checks.items():
        want = rows if name == "alltoall splits" else x
        if not same_bits(got, want):
            raise AssertionError(f"api: {name} at one rank is not its input")
    if received.tolist() != [3]:
        raise AssertionError(f"api: received splits {received.tolist()}")
    w = torch.randn(x.shape, generator=gen, device=dev)
    xr = x.clone().requires_grad_(True)
    (hvd.allreduce(xr, op=hvd.Sum) * w).sum().backward()
    if not same_bits(xr.grad, w):
        raise AssertionError("api: the gradient through allreduce is not "
                             "the upstream gradient")
    mine = C._exchange(C._describe("allreduce", x.shape, x.dtype,
                                   op=hvd.Sum))
    other = list(mine[0])
    other[C._DTYPE] = C._dtype_code(torch.float64)
    errors = []
    for name, call in (("dtype", lambda: C._check(mine + [other])),
                       ("splits", lambda: hvd.alltoall(rows, splits=[4]))):
        try:
            call()
        except HvdTpuInternalError as e:
            errors.append(str(e))
            continue
        raise AssertionError(f"api: the {name} mismatch did not raise")
    if not (errors[0].startswith("Mismatched data types") and
            errors[1].startswith("alltoall splits sum")):
        raise AssertionError(f"api: wrong errors {errors}")
    log(f"api: {len(pairs)} async ops bitwise against their sync twins "
        f"({', '.join(pairs)}); reducescatter, alltoall with splits and "
        f"allgather exact; allreduce's gradient exact; errors raised: "
        f"{errors}")


def reinit(hvd, mesh_shape):
    """The runtime initialized anew on ``mesh_shape``; its device. The
    earlier phases' objects are collected first, so that each phase's peak
    memory counts its own tensors; what is still allocated is logged."""
    hvd.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    hvd.init(mesh_shape=mesh_shape)
    log(f"runtime on {mesh_shape}: {torch.cuda.memory_allocated()} bytes "
        f"allocated before the phase")
    return hvd.device()


def timed_steps(path: str, step, warmup: int = MESH_WARMUP,
                steps: int = MESH_STEPS):
    """``warmup`` steps, then the launch counts set to 0 and ``steps``
    timed steps; their losses (as floats, warm-up ones first), the step
    time in ms, the launches and the routes."""
    losses = [step() for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    losses += [step() for _ in range(steps)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    launches, routes = read_launches(), read_routes()
    losses = [float(v) for v in losses]
    log(f"{path}: step {ms:.3f} ms, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, launches in "
        f"{steps} steps {launches}; losses {losses}")
    check_losses(losses)
    return ms, launches, routes


def check_adasum(dev):
    """The fused per-tensor Adasum combine on the card: 4 synthetic rank
    vectors in ResNet-50's layout (161 tensors, one segment each), folded
    as the reference folds 4 ranks, ``((r0, r1), (r2, r3))``, each pair by
    ``partials`` (every tensor's a·b, a·a, b·b from one float64 prefix
    sum) and
    ``combine`` (each tensor's coefficients); every tensor's result against
    the float64 ``adasum_reference`` of its 4 pieces."""
    import numpy as np
    from horovod_tpu_torch.models import ResNet50
    from horovod_tpu_torch.parallel.adasum import (adasum_reference,
                                                   bounds, combine,
                                                   partials, segments)
    sizes = [p.numel() for p in ResNet50(num_classes=1000).parameters()]
    total = sum(sizes)
    gen = torch.Generator(device=dev).manual_seed(3)
    # Correlated ranks (a shared part and each rank's own), so the
    # coefficients sit well inside (0, 1).
    common = torch.randn(total, generator=gen, device=dev)
    ranks = [common + (0.5 + r) * torch.randn(total, generator=gen,
                                                device=dev)
             for r in range(ADASUM_RANKS)]
    ids, ends = segments(sizes, total, dev)
    cuts = bounds(ends, 0, total, dev)

    def pair(a, b):
        return combine(a, b, partials(a, b, cuts), ids)

    def fold():
        return pair(pair(ranks[0], ranks[1]), pair(ranks[2], ranks[3]))

    got = fold()
    ms = time_ms(fold, iters=5) / 3  # three pairwise combines a fold
    got = got.cpu().numpy()
    host = [r.cpu().numpy() for r in ranks]
    worst, off = 0.0, 0
    for size in sizes:
        ref = adasum_reference([h[off:off + size] for h in host])
        err = float(np.abs(got[off:off + size] - ref).max() /
                    max(np.abs(ref).max(), 1e-30))
        worst = max(worst, err)
        off += size
    if not worst <= ADASUM_TOL:
        raise AssertionError(f"adasum: fused combine off by {worst:.3g} of "
                             f"a tensor's largest value, above "
                             f"{ADASUM_TOL}")
    log(f"adasum: fused per-tensor combine of {ADASUM_RANKS} ranks in "
        f"ResNet-50's layout ({len(sizes)} tensors, {total} values) within "
        f"{worst:.3g} of each tensor's largest value of the float64 "
        f"reference (tolerance {ADASUM_TOL}); one pairwise combine "
        f"{ms:.4f} ms")
    return ms


def resnet_mesh_slice(hvd, dev):
    """A fresh ResNet-50 (seed 0, channels_last) and the fixed batch."""
    from horovod_tpu_torch.models import ResNet50
    torch.manual_seed(0)
    model = ResNet50(num_classes=1000)
    gen = torch.Generator(device=dev).manual_seed(0)
    images = torch.randn(BATCH, IMAGE, IMAGE, 3, generator=gen, device=dev)
    labels = torch.randint(0, 1000, (BATCH,), generator=gen, device=dev)
    return model, images, labels


def make_sync_adasum_slice(hvd, dev, sync: bool = True):
    """The ResNet-50 slice of the SyncBatchNorm + hierarchical Adasum
    phase (on a ``{"dcn", "ici"}`` mesh); with ``sync`` False, the same
    model with its batch norms and the dense Average optimizer, which
    ``scripts/profile_torch_slice.py --path resnet_dense`` sets beside
    it."""
    model, images, labels = resnet_mesh_slice(hvd, dev)
    kw = {}
    if sync:
        hvd.SyncBatchNorm.convert_sync_batchnorm(model, axis=("dcn", "ici"))
        kw = dict(op=hvd.Adasum, hierarchical=("ici", "dcn"))
    model = model.to(dev, memory_format=torch.channels_last)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9),
        named_parameters=model.named_parameters(), **kw)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    return model, opt, images, labels


def train_sync_adasum(hvd):
    """ResNet-50 with SyncBatchNorm over both mesh axes in place of every
    batch norm, its gradients reduced by hierarchical Adasum from the
    hooks; then the trained model against a CPU copy of itself."""
    path = "resnet_syncbn_adasum"
    dev = reinit(hvd, {"dcn": 1, "ici": 1})
    model, opt, images, labels = make_sync_adasum_slice(hvd, dev)
    n_sync = sum(isinstance(m, hvd.SyncBatchNorm) for m in model.modules())
    if n_sync != SYNC_BN_LAYERS:
        raise AssertionError(f"{path}: {n_sync} SyncBatchNorm layers")
    launched = []

    def step():
        loss = forward_backward(model, opt, images, labels)
        launched.append([opt.hook_launches])
        opt.step()
        return loss

    ms, launches, _ = timed_steps(path, step)
    units = len(opt._units)
    timed = launched[MESH_WARMUP:]
    log(f"{path}: {n_sync} SyncBatchNorm layers, op=Adasum, hierarchical="
        f"(ici, dcn), {units} dense buckets; launched before backward() "
        f"returned, each timed step: {timed}")
    check_hook_launches(path, timed, [units])
    check_launches(path, launches, {}, MESH_STEPS)
    model.eval()
    small = images[:2, :64, :64].contiguous()
    with torch.no_grad():
        got = model(small).cpu()
        ref = copy.deepcopy(model).cpu().float()(small.cpu())
    if got.shape != (2, 1000) or not torch.isfinite(got).all():
        raise AssertionError(f"{path}: bad logits")
    torch.testing.assert_close(got, ref, rtol=1e-3,
                               atol=1e-3 * float(ref.abs().max()))
    log(f"{path}: trained model agrees with its CPU copy (fp32, rtol 1e-3)")
    return ms


def train_hierarchical_compressed(hvd):
    """ResNet-50, its fused gradients reduced each step by
    ``hierarchical_compressed_allreduce`` with the residual carried, then
    SGD: B1 twice, B3 once and B4 twice a step, B3 and B4 on the packed
    route."""
    from horovod_tpu_torch.compression import (
        MaxMinQuantizer, hierarchical_compressed_allreduce)
    path = "resnet_hier_compressed"
    dev = reinit(hvd, {"dcn": 1, "ici": 1})
    model, images, labels = resnet_mesh_slice(hvd, dev)
    model = model.to(dev, memory_format=torch.channels_last)
    params = list(model.parameters())
    sizes = [p.numel() for p in params]
    opt = torch.optim.SGD(params, lr=LR, momentum=0.9)
    quant = MaxMinQuantizer(bits=BITS, bucket_size=BUCKET)
    state = {"residual": "init"}
    norms = []

    def step():
        opt.zero_grad(set_to_none=True)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            logits = model(images)
        loss = F.cross_entropy(logits, labels)
        loss.backward()
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        out, state["residual"] = hierarchical_compressed_allreduce(
            flat, quant, "ici", "dcn", reduction="scatter_allgather",
            op=hvd.Average, residual=state["residual"])
        for p, part in zip(params, out.split(sizes)):
            p.grad.copy_(part.view_as(p))
        norms.append(state["residual"].norm())
        opt.step()
        return loss.detach()

    ms, launches, routes = timed_steps(path, step)
    residual = state["residual"]
    norms = [float(v) for v in norms]
    log(f"{path}: residual {tuple(residual.shape)} carried, its norm after "
        f"each step {norms}")
    if tuple(residual.shape) != (RESNET50_PARAMS,):
        raise AssertionError(f"{path}: residual {tuple(residual.shape)}")
    if not all(math.isfinite(v) and v > 0 for v in norms) or \
            len(set(norms)) != len(norms):
        raise AssertionError(f"{path}: residual not carried: {norms}")
    check_launches(path, launches, PATH_LAUNCHES["resnet"], MESH_STEPS,
                   routes, DECODE_ROUTES)
    return ms, launches


def train_gpt_zero(hvd):
    """The GPT path under ZeRO-1 Adam on a one-axis mesh: B7 twice a layer
    and B8, B9 once, all on the tensor cores; Adam's state the computed
    bytes."""
    from horovod_tpu_torch.models import GPT, GPTConfig
    path = "gpt_zero1"
    dev = reinit(hvd, {"dp": 1})
    cfg = GPTConfig(**GPT_CONFIG)
    model = GPT(cfg, seed=0).to(dev)
    opt = hvd.ShardedDistributedOptimizer(torch.optim.Adam,
                                          model.parameters(), lr=ZERO_LR)
    tokens, targets = gpt_tokens(dev, cfg)

    def step():
        loss = gpt_forward_backward(model, opt, tokens, targets)
        opt.step()
        return loss

    ms, launches, _ = timed_steps(path, step)
    layers = cfg.num_layers
    check_launches(path, launches, {"flash_fwd": 2 * layers,
                                    "flash_dkdv": layers,
                                    "flash_dq": layers}, MESH_STEPS)
    check_flash_routes(path, launches)
    vectors = sum(t.numel() * t.element_size()
                  for st in opt.optimizer.state.values()
                  for t in st.values()
                  if torch.is_tensor(t) and t.numel() == opt.shard_len)
    total = opt.state_bytes()
    log(f"{path}: Adam state {total} bytes on this rank ({vectors} in the "
        f"shard's two moments of {opt.shard_len} values, {total - vectors} "
        f"in its step count); every B7, B8 and B9 launch on the tensor "
        f"cores")
    if opt.shard_len != GPT_PARAMS or vectors != ZERO_STATE_BYTES or \
            not 0 <= total - vectors <= 8:
        raise AssertionError(f"{path}: Adam state {total} bytes, "
                             f"{vectors} in the moments, expected "
                             f"{ZERO_STATE_BYTES}")
    return ms, launches


def check_flash_routes(path: str, launches) -> None:
    """Every B7, B8 and B9 launch of the window on the tensor cores, on its
    kernel's route (``BF16_ROUTES``)."""
    from horovod_tpu_torch.ops.flash_attention import ROUTES
    routes = {name: dict(counts) for name, counts in ROUTES.items()}
    want = {name: {r: launches[name] if r == BF16_ROUTES[name] else 0
                   for r in routes[name]} for name in routes}
    if routes != want:
        raise AssertionError(f"{path}: routes {routes}, expected {want}")


def check_cpu_copy(path: str, dev, trained, cpu_copy, forward) -> None:
    """``trained`` (an fp32 copy of the trained model on the card) against
    ``cpu_copy`` (the same weights on the CPU, where the wrappers take
    their plain versions) on the first 200 tokens of a seeded sequence;
    ``forward(model, tokens)`` gives the logits."""
    gen = torch.Generator().manual_seed(1)
    small = torch.randint(0, 1000, (1, 200), generator=gen)
    with torch.no_grad():
        ref = forward(cpu_copy, small)
        got = forward(trained.to(dev), small.to(dev)).cpu()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{path}: bad logits {tuple(got.shape)}")
    torch.testing.assert_close(got, ref, rtol=1e-4,
                               atol=1e-4 * float(ref.abs().max()))
    log(f"{path}: trained model agrees with its CPU copy (fp32, rtol 1e-4)")


def gpt_fp32_copies(model):
    """fp32 copies of a trained GPT: one with its mesh axes (for the card)
    and one without (for the CPU, where no collective runs; every axis of
    the phases has size 1, so the two compute the same function)."""
    from horovod_tpu_torch.models import GPT
    cfg = dataclasses.replace(model.cfg, dtype=torch.float32)
    trained = GPT(cfg)
    trained.load_state_dict(model.state_dict())
    cpu = GPT(dataclasses.replace(cfg, tp_axis=None, sp_axis=None,
                                  ep_axis=None))
    cpu.load_state_dict(model.state_dict())
    return trained, cpu


def gpt_tokens(dev, cfg):
    """The GPT path's batch of tokens and targets, this rank's shard."""
    from horovod_tpu_torch.models import gpt
    from horovod_tpu_torch.parallel import local_shard
    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (GPT_BATCH, GPT_SEQ),
                           generator=gen, device=dev)
    targets = torch.roll(tokens, -1, dims=1)
    targets[:, -1] = -1
    spec = gpt.data_specs(cfg)
    return local_shard(tokens, spec), local_shard(targets, spec)


def mesh_gpt_step(model, opt, tokens, targets):
    """One SGD step of the model-parallel GPT: the dp average by the
    optimizer, the sums over sp and ep by ``sum_replica_grads``."""
    from horovod_tpu_torch.models import gpt
    loss = gpt_forward_backward(model, opt, tokens, targets)
    opt.synchronize()
    gpt.sum_replica_grads(model)
    with opt.skip_synchronize():
        opt.step()
    return loss


def make_mesh_gpt_slice(hvd, dev, **overrides):
    """The GPT path's model with ``overrides``, this rank's shards of it,
    its ``DistributedOptimizer`` over dp and this rank's batch."""
    from horovod_tpu_torch.models import GPT, GPTConfig
    cfg = GPTConfig(**{**GPT_CONFIG, **overrides})
    model = GPT(cfg, seed=0).to(dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=GPT_LR),
        named_parameters=model.named_parameters(), axis="dp")
    return (model, opt) + gpt_tokens(dev, cfg)


def train_mesh_gpt(hvd, path: str, mesh_shape, **overrides):
    """A model-parallel GPT phase at full width on ``mesh_shape``: the
    step time, the peak memory of the timed steps and the trained model."""
    dev = reinit(hvd, mesh_shape)
    model, opt, tokens, targets = make_mesh_gpt_slice(hvd, dev, **overrides)
    cfg = model.cfg
    ms, launches, _ = timed_steps(
        path, lambda: mesh_gpt_step(model, opt, tokens, targets))
    peak = torch.cuda.max_memory_allocated()
    check_launches(path, launches, MP_LAUNCHES[path], MESH_STEPS)
    check_flash_routes(path, launches)
    log(f"{path}: mesh {mesh_shape}, attention {cfg.attention}, remat "
        f"{cfg.remat}; B7, B8 and B9 launches a step "
        f"{MP_LAUNCHES[path]}, all on the tensor cores")
    trained, cpu = gpt_fp32_copies(model)
    check_cpu_copy(path, dev, trained, cpu, lambda m, t: m(t))
    return {"ms": ms, "peak_bytes": peak}, model


def train_moe(hvd):
    """(c): the switch GPT on ``{"dp": 1, "ep": 1}``; the dropped fraction
    and load-balance loss of each switch block's last step."""
    path = "gpt_moe"
    mesh_shape, overrides = MP_PATHS[path]
    out, model = train_mesh_gpt(hvd, path, mesh_shape, **overrides)
    tokens = GPT_BATCH * GPT_SEQ
    capacity = math.ceil(tokens * MOE["capacity_factor"] /
                         MOE["num_experts"])
    if capacity != MOE_CAPACITY:
        raise AssertionError(f"{path}: capacity {capacity}")
    aux = [{k: float(v) for k, v in block.moe_aux.items()}
           for block in model.layers if block.moe is not None]
    if len(aux) != GPT_LAYERS // MOE["moe_every"] or not all(
            math.isfinite(v) for a in aux for v in a.values()) or not all(
            0 <= a["dropped_fraction"] < 1 for a in aux):
        raise AssertionError(f"{path}: aux {aux}")
    log(f"{path}: {capacity} slots an expert for {tokens} tokens; each "
        f"switch block's last step: {aux}")
    out["aux"] = aux
    return out


def gpt_loss_and_grads(hvd, dev, remat: str):
    """Loss, gradients and peak memory of one forward and backward of the
    GPT path's model (seed 0) with ``remat`` on its batch. The peak is
    counted from what was allocated before the forward (the model and
    whatever else is alive), so it is the step's own: activations,
    recompute, logits and gradients."""
    from horovod_tpu_torch.models import GPT, GPTConfig, loss_fn
    model = GPT(GPTConfig(**{**GPT_CONFIG, "remat": remat}), seed=0).to(dev)
    tokens, targets = gpt_tokens(dev, model.cfg)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss = loss_fn(model, tokens, targets)
    loss.backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    return (loss.detach(), {k: p.grad for k, p in model.named_parameters()},
            peak)


def train_remat(hvd):
    """(d): remat "dots" against "none" and "full": the same loss and
    gradients, bitwise, on the same inputs, the peak memory of that
    forward and backward lowest for "full" and highest for "none"; then
    each trained for the timed steps."""
    dev = reinit(hvd, {"dp": 1})
    ref_loss, ref, dots_peak = gpt_loss_and_grads(hvd, dev, "dots")
    peaks = {"dots": dots_peak}
    diffs = {}
    for mode in ("none", "full"):
        loss, grads, peaks[mode] = gpt_loss_and_grads(hvd, dev, mode)
        worst = max(float((grads[k] - g).abs().max() / g.abs().max())
                    for k, g in ref.items())
        loss_diff = abs(float(loss - ref_loss))
        diffs[mode] = {"loss": loss_diff, "grad": worst,
                       "bitwise": loss_diff == 0 and all(
                           torch.equal(grads[k], g) for k, g in ref.items())}
        # The same kernels run on the same inputs in every mode, so the
        # loss and every gradient must be the same bits.
        if not diffs[mode]["bitwise"]:
            raise AssertionError(f"remat dots against {mode}: {diffs[mode]}")
        del grads
    log(f"gpt_remat: dots against none and full on the same inputs (loss "
        f"difference, largest gradient difference over its tensor's "
        f"largest magnitude): {diffs}")
    log(f"gpt_remat: peak memory of one forward and backward above what "
        f"was allocated before it, bytes {peaks}")
    if not peaks["full"] < peaks["dots"] < peaks["none"]:
        raise AssertionError(f"gpt_remat: peak memory {peaks}")
    del ref, ref_loss
    out = {"diffs": diffs, "step_peak_bytes": peaks}
    for mode in ("none", "full", "dots"):
        out[mode] = train_mesh_gpt(hvd, f"gpt_remat_{mode}", {"dp": 1},
                                   remat=mode)[0]
    return out


class PipelineStage(torch.nn.Module):
    """The pipeline's stage: every block of a GPT (one stage at pp = 1)."""

    def __init__(self, blocks):
        super().__init__()
        self.blocks = blocks

    def forward(self, x, positions):
        for block in self.blocks:
            x = block(x, positions)
        return x


def pipeline_logits(model, tokens):
    """GPT logits ``[M, mb, S, V]`` of micro-batched ``tokens [M, mb, S]``:
    the embedding, ``pipeline_apply`` over the blocks (recomputed at each
    tick), the out norm and head."""
    from torch.func import functional_call
    from horovod_tpu_torch.parallel import pipeline_apply
    stage = PipelineStage(model.layers)
    params = {k: p.unsqueeze(0) for k, p in stage.named_parameters()}
    positions = torch.arange(tokens.shape[-1], device=tokens.device
                             ).expand(tokens.shape[1:])
    x = model.embed.to(model.cfg.dtype)[tokens]
    out = pipeline_apply(
        lambda p, h: functional_call(stage, p, (h, positions)), params, x,
        axis="pp", remat=True)
    return model.head(out)


def train_pipeline(hvd):
    """(e): GPipe on ``{"dp": 1, "pp": 1}``, the GPT path's 6 blocks as the
    stage over 2 micro-batches of one 4096-token sequence."""
    from horovod_tpu_torch.models import GPT, GPTConfig
    path = "gpt_pipeline"
    dev = reinit(hvd, {"dp": 1, "pp": 1})
    cfg = GPTConfig(**{**GPT_CONFIG, "remat": "none"})
    model = GPT(cfg, seed=0).to(dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=GPT_LR),
        named_parameters=model.named_parameters(), axis="dp")
    tokens, targets = gpt_tokens(dev, cfg)
    shape = (PIPE_MICRO, GPT_BATCH // PIPE_MICRO, GPT_SEQ)

    def step():
        opt.zero_grad(set_to_none=True)
        logits = pipeline_logits(model, tokens.view(shape))
        loss = F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                               targets.reshape(-1), ignore_index=-1)
        loss.backward()
        opt.step()
        return loss.detach()

    ms, launches, _ = timed_steps(path, step)
    peak = torch.cuda.max_memory_allocated()
    check_launches(path, launches, MP_LAUNCHES[path], MESH_STEPS)
    check_flash_routes(path, launches)
    log(f"{path}: {PIPE_MICRO} micro-batches of {shape[1]} x {GPT_SEQ} "
        f"tokens; B7, B8 and B9 launches a step {MP_LAUNCHES[path]}, all "
        f"on the tensor cores")
    trained, cpu = gpt_fp32_copies(model)
    check_cpu_copy(path, dev, trained, cpu, lambda m, t: (
        pipeline_logits(m, t[None]) if t.is_cuda else m(t)[None]))
    return {"ms": ms, "peak_bytes": peak}


def train_encoder(hvd, seed: int):
    """(f): the JAX ``Encoder``'s defaults with the non-causal kernels,
    ``masked_lm_loss`` at 15% of 2 x 4096 positions (from ``seed``),
    ``DistributedOptimizer`` and Adam."""
    from horovod_tpu_torch.models import Encoder, masked_lm_loss
    from horovod_tpu_torch.ops.flash_attention import flash_attention
    path = "encoder"
    dev = reinit(hvd, {"dp": 1})
    model = Encoder(**ENCODER_CONFIG, attn_fn=flash_attention,
                    seed=seed).to(dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=ENCODER_LR),
        named_parameters=model.named_parameters())
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, ENCODER_CONFIG["vocab_size"],
                           (GPT_BATCH, GPT_SEQ), generator=gen, device=dev)
    mask = torch.rand(tokens.shape, generator=gen, device=dev) < MASK_SHARE
    inputs = torch.where(mask, MASK_ID, tokens)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = masked_lm_loss(model(inputs), tokens, mask)
        loss.backward()
        opt.step()
        return loss.detach()

    ms, launches, _ = timed_steps(path, step)
    peak = torch.cuda.max_memory_allocated()
    check_launches(path, launches, MP_LAUNCHES[path], MESH_STEPS)
    check_flash_routes(path, launches)
    log(f"{path}: {int(mask.sum())} of {mask.numel()} positions masked; "
        f"B7, B8 and B9 launches a step {MP_LAUNCHES[path]} (non-causal), "
        f"all on the tensor cores")
    trained = Encoder(**ENCODER_CONFIG, dtype=torch.float32,
                      attn_fn=flash_attention)
    trained.load_state_dict(model.state_dict())
    check_cpu_copy(path, dev, trained, copy.deepcopy(trained).cpu(),
                   lambda m, t: m(t))
    return {"ms": ms, "peak_bytes": peak, "launches": launches}


def train_model_parallel(hvd, seed: int):
    """Phases (a)-(f), each on a runtime initialized anew: step time and
    peak memory of each (and the encoder's launches)."""
    out = {}
    for path in ("gpt_ulysses_flash", "gpt_ring"):
        mesh_shape, overrides = MP_PATHS[path]
        out[path] = train_mesh_gpt(hvd, path, mesh_shape, **overrides)[0]
    out["gpt_moe"] = train_moe(hvd)
    out["gpt_remat"] = train_remat(hvd)
    out["gpt_pipeline"] = train_pipeline(hvd)
    out["encoder"] = train_encoder(hvd, seed)
    log(f"model-parallel phases: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# the vision phases (g)-(j)
# ---------------------------------------------------------------------------

def make_vision_slice(hvd, dev, path: str):
    """The model, optimizer and fixed synthetic batch of a vision phase:
    ``vgg16`` (VGG-16 through 4-bit max-min, ``scatter_allgather`` with
    error feedback, buckets of 512), ``vgg16_powersgd`` (through
    ``PowerSGDOptimizer`` at rank 4) or ``inception_v3`` (Inception V3
    through ``make_compressor("uni")``)."""
    from horovod_tpu_torch.compression import (CompressionConfig,
                                               MaxMinQuantizer,
                                               make_compressor)
    from horovod_tpu_torch.models import VGG, InceptionV3
    torch.manual_seed(0)
    if path == "inception_v3":
        model, image, lr = InceptionV3(num_classes=1000), INCEPTION_IMAGE, LR
    else:
        cfg = {} if VGG_CFG is None else {"cfg": VGG_CFG}
        model = VGG(num_classes=1000, image_size=VGG_IMAGE, **cfg)
        image, lr = VGG_IMAGE, VGG_LR
    model = model.to(dev, memory_format=torch.channels_last)
    sgd = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9)
    if path == "vgg16_powersgd":
        opt = hvd.PowerSGDOptimizer(sgd, rank=POWERSGD_RANK)
    else:
        compressor = make_compressor("uni") if path == "inception_v3" \
            else MaxMinQuantizer(bits=BITS, bucket_size=BUCKET)
        opt = hvd.DistributedOptimizer(
            sgd, named_parameters=model.named_parameters(),
            compression=CompressionConfig(
                compressor, reduction="scatter_allgather",
                error_feedback=True))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    images = torch.randn(BATCH, image, image, 3, generator=gen, device=dev)
    labels = torch.randint(0, 1000, (BATCH,), generator=gen, device=dev)
    return model, opt, images, labels


def vision_step(model, opt, images, labels, launched=None):
    """One training step; ``launched`` gets the reductions the hooks had
    launched when ``backward()`` returned."""
    def step():
        loss = forward_backward(model, opt, images, labels)
        if launched is not None:
            launched.append([opt.hook_launches])
        opt.step()
        return loss
    return step


def check_param_count(path: str, model, want: int) -> None:
    got = sum(p.numel() for p in model.parameters())
    if got != want:
        raise AssertionError(f"{path}: {got} parameters, expected {want}")


def train_vgg(hvd):
    """(g) VGG-16 through 4-bit max-min with cuDNN deterministic: 2
    warm-up and 10 timed steps (B1 twice, B3 once and B4 twice a step, B3
    and B4 on the packed route), the model's and optimizer's
    ``state_dict`` (error-feedback residuals included, through
    ``stack_ranks``) saved with ``save_checkpoint`` after timed step 5
    (out of the clock); then a fresh model and optimizer restored from it
    run steps 6-10 again, and must give the same losses and weights,
    bitwise. Last, the trained model against its CPU copy."""
    import shutil
    from horovod_tpu_torch.checkpoint import stack_ranks, unstack_rank
    path = "vgg16"
    dev = reinit(hvd, None)
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    ckpt = os.path.join(ROOT, "_smoke_checkpoints")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        model, opt, images, labels = make_vision_slice(hvd, dev, path)
        if VGG_CFG is None:
            check_param_count(path, model, VGG16_PARAMS)
        launched = []
        step = vision_step(model, opt, images, labels, launched)
        losses = [step() for _ in range(WARMUP)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        del launched[:]
        t0 = time.perf_counter()
        losses += [step() for _ in range(VGG_RESUME_AT)]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        hvd.save_checkpoint(ckpt, {"model": model.state_dict(),
                                   "opt": stack_ranks(opt.state_dict())},
                            step=WARMUP + VGG_RESUME_AT)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        straight = [step() for _ in range(STEPS - VGG_RESUME_AT)]
        torch.cuda.synchronize()
        seconds += time.perf_counter() - t0
        losses += straight
        launches, routes = read_launches(), read_routes()
        peak = torch.cuda.max_memory_allocated()
        losses = [float(v) for v in losses]
        log(f"{path}: VGG-16, batch {BATCH}, {VGG_IMAGE}x{VGG_IMAGE}, SGD "
            f"lr {VGG_LR} momentum 0.9, cuDNN deterministic; losses "
            f"{losses}")
        log(f"{path}: step {seconds / STEPS * 1e3:.3f} ms, "
            f"{BATCH * STEPS / seconds:.1f} images/s, peak memory "
            f"{peak / 2**30:.3f} GiB, launches in {STEPS} steps {launches}; "
            f"reductions launched before backward() returned {launched}")
        check_losses(losses)
        check_hook_launches(path, launched, [1])
        check_launches(path, launches, PATH_LAUNCHES[path], STEPS, routes,
                       DECODE_ROUTES)

        fresh, fresh_opt, _, _ = make_vision_slice(hvd, dev, path)
        t0 = time.perf_counter()
        saved = hvd.restore_checkpoint(ckpt)
        fresh.load_state_dict(saved["model"])
        fresh_opt.load_state_dict(unstack_rank(saved["opt"]))
        del saved
        restore_s = time.perf_counter() - t0
        resume = vision_step(fresh, fresh_opt, images, labels)
        resumed = [float(resume()) for _ in range(STEPS - VGG_RESUME_AT)]
        straight = [float(v) for v in straight]
        differ = [name for (name, p), q in zip(model.named_parameters(),
                                               fresh.parameters())
                  if not torch.equal(p, q)]
        log(f"{path}: checkpoint after step {VGG_RESUME_AT} saved in "
            f"{save_s:.3f} s, restored in {restore_s:.3f} s; steps "
            f"{VGG_RESUME_AT + 1}-{STEPS}: uninterrupted {straight}, "
            f"resumed {resumed}; parameters that differ {differ}")
        if resumed != straight or differ:
            raise AssertionError(f"{path}: the resumed run is not the "
                                 f"uninterrupted one")
        del fresh, fresh_opt, resume
        check_vision_copy(path, model, images[:1])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    return {"ms": seconds / STEPS * 1e3, "peak_bytes": peak,
            "launches": launches}


def check_vision_copy(path: str, model, small) -> None:
    """The trained model (fp32, eval mode) against a CPU copy of itself on
    ``small``, within rtol 1e-3."""
    model.eval()
    with torch.no_grad():
        got = model(small).cpu()
        ref = copy.deepcopy(model).cpu().float()(small.cpu())
    if got.shape != (small.shape[0], 1000) or not torch.isfinite(got).all():
        raise AssertionError(f"{path}: bad logits")
    torch.testing.assert_close(got, ref, rtol=1e-3,
                               atol=1e-3 * float(ref.abs().max()))
    log(f"{path}: trained model agrees with its CPU copy (fp32, rtol 1e-3)")


def train_vgg_powersgd(hvd):
    """(h) VGG-16 through ``PowerSGDOptimizer(SGD(momentum=0.9), rank=4)``:
    no kernel; the floats a step sends against the dense gradients'."""
    from horovod_tpu_torch.compression.powersgd import wire_floats
    path = "vgg16_powersgd"
    dev = reinit(hvd, None)
    model, opt, images, labels = make_vision_slice(hvd, dev, path)
    params = list(model.parameters())
    wire = wire_floats(params, POWERSGD_RANK)
    dense = sum(p.numel() for p in params)
    log(f"{path}: {wire[0]} factor floats and {wire[1]} dense floats a "
        f"step, against {dense} dense ({dense / sum(wire):.1f}x fewer)")
    if VGG_CFG is None and (wire != POWERSGD_WIRE or dense != VGG16_PARAMS):
        raise AssertionError(f"{path}: {wire} floats on the wire of "
                             f"{dense}, expected {POWERSGD_WIRE}")
    ms, launches, _ = timed_steps(path, vision_step(model, opt, images,
                                                    labels),
                                  WARMUP, STEPS)
    check_launches(path, launches, {})
    return {"ms": ms, "peak_bytes": torch.cuda.max_memory_allocated(),
            "wire_floats": wire}


def train_inception(hvd):
    """(i) Inception V3 through the normalized quantizer (4 bits, buckets
    of 512, linf): B5 twice and B6 three times a step, B5 on the packed
    bisection route; the trained model against its CPU copy at 75x75."""
    path = "inception_v3"
    dev = reinit(hvd, None)
    model, opt, images, labels = make_vision_slice(hvd, dev, path)
    if INCEPTION_IMAGE == 299:
        check_param_count(path, model, INCEPTION_PARAMS)
    if len(list(model.parameters())) != INCEPTION_LEAVES:
        raise AssertionError(f"{path}: not {INCEPTION_LEAVES} leaves")
    launched = []
    ms, launches, routes = timed_steps(
        path, vision_step(model, opt, images, labels, launched), WARMUP,
        STEPS)
    check_hook_launches(path, launched[WARMUP:], [1])
    check_launches(path, launches, PATH_LAUNCHES[path], STEPS, routes,
                   PATH_ROUTES[path])
    peak = torch.cuda.max_memory_allocated()
    check_vision_copy(path, model, images[:2, :75, :75].contiguous())
    return {"ms": ms, "peak_bytes": peak, "launches": launches}


def check_autotune(hvd):
    """(j) ``autotune_compressed("ici", "dcn")`` on ``{"dcn": 1, "ici":
    1}`` at 1 MiB and 16 MiB with its default 4-bit max-min compressor:
    the exact launches of its compressed calls (B3 and B4 on the packed
    route), the table, and the crossover link speed of each size from the
    measured compressed call. At a world of one no byte crosses a link:
    the compressed call's time is its compression work and the dense
    call's a copy, so neither names a winner."""
    from horovod_tpu_torch.compression import MaxMinQuantizer
    path = "autotune_compressed"
    reinit(hvd, {"dcn": 1, "ici": 1})
    reset_launches()
    table = hvd.autotune_compressed("ici", "dcn", sizes=AUTOTUNE_SIZES,
                                    reps=AUTOTUNE_REPS)
    torch.cuda.synchronize()
    launches, routes = read_launches(), read_routes()
    check_launches(path, launches, AUTOTUNE_LAUNCHES, AUTOTUNE_CALLS, routes,
                   DECODE_ROUTES)
    out = {}
    for nbytes, (winner, dense_s, comp_s) in sorted(table.items()):
        comp_bytes = hvd.payload_nbytes(MaxMinQuantizer(bits=4), nbytes // 4)
        cross = hvd.crossover_gbps(nbytes, comp_bytes, comp_s)
        out[nbytes] = {"dense_ms": dense_s * 1e3, "compressed_ms":
                       comp_s * 1e3, "payload_bytes": comp_bytes,
                       "crossover_gbps": cross, "table_says": winner}
        log(f"{path}: {nbytes} bytes: dense {dense_s * 1e3:.4f} ms, "
            f"compressed {comp_s * 1e3:.4f} ms, payload {comp_bytes} "
            f"bytes; compression pays below {cross:.2f} Gb/s (wire time 0 "
            f"at a world of one: no winner is read from '{winner}')")
    return {"table": out, "launches": launches}


def train_vision(hvd):
    """Phases (g)-(j), each on a runtime initialized anew."""
    out = {"vgg16": train_vgg(hvd), "vgg16_powersgd":
           train_vgg_powersgd(hvd), "inception_v3": train_inception(hvd),
           "autotune_compressed": check_autotune(hvd)}
    log(f"vision phases: {json.dumps(out)}")
    return out


def make_gpt_slice(hvd, dev):
    """The GPT path's model, optimizer and fixed batch of tokens."""
    from horovod_tpu_torch.models import GPT, GPTConfig

    cfg = GPTConfig(**GPT_CONFIG)
    model = GPT(cfg, seed=0).to(dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=GPT_LR),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    return (model, opt) + gpt_tokens(dev, cfg)


def gpt_forward_backward(model, opt, tokens, targets):
    from horovod_tpu_torch.models import loss_fn

    opt.zero_grad(set_to_none=True)
    loss = loss_fn(model, tokens, targets)
    loss.backward()
    return loss.detach()


def train_gpt(hvd, dev):
    """The GPT path: 2 warm-up and 10 timed steps of SGD through the dense
    DistributedOptimizer, then the trained model against its CPU copy."""
    model, opt, tokens, targets = make_gpt_slice(hvd, dev)
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != GPT_PARAMS:
        raise AssertionError(f"GPT has {n_params} parameters")

    launched = []

    def step():
        loss = gpt_forward_backward(model, opt, tokens, targets)
        launched.append([opt.hook_launches])
        opt.step()
        return loss

    units = len(opt._units)
    losses = [step() for _ in range(WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    del launched[:]
    t0 = time.perf_counter()
    losses += [step() for _ in range(STEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    losses = [float(v) for v in losses]
    log(f"gpt: {n_params} parameters, L{cfg.num_layers} d{cfg.embed_dim} "
        f"{cfg.num_heads}x{cfg.head_dim} heads, batch {GPT_BATCH} x "
        f"{GPT_SEQ} tokens, bf16, remat {cfg.remat}, lr {GPT_LR}; losses "
        f"{losses}")
    log(f"gpt: step {seconds / STEPS * 1e3:.3f} ms, "
        f"{GPT_BATCH * GPT_SEQ * STEPS / seconds:.1f} tokens/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, launches in "
        f"{STEPS} steps {launches}")
    log(f"gpt: {units} gradient buckets; launched before backward() "
        f"returned, each timed step: {launched}")
    check_losses(losses)
    check_hook_launches("gpt", launched, [GPT_HOOK_LAUNCHES])
    # B7 runs twice a layer (forward, and the recompute of remat="full"),
    # B8 and B9 once in the backward.
    layers = cfg.num_layers
    check_launches("gpt", launches, {"flash_fwd": 2 * layers,
                                     "flash_dkdv": layers,
                                     "flash_dq": layers})
    check_flash_routes("gpt", launches)
    log("gpt: every B7, B8 and B9 launch on the tensor cores")
    trained, cpu = gpt_fp32_copies(model)
    check_cpu_copy("gpt", dev, trained, cpu, lambda m, t: m(t))
    return launches


def measure(kernels, norm_kernels, dev, n_values: int, launches, errors,
            rates):
    """B1–B6 at the ResNet path's shape (4 bits, buckets of 512), and B5
    also with the 128-level table of 8 bits. Bound: each input read once
    and each output written once at the memory rate (B2 and B5 write their
    codes packed), against the work at the card's rate outside the tensor
    cores. B1, B3, B4 and B6 count operations per padded value at the fp32
    rate (integer operations counted as fp32 ones): B1 7 (min, max,
    subtract, divide, round, two clamps), B3 3 and B4 2 (a multiply and an
    add), B6 4 (shift, clip, sign, multiply). B2 and B5 count issue slots,
    one per warp instruction and lane, at half the fp32 rate (one FMA, two
    operations, takes one slot): B2 the sum of ``B2_SLOTS`` per value, the
    least its function needs; B5 ``15 + 3 s`` for s bisection steps
    (abs and max for the norm, divide, a load, compare and select per
    step, two distances, the tie check, the code and its packing).
    B3 and B4 read the payload packed at 4 bits (B3 from one rank, as at
    the path's world of one, and from ``B3_RANKS`` ranks of
    ``B3_RANK_BUCKETS`` buckets each, the chunk a rank of a world of 4
    sums). Yardstick of B4: the one PyTorch call that computes ``min + q
    unit``, ``torch.addcmul``, on the unpacked uint8 codes. It rounds once
    where B4 rounds twice and reads a byte a code, so it measures rate
    only; B4 stays bitwise against its plain version. B2 and B5 (4 and 8
    bits), B3 and B4 are timed in ``FLASH_ROUNDS`` alternating rounds
    (medians) beside their packed route on an input that is not aligned
    (B2, B5: one value into its buffer, read one value at a time; B3, B4:
    one byte, read one byte at a time). All must give the same bytes.
    Every ``ms``, ``plain_ms`` and ``library_ms`` is CUDA events around
    eager calls, as for every other kernel; B3's and B4's rounds are also
    timed as CUDA graphs of the calls (``time_ms(graph=True)``: device
    time without the wrappers' host cost, which at 0.02-0.05 ms a kernel
    shows), in the ``*_graph`` fields. Their calls cycle through
    ``ROTATE`` copies of the inputs and keep ``ROTATE`` outputs alive
    (:func:`rotating`), so that no reading is served from the L2."""
    x = torch.randn(n_values, device=dev) * 1e-2
    shifted = at_offset(x, 1)
    work, inputs = kernel_work(kernels, norm_kernels, x, rates[1],
                               extra=True)
    packed = packed_rounds(kernels, norm_kernels, x, shifted,
                           inputs["tables"])
    decoded, graphed = decode_rounds(kernels, inputs["decode"],
                                     inputs["codes"])
    packed.update(decoded)
    library = {"maxmin_dequantize": (
        packed["maxmin_dequantize"], packed["addcmul"],
        "torch.addcmul(mn[:, None], q, unit[:, None]) on the unpacked uint8 "
        "codes (rate only: one rounding, a byte a code)")}
    for name in ("maxmin_quantize_stochastic", "norm_quantize",
                 "maxmin_dequantize_sum"):
        library[name] = (packed[name], None, None)
    rows = []
    for name in (n for n in work if n in REPLACES):
        source = "norm" if name.startswith("norm") else "maxmin"
        ms, lib_ms, lib = library.get(name, (None, None, None))
        row = {"name": name, "route": "cuda", "source": SOURCES[source],
               "replaces": REPLACES[name], "launches": launches[name],
               "max_abs_err": errors[name],
               **bounded(work[name], rates, ms), "library_ms": lib_ms}
        if lib is not None:
            row["library"] = lib
        if name in graphed:
            row.update(graphed[name])
        if name == "norm_quantize":
            row.update({f"{k}_at_8_bits": v for k, v in bounded(
                work["norm_quantize_8"], rates,
                packed["norm_quantize_8"]).items()})
        if name == "maxmin_dequantize_sum":
            four = f"maxmin_dequantize_sum_{B3_RANKS}_ranks"
            row.update({f"{k}_at_{B3_RANKS}_ranks": v for k, v in bounded(
                work[four], rates, packed[four]).items()})
            row.update({f"{k}_at_{B3_RANKS}_ranks": v for k, v in
                        graphed[four].items()})
            log(f"kernel maxmin_dequantize_sum at {B3_RANKS} ranks of "
                f"{B3_RANK_BUCKETS} buckets: "
                f"{row['ms_at_4_ranks']:.4f} ms (plain "
                f"{row['plain_ms_at_4_ranks']:.4f} ms, bound "
                f"{row['bound_ms_at_4_ranks']:.6f} ms by "
                f"{row['bound_by_at_4_ranks']})")
        rows.append(row)
        nbytes, ops = work[name][2:]
        log(f"kernel {name}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}"
            f" ms, bound {row['bound_ms']:.4f} ms by {row['bound_by']}, "
            f"{nbytes} bytes, {ops:.0f} operations at the fp32 rate)"
            + (f"; {lib} {lib_ms:.4f} ms" if lib else ""))
    eight = next(row for row in rows if row["name"] == "norm_quantize")
    log(f"kernel norm_quantize at 8 bits (128 levels): "
        f"{eight['ms_at_8_bits']:.4f} ms (plain "
        f"{eight['plain_ms_at_8_bits']:.4f} ms, bound "
        f"{eight['bound_ms_at_8_bits']:.4f} ms by "
        f"{eight['bound_by_at_8_bits']})")
    return rows


def kernel_work(kernels, norm_kernels, x, fp32: float, extra: bool = False,
                copies: int = ROTATE):
    """B1-B6 on ``x`` at 4 bits and buckets of 512 (B5 and B6 with the
    uniform table, linf), and the terms of each one's bound as
    :func:`measure` counts them: ``work`` maps a kernel's name to (kernel,
    plain, bytes moved, operations at the fp32 rate). B3 (one rank) and
    B4 decode ``x``'s packed payload, each call on the next of ``copies``
    copies (:func:`rotating`). With ``extra``, also B3 on ``B3_RANKS``
    ranks of ``B3_RANK_BUCKETS`` buckets and B5 with the 8-bit table, as
    ``maxmin_dequantize_sum_4_ranks`` and ``norm_quantize_8``. Returns
    ``work`` and the inputs: ``codes`` (B1's, unpacked), ``decode`` (B3's
    and B4's copies by name) and ``tables`` (by bits)."""
    from horovod_tpu_torch.compression.quantize import (default_levels,
                                                        pack_bits,
                                                        unpack_bits)
    issue = fp32 / 2
    n_values = x.numel()
    n_buckets = -(-n_values // BUCKET)
    padded = n_buckets * BUCKET
    codes, mn, unit = kernels.maxmin_quantize(x, BITS, BUCKET)
    q = pack_bits(codes.view(1, -1), BITS)
    decode = {"maxmin_dequantize": (q, mn, unit),
              "maxmin_dequantize_sum": (q, mn[None], unit[None])}
    if extra:
        gen = torch.Generator(device=x.device).manual_seed(4)
        decode[f"maxmin_dequantize_sum_{B3_RANKS}_ranks"] = packed_ranks(
            gen, x.device, B3_RANKS, B3_RANK_BUCKETS, BITS, BUCKET)
    decode = {name: [tuple(t.clone() for t in args) for _ in range(copies)]
              for name, args in decode.items()}
    tables = {bits: norm_kernels.LevelTable(default_levels(bits, "uni"),
                                            x.device)
              for bits in ((BITS, 8) if extra else (BITS,))}
    nq, nrm = norm_kernels.norm_quantize(x, tables[BITS], BUCKET, False,
                                         BITS)
    nq = unpack_bits(nq, BITS, BUCKET)

    def decode_work(name, ops_per_value):
        copies = decode[name]
        qd, mnd, _ = copies[0]
        b4 = name == "maxmin_dequantize"
        kernel = kernels.maxmin_dequantize if b4 else \
            kernels.maxmin_dequantize_sum
        plain = kernels.maxmin_dequantize_plain if b4 else \
            kernels.maxmin_dequantize_sum_plain
        values = mnd.shape[-1] * BUCKET
        return (rotating(lambda *a: kernel(*a, BITS, BUCKET), copies),
                rotating(lambda *a: plain(*a, BITS, BUCKET), copies),
                qd.numel() + 8 * mnd.numel() + 4 * values,
                ops_per_value * qd.shape[0] * values)

    def norm_work(bits):
        table = tables[bits]
        steps = table.levels.shape[0].bit_length()
        return (lambda: norm_kernels.norm_quantize(x, table, BUCKET, False,
                                                   bits),
                lambda: norm_kernels.norm_quantize_plain(x, table.levels,
                                                         BUCKET, False),
                4 * n_values + padded * bits // 8 + 4 * n_buckets,
                (15 + 3 * steps) * padded * fp32 / issue)

    work = {
        "maxmin_quantize": (
            lambda: kernels.maxmin_quantize(x, BITS, BUCKET),
            lambda: kernels.maxmin_quantize_plain(x, BITS, BUCKET),
            4 * n_values + padded + 8 * n_buckets, 7 * padded),
        "maxmin_quantize_stochastic": (
            lambda: kernels.maxmin_quantize_stochastic(x, BITS, BUCKET, 0),
            lambda: kernels.maxmin_quantize_stochastic_plain(x, BITS, BUCKET,
                                                             0),
            4 * n_values + padded * BITS // 8 + 8 * n_buckets,
            sum(B2_SLOTS.values()) * padded * fp32 / issue),
        "maxmin_dequantize_sum": decode_work("maxmin_dequantize_sum", 3),
        "maxmin_dequantize": decode_work("maxmin_dequantize", 2),
        "norm_quantize": norm_work(BITS),
        "norm_dequantize": (
            lambda: norm_kernels.norm_dequantize(nq, tables[BITS].levels,
                                                 nrm),
            lambda: norm_kernels.norm_dequantize_plain(
                nq, tables[BITS].levels, nrm),
            padded + 4 * n_buckets + 4 * padded, 4 * padded),
    }
    if extra:
        four = f"maxmin_dequantize_sum_{B3_RANKS}_ranks"
        work[four] = decode_work(four, 3)
        work["norm_quantize_8"] = norm_work(8)
    return work, {"codes": codes, "decode": decode, "tables": tables}


def bounded(work, rates, ms=None):
    """``ms`` (timed here if not given) and the plain version's time of
    one entry of :func:`kernel_work`, beside its bound: the larger of its
    bytes at the memory rate and its operations at the fp32 rate."""
    kernel, plain, nbytes, ops = work
    bandwidth, fp32, _ = rates
    byte_ms, op_ms = nbytes / bandwidth * 1e3, ops / fp32 * 1e3
    return {"ms": time_ms(kernel) if ms is None else ms,
            "plain_ms": time_ms(plain),
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations"}


def measure_at(kernels, norm_kernels, dev, rows, errors, vision, rates):
    """Each path's other shapes (``AT_SHAPES``): its kernels' rows get
    the time, plain time and bound at that path's buffer (from
    :func:`kernel_work`, by CUDA events over eager calls), the error of
    the check at that shape and the launches of the path's run, as fields
    with the shape's suffix. The inputs (96 MB and more) do not fit the
    L2, so B3 and B4 decode one copy of theirs."""
    for suffix, (n, phase, names) in AT_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(5)
        x = torch.randn(n, generator=gen, device=dev) * 1e-2
        work, _ = kernel_work(kernels, norm_kernels, x, rates[1], copies=1)
        for row in rows:
            name = row["name"]
            if name not in names:
                continue
            timed = bounded(work[name], rates)
            row.update({k + suffix: v for k, v in timed.items()})
            row["max_abs_err" + suffix] = errors[name + suffix]
            row["launches" + suffix] = vision[phase]["launches"][name]
            log(f"kernel {name} at {n} values: {timed['ms']:.4f} ms (plain "
                f"{timed['plain_ms']:.4f} ms, bound {timed['bound_ms']:.6f} "
                f"ms by {timed['bound_by']}, {work[name][2]} bytes)")
        del work
        torch.cuda.empty_cache()


def packed_rounds(kernels, norm_kernels, x, shifted, tables):
    """B2 and B5 (4 and 8 bits) on their packed routes, in ``FLASH_ROUNDS``
    alternating rounds beside the same route on ``shifted`` (the same
    values at an offset of one value, read one value at a time). The
    payloads must be the same bytes. Returns the packed route's median ms
    of each on the aligned input."""
    def b2(t):
        return kernels.maxmin_quantize_stochastic(t, BITS, BUCKET, 0)[0]

    def b5(t, bits):
        return norm_kernels.norm_quantize(t, tables[bits], BUCKET, False,
                                          bits)[0]

    groups = {
        "maxmin_quantize_stochastic": (lambda: b2(x), lambda: b2(shifted)),
        "norm_quantize": (lambda: b5(x, BITS), lambda: b5(shifted, BITS)),
        "norm_quantize_8": (lambda: b5(x, 8), lambda: b5(shifted, 8))}
    medians = {}
    for name, (packed, unaligned) in groups.items():
        fns = {"packed": packed, "packed_unaligned": unaligned}
        outs = {k: fn() for k, fn in fns.items()}
        flat = {k: v.reshape(-1) for k, v in outs.items()}
        if any(not torch.equal(v, flat["packed"]) for v in flat.values()):
            raise AssertionError(f"{name}: the routes' payloads differ")
        medians[name] = timed_rounds(name, fns)["packed"]
    return medians


def timed_rounds(name: str, fns, graph: bool = False):
    """``paired_ms`` of ``fns``, logged with the clocks before and after;
    returns the medians."""
    log(f"{name} timing: clocks.sm, clocks.max.sm, power.draw before "
        f"{smi_clocks()}")
    med, readings = paired_ms(fns, graph=graph)
    log(f"{name} timing: clocks.sm, clocks.max.sm, power.draw after "
        f"{smi_clocks()}")
    log(f"{name} timing: {FLASH_ROUNDS} alternating rounds, ms "
        f"{json.dumps(readings)}; medians {json.dumps(med)}")
    return med


def rotating(fn, inputs):
    """A function that calls ``fn`` on each tuple of ``inputs`` in turn and
    keeps as many of its last outputs alive, so that successive calls read
    and write other memory."""
    turn = itertools.cycle(inputs)
    alive = collections.deque(maxlen=len(inputs))

    def call():
        alive.append(fn(*next(turn)))
        return alive[-1]
    return call


def decode_rounds(kernels, inputs, codes):
    """B4 and B3 (one rank, and ``B3_RANKS`` ranks) on the packed payload,
    in ``FLASH_ROUNDS`` alternating rounds beside the same kernel on the
    payload one byte into its buffer (read one byte at a time); B4 also
    beside ``torch.addcmul`` on ``codes``, its unpacked uint8 codes. Each
    function cycles through the ``ROTATE`` copies of its inputs
    (:func:`rotating`). The outputs on the first copy must be the
    same bytes. The rounds run twice: with CUDA events around eager calls,
    and as CUDA graphs of the calls (device time only). Returns the eager
    medians of the packed route (by name) and of addcmul, and by name the
    fields of the graph medians (``device_ms_graph``,
    ``library_ms_graph``)."""
    eager, graphed = {}, {}
    for name, copies in inputs.items():
        kernel = kernels.maxmin_dequantize if name == "maxmin_dequantize" \
            else kernels.maxmin_dequantize_sum
        def decode(q, mn, unit, k=kernel):
            return k(q, mn, unit, BITS, BUCKET)

        shifted = [(at_offset(q, 1), mn, unit) for q, mn, unit in copies]
        designs = {"packed": (decode, copies),
                   "packed_misaligned": (decode, shifted)}
        outs = {k: fn(*args[0]) for k, (fn, args) in designs.items()}
        if any(not bitwise(v, outs["packed"]) for v in outs.values()):
            raise AssertionError(f"{name}: the designs' outputs differ")
        fns = {k: rotating(fn, args) for k, (fn, args) in designs.items()}
        if name == "maxmin_dequantize":
            fns["addcmul"] = rotating(
                lambda c, mn, unit: torch.addcmul(mn[:, None], c,
                                                  unit[:, None]),
                [(codes.clone(), mn, unit) for _, mn, unit in copies])
        med = timed_rounds(name, fns)
        med_graph = timed_rounds(f"{name} (CUDA graphs)", fns, graph=True)
        eager[name] = med["packed"]
        fields = {"device_ms_graph": med_graph["packed"]}
        if "addcmul" in med:
            eager["addcmul"] = med["addcmul"]
            fields["library_ms_graph"] = med_graph["addcmul"]
        graphed[name] = fields
    return eager, graphed


def parent_kernels(parent: str):
    """The parent checkout's B9 (the ``mma.sync`` design this tree's
    ``wgmma`` kernel replaces), built from its own sources by its own
    ``utils/cuda_build.py`` into its own tree and called through its C
    entry point, which takes the same arguments as this tree's: by name, a
    function with the signature of ``flash_dq``. It raises if its launch
    fails or its library reports another route than the parent's
    ``mma.sync`` one (1)."""
    import ctypes
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "parent_cuda_build",
        os.path.join(parent, "horovod_tpu_torch", "utils", "cuda_build.py"))
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    lib = ctypes.CDLL(str(build.build()))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    shape = [i32, i32, i32, f32, i32, i32, ptr]  # bh S D scale causal bf16
    lib.hvd_flash_dq.argtypes = [ptr] * 7 + shape
    lib.hvd_flash_dq.restype = i32
    lib.hvd_flash_last_route.argtypes = []
    lib.hvd_flash_last_route.restype = i32

    def flash_dq(q, k, v, do, lse, delta, scale, causal):
        dq = torch.empty_like(q)
        bh, s, d = q.shape
        err = lib.hvd_flash_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, s, d, scale,
            int(causal), 1, torch.cuda.current_stream().cuda_stream)
        route = lib.hvd_flash_last_route()
        if err or route != 1:
            raise RuntimeError(f"parent flash_dq: error {err}, route {route}")
        return dq

    return {"flash_dq": flash_dq}


def check_parent(flash, dev, parent):
    """The parent's B9 within the same bound of the plain version as this
    tree's, at the GPT path's shape (causal) and the encoder's
    (non-causal); returns its largest error by causality."""
    heads, d = GPT_CONFIG["num_heads"], GPT_CONFIG["head_dim"]
    theirs = types.SimpleNamespace(**{**vars(flash), **parent})
    errors = {}
    for causal in (True, False):
        errors[causal], ratios = flash_errors(theirs, *flash_inputs(
            dev, GPT_BATCH * heads, GPT_SEQ, d, torch.bfloat16, 7), causal)
        log(f"parent B9 (causal={causal}): within the bound, largest "
            f"error over it {ratios['dq']}")
    return errors


def smi_clocks() -> str:
    """The card's SM clock, its maximum and the power draw, now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def paired_ms(fns, rounds: int = FLASH_ROUNDS, graph: bool = False):
    """Median of ``rounds`` ``time_ms`` readings of each function, taken in
    alternating rounds (every function once per round, in order), so that
    a kernel and its yardstick see the same clocks."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(time_ms(fn, graph=graph))
    return {name: statistics.median(t) for name, t in times.items()}, times


def parent_rounds(parent, args):
    """The parent's B9 as a function for the timing rounds (none without
    ``parent``)."""
    if not parent:
        return {}
    return {"parent_flash_dq": lambda: parent["flash_dq"](*args)}


def measure_noncausal(flash, q, k, v, do, heads, sdpa_grad, rates,
                      parent=None):
    """B7, B8 and B9 non-causal at the encoder's shape (BH 16, S 4096, D
    64, bf16): every one of the ``BH * S * S`` pairs, 2 D operations per
    pair and product, beside SDPA (``is_causal=False``) and, with
    ``parent``, the parent's B9 in alternating rounds, and their plain
    versions; ``noncausal_*`` fields by kernel."""
    bandwidth, _, tensor = rates
    bh, s, d = q.shape
    scale = 1.0 / math.sqrt(d)
    o, lse = flash.flash_fwd(q, k, v, scale, False)
    delta = (do.float() * o.float()).sum(dim=-1)
    args = (q, k, v, do, lse, delta, scale, False)
    sdpa_out = F.scaled_dot_product_attention(*heads, is_causal=False)
    medians, readings = paired_ms({
        "flash_fwd": lambda: flash.flash_fwd(q, k, v, scale, False),
        "sdpa_forward": lambda: F.scaled_dot_product_attention(
            *heads, is_causal=False),
        "flash_dkdv": lambda: flash.flash_dkdv(*args),
        "flash_dq": lambda: flash.flash_dq(*args),
        "sdpa_backward": lambda: torch.autograd.grad(
            sdpa_out, heads, sdpa_grad, retain_graph=True),
        **parent_rounds(parent, args)})
    log(f"flash timing, non-causal: {FLASH_ROUNDS} alternating rounds, ms "
        f"{json.dumps(readings)}")
    tensor_bytes = q.numel() * q.element_size()
    stat_bytes = bh * s * 4
    pairs = bh * s * s
    work = {"flash_fwd": (lambda: flash.flash_fwd_plain(q, k, v, scale,
                                                        False),
                          4 * tensor_bytes + stat_bytes, 2, "sdpa_forward"),
            "flash_dkdv": (lambda: flash.flash_dkdv_plain(*args),
                           6 * tensor_bytes + 2 * stat_bytes, 4,
                           "sdpa_backward"),
            "flash_dq": (lambda: flash.flash_dq_plain(*args),
                         5 * tensor_bytes + 2 * stat_bytes, 3,
                         "sdpa_backward")}
    out = {}
    for name, (plain, nbytes, products, lib) in work.items():
        ops = 2 * d * products * pairs
        byte_ms, op_ms = nbytes / bandwidth * 1e3, ops / tensor * 1e3
        out[name] = {"noncausal_ms": medians[name],
                     "noncausal_plain_ms": time_ms(plain),
                     "noncausal_bound_ms": max(byte_ms, op_ms),
                     "noncausal_bound_by": "bytes" if byte_ms >= op_ms
                     else "operations",
                     "noncausal_library_ms": medians[lib]}
        if "parent_" + name in medians:
            out[name]["noncausal_parent_ms"] = medians["parent_" + name]
        log(f"kernel {name} non-causal: {medians[name]:.4f} ms (plain "
            f"{out[name]['noncausal_plain_ms']:.4f} ms, bound "
            f"{max(byte_ms, op_ms):.4f} ms, {ops} operations; SDPA "
            f"{medians[lib]:.4f} ms)")
    return out


def measure_flash(flash, dev, launches, errors, rates, noncausal_launches,
                  noncausal_errors, parent=None):
    """B7, B8 and B9 at the GPT path's shape. Bound: the causal pairs this
    run computes, 2 D operations per pair and product (B7 2 products, B8 4,
    B9 3) at the bf16 tensor-core rate, against each input read once and
    each output written once at the memory rate. Yardstick: PyTorch's
    scaled_dot_product_attention, forward for B7, and its backward (dQ, dK
    and dV together) for B8 and B9; and the port's whole backward (the
    delta pass, B8 and B9) against that backward, logged. Kernels and
    yardsticks are timed in ``FLASH_ROUNDS`` alternating rounds; the
    medians are reported. With ``parent`` (:func:`parent_kernels`), the
    parent's B9 runs in the same rounds, causal and non-causal, after
    :func:`check_parent` held it to the same bound: the ``parent_ms`` and
    ``noncausal_parent_ms`` fields of its row."""
    bandwidth, _, tensor = rates
    bh, s = GPT_BATCH * GPT_CONFIG["num_heads"], GPT_SEQ
    d = GPT_CONFIG["head_dim"]
    q, k, v, do = flash_inputs(dev, bh, s, d, torch.bfloat16, 7)
    scale = 1.0 / math.sqrt(d)
    o, lse = flash.flash_fwd(q, k, v, scale, True)
    delta = (do.float() * o.float()).sum(dim=-1)
    pairs = bh * s * (s + 1) // 2
    tensor_bytes = q.numel() * q.element_size()
    stat_bytes = bh * s * 4

    heads = [t.view(GPT_BATCH, -1, s, d).detach().requires_grad_()
             for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*heads, is_causal=True)
    sdpa_grad = do.view(GPT_BATCH, -1, s, d)
    args = (q, k, v, do, lse, delta, scale, True)

    def port_backward():
        dlt = (do.float() * o.float()).sum(dim=-1)
        flash.flash_dkdv(q, k, v, do, lse, dlt, scale, True)
        flash.flash_dq(q, k, v, do, lse, dlt, scale, True)

    log(f"flash timing: clocks.sm, clocks.max.sm, power.draw before "
        f"{smi_clocks()}")
    medians, readings = paired_ms({
        "flash_fwd": lambda: flash.flash_fwd(q, k, v, scale, True),
        "sdpa_forward": lambda: F.scaled_dot_product_attention(
            *heads, is_causal=True),
        "flash_dkdv": lambda: flash.flash_dkdv(*args),
        "flash_dq": lambda: flash.flash_dq(*args),
        "sdpa_backward": lambda: torch.autograd.grad(
            sdpa_out, heads, sdpa_grad, retain_graph=True),
        "port_backward": port_backward,
        **parent_rounds(parent, args)})
    log(f"flash timing: clocks.sm, clocks.max.sm, power.draw after "
        f"{smi_clocks()}")
    log(f"flash timing: {FLASH_ROUNDS} alternating rounds, ms "
        f"{json.dumps(readings)}")
    log(f"flash backward: delta pass + B8 + B9 {medians['port_backward']:.4f}"
        f" ms against SDPA's backward {medians['sdpa_backward']:.4f} ms "
        f"({medians['port_backward'] / medians['sdpa_backward']:.2f}x)")
    work = {
        # name: (plain, bytes, products, library ms, library call)
        "flash_fwd": (
            lambda: flash.flash_fwd_plain(q, k, v, scale, True),
            4 * tensor_bytes + stat_bytes, 2, medians["sdpa_forward"],
            "scaled_dot_product_attention(is_causal=True) forward"),
        "flash_dkdv": (
            lambda: flash.flash_dkdv_plain(*args),
            6 * tensor_bytes + 2 * stat_bytes, 4, medians["sdpa_backward"],
            "its backward: dQ, dK and dV together"),
        "flash_dq": (
            lambda: flash.flash_dq_plain(*args),
            5 * tensor_bytes + 2 * stat_bytes, 3, medians["sdpa_backward"],
            "its backward: dQ, dK and dV together"),
    }
    noncausal = measure_noncausal(flash, q, k, v, do, heads, sdpa_grad,
                                  rates, parent)
    rows = []
    for name, (plain, nbytes, products, lib_ms, lib) in work.items():
        ops = 2 * d * products * pairs
        byte_ms, op_ms = nbytes / bandwidth * 1e3, ops / tensor * 1e3
        ms = medians[name]
        plain_ms = time_ms(plain)
        kernel, source = FLASH_KERNELS[name]
        row = {
            "name": name, "kernel": kernel, "route": "cuda",
            "source": SOURCES[source], "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": errors[name],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": lib_ms, "library": lib,
            "noncausal_launches": noncausal_launches[name],
            "noncausal_max_abs_err": noncausal_errors[name],
            **noncausal[name]}
        if "parent_" + name in medians:
            row["parent_ms"] = medians["parent_" + name]
            log(f"kernel {name}: {ms:.4f} ms against the parent's "
                f"{row['parent_ms']:.4f} ms causal, "
                f"{row['noncausal_ms']:.4f} against "
                f"{row['noncausal_parent_ms']:.4f} ms non-causal")
        rows.append(row)
        log(f"kernel {name} ({kernel}): {ms:.4f} ms (plain {plain_ms:.4f} "
            f"ms, bound {max(byte_ms, op_ms):.4f} ms, {ops} operations, "
            f"{nbytes} bytes; {lib} {lib_ms:.4f} ms)")
    return rows


# ---------------------------------------------------------------------------
# (k) the process-mode native core: ranks sharing the one card
# ---------------------------------------------------------------------------

def process_launches(n: int):
    """(k3)'s launches a step: B1 quantizes the fused group once; B4
    decodes it once for the error-feedback residual and once for each
    rank's gathered payload."""
    return {"maxmin_quantize": 1, "maxmin_dequantize": n + 1}


def process_menu(hvd, dev, r: int, n: int) -> int:
    """(k1): the collective menu through the core on tensors on ``dev``,
    each result equal to what the host computes from every rank's inputs
    (integers, and scales by powers of two, so that every result is
    exact); the error classes on every rank. Returns the results
    checked."""
    checked = [0]

    def same(what, got, want):
        got = got.cpu()
        if got.dtype != want.dtype or got.shape != want.shape or \
                not torch.equal(got, want):
            raise AssertionError(f"(k1) {what}: {got} against {want}")
        checked[0] += 1

    def vals(q, rows=6):
        return ((torch.arange(rows * 4).view(rows, 4) * (q + 3)) % 17
                - 8).double()

    stack = torch.stack([vals(q) for q in range(n)])
    wants = {"Sum": stack.sum(0), "Min": stack.min(0).values,
             "Max": stack.max(0).values, "Average": stack.sum(0) / n}
    for dtype in (torch.float32, torch.bfloat16, torch.float16, torch.int32):
        x = vals(r).to(dtype).to(dev)
        floating = dtype.is_floating_point
        for op, want in wants.items():
            if op == "Average" and not floating:
                # The core scales integers by llround.
                want = want.sign() * (want.abs() + 0.5).floor()
            same(f"{dtype} {op}", hvd.allreduce(
                x, op=getattr(hvd, op), name=f"k1.{dtype}.{op}"),
                want.to(dtype))
        if not floating:
            continue
        same(f"{dtype} Sum, prescale 0.5, postscale 4", hvd.allreduce(
            x, op=hvd.Sum, prescale_factor=0.5, postscale_factor=4.0,
            name=f"k1.{dtype}.scaled"), (stack.sum(0) * 2).to(dtype))
        if dtype != torch.float32:
            continue  # the core's Adasum takes fp32 and fp64
        # Orthogonal vectors: Adasum adds them.
        rows = torch.zeros(n, 6, 4, dtype=torch.float64)
        for q in range(n):
            rows[q, q] = vals(q)[q]
        same(f"{dtype} Adasum", hvd.allreduce(
            rows[r].to(dtype).to(dev), op=hvd.Adasum,
            name=f"k1.{dtype}.adasum"), rows.sum(0).to(dtype))
    group = [vals(r)[:3].float(), vals(r).reshape(-1)[:5].float(),
             vals(r).reshape(-1)[:7].to(torch.bfloat16)]
    for i, got in enumerate(hvd.grouped_allreduce(
            [t.to(dev) for t in group], op=hvd.Sum, name="k1.group")):
        same(f"grouped {i}", got, sum(
            [vals(q)[:3], vals(q).reshape(-1)[:5],
             vals(q).reshape(-1)[:7]][i] for q in range(n)).to(
                 group[i].dtype))
    root = n - 1
    same("broadcast", hvd.broadcast(vals(r).float().to(dev), root,
                                    name="k1.bc"), vals(root).float())
    same("allgather", hvd.allgather(vals(r, r + 1).float().to(dev),
                                    name="k1.ag"),
         torch.cat([vals(q, q + 1) for q in range(n)]).float())
    sends = [[(q + j) % 3 for j in range(n)] for q in range(n)]
    rows = [vals(q, sum(sends[q])).float() for q in range(n)]
    got, recv = hvd.alltoall(rows[r].to(dev), splits=sends[r],
                             name="k1.a2a")
    same("alltoall", got, torch.cat(
        [rows[q][sum(sends[q][:r]):sum(sends[q][:r + 1])]
         for q in range(n)]))
    same("alltoall received splits", recv,
         torch.tensor([sends[q][r] for q in range(n)], dtype=torch.int32))
    same("reducescatter", hvd.reducescatter(
        vals(r, 3 * n).float().to(dev), op=hvd.Sum, name="k1.rs"),
        sum(vals(q, 3 * n) for q in range(n))[3 * r:3 * r + 3].float())
    if hvd.broadcast_object({"rank": r, "v": [r] * 3}, 0) != \
            {"rank": 0, "v": [0, 0, 0]} or \
            hvd.allgather_object(r) != list(range(n)):
        raise AssertionError("(k1) object collectives")
    checked[0] += 2
    def raises(what, cls, call):
        try:
            call()
        except cls as e:
            log(f"(k1) {what}: {cls.__name__}: {e}")
            checked[0] += 1
        else:
            raise AssertionError(f"(k1) no {cls.__name__} for the {what}")

    with hvd.grouped_enqueue():  # the first stays pending
        h = hvd.allreduce_async(torch.ones(2, device=dev), name="k1.dup")
        raises("duplicate name", hvd.DuplicateNameError,
               lambda: hvd.allreduce_async(torch.ones(2, device=dev),
                                           name="k1.dup"))
    same("allreduce beside the duplicate", hvd.synchronize(h),
         torch.full((2,), float(n)) / n)
    if n > 1:
        raises("shape mismatch", hvd.TensorShapeMismatchError,
               lambda: hvd.allreduce(torch.ones(r + 1, device=dev),
                                     name="k1.bad_shape"))
        raises("dtype mismatch", hvd.TensorDtypeMismatchError,
               lambda: hvd.allreduce(torch.ones(
                   3, device=dev, dtype=torch.float32 if r == 0
                   else torch.float64), name="k1.bad_dtype"))
    return checked[0]


def weights_digest(model) -> str:
    """SHA-256 of every parameter's bytes, in order."""
    import hashlib
    digest = hashlib.sha256()
    for p in model.parameters():
        digest.update(p.detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    return digest.hexdigest()


def same_weights(hvd, path: str, model) -> str:
    """Every rank's weights bitwise equal (their digests through the
    core's allgather)."""
    digests = hvd.allgather_object(weights_digest(model))
    if len(set(digests)) != 1:
        raise AssertionError(f"{path}: the ranks' weights differ {digests}")
    return digests[0]


def process_slice(hvd, dev, seed: int, compression=None, zero=False):
    """Full-width ResNet-50 on ``dev``, its optimizer through the core, and
    this rank's synthetic batch (seed + rank)."""
    from horovod_tpu_torch.models import ResNet50
    torch.manual_seed(seed)
    model = ResNet50(num_classes=1000).to(dev,
                                          memory_format=torch.channels_last)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    if zero:
        opt = hvd.ShardedDistributedOptimizer(
            torch.optim.Adam, model.parameters(), lr=ZERO_LR)
    else:
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9),
            named_parameters=model.named_parameters(),
            compression=compression)
    gen = torch.Generator(device=dev).manual_seed(seed + hvd.rank())
    images = torch.randn(BATCH, IMAGE, IMAGE, 3, generator=gen, device=dev)
    labels = torch.randint(0, 1000, (BATCH,), generator=gen, device=dev)
    return model, opt, images, labels


def process_steps(hvd, path: str, model, opt, images, labels,
                  steps: int = MESH_STEPS, falls: bool = True):
    """``MESH_WARMUP`` steps, then ``steps`` timed ones: their losses, step
    ms, backward ms and the part of it the hooks waited for the stream
    before the core could read a bucket, peak memory, bytes staged each way
    a step, the core's wire bytes, and the launches and routes."""
    from horovod_tpu_torch.ops import collectives as C
    backward, waits = [], []

    def step():
        w0, t0 = C.STAGED["wait_s"], time.perf_counter()
        loss = forward_backward(model, opt, images, labels)
        backward.append(time.perf_counter() - t0)
        waits.append(C.STAGED["wait_s"] - w0)
        opt.step()
        return loss

    losses = [step() for _ in range(MESH_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    del backward[:], waits[:]
    staged, wire = dict(C.STAGED), hvd.runtime.core().wire_stats()
    t0 = time.perf_counter()
    losses += [step() for _ in range(steps)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    raw, sent = (b - a for a, b in zip(wire, hvd.runtime.core().wire_stats()))
    stats = {
        "losses": [float(v) for v in losses], "step_ms": ms,
        "backward_ms": statistics.mean(backward) * 1e3,
        "backward_wait_ms": statistics.mean(waits) * 1e3,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "d2h_bytes_a_step": (C.STAGED["d2h"] - staged["d2h"]) // steps,
        "h2d_bytes_a_step": (C.STAGED["h2d"] - staged["h2d"]) // steps,
        "wire_raw_bytes_a_step": raw // steps,
        "wire_sent_bytes_a_step": sent // steps,
        "launches": read_launches(), "routes": read_routes()}
    log(f"(k) {path} rank {hvd.rank()}: step {ms:.3f} ms, backward "
        f"{stats['backward_ms']:.3f} ms of which the hooks waited "
        f"{stats['backward_wait_ms']:.3f} ms for the stream, peak "
        f"{stats['peak_gib']:.3f} GiB, staged a step "
        f"{stats['d2h_bytes_a_step']} bytes to the host and "
        f"{stats['h2d_bytes_a_step']} back, wire a step "
        f"{stats['wire_raw_bytes_a_step']} raw / "
        f"{stats['wire_sent_bytes_a_step']} sent, launches in {steps} steps "
        f"{stats['launches']}; losses {stats['losses']}")
    if falls:
        check_losses(stats["losses"])
    elif not all(math.isfinite(v) for v in stats["losses"]):
        raise AssertionError(f"{path}: non-finite loss {stats['losses']}")
    return stats


def free_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def transports(hvd):
    """The transports the core's ops ran over, from its metrics."""
    import re
    return sorted(set(re.findall(r'transport="([^"]*)"',
                                 hvd.runtime.core().metrics_dump())))


def next_process_world(hvd, device, compression: str) -> None:
    """A new world with the core's wire compression set: rank 0 finds a
    free port and tells the others through the old core; ``join`` first,
    so no rank shuts down while a peer still receives its bytes."""
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    port = int(hvd.broadcast(torch.tensor([port]), 0, name="k.port")[0])
    hvd.join()
    hvd.shutdown()
    os.environ["HVDTPU_CONTROLLER_PORT"] = str(port)
    os.environ["HVDTPU_COMPRESSION"] = compression
    hvd.init(mode="process", device=device)


def process_worker(out_dir: str, seed: int, device: str = "cuda:0") -> None:
    """One rank of phase (k): every sub-phase, its results written to
    ``out_dir/<rank>.json``."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.compression import (CompressionConfig,
                                               MaxMinQuantizer)
    from horovod_tpu_torch.utils import envvars as ev
    hvd.init(mode="process", device=device)
    dev, r, n = hvd.device(), hvd.rank(), hvd.size()
    res = {"rank": r, "size": n, "device": str(dev), "launcher": {
        "rank": r, "size": n, "local_rank": hvd.local_rank(),
        "local_size": hvd.local_size(),
        "hostname": ev.get_str(ev.HVDTPU_HOSTNAME)}}
    res["menu_checked"] = process_menu(hvd, dev, r, n)
    log(f"(k1) rank {r}: {res['menu_checked']} results exact")

    # (k2) dense, then (k5) join on the same model.
    model, opt, images, labels = process_slice(hvd, dev, seed)
    res["dense"] = process_steps(hvd, "process_dense", model, opt, images,
                                 labels)
    res["dense"]["digest"] = same_weights(hvd, "(k2)", model)
    res["dense"]["transports"] = transports(hvd)
    log(f"(k2) rank {r}: the core's ops ran over "
        f"{res['dense']['transports']}; weights {res['dense']['digest']}")
    if r == n - 1 and n > 1:
        # One step more than the others, which have joined: their zeros
        # come into the Average.
        forward_backward(model, opt, images, labels)
        local = [p.grad.detach().clone() for p in model.parameters()]
        opt.synchronize()
        if not all(torch.equal(p.grad, g * (1.0 / n))
                   for p, g in zip(model.parameters(), local)):
            raise AssertionError("(k5) the extra step's reduction is not "
                                 "this rank's gradient over the world")
        with opt.skip_synchronize():
            opt.step()
    res["join"] = hvd.join()
    if res["join"] != n - 1:
        raise AssertionError(f"(k5) join returned {res['join']}")
    log(f"(k5) rank {r}: join returned {res['join']}")
    del model, opt
    free_memory()

    # (k3) 4-bit max-min through the eager process-compressed path.
    model, opt, images, labels = process_slice(
        hvd, dev, seed, CompressionConfig(
            MaxMinQuantizer(bits=BITS, bucket_size=BUCKET),
            reduction="scatter_allgather", error_feedback=True))
    res["maxmin"] = process_steps(hvd, "process_maxmin", model, opt, images,
                                  labels)
    res["maxmin"]["digest"] = same_weights(hvd, "(k3)", model)
    check_launches("process_maxmin", res["maxmin"]["launches"],
                   process_launches(n), MESH_STEPS, res["maxmin"]["routes"],
                   {"maxmin_dequantize": "packed"})
    del model, opt
    free_memory()

    # (k6) ZeRO-1 Adam.
    model, opt, images, labels = process_slice(hvd, dev, seed, zero=True)
    res["zero1"] = process_steps(hvd, "process_zero1", model, opt, images,
                                 labels)
    res["zero1"]["digest"] = same_weights(hvd, "(k6)", model)
    total = sum(p.numel() for p in model.parameters())
    want = 2 * 4 * -(-total // n) + 4  # m and v of the shard; the step
    res["zero1"]["state_bytes"] = opt.state_bytes()
    gauge = [line for line in hvd.runtime.core().metrics_dump().splitlines()
             if line.startswith("hvdtpu_optimizer_state_bytes")]
    log(f"(k6) rank {r}: Adam state {opt.state_bytes()} bytes of the "
        f"shard's {opt.shard_len} values (expected {want}); published "
        f"{gauge}")
    if opt.state_bytes() != want or not gauge or \
            float(gauge[0].split()[-1]) != want:
        raise AssertionError(f"(k6) state bytes {opt.state_bytes()}, "
                             f"published {gauge}, expected {want}")
    del model, opt
    free_memory()

    # (k4) the core's own int4 wire compression, on a world of its own.
    next_process_world(hvd, str(dev), "int4")
    model, opt, images, labels = process_slice(hvd, dev, seed)
    res["wire_int4"] = process_steps(hvd, "process_wire_int4", model, opt,
                                     images, labels, PROCESS_WIRE_STEPS,
                                     falls=False)
    wire = res["wire_int4"]
    if not 0 < wire["wire_sent_bytes_a_step"] < wire["wire_raw_bytes_a_step"]:
        raise AssertionError(f"(k4) wire bytes {wire}")
    res["wire_int4"]["transports"] = transports(hvd)
    del model, opt
    free_memory()
    hvd.join()
    hvd.shutdown()
    with open(os.path.join(out_dir, f"{r}.json"), "w") as f:
        json.dump(res, f)


def process_ranks() -> int:
    """Two ranks share the card unless its compute mode allows one
    context only."""
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    ranks = PROCESS_RANKS if mode == "Default" else 1
    log(f"(k) compute mode {mode}: {ranks} ranks on the card")
    return ranks


def run_launcher(argv, what: str, timeout: float, env=None) -> str:
    """``python -m horovod_tpu_torch.runner.launch argv`` from the
    checkout: its output (the workers' too), after it exited 0. Past
    ``timeout`` it gets SIGTERM, on which it stops its workers' process
    groups, and the phase fails."""
    import signal
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", *argv],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        out = proc.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        proc.send_signal(signal.SIGTERM)
        try:
            out = proc.communicate(timeout=30)[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            out = proc.communicate()[0]
        for line in out.splitlines():
            log(f"[{what}] {line}")
        raise AssertionError(f"{what}: the launcher did not end within "
                             f"{timeout} s")
    for line in out.splitlines():
        log(f"[{what}] {line}")
    if proc.returncode != 0:
        raise AssertionError(f"{what}: the launcher exited "
                             f"{proc.returncode}")
    return out


def train_process(seed: int, ranks: int):
    """Phase (k): ``ranks`` processes of this script
    (``--process-worker``), started by the port's static launcher
    (``-np ranks -H localhost:ranks``), each ``hvd.init(mode="process",
    device="cuda:0")`` with the topology variables the launcher exported;
    the results every rank wrote."""
    import tempfile
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_process_")
    run_launcher(["-np", str(ranks), "-H", f"localhost:{ranks}",
                  sys.executable, os.path.abspath(__file__),
                  "--process-worker", out_dir, "--seed", str(seed)],
                 "(k)", PROCESS_TIMEOUT)
    results = []
    for r in range(ranks):
        with open(os.path.join(out_dir, f"{r}.json")) as f:
            results.append(json.load(f))
    if [res["launcher"] for res in results] != [
            {"rank": r, "size": ranks, "local_rank": r, "local_size": ranks,
             "hostname": "localhost"} for r in range(ranks)]:
        raise AssertionError(f"(k) the launcher's topology "
                             f"{[res['launcher'] for res in results]}")
    for key in ("dense", "maxmin", "zero1"):
        if len({res[key]["digest"] for res in results}) != 1:
            raise AssertionError(f"(k) {key}: weights differ across ranks")
    return results


# ---------------------------------------------------------------------------
# (l) elastic ResNet-50 through the port's elastic launcher
# ---------------------------------------------------------------------------

def elastic_batch(dev, seed: int, batch: int, rank: int):
    """Rank ``rank``'s synthetic batch ``batch`` of (l), from the seed."""
    gen = torch.Generator(device=dev).manual_seed(
        seed * 1_000_003 + 1_000 * batch + rank)
    images = torch.randn(BATCH, IMAGE, IMAGE, 3, generator=gen, device=dev)
    labels = torch.randint(0, 1000, (BATCH,), generator=gen, device=dev)
    return images, labels


def recovery_metric(hvd):
    """(count, sum) of the core's ``hvdtpu_recovery_seconds``."""
    import re
    got = dict(re.findall(
        r"^hvdtpu_recovery_seconds_(sum|count)(?:\{[^}]*\})? (\S+)$",
        hvd.runtime.core().metrics_dump(), re.M))
    return float(got.get("count", 0)), float(got.get("sum", 0))


def elastic_worker(out_dir: str, form: str, seed: int) -> None:
    """One worker of phase (l), started by the elastic driver: ResNet-50
    through 4-bit max-min with error feedback (the process path: B1 and
    B4) under ``hvd.elastic.run``, a ``TorchState`` committed every
    batch. ``grow``: at the commit of batch ``ELASTIC_GROW_AT`` rank 0 of
    the world of 2 adds ``127.0.0.1:1`` to the hosts file and the ranks
    commit until the driver's new round interrupts them; the worker of
    ``127.0.0.1`` dies before its step of batch ``ELASTIC_DIE_AT``.
    ``solo``: one worker, its commits also on disk; the worker of
    ``127.0.0.1`` dies before batch ``ELASTIC_SOLO_DIE_AT`` and the one
    that replaces it resumes from the disk. Each worker writes what it
    saw into ``out_dir/record.<worker id>.json``."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.compression import (CompressionConfig,
                                               MaxMinQuantizer)
    from horovod_tpu_torch.models import ResNet50
    from horovod_tpu_torch.utils import envvars as ev
    wid = ev.get_str(ev.HVDTPU_WORKER_ID)
    solo = form == "solo"
    die_at = ELASTIC_SOLO_DIE_AT if solo else ELASTIC_DIE_AT
    record = {"worker": wid, "steps": [], "commits": {}, "syncs": []}
    path = os.path.join(out_dir, f"record.{wid}.json")

    def write_record():
        with open(path, "w") as f:
            json.dump(record, f)

    hvd.init(device="cuda:0")
    record["init_done"] = time.time()
    dev = hvd.device()
    torch.manual_seed(seed)
    model = ResNet50(num_classes=1000).to(dev,
                                          memory_format=torch.channels_last)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9),
        named_parameters=model.named_parameters(),
        compression=CompressionConfig(
            MaxMinQuantizer(bits=BITS, bucket_size=BUCKET),
            reduction="scatter_allgather", error_feedback=True))

    class State(hvd.elastic.TorchState):
        def sync(self):
            start = time.time()
            super().sync()
            digest = weights_digest(model)
            if len(set(hvd.allgather_object(digest))) != 1:
                raise AssertionError(f"(l) {wid}: the ranks' weights differ "
                                     f"after the sync at batch {self.batch}")
            count, total = recovery_metric(hvd)
            record["syncs"].append({
                "batch": self.batch, "size": hvd.size(),
                "rank": hvd.rank(), "digest": digest, "start": start,
                "time": time.time(), "recoveries": count,
                "recovery_s": total})

    state = State(model, opt, batch=0, grown=False,
                  checkpoint_dir=os.path.join(out_dir, "checkpoints")
                  if solo else None, checkpoint_keep=2)
    record["state_built"] = time.time()
    if solo and state.load_from_checkpoint():
        record["resumed"] = {"batch": state.batch,
                             "digest": weights_digest(model)}

    @hvd.elastic.run
    def train(state):
        while state.batch < ELASTIC_BATCHES:
            size, rank = hvd.size(), hvd.rank()
            if wid.startswith("127.0.0.1") and state.batch == die_at:
                record["died"] = {"batch": state.batch, "time": time.time()}
                write_record()
                with open(os.path.join(out_dir, "died.marker"), "w") as f:
                    f.write(f"{wid} {state.batch}\n")
                os._exit(7)
            images, labels = elastic_batch(dev, seed, state.batch, rank)
            reset_launches()
            t0 = time.perf_counter()
            forward_backward(model, opt, images, labels)
            opt.step()
            torch.cuda.synchronize()
            record["steps"].append({
                "batch": state.batch, "size": size, "rank": rank,
                "ms": (time.perf_counter() - t0) * 1e3, "time": time.time(),
                "launches": read_launches()})
            state.batch += 1
            state.commit()
            if size == 3 or solo:
                record["commits"][str(state.batch)] = weights_digest(model)
                write_record()
            if not solo and size == 2 and not state.grown and \
                    state.batch == ELASTIC_GROW_AT:
                if rank == 0:
                    with open(os.path.join(out_dir, "hosts.txt"), "w") as f:
                        f.write("localhost:2\n127.0.0.1:1\n")
                    record["grown"] = time.time()
                state.grown = True
                deadline = time.monotonic() + ELASTIC_GROW_WAIT
                while time.monotonic() < deadline:
                    time.sleep(0.2)
                    state.commit()  # the driver's new round interrupts it
                raise AssertionError("(l) the driver added no worker within "
                                     f"{ELASTIC_GROW_WAIT} s")
        return hvd.size()

    record["final_size"] = train(state)
    record["final"] = {"batch": state.batch, "rank": hvd.rank(),
                       "digest": weights_digest(model)}
    write_record()
    hvd.join()
    hvd.shutdown()


def driver_events(out: str):
    """(time.time(), message) of each line the elastic driver logged."""
    import datetime
    import re
    return [(datetime.datetime.strptime(stamp, "%Y-%m-%d %H:%M:%S,%f")
             .timestamp(), msg)
            for stamp, msg in re.findall(
                r"(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3}) \[\w+\] "
                r"(elastic: .*)", out)]


def shm_segments():
    """The native core's shared-memory segments of this user."""
    return sorted(n for n in os.listdir("/dev/shm")
                  if n.startswith(f"hvdtpu_{os.getuid()}_"))


def train_elastic(seed: int, ranks: int):
    """Phase (l): the port's elastic launcher
    (``--host-discovery-script``) runs ``elastic_worker``: the ``grow``
    form (2 -> 3 -> 2 workers) when two contexts may share the card, else
    the ``solo`` form. Checks the job's outcome and returns its numbers:
    step ms at each world size, the scale-up and recovery seconds, and
    the launches of B1 and B4."""
    import re
    import statistics
    import tempfile
    form = "grow" if ranks >= 2 else "solo"
    work = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    with open(os.path.join(work, "hosts.txt"), "w") as f:
        f.write("localhost:2\n" if form == "grow" else
                "127.0.0.1:1\nlocalhost:1\n")
    script = os.path.join(work, "discover.sh")
    with open(script, "w") as f:
        f.write(f"#!/bin/sh\ncat {os.path.join(work, 'hosts.txt')}\n")
    os.chmod(script, 0o755)
    min_np, max_np = (2, 3) if form == "grow" else (1, 1)
    shm_before = shm_segments()
    log(f"(l) form {form}: workers {min_np}..{max_np}; /dev/shm before: "
        f"{shm_before}")
    t0 = time.monotonic()
    out = run_launcher(
        ["-np", str(min_np), "--min-np", str(min_np), "--max-np",
         str(max_np), "--host-discovery-script", script,
         "--elastic-timeout", "120", sys.executable,
         os.path.abspath(__file__), "--elastic-worker", work,
         "--elastic-form", form, "--seed", str(seed)], "(l)",
        ELASTIC_TIMEOUT, env=dict(os.environ, HVDTPU_LOG_LEVEL="info"))
    seconds = time.monotonic() - t0
    shm_after = shm_segments()
    log(f"(l) the job took {seconds:.3f} s; /dev/shm after: {shm_after}")
    if set(shm_after) - set(shm_before):
        raise AssertionError(f"(l) segments left in /dev/shm: "
                             f"{sorted(set(shm_after) - set(shm_before))}")
    if not os.path.exists(os.path.join(work, "died.marker")):
        raise AssertionError("(l) no worker died")
    records = {}
    for name in os.listdir(work):
        if name.startswith("record."):
            with open(os.path.join(work, name)) as f:
                rec = json.load(f)
            records[rec["worker"]] = rec
    finishers = {w: r for w, r in records.items() if "final" in r}
    want = {"localhost:0", "localhost:1"} if form == "grow" else \
        {"localhost:0"}
    if set(finishers) != want or any(
            r["final_size"] != len(want) or
            r["final"]["batch"] != ELASTIC_BATCHES
            for r in finishers.values()):
        raise AssertionError(f"(l) finishers {sorted(finishers)}, expected "
                             f"{sorted(want)} at size {len(want)} and batch "
                             f"{ELASTIC_BATCHES}: "
                             f"{[r.get('final') for r in records.values()]}")
    if len({r["final"]["digest"] for r in finishers.values()}) != 1:
        raise AssertionError("(l) the finishers' weights differ")
    dead = next(r for w, r in records.items() if w.startswith("127.0.0.1"))
    die_at = dead["died"]["batch"]
    # Every completed step launched B1 once and B4 size + 1 times.
    launches = collections.Counter()
    for rec in records.values():
        for step in rec["steps"]:
            want_launches = {name: process_launches(step["size"]).get(name, 0)
                             for name in step["launches"]}
            if step["launches"] != want_launches:
                raise AssertionError(
                    f"(l) {rec['worker']} batch {step['batch']} at size "
                    f"{step['size']}: launches {step['launches']}, expected "
                    f"{want_launches}")
            launches.update(step["launches"])
    res = {"form": form, "seconds": seconds, "died_at": die_at,
           "launches": dict(launches)}
    if form == "grow":
        # The survivors' weights after their restore and sync are the
        # digest they committed before the failure; the joiner synced to
        # rank 0's (checked in the worker: every sync's digests agree).
        for w, rec in finishers.items():
            after = [s for s in rec["syncs"] if s["size"] == 2 and
                     s["batch"] == die_at]
            if not after or after[0]["digest"] != rec["commits"][
                    str(die_at)]:
                raise AssertionError(f"(l) {w}: weights after the restore "
                                     f"{after} are not the commit of batch "
                                     f"{die_at}")
        if not any(s["size"] == 3 for s in dead["syncs"]):
            raise AssertionError("(l) the joiner never synced in a world "
                                 "of 3")
        rank0 = finishers["localhost:0"]
        first3 = min(s["time"] for s in rank0["steps"] if s["size"] == 3)
        res["scale_up_s"] = first3 - rank0["grown"]
        recovered = [s for s in rank0["syncs"] if s["recoveries"] > 0]
        res["recovery_s_metric"] = recovered[0]["recovery_s"] \
            if recovered else None
    else:
        resumed = finishers["localhost:0"].get("resumed")
        if resumed is None or resumed["batch"] != die_at or \
                resumed["digest"] != dead["commits"][str(die_at)]:
            raise AssertionError(f"(l) the replacement resumed {resumed}, "
                                 f"not the commit of batch {die_at}")
        res["recovery_s_metric"] = None
    # The driver's log: when it saw the failure, started each round and
    # saw each round formed (every worker claimed it).
    events = driver_events(out)
    formed = re.findall(r"elastic: epoch (\d+) \((.*?)\) formed: (\d+) "
                        r"workers claimed it ([0-9.]+) s", out)
    res["rounds"] = [(int(e), why, int(n), float(s))
                     for e, why, n, s in formed]
    failed = [t for t, msg in events
              if re.match(r"elastic: worker 127\.0\.0\.1:0 failed", msg)]
    recovered = [t for t, msg in events if re.match(
        r"elastic: epoch \d+ \(worker 127\.0\.0\.1:0 failed\) formed",
        msg)]
    res["recovery_s_driver"] = recovered[0] - failed[0] \
        if failed and recovered else None
    rank0 = finishers["localhost:0"]
    if form == "grow":
        # The scale-up's parts: discovery (the file rewritten -> the
        # round), the joiner's start (-> every worker claimed it), its
        # core's form-up (-> init returned), its model, optimizer and
        # state, its first sync, and rank 0's first step at size 3.
        started = [t for t, msg in events if re.match(
            r"elastic: rendezvous epoch \d+ \(host set changed\)", msg)]
        grown = [t for t, msg in events if re.match(
            r"elastic: epoch \d+ \(host set changed\) formed", msg)]
        sync = dead["syncs"][0]
        step3 = min((s for s in rank0["steps"] if s["size"] == 3),
                    key=lambda s: s["time"])
        res["scale_up_parts_s"] = {
            "discovery": started[0] - rank0["grown"],
            "joiner_start": grown[0] - started[0],
            "joiner_init": dead["init_done"] - grown[0],
            "joiner_model": dead["state_built"] - dead["init_done"],
            "sync": sync["time"] - sync["start"],
            "first_step": step3["time"] - sync["time"]}
    res["step_ms"] = {
        size: statistics.median(s["ms"] for s in rank0["steps"]
                                if s["size"] == size)
        for size in sorted({s["size"] for s in rank0["steps"]})}
    log(f"(l) {form}: {len(records)} workers, rounds {res['rounds']}; "
        f"finishers {sorted(finishers)} at batch {ELASTIC_BATCHES}, weights "
        f"bitwise equal; median step ms by world size {res['step_ms']}; "
        f"scale-up {res.get('scale_up_s')} s (hosts file rewritten -> "
        f"first step at size 3; parts {res.get('scale_up_parts_s')}); "
        f"recovery {res['recovery_s_metric']} s "
        f"(hvdtpu_recovery_seconds) and {res['recovery_s_driver']} s (the "
        f"driver: failure -> world formed); launches {res['launches']}")
    return res


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--seed", type=int, default=0,
        help="seed of the encoder phase's weights, tokens and mask")
    parser.add_argument(
        "--parent", default=None,
        help="a checkout of the parent commit: time its B9 beside "
             "this tree's in alternating rounds")
    parser.add_argument(
        "--process-worker", default=None, metavar="DIR",
        help="run one rank of phase (k) (started by the launcher) and write "
             "its results into DIR")
    parser.add_argument(
        "--elastic-worker", default=None, metavar="DIR",
        help="run one worker of phase (l) (started by the elastic driver) "
             "and write what it saw into DIR")
    parser.add_argument("--elastic-form", default="grow",
                        choices=("grow", "solo"),
                        help="phase (l)'s schedule (with --elastic-worker)")
    args = parser.parse_args()
    if args.process_worker:
        process_worker(args.process_worker, args.seed)
        return 0
    if args.elastic_worker:
        elastic_worker(args.elastic_worker, args.elastic_form, args.seed)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.utils import cuda_build

    kernels, norm_kernels, flash = kernel_modules()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    name = torch.cuda.get_device_name(0)
    rates = card_rates(name)

    # The native core (g++) builds while nvcc builds the kernels.
    from concurrent.futures import ThreadPoolExecutor
    from horovod_tpu_torch.utils import native_build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        core_build = pool.submit(native_build.build)
        path = cuda_build.build()
        log(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")
        core_path = core_build.result()
    log(f"build: {core_path.name} (the native core) done "
        f"{time.perf_counter() - t0:.1f} s after the start")

    hvd.init()
    try:
        dev = hvd.device()
        errors = check_kernels(kernels, dev, (
            RESNET50_PARAMS, VGG16_PARAMS,
            *(n // 4 for n in AUTOTUNE_SIZES)))
        log(f"kernels: B1, B3 and B4 bitwise (B3 and B4 on packed "
            f"payloads at every width, aligned or not, and on byte codes); "
            f"errors at the path's shape {errors}")
        errors["maxmin_quantize_stochastic"], routes = check_stochastic(
            kernels, dev, RESNET50_PARAMS)
        log(f"kernels: B2 bitwise (packed payloads against pack_bits of "
            f"the plain codes) at {sum(routes.values())} shapes, seeds and "
            f"offsets; launches by route {routes}")
        norm_errors, midpoints, routes = check_norm(
            norm_kernels, dev, (RESNET50_PARAMS, INCEPTION_PARAMS))
        errors.update(norm_errors)
        log(f"kernels: B5 bitwise (linf; packed payloads against pack_bits "
            f"of the plain codes) and within rtol 1e-6 with {midpoints} "
            f"midpoint codes one level apart (l2), B6 bitwise, at "
            f"{sum(routes.values())} shapes; launches by route {routes}; "
            f"errors at the path's shape {norm_errors}")
        flash_err, noncausal_err = check_flash(flash, dev)
        log(f"kernels: B7, B8 and B9 within their tolerances at 51 shapes "
            f"(bf16 on the tensor cores); errors at the GPT path's shape "
            f"{flash_err}, at the encoder's {noncausal_err}")
        # Each kernel's launches in the timed steps of the phase that
        # carries it (B3 and B4: the max-min phase).
        phases = {"resnet": train(hvd, dev),
                  "resnet_uni": train(hvd, dev, "resnet_uni", False),
                  "resnet_stochastic": train(hvd, dev, "resnet_stochastic",
                                             False)}
        train_accumulated(hvd, dev)
        flash_launches = train_gpt(hvd, dev)
        check_api(hvd, dev)
        check_adasum(dev)
        train_sync_adasum(hvd)
        train_hierarchical_compressed(hvd)
        train_gpt_zero(hvd)
        model_parallel = train_model_parallel(hvd, args.seed)
        vision = train_vision(hvd)
        dev = reinit(hvd, None)
        launches = {name: phases[path][name]
                    for path in ("resnet_stochastic", "resnet_uni",
                                 "resnet")
                    for name in PATH_LAUNCHES[path]}
        rows = measure(kernels, norm_kernels, dev, RESNET50_PARAMS,
                       launches, errors, rates)
        measure_at(kernels, norm_kernels, dev, rows, errors, vision, rates)
        for row in rows:
            if row["name"] in AUTOTUNE_LAUNCHES:
                row["launches_autotune_compressed"] = \
                    vision["autotune_compressed"]["launches"][row["name"]]
                row.update({"max_abs_err" + SHAPES[n // 4]:
                            errors[row["name"] + SHAPES[n // 4]]
                            for n in AUTOTUNE_SIZES})
        parent = parent_kernels(args.parent) if args.parent else None
        if parent:
            check_parent(flash, dev, parent)
        rows += measure_flash(flash, dev, flash_launches, flash_err, rates,
                              model_parallel["encoder"]["launches"],
                              noncausal_err, parent)
        hvd.shutdown()
        free_memory()
        ranks = process_ranks()
        process = train_process(args.seed, ranks)
        elastic = train_elastic(args.seed, ranks)
        for row in rows:
            if row["name"] in process_launches(1):
                row["launches_process_maxmin"] = \
                    process[0]["maxmin"]["launches"][row["name"]]
                row["launches_elastic"] = elastic["launches"][row["name"]]
        dense, zero1 = process[0]["dense"], process[0]["zero1"]
        log(f"(k) {len(process)} ranks: (k1) {process[0]['menu_checked']} "
            f"exact results; (k2) dense {dense['step_ms']:.3f} ms a step, "
            f"transports {dense['transports']}; (k5) join returned "
            f"{[res['join'] for res in process]}; (k6) Adam state "
            f"{zero1['state_bytes']} bytes a rank; (k4) int4 wire "
            f"{process[0]['wire_int4']['wire_sent_bytes_a_step']} of "
            f"{process[0]['wire_int4']['wire_raw_bytes_a_step']} bytes a "
            f"step; weights bitwise equal across the ranks in (k2), (k3) "
            f"and (k6)")
        log(f"(l) {elastic['form']} form in {elastic['seconds']:.3f} s: "
            f"median step ms by world size {elastic['step_ms']}; scale-up "
            f"{elastic.get('scale_up_s')} s; recovery "
            f"{elastic['recovery_s_metric']} s (hvdtpu_recovery_seconds), "
            f"{elastic['recovery_s_driver']} s (driver); on {smi}")
    finally:
        hvd.shutdown()
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
