#!/usr/bin/env python3
"""B2 and B5's packed kernels of several source trees, timed side by side
on one card.

Run on a machine with an NVIDIA GPU and the CUDA toolkit, with checkouts
of the trees to compare (for example a parent unpacked with
``git archive``)::

    python3 scripts/quantize_trees.py TREE [TREE ...]

Each tree's library is built by that tree's own
``horovod_tpu_torch/utils/cuda_build.py`` into the tree. B2 and B5 (4
bits, buckets of 512, uniform levels searched by bisection, linf: the
ResNet-50 path's shape, 25,557,032 values) are called through their C
entry points on an input at a 16-byte aligned address and on a view one
value into its buffer. The aligned payloads must agree across trees (a
tree whose kernels write one byte a code compares its first bytes only,
so give trees that write the same layout). Prints the card's name, power
limit and SM clock before and after, then one JSON line a function: the
median and the readings of 5 alternating rounds (CUDA events over 20
launches each).
"""
import ctypes
import importlib.util
import json
import os
import statistics
import subprocess
import sys

import torch

N, BUCKET, BITS = 25_557_032, 512, 4


P, I64, I32, U64 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                    ctypes.c_uint64)
# The C entry points' parameters (csrc/maxmin.cu, csrc/norm.cu), applied
# at each call.
SIGNATURES = {
    "hvd_maxmin_quantize_stochastic": (P, I64, I64, I32, I32, U64, U64, P, P,
                                       P, P),
    "hvd_norm_quantize": (P, I64, I64, I32, P, I32, I32, I32, I32, P, P, P)}


def lib_of(root, i):
    spec = importlib.util.spec_from_file_location(
        f"cuda_build_{i}",
        os.path.join(root, "horovod_tpu_torch", "utils", "cuda_build.py"))
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    return ctypes.CDLL(str(build.build()))


def call(lib, name, *args):
    types = SIGNATURES[name]
    if len(args) != len(types):
        raise TypeError(f"{name} takes {len(types)} arguments")
    return getattr(lib, name)(*(t(a) for t, a in zip(types, args)))


def time_ms(fn, iters=20):
    for _ in range(3):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main():
    dev = torch.device("cuda")
    n_buckets = -(-N // BUCKET)
    x = torch.randn(N, device=dev) * 1e-2
    buf = torch.zeros(N + 1, device=dev)
    buf[1:] = x
    shifted = buf[1:]
    levels = torch.linspace(1, 0, 8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    fns, outs = {}, {}
    for i, root in enumerate(sys.argv[1:]):
        lib = lib_of(root, i)
        name = os.path.basename(os.path.abspath(root))
        q = torch.empty(n_buckets * BUCKET, dtype=torch.uint8, device=dev)
        meta = torch.empty(2, n_buckets, device=dev)

        def b2(t, lib=lib, q=q, meta=meta):
            err = call(lib, "hvd_maxmin_quantize_stochastic", t.data_ptr(), N,
                       n_buckets, BUCKET, BITS, 0, 0, q.data_ptr(),
                       meta[0].data_ptr(), meta[1].data_ptr(), stream)
            if err:
                raise RuntimeError(f"B2 launch failed ({err})")
            return q

        def b5(t, lib=lib, q=q, meta=meta):
            err = call(lib, "hvd_norm_quantize", t.data_ptr(), N, n_buckets,
                       BUCKET, levels.data_ptr(), 8, 0, BITS, 1, q.data_ptr(),
                       meta[0].data_ptr(), stream)
            if err:
                raise RuntimeError(f"B5 launch failed ({err})")
            return q

        for kernel, fn in (("b2", b2), ("b5", b5)):
            outs[(kernel, name)] = fn(x)[:n_buckets * BUCKET * BITS // 8] \
                .clone()
            fns[f"{kernel} {name}"] = lambda fn=fn: fn(x)
            fns[f"{kernel} {name} unaligned"] = lambda fn=fn: fn(shifted)
    for kernel in ("b2", "b5"):
        got = [v for (k, _), v in outs.items() if k == kernel]
        if not all(torch.equal(g, got[0]) for g in got):
            raise AssertionError(f"{kernel}: the trees' payloads differ")
    smi = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
           "--format=csv,noheader"]
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip())
    times = {k: [] for k in fns}
    for _ in range(5):
        for k, fn in fns.items():
            times[k].append(time_ms(fn))
    print(subprocess.run(smi, capture_output=True, text=True).stdout.strip())
    for k, t in times.items():
        print(json.dumps({"fn": k, "median_ms": statistics.median(t),
                          "rounds": t}))


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    main()
