"""The port's compressed-against-dense A/B model held against the JAX
package's (``compression/ab.py``).

This file is also the ranks' worker (``python <file> --worker <dir>``,
which imports no JAX): one gloo world of 4 ranks as ``{"dcn": 2, "ici":
2}`` runs ``autotune_compressed`` with its default measure (the dense
hierarchical allreduce against ``hierarchical_compressed_allreduce``),
whose table every rank must hold alike.

The byte counts are exact: ``payload_nbytes`` equals JAX's (read from
``jax.eval_shape``) and the port's own payload's bytes, for max-min at 2, 4
and 8 bits, the normalized quantizer, TopK and the fp16 cast, at 1, 511,
512 and 1<<20 values. The wire model is the same arithmetic on both sides,
so ``projected_step_seconds`` and ``crossover_gbps`` agree to the bit, the
``None`` and ``inf`` sentinels included; so does the table an injected
bandwidth model gives.
"""

import math
import os
import pickle
import subprocess
import sys

import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch import compression as tc
from horovod_tpu_torch.compression import ab

WORLD, MESH = 4, {"dcn": 2, "ici": 2}
SIZES = (4096, 65536)
COMPRESSORS = {
    "maxmin2": lambda m: m.MaxMinQuantizer(bits=2),
    "maxmin4": lambda m: m.MaxMinQuantizer(bits=4),
    "maxmin8": lambda m: m.MaxMinQuantizer(bits=8),
    "normalized": lambda m: m.NormalizedQuantizer(),
    "topk": lambda m: m.TopKCompressor(0.01),
}


def _worker(out_dir):
    rank = int(os.environ["HVDTPU_RANK"])
    thvd.init(device="cpu", mesh_shape=MESH)
    try:
        table = thvd.autotune_compressed("ici", "dcn", sizes=SIZES, reps=2)
    finally:
        thvd.shutdown()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(table, f)


@pytest.mark.parametrize("nelem", [1, 511, 512, 1 << 20])
@pytest.mark.parametrize("name", sorted(COMPRESSORS))
def test_payload_nbytes_is_the_references(name, nelem):
    import horovod_tpu.compression as jc
    from horovod_tpu.compression.ab import payload_nbytes
    port = COMPRESSORS[name](tc)
    want = payload_nbytes(COMPRESSORS[name](jc), nelem)
    assert ab.payload_nbytes(port, nelem) == want
    payload, _ = port.compress(torch.ones(nelem))
    assert tc.compressed_size_bytes(payload) == want


def test_payload_nbytes_of_a_cast_is_the_references():
    import horovod_tpu.compression as jc
    from horovod_tpu.compression.ab import payload_nbytes
    for n in (1, 511, 1 << 20):
        assert ab.payload_nbytes(tc.Compression.fp16, n) == \
            payload_nbytes(jc.Compression.fp16, n) == 2 * n


NBYTES, COMP_BYTES = 16 << 20, 2 << 20
WIRE_CASES = [(NBYTES, COMP_BYTES, 5e-3), (NBYTES, NBYTES, 5e-3),
              (NBYTES, 2 * NBYTES, 1e-3), (NBYTES, COMP_BYTES, 0.0),
              (1 << 20, 131328, 2.5e-4)]


@pytest.mark.parametrize("nbytes,comp_bytes,compute_s", WIRE_CASES)
def test_wire_model_is_the_references(nbytes, comp_bytes, compute_s):
    from horovod_tpu.compression import ab as jab
    got = ab.crossover_gbps(nbytes, comp_bytes, compute_s)
    assert got == jab.crossover_gbps(nbytes, comp_bytes, compute_s)
    if comp_bytes >= nbytes:
        assert got is None
    elif compute_s == 0:
        assert got == math.inf
    for gbps in (1.0, 25.0, 400.0):
        assert ab.projected_step_seconds(nbytes, comp_bytes, compute_s,
                                         gbps) == \
            jab.projected_step_seconds(nbytes, comp_bytes, compute_s, gbps)


def _bandwidth_model(outer_gbps, ratio=8.0, compute_s=2e-3):
    """The JAX test's injectable measure: only the outer hop differs."""
    def measure(kind, nbytes, inner_axis, outer_axis, reps):
        shard = nbytes / 2
        wire = shard if kind == "dense" else shard / ratio
        extra = 0.0 if kind == "dense" else compute_s
        return 2 * wire / (outer_gbps * 1e9 / 8) + extra
    return measure


@pytest.fixture
def port_mesh():
    thvd.init(device="cpu", mesh_shape={"dcn": 1, "ici": 1})
    yield thvd
    thvd.shutdown()


@pytest.mark.parametrize("gbps", [3.0, 40.0, 400.0])
def test_injected_measure_gives_the_references_table(gbps, port_mesh,
                                                     make_runtime):
    from horovod_tpu.compression.ab import autotune_compressed
    sizes = (1 << 20, 16 << 20, 128 << 20)
    got = ab.autotune_compressed("ici", "dcn", sizes=sizes,
                                 measure=_bandwidth_model(gbps))
    make_runtime(mesh_shape={"dcn": 2, "ici": 4})
    want = autotune_compressed("ici", "dcn", sizes=sizes,
                               measure=_bandwidth_model(gbps))
    assert got == want
    if gbps == 3.0:  # the JAX test's slow link: compression wins always
        assert {w for w, _, _ in got.values()} == {"compressed"}


def test_default_measure_gives_every_rank_the_same_table(tmp_path):
    """``autotune_compressed`` with its own measure on a gloo 2 x 2 mesh:
    every rank holds rank 0's table, and each winner is the faster."""
    from conftest import free_port, subprocess_env
    port, procs = free_port(), []
    for rank in range(WORLD):
        env = subprocess_env()
        env.update({"HVDTPU_RANK": str(rank), "HVDTPU_SIZE": str(WORLD),
                    "HVDTPU_LOCAL_RANK": str(rank),
                    "HVDTPU_LOCAL_SIZE": str(WORLD),
                    "HVDTPU_CONTROLLER_ADDR": "127.0.0.1",
                    "HVDTPU_CONTROLLER_PORT": str(port)})
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             str(tmp_path)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    tables = []
    for rank in range(WORLD):
        with open(tmp_path / f"{rank}.pkl", "rb") as f:
            tables.append(pickle.load(f))
    assert all(t == tables[0] for t in tables)
    assert sorted(tables[0]) == sorted(SIZES)
    for winner, dense_s, comp_s in tables[0].values():
        assert dense_s > 0 and comp_s > 0
        assert winner == ("compressed" if comp_s < dense_s else "dense")


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2])
