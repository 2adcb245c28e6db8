"""``run.py`` with a fault planted in the program, in rank 0 and in every
rank it starts::

    python fault_runner.py <fault> <run.py's arguments, --checkout among
    them>

Faults: ``unchanged`` (the optimizer's step synchronizes and leaves the
weights as they were), ``half_batch`` (the step trains on half of its
batch, the mean taken over the rest), ``no_exchange`` (each rank reduces
its own gradient alone: the exchange between ranks left out),
``frozen_residual`` (error feedback's residuals written at the first step
and never again), ``jax_in_rank`` (every rank but 0 loads a module named
``jax`` once its window has closed).
"""

from __future__ import annotations

import sys
import types
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
CHECKOUT = sys.argv[sys.argv.index("--checkout") + 1]
sys.path[:0] = [str(BENCH), CHECKOUT]


def plant(fault: str) -> None:
    import harness
    if fault == "unchanged":
        from horovod_tpu_torch.parallel import optimizer

        def step(self, closure=None):
            self.synchronize()
            self._synchronized = False
        optimizer._DistributedOptimizer.step = step
    elif fault == "half_batch":
        plain = harness.train_step

        def train_step(dtype, device_type, cache):
            inner = plain(dtype, device_type, cache)

            def step(model, opt, batch):
                images, labels = batch
                half = images.shape[0] // 2
                return inner(model, opt, (images[:half], labels[:half]))
            return step
        harness.train_step = train_step
    elif fault == "no_exchange":
        from horovod_tpu_torch.compression import reducers

        def alone(x, compressor, residual=None, key=None, axis=None):
            chunks = reducers._padded_chunks(x, residual, 1)
            payload, ctx = compressor.compress_rows(chunks)
            if residual is not None:
                residual = reducers._row_residual(compressor, chunks,
                                                  payload, ctx, x)
            mine = compressor.decompress_rows(payload, ctx)[0]
            again, ctx2 = compressor.compress(mine)
            out = compressor.decompress(again, ctx2)
            return out.view(x.shape), residual
        reducers._REDUCERS["scatter_allgather"] = alone
    elif fault == "frozen_residual":
        from horovod_tpu_torch.parallel import optimizer
        write, calls = optimizer.update_residuals, []

        def update_residuals(residuals, new_residuals):
            if not calls:
                write(residuals, new_residuals)
            calls.append(1)
        optimizer.update_residuals = update_residuals
    elif fault == "jax_in_rank":
        if "--world-dir" in sys.argv:
            run_rank = harness.run_rank

            def loads_jax(*args, **kwargs):
                record = run_rank(*args, **kwargs)
                sys.modules["jax"] = types.ModuleType("jax")
                return record
            harness.run_rank = loads_jax
    else:
        raise ValueError(f"unknown fault {fault!r}")
    argv = harness.rank_argv
    harness.rank_argv = lambda args, rank, world_dir: [
        sys.executable, __file__, fault] + argv(args, rank, world_dir)[2:]


if __name__ == "__main__":
    plant(sys.argv[1])
    import run
    sys.exit(run.main(sys.argv[2:]))
