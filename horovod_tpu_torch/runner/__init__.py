"""The launcher and the programmatic ``run()`` (counterpart of
``horovod_tpu/runner/__init__.py``; reference: ``horovod.run``,
``horovod/runner/__init__.py:99``).
"""

from __future__ import annotations

import os
import pickle
import secrets
from typing import Any, Callable, List, Optional

from ..utils import envvars as ev

try:
    import cloudpickle as _fn_pickler  # sends functions by value
except ImportError:
    _fn_pickler = pickle  # by reference: fn must be importable by workers


def run(fn: Callable, args: tuple = (), kwargs: Optional[dict] = None,
        np: int = 2, hosts: Optional[str] = None, verbose: bool = False,
        use_gloo: bool = True, use_mpi: bool = False,
        device: Optional[str] = None, **launcher_kwargs) -> List[Any]:
    """Run ``fn(*args, **kwargs)`` on ``np`` workers, each under an
    initialized runtime, and return their results in rank order
    (reference signature: ``horovod.run``; ``use_gloo``/``use_mpi`` are
    accepted and change nothing, as in the JAX package).

    The function travels to the workers, and their results back, through
    the launcher's HMAC-authenticated key-value store, so ``hosts`` may
    name other machines (reached over ssh, with ``horovod_tpu_torch``
    importable there) without a shared filesystem. Without
    ``cloudpickle`` the function is pickled by reference and must be
    importable by the workers. ``device``: where the workers' runtime
    runs (``"cpu"``), by default the card of each worker's local rank.
    Other keyword arguments are the launcher's flags
    (``fusion_threshold_mb=32`` is ``--fusion-threshold-mb 32``)."""
    from .http_kv import KVStoreServer
    from .launch import parse_args, run_launcher
    from .preflight import local_addr
    from .safe_exec import PYTHON_PLACEHOLDER

    secret = ev.get_str(ev.HVDTPU_SECRET) or secrets.token_hex(16)
    server = KVStoreServer(secret=secret)
    server.start()
    server.put("/run/fn", _fn_pickler.dumps((fn, args, kwargs or {})))
    exported = {ev.HVDTPU_SECRET: secret, ev.HVDTPU_RUN_KV_ADDR: local_addr(),
                ev.HVDTPU_RUN_KV_PORT: str(server.port),
                ev.HVDTPU_RUN_DEVICE: device}
    saved = {k: os.environ.get(k) for k in exported}
    for k, v in exported.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        argv = ["-np", str(np)]
        if hosts:
            argv += ["-H", hosts]
        if verbose:
            argv += ["--verbose"]
        for k, v in launcher_kwargs.items():
            flag = "--" + k.replace("_", "-")
            if v is True:
                argv.append(flag)
            elif v is not False and v is not None:
                argv += [flag, str(v)]
        argv += [PYTHON_PLACEHOLDER, "-m",
                 "horovod_tpu_torch.runner.task_runner", "--kv"]
        rc = run_launcher(parse_args(argv))
        if rc != 0:
            raise RuntimeError(f"hvdrun job failed with exit code {rc}")
        results = []
        for rank in range(np):
            val = server.get(f"/run/result/{rank}")
            if val is None:
                raise RuntimeError(
                    f"worker rank {rank} exited 0 but posted no result")
            results.append(pickle.loads(val))
        return results
    finally:
        server.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
