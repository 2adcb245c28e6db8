"""The worker side of :func:`horovod_tpu_torch.runner.run` (counterpart of
``horovod_tpu/runner/task_runner.py``; reference: the remote side of
``horovod.run``, ``horovod/runner/__init__.py:99``).

``--kv``: fetch the pickled ``(fn, args, kwargs)`` from the launcher's
key-value store (``/run/fn``), run it under an initialized runtime and PUT
the pickled result at ``/run/result/<rank>``, so that no shared
filesystem is needed. ``<fn_path> <out_path>``: the same through files on
one host, the result in ``<out_path>.<rank>``.

The runtime starts on the device ``run(device=...)`` named
(``HVDTPU_RUN_DEVICE``), by default the card of the worker's local rank.
"""

from __future__ import annotations

import pickle
import sys

def _run_under_runtime(fn, args, kwargs):
    import horovod_tpu_torch as hvd
    from ..utils import envvars as ev
    hvd.init(device=ev.get_str(ev.HVDTPU_RUN_DEVICE))
    try:
        result = fn(*args, **kwargs)
    finally:
        rank = hvd.rank()
        hvd.shutdown()
    return rank, result


def main() -> int:
    if sys.argv[1] == "--kv":
        from ..utils import envvars as ev
        from .http_kv import KVStoreClient

        client = KVStoreClient(
            ev.get_required(ev.HVDTPU_RUN_KV_ADDR),
            int(ev.get_required(ev.HVDTPU_RUN_KV_PORT)),
            timeout=30.0, secret=ev.get_str(ev.HVDTPU_SECRET))
        payload = client.get("/run/fn")
        if payload is None:
            raise RuntimeError("launcher KV store has no /run/fn payload")
        fn, args, kwargs = pickle.loads(payload)
        rank, result = _run_under_runtime(fn, args, kwargs)
        client.put(f"/run/result/{rank}", pickle.dumps(result))
        return 0

    fn_path, out_path = sys.argv[1], sys.argv[2]
    with open(fn_path, "rb") as f:
        fn, args, kwargs = pickle.load(f)
    rank, result = _run_under_runtime(fn, args, kwargs)
    with open(f"{out_path}.{rank}", "wb") as f:
        pickle.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
