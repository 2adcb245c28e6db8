"""Framework exceptions (counterpart of ``horovod_tpu/exceptions.py``).

Reference: ``horovod/common/exceptions.py``. The port keeps its own copy so
that importing it never runs the JAX package's ``__init__``.
"""

from __future__ import annotations


class HvdTpuInternalError(RuntimeError):
    """A collective failed on every rank, for example because the ranks
    disagreed on its dtype, shape, reduce op or root (reference:
    ``HorovodInternalError``, ``horovod/common/exceptions.py:20``; the
    messages are those of ``horovod_tpu/native/core.cpp:2501-2600``)."""


class NotInitializedError(RuntimeError):
    """An API was called before ``init()`` (reference: basics.py check)."""

    def __init__(self, what: str = "horovod_tpu_torch"):
        super().__init__(
            f"{what} has not been initialized; call "
            "horovod_tpu_torch.init() first.")
