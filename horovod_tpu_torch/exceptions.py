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


class HostsUpdatedInterrupt(Exception):
    """The elastic driver reported a change of the host set (JAX
    ``exceptions.py:20``; reference: ``horovod/common/elastic.py:73-93``).
    Raised at ``state.commit()`` on every rank together; ``skip_sync``
    tells the retry loop that no rank needs the state broadcast again."""

    def __init__(self, skip_sync: bool = False):
        super().__init__("hosts updated")
        self.skip_sync = skip_sync


class TensorShapeMismatchError(ValueError):
    """The ranks passed different shapes for one named collective (JAX
    ``exceptions.py:33``; reference: ``controller.cc:380-657``). Raised by
    process mode, whose native core reports it to every rank."""


class TensorDtypeMismatchError(ValueError):
    """The ranks passed different dtypes for one named collective (JAX
    ``exceptions.py:41``)."""


class DuplicateNameError(ValueError):
    """A collective was enqueued under a name that is still pending on this
    rank (JAX ``exceptions.py:46``; reference: "already pending")."""


class NotInitializedError(RuntimeError):
    """An API was called before ``init()`` (reference: basics.py check)."""

    def __init__(self, what: str = "horovod_tpu_torch"):
        super().__init__(
            f"{what} has not been initialized; call "
            "horovod_tpu_torch.init() first.")
