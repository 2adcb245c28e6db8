"""Elastic state: commit, restore and sync, and the retry loop (counterpart
of ``horovod_tpu/elastic/state.py``: ``State`` :25, ``ObjectState`` :100,
``DurableStateMixin`` :128, ``run_fn`` :301, ``run`` :361,
``_NotificationManager`` :367; reference: ``horovod/common/elastic.py``
``State`` :60, ``ObjectState`` :109, ``run`` :147).

``hvd.elastic.run(train)(state)`` runs ``train(state)`` and, when a
collective fails (:class:`HvdTpuInternalError`: a peer died), rolls the
state back to its last ``commit()``, re-initializes the runtime in the
driver's next round and runs ``train`` again from there; when the driver
reports new hosts (:class:`HostsUpdatedInterrupt` at a ``commit()``), it
keeps the state and does the same. After each reset rank 0's state is
broadcast to every rank (``sync``), so workers that joined start from it.

The JAX package's ``TpuState`` holds JAX pytrees and has no counterpart:
the port's state of a model is :class:`~horovod_tpu_torch.elastic.
torch_state.TorchState`.
"""

from __future__ import annotations

import copy
import queue
from typing import Callable, List, Optional

import torch

from .. import runtime
from ..exceptions import HostsUpdatedInterrupt, HvdTpuInternalError
from ..functions import broadcast_object
from ..utils import envvars as ev
from ..utils import logging as log


class State:
    """What an elastic job rolls back and broadcasts (reference:
    ``horovod/common/elastic.py:60``). A subclass writes ``save`` (keep a
    copy), ``restore`` (return to it) and ``sync`` (take rank 0's)."""

    def __init__(self, **kwargs):
        self._host_messages: "queue.Queue" = queue.Queue()
        self._last_updated_timestamp = 0
        self._reset_callbacks: List[Callable[[], None]] = []
        for k, v in kwargs.items():
            setattr(self, k, v)

    def register_reset_callbacks(self, callbacks) -> None:
        """Callbacks run after each reset, before training goes on."""
        self._reset_callbacks.extend(callbacks)

    def on_reset(self) -> None:
        self._host_messages = queue.Queue()
        self.reset()
        for cb in self._reset_callbacks:
            cb()

    def on_hosts_updated(self, timestamp, update_res) -> None:
        """The driver reported a change of hosts."""
        self._host_messages.put((timestamp, update_res))

    def commit(self) -> None:
        """Keep the state as the point to return to, then raise
        :class:`HostsUpdatedInterrupt` if the hosts changed."""
        self.save()
        self.check_host_updates()

    def check_host_updates(self) -> None:
        """Raise :class:`HostsUpdatedInterrupt` on every rank together
        when any rank heard of a change: one MAX allreduce of (last
        timestamp, newest timestamp, update flag) makes the ranks agree on
        whether to raise and on ``skip_sync``."""
        notification_manager.poll()
        last = prev = self._last_updated_timestamp
        update = 0
        while not self._host_messages.empty():
            timestamp, res = self._host_messages.get()
            if timestamp > last:
                last = timestamp
                update |= int(res)
        from ..ops import collectives as C
        dev = "cpu" if runtime.mode() == "process" else runtime.device()
        agreed = C.allreduce(
            torch.tensor([prev, last, update], dtype=torch.int64,
                         device=dev),
            op=C.ReduceOp.MAX, name="elastic.host_updates",
            axis=runtime.axis_names()).tolist()
        self._last_updated_timestamp = agreed[1]
        if agreed[1] > agreed[0]:
            raise HostsUpdatedInterrupt(skip_sync=agreed[2] == 0)

    def save(self) -> None:
        raise NotImplementedError

    def restore(self) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class ObjectState(State):
    """Picklable attributes, kept by deep copy and synced by
    ``broadcast_object`` (reference: ``horovod/common/elastic.py:109``)."""

    def __init__(self, bcast_object=broadcast_object, **kwargs):
        self._bcast_object = bcast_object
        self._saved_state = kwargs
        super().__init__(**kwargs)

    def save(self) -> None:
        self._saved_state = {k: copy.deepcopy(getattr(self, k))
                             for k in self._saved_state}

    def restore(self) -> None:
        for k, v in self._saved_state.items():
            setattr(self, k, copy.deepcopy(v))

    def sync(self) -> None:
        if self._saved_state:
            synced = self._bcast_object(self._saved_state, root_rank=0,
                                        name="elastic.object_state")
            for k, v in synced.items():
                self._saved_state[k] = v
                setattr(self, k, v)


class DurableStateMixin:
    """Commits that also go to disk: every ``checkpoint_every``-th commit
    is written by :func:`horovod_tpu_torch.save_checkpoint` under
    ``checkpoint_dir`` (the newest ``checkpoint_keep`` steps kept), its
    step numbers going on across restarts, so that a new job can resume
    from the last one. A subclass calls :meth:`_init_durable` in its
    ``__init__`` and :meth:`_maybe_durable_save` after each in-memory
    save, with a function that builds the tree to write."""

    def _init_durable(self, checkpoint_dir: Optional[str],
                      checkpoint_every: int,
                      checkpoint_keep: Optional[int]) -> None:
        self._ckpt_dir = checkpoint_dir
        self._ckpt_every = max(int(checkpoint_every), 1)
        self._ckpt_keep = checkpoint_keep
        # Off for the snapshots of construction and sync: on disk they
        # would be the newest step while holding untrained or rolled-back
        # state.
        self._ckpt_armed = True
        self._commit_count = 0
        self._latest_durable = 0
        if checkpoint_dir is not None:
            from ..checkpoint import latest_checkpoint_step
            self._latest_durable = latest_checkpoint_step(checkpoint_dir) or 0
            self._commit_count = self._latest_durable

    def _maybe_durable_save(self, build_tree: Callable[[], dict]) -> None:
        if not self._ckpt_armed:
            return
        self._commit_count += 1
        if self._ckpt_dir is None or \
                self._commit_count % self._ckpt_every != 0:
            return
        if runtime.is_initialized() and runtime.rank() != 0:
            return  # one writer
        from ..checkpoint import save_checkpoint
        save_checkpoint(self._ckpt_dir, build_tree(),
                        step=self._commit_count, keep=self._ckpt_keep)
        self._latest_durable = self._commit_count


def run_fn(func: Callable, reset: Callable) -> Callable:
    """The retry loop (reference: ``horovod/common/elastic.py:147``):

    * :class:`HvdTpuInternalError`: restore the last commit, reset, sync,
      run again;
    * :class:`HostsUpdatedInterrupt`: keep the state, reset, sync unless
      no rank needs it, run again.
    """

    def wrapper(state: State, *args, **kwargs):
        notification_manager.init()
        notification_manager.register_listener(state)
        skip_sync = False
        try:
            while True:
                if not skip_sync:
                    state.sync()
                try:
                    return func(state, *args, **kwargs)
                except HvdTpuInternalError:
                    log.warning("elastic: internal error — restoring last "
                                "commit")
                    # The time of detection, for the recovery time the
                    # next init records; the hint starts the driver's new
                    # round now rather than at its next poll.
                    runtime.note_failure_detected()
                    notification_manager.post_failure_hint()
                    state.restore()
                    skip_sync = False
                except HostsUpdatedInterrupt as e:
                    log.info("elastic: hosts updated — resetting")
                    skip_sync = e.skip_sync
                # A peer may die while the world re-forms: the core's
                # form-up then fails, which is a new failure, not the
                # job's end; the rendezvous itself ends at the elastic
                # timeout (TimeoutError).
                while True:
                    try:
                        reset()
                        break
                    except HvdTpuInternalError as exc:
                        log.warning("elastic: re-initialization failed (%s);"
                                    " retrying rendezvous", exc)
                        runtime.note_failure_detected()
                        notification_manager.post_failure_hint()
                        skip_sync = False
                state.on_reset()
        finally:
            notification_manager.remove_listener(state)

    return wrapper


def run(func: Callable) -> Callable:
    """Decorator of an elastic training function:
    ``hvd.elastic.run(train)(state)``. Its reset is
    :func:`horovod_tpu_torch.runtime.reinit`."""
    return run_fn(func, runtime.reinit)


class _NotificationManager:
    """The states that hear of the driver's changes of hosts. Workers read
    the driver's ``/rendezvous/updates`` at each ``commit()`` (the
    reference's driver pushes them into a service in each worker; commits
    are the only points where a change can act either way)."""

    def __init__(self):
        self._listeners: List[State] = []
        self._initialized = False
        self._client = None
        self._seen_epoch = 0

    def init(self) -> None:
        if self._initialized:
            return
        self._initialized = True
        addr = ev.get_str(ev.HVDTPU_RENDEZVOUS_ADDR)
        if addr:
            from ..runner.http_kv import KVStoreClient
            self._client = KVStoreClient(
                addr, ev.get_int(ev.HVDTPU_RENDEZVOUS_PORT, 0),
                secret=ev.get_str(ev.HVDTPU_SECRET))
            self._seen_epoch = runtime._elastic_last_epoch

    def poll(self) -> None:
        """Read the driver's last change (nothing outside an elastic
        job)."""
        if self._client is None:
            return
        try:
            raw = self._client.get("/rendezvous/updates")
        except OSError:
            return
        if not raw:
            return
        epoch = int(raw)
        if epoch > max(self._seen_epoch, runtime._elastic_last_epoch):
            self._seen_epoch = epoch
            self.handle_hosts_updated(epoch, 1)

    def post_failure_hint(self) -> None:
        """Tell the driver that a peer looks dead."""
        if self._client is None:
            return
        try:
            self._client.put("/rendezvous/hint",
                             (ev.get_str(ev.HVDTPU_WORKER_ID) or
                              "?").encode())
        except OSError:
            pass  # the driver also sees the dead worker's exit

    def register_listener(self, state: State) -> None:
        self._listeners.append(state)

    def remove_listener(self, state: State) -> None:
        if state in self._listeners:
            self._listeners.remove(state)

    def handle_hosts_updated(self, timestamp, update_res) -> None:
        for listener in self._listeners:
            listener.on_hosts_updated(timestamp, update_res)


notification_manager = _NotificationManager()
