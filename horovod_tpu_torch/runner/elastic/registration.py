"""Outcomes of the workers of each rendezvous round (counterpart of
``horovod_tpu/runner/elastic/registration.py``; reference:
``horovod/runner/elastic/registration.py``).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Set

SUCCESS = "success"
FAILURE = "failure"


class WorkerStateRegistry:
    """Epoch -> worker id -> ``SUCCESS`` or ``FAILURE``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._states: Dict[int, Dict[str, str]] = {}

    def record(self, epoch: int, worker_id: str, state: str) -> None:
        with self._lock:
            self._states.setdefault(epoch, {})[worker_id] = state

    def state_of(self, epoch: int, worker_id: str) -> Optional[str]:
        with self._lock:
            return self._states.get(epoch, {}).get(worker_id)

    def count(self, epoch: int, state: str) -> int:
        with self._lock:
            return sum(1 for s in self._states.get(epoch, {}).values()
                       if s == state)

    def failures(self, epoch: int) -> Set[str]:
        with self._lock:
            return {w for w, s in self._states.get(epoch, {}).items()
                    if s == FAILURE}

    def all_succeeded(self, epoch: int, expected: Set[str]) -> bool:
        with self._lock:
            done = {w for w, s in self._states.get(epoch, {}).items()
                    if s == SUCCESS}
            return expected.issubset(done)
