"""Host discovery of an elastic job (counterpart of
``horovod_tpu/runner/elastic/discovery.py``; reference:
``horovod/runner/elastic/discovery.py``: ``HostManager`` :79,
``HostDiscoveryScript`` :130, ``FixedHosts`` :155).
"""

from __future__ import annotations

import subprocess
import threading
from typing import Dict


class HostDiscovery:
    """Answers which hosts may run workers now, and with how many slots."""

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        raise NotImplementedError


class HostDiscoveryScript(HostDiscovery):
    """The user's script: each line of its output is ``host:slots``, or
    ``host`` with ``slots`` slots. RuntimeError when it exits non-zero."""

    def __init__(self, discovery_script: str, slots: int = 1):
        self._script = discovery_script
        self._default_slots = slots

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        out = subprocess.run(self._script, shell=True, capture_output=True,
                             text=True, timeout=60)
        if out.returncode != 0:
            raise RuntimeError(
                f"discovery script failed ({out.returncode}): {out.stderr}")
        hosts: Dict[str, int] = {}
        for line in out.stdout.splitlines():
            line = line.strip()
            if not line:
                continue
            if ":" in line:
                host, slots = line.rsplit(":", 1)
                hosts[host] = int(slots)
            else:
                hosts[line] = self._default_slots
        return hosts


class FixedHosts(HostDiscovery):
    """A host set that the caller changes with :meth:`set` (tests)."""

    def __init__(self, hosts: Dict[str, int]):
        self._hosts = dict(hosts)
        self._lock = threading.Lock()

    def set(self, hosts: Dict[str, int]) -> None:
        with self._lock:
            self._hosts = dict(hosts)

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._hosts)


class HostManager:
    """The usable hosts: what discovery found, less the blacklisted ones
    and those without a slot."""

    def __init__(self, discovery: HostDiscovery):
        self._discovery = discovery
        self._blacklist: set = set()
        self._current: Dict[str, int] = {}
        self._lock = threading.Lock()

    def blacklist(self, host: str) -> None:
        with self._lock:
            self._blacklist.add(host)

    def is_blacklisted(self, host: str) -> bool:
        with self._lock:
            return host in self._blacklist

    @property
    def current_hosts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._current)

    def update_available_hosts(self) -> bool:
        """Ask discovery again; True when the usable set changed."""
        found = self._discovery.find_available_hosts_and_slots()
        with self._lock:
            usable = {h: s for h, s in found.items()
                      if h not in self._blacklist and s > 0}
            changed = usable != self._current
            self._current = usable
            return changed
