"""Host lists and rank assignment (counterpart of
``horovod_tpu/runner/hosts.py``: ``SlotInfo`` :15, ``parse_hosts`` :26,
``parse_hostfile`` :42, ``host_groups`` :60, ``get_host_assignments``
:75; reference: ``horovod/runner/common/util/hosts.py``).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass
class SlotInfo:
    """One worker's place in the job: its host and its global, local and
    cross ranks."""
    hostname: str
    rank: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int
    size: int


def parse_hosts(hosts_str: str) -> List[Tuple[str, int]]:
    """``"h1:2,h2:4"`` as ``[(host, slots)]``; a host without ``:slots``
    has one slot."""
    out = []
    for part in hosts_str.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            host, slots = part.rsplit(":", 1)
            out.append((host, int(slots)))
        else:
            out.append((part, 1))
    return out


def parse_hostfile(path: str) -> List[Tuple[str, int]]:
    """An mpirun-style hostfile, ``host slots=N`` a line (``#`` starts a
    comment; one slot without ``slots=``)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            host, *options = line.split()
            slots = 1
            for option in options:
                if option.startswith("slots="):
                    slots = int(option.split("=", 1)[1])
            out.append((host, slots))
    return out


def host_groups(slots: List[SlotInfo]) -> Dict[str, List[int]]:
    """Host -> the global ranks on it, in rank order: the groups the core
    gives shared-memory lanes (``native/data_plane.cpp``), the first rank
    of each its host's leader."""
    groups: Dict[str, List[int]] = collections.OrderedDict()
    for s in slots:
        groups.setdefault(s.hostname, []).append(s.rank)
    return groups


def get_host_assignments(hosts: List[Tuple[str, int]],
                         np_: int) -> List[SlotInfo]:
    """``np_`` slots filled host by host, in the order given. A host named
    twice is one host with the slots summed. ``cross_rank`` is the host's
    place among the hosts that have a worker at that ``local_rank``, and
    ``cross_size`` their number. ValueError when the hosts hold fewer than
    ``np_`` slots."""
    merged: Dict[str, int] = collections.OrderedDict()
    for host, cap in hosts:
        merged[host] = merged.get(host, 0) + cap
    total = sum(merged.values())
    if total < np_:
        raise ValueError(f"requested -np {np_} but only {total} slots "
                         f"available: {list(merged.items())}")
    slots: List[SlotInfo] = []
    used: List[Tuple[str, int]] = []  # (host, workers placed on it)
    for host, cap in merged.items():
        if len(slots) >= np_:
            break
        use = min(cap, np_ - len(slots))
        used.append((host, use))
        for lr in range(use):
            slots.append(SlotInfo(hostname=host, rank=len(slots),
                                  local_rank=lr, local_size=use,
                                  cross_rank=0, cross_size=0, size=np_))
    for s in slots:
        peers = [h for h, use in used if use > s.local_rank]
        s.cross_rank = peers.index(s.hostname)
        s.cross_size = len(peers)
    return slots
