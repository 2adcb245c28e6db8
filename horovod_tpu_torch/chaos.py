"""Fault-injection spec of the native core (counterpart of
``horovod_tpu/chaos.py``: ``parse_chaos`` :80, ``armed_chaos`` :151).

``HVDTPU_CHAOS`` arms at most one one-shot fault inside the core's data
plane (``hvdtpu_set_chaos``)::

    [rank<R>:]<action>[=<arg>]@<trigger>

    action   kill | hang | delay=<ms> | drop[=<peer>] | corrupt
    trigger  op=<N>   the N-th allreduce this rank starts (1-based)
             hop=<N>  the N-th pairwise exchange this rank runs

``rank<R>:`` arms it on global rank R alone. With ``HVDTPU_CHAOS_MARKER``
set, the spec arms only in the first process that claims the marker:
under the elastic driver through its key-value store (``_claim_marker_kv``,
JAX ``chaos.py:126-150``), which every host sees, else by creating the
file it names.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional

from .utils import envvars as ev

# hvdtpu::ChaosSpec::Action (native/data_plane.h).
CHAOS_ACTIONS = {"none": 0, "kill": 1, "hang": 2, "delay": 3, "drop": 4,
                 "corrupt": 5}

_SPEC_RE = re.compile(
    r"^(?:rank(?P<rank>\d+):)?"
    r"(?P<action>kill|hang|delay|drop|corrupt)"
    r"(?:=(?P<arg>\d+))?"
    r"@(?P<trigger>op|hop)=(?P<index>\d+)$")


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """One resolved fault, as ``hvdtpu_set_chaos`` takes it."""
    action: int
    op_index: int = 0
    hop_index: int = 0
    delay_ms: int = 0
    peer: int = -1


def parse_chaos(spec: str, rank: int) -> Optional[ChaosSpec]:
    """The fault ``spec`` arms on global rank ``rank``: None when it is
    empty or aims at another rank; ValueError, naming the knob, when it is
    malformed."""
    spec = (spec or "").strip()
    if not spec:
        return None
    m = _SPEC_RE.match(spec)
    if m is None:
        raise ValueError(
            f"{ev.HVDTPU_CHAOS} must match "
            f"'[rankR:]kill|hang|delay=<ms>|drop[=<peer>]@op=N|hop=N', "
            f"got {spec!r}")
    action = m.group("action")
    arg = m.group("arg")
    if action == "delay" and arg is None:
        raise ValueError(
            f"{ev.HVDTPU_CHAOS}: delay needs a duration, e.g. "
            f"'delay=200@hop=5' (milliseconds)")
    if action in ("kill", "hang", "corrupt") and arg is not None:
        raise ValueError(
            f"{ev.HVDTPU_CHAOS}: {action} takes no '=<arg>' (got {spec!r})")
    if action == "corrupt" and m.group("trigger") != "op":
        raise ValueError(
            f"{ev.HVDTPU_CHAOS}: corrupt flips a byte of a specific op's "
            f"post-allreduce OUTPUT, so it is op-gated only — use "
            f"'corrupt@op=N' (got {spec!r})")
    index = int(m.group("index"))
    if index <= 0:
        raise ValueError(
            f"{ev.HVDTPU_CHAOS}: op/hop indices are 1-based, got {index}")
    if m.group("rank") is not None and int(m.group("rank")) != rank:
        return None
    return ChaosSpec(
        action=CHAOS_ACTIONS[action],
        op_index=index if m.group("trigger") == "op" else 0,
        hop_index=index if m.group("trigger") == "hop" else 0,
        delay_ms=int(arg) if action == "delay" else 0,
        peer=int(arg) if (action == "drop" and arg is not None) else -1)


def _claim_marker_kv(marker: str, rank: int) -> Optional[bool]:
    """Claim the one-shot marker in the elastic driver's store: True when
    this process claimed it, False when another did, None outside an
    elastic job or when the store cannot be reached (the caller falls back
    to the file). The worker that replaces a dead one may run on another
    host, where a file marker does not exist, so the claim must be the
    store's. A GET then a PUT is enough: two claims are a detection and a
    new rendezvous apart, never at once."""
    addr = ev.get_str(ev.HVDTPU_RENDEZVOUS_ADDR)
    if not addr:
        return None
    from .runner.http_kv import KVStoreClient
    client = KVStoreClient(addr, ev.get_int(ev.HVDTPU_RENDEZVOUS_PORT, 0),
                           secret=ev.get_str(ev.HVDTPU_SECRET))
    key = "/chaos/marker/" + os.path.basename(marker)
    try:
        if client.get(key):
            return False
        client.put(key, f"armed rank={rank} "
                        f"spec={ev.get_str(ev.HVDTPU_CHAOS)}\n".encode())
    except OSError:
        return None
    return True


def armed_chaos(rank: int) -> Optional[ChaosSpec]:
    """The fault this process arms at init, once per marker."""
    spec = parse_chaos(ev.get_str(ev.HVDTPU_CHAOS, "") or "", rank)
    if spec is None:
        return None
    marker = ev.get_str(ev.HVDTPU_CHAOS_MARKER)
    if marker:
        claimed = _claim_marker_kv(marker, rank)
        if claimed is not None:
            return spec if claimed else None
        try:
            fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
        except FileExistsError:
            return None
        with os.fdopen(fd, "w") as f:
            f.write(f"armed rank={rank} spec={ev.get_str(ev.HVDTPU_CHAOS)}\n")
    return spec
