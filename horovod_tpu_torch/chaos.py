"""Fault-injection spec of the native core (counterpart of
``horovod_tpu/chaos.py``: ``parse_chaos`` :80, ``armed_chaos`` :151).

``HVDTPU_CHAOS`` arms at most one one-shot fault inside the core's data
plane (``hvdtpu_set_chaos``)::

    [rank<R>:]<action>[=<arg>]@<trigger>

    action   kill | hang | delay=<ms> | drop[=<peer>] | corrupt
    trigger  op=<N>   the N-th allreduce this rank starts (1-based)
             hop=<N>  the N-th pairwise exchange this rank runs

``rank<R>:`` arms it on global rank R alone. With ``HVDTPU_CHAOS_MARKER``
naming a file, the spec arms only in the first process that creates the
file. (The JAX package also claims the marker through the elastic
rendezvous's key-value store, which comes with the runner.)
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


def armed_chaos(rank: int) -> Optional[ChaosSpec]:
    """The fault this process arms at init, once per marker file."""
    spec = parse_chaos(ev.get_str(ev.HVDTPU_CHAOS, "") or "", rank)
    if spec is None:
        return None
    marker = ev.get_str(ev.HVDTPU_CHAOS_MARKER)
    if marker:
        try:
            fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
        except FileExistsError:
            return None
        with os.fdopen(fd, "w") as f:
            f.write(f"armed rank={rank} spec={ev.get_str(ev.HVDTPU_CHAOS)}\n")
    return spec
