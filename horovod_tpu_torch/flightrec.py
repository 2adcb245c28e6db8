"""Flight-recorder dump decoder (docs/fault-tolerance.md "Post-mortem
debugging").

The native core keeps an always-on, lock-free in-memory ring of compact
binary phase records (``native/flightrec.{h,cpp}``) and dumps it to
``flightrec.<rank>.bin`` on the abort cascade, stall escalation, fatal
signals, or on demand. This module is the Python half:

* :func:`parse_dump` — decode one dump image (bytes) into a
  :class:`FlightDump`;
* :func:`load_dump_dir` — every ``flightrec.<rank>.bin`` in a directory,
  keyed by rank (what ``python -m horovod_tpu_torch.postmortem`` consumes);
* :func:`debugz_dict` / :func:`debugz_json` — the live ``/debugz`` view:
  in-flight op + last-N events, rendered from an in-memory snapshot
  (``NativeCore.flightrec_snapshot``).

``FLIGHT_EVENTS`` / ``DUMP_REASONS`` mirror the native enums byte-for-byte
(the ENUM-MIRROR rule of the JAX package's invariant linter). No reference
analog: the reference's only post-hoc artifact is the optional timeline.

The port's own copy of ``horovod_tpu/flightrec.py`` (it imports nothing of
the JAX package); the two are held to the same outputs on the same input
(``tests/test_torch_port_observability.py``).
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Dict, List, Optional

# Byte-for-byte mirror of hvdtpu::FlightEvent (native/flightrec.h).
FLIGHT_EVENTS = {"none": 0, "op_begin": 1, "op_end": 2, "send": 3,
                 "recv": 4, "sendrecv": 5, "reduce": 6, "quantize": 7,
                 "dequantize": 8, "fusion_wait": 9, "fail_detect": 10,
                 "stall": 11, "abort": 12, "mark": 13, "anomaly": 14,
                 "nonfinite": 15, "divergence": 16}
EVENT_NAMES = {v: k for k, v in FLIGHT_EVENTS.items()}

# Byte-for-byte mirror of hvdtpu::DumpReason (native/flightrec.h).
DUMP_REASONS = {"on_demand": 0, "abort": 1, "stall": 2, "signal": 3,
                "nonfinite": 4}
REASON_NAMES = {v: k for k, v in DUMP_REASONS.items()}

# Lane codes (FlightLaneCode in native/flightrec.h).
LANE_NAMES = {0: "local", 1: "tcp", 2: "shm", 3: "tcp-zc"}

MAGIC = b"HVDFREC1"
_HEADER = struct.Struct("<8sIIiiqqqqqIIIIii")  # 88 bytes of payload
_RECORD = struct.Struct("<qQqQQ")  # 5 little-endian u64-sized words


class FlightEventRecord:
    """One decoded ring record."""

    __slots__ = ("t_end_us", "dur_us", "type", "lane", "bytes", "name_id",
                 "arg", "send_peer", "recv_peer", "name")

    def __init__(self, t_end_us, dur_us, type_, lane, bytes_, name_id, arg,
                 send_peer, recv_peer, name):
        self.t_end_us = t_end_us
        self.dur_us = dur_us
        self.type = type_          # event name string ("sendrecv", ...)
        self.lane = lane           # lane name string ("shm", ...)
        self.bytes = bytes_
        self.name_id = name_id
        self.arg = arg             # wait_us (hops) / status (op_end) / ...
        self.send_peer = send_peer
        self.recv_peer = recv_peer
        self.name = name           # interned name ("" when nameless)

    @property
    def t_start_us(self) -> int:
        return self.t_end_us - self.dur_us

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class FlightDump:
    """One rank's decoded flight-recorder dump."""

    def __init__(self, rank, world_size, clock_offset_us, clock_err_us,
                 steady_now_us, wall_now_us, write_count, capacity, reason,
                 detail, names, events):
        self.rank = rank
        self.world_size = world_size
        # The tracing layer's clock sync vs rank 0 (err < 0 = never
        # synced): add the offset to this rank's steady timestamps to land
        # on rank 0's axis.
        self.clock_offset_us = clock_offset_us
        self.clock_err_us = clock_err_us
        self.steady_now_us = steady_now_us  # anchor pair taken at dump time
        self.wall_now_us = wall_now_us
        self.write_count = write_count      # records ever written
        self.capacity = capacity
        self.reason = reason                # "abort" / "stall" / "signal" / ...
        self.detail = detail                # failed peer / signo / -1
        self.names = names
        self.events: List[FlightEventRecord] = events

    def last_inflight_op(self) -> Optional[FlightEventRecord]:
        """The last ``op_begin`` with no matching ``op_end`` after it — the
        collective this rank was inside when the ring froze (None = idle)."""
        last = None
        for ev in self.events:
            if ev.type == "op_begin":
                last = ev
            elif ev.type == "op_end" and last is not None and \
                    ev.name_id == last.name_id:
                last = None
        return last

    def last_failed_op(self) -> Optional[FlightEventRecord]:
        """The most recent ``op_begin`` whose ``op_end`` carried an error —
        on a survivor the abort cascade breaks the collective it was inside,
        so the op COMPLETES (with an error) before the ring is dumped; this
        is the fatal op even though nothing is technically in flight."""
        begins: Dict[int, FlightEventRecord] = {}
        failed = None
        for ev in self.events:
            if ev.type == "op_begin":
                begins[ev.name_id] = ev
            elif ev.type == "op_end" and ev.arg != 0:
                failed = begins.get(ev.name_id, failed) or failed
        return failed

    def last_hop(self) -> Optional[FlightEventRecord]:
        """The most recent wire hop — whose peer is who this rank was
        talking to (or waiting on) last."""
        for ev in reversed(self.events):
            if ev.type in ("send", "recv", "sendrecv"):
                return ev
        return None


def _s32(u: int) -> int:
    return u - (1 << 32) if u >= (1 << 31) else u


def parse_dump(data: bytes) -> FlightDump:
    """Decode one dump image (the file contents / a live snapshot)."""
    if len(data) < _HEADER.size or data[:8] != MAGIC:
        raise ValueError("not a flight-recorder dump (bad magic)")
    (_, version, header_bytes, rank, world, clock_off, clock_err,
     steady_now, wall_now, write_count, capacity, record_bytes, name_count,
     name_bytes, reason, detail) = _HEADER.unpack_from(data, 0)
    if version != 1:
        raise ValueError(f"unsupported flight-recorder dump version "
                         f"{version}")
    off = header_bytes
    names: List[str] = []
    for _ in range(name_count):
        raw = data[off:off + name_bytes]
        names.append(raw.split(b"\x00", 1)[0].decode(errors="replace"))
        off += name_bytes
    events: List[FlightEventRecord] = []
    while off + record_bytes <= len(data):
        t_end, w1, bytes_, w3, w4 = _RECORD.unpack_from(data, off)
        off += record_bytes
        name_id = _s32(w3 & 0xFFFFFFFF)
        events.append(FlightEventRecord(
            t_end_us=t_end,
            dur_us=w1 & 0xFFFFFFFF,
            type_=EVENT_NAMES.get((w1 >> 32) & 0xFFFF, "none"),
            lane=LANE_NAMES.get(w1 >> 48, "?"),
            bytes_=bytes_,  # 'q' in _RECORD: already signed
            name_id=name_id,
            arg=_s32(w3 >> 32),
            send_peer=_s32(w4 & 0xFFFFFFFF),
            recv_peer=_s32(w4 >> 32),
            name=names[name_id] if 0 <= name_id < len(names) else ""))
    return FlightDump(rank, world, clock_off, clock_err, steady_now,
                      wall_now, write_count, capacity,
                      REASON_NAMES.get(reason, str(reason)), detail, names,
                      events)


_DUMP_FILE_RE = re.compile(r"^flightrec\.(\d+)\.bin$")


def load_dump_dir(path: str) -> Dict[int, FlightDump]:
    """Every ``flightrec.<rank>.bin`` under ``path``, decoded and keyed by
    rank. Unparseable files are skipped (a half-written dump from a rank
    that died mid-write must not take the whole post-mortem down)."""
    dumps: Dict[int, FlightDump] = {}
    for name in sorted(os.listdir(path)):
        m = _DUMP_FILE_RE.match(name)
        if m is None:
            continue
        try:
            with open(os.path.join(path, name), "rb") as f:
                dump = parse_dump(f.read())
        except (ValueError, OSError):
            continue
        dumps[int(m.group(1))] = dump
    return dumps


def debugz_dict(snapshot: bytes, last_n: int = 50) -> dict:
    """The live ``/debugz`` view: in-flight op + the last ``last_n`` ring
    events from an in-memory snapshot (empty snapshot = recorder off)."""
    if not snapshot:
        return {"flightrec": "disabled"}
    dump = parse_dump(snapshot)
    inflight = dump.last_inflight_op()
    hop = dump.last_hop()
    return {
        "flightrec": "on",
        "rank": dump.rank,
        "world_size": dump.world_size,
        "records_written": dump.write_count,
        "ring_capacity": dump.capacity,
        "clock_offset_us": dump.clock_offset_us,
        "clock_err_us": dump.clock_err_us,
        "inflight_op": None if inflight is None else {
            "name": inflight.name,
            "since_us": inflight.t_end_us,
            "bytes": inflight.bytes,
        },
        "last_hop": None if hop is None else {
            "type": hop.type, "send_peer": hop.send_peer,
            "recv_peer": hop.recv_peer, "bytes": hop.bytes,
            "lane": hop.lane, "wait_us": hop.arg,
        },
        "last_events": [ev.to_dict() for ev in dump.events[-last_n:]],
    }


def debugz_json(snapshot: bytes, last_n: int = 50) -> str:
    return json.dumps(debugz_dict(snapshot, last_n=last_n), indent=1)
