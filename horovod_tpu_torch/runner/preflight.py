"""Connectivity preflight of a multi-host job (counterpart of
``horovod_tpu/runner/preflight.py``: ``local_addr`` :31, ``probe_main``
:86, ``check_connectivity`` :190; reference:
``horovod/runner/driver/driver_service.py:193``).

Before the launcher starts workers on other hosts, a probe on every host
checks the two paths a worker will use: it reaches the launcher's
key-value store (which also proves that ssh and the remote interpreter
work), and, on every host but rank 0's, it opens a TCP connection to the
controller's port, where rank 0's host listens with a throwaway socket.
A failure names the host and the address it tried.
:func:`check_metrics_ports` (JAX :162) proves, before the workers start,
that the live-metrics ports of this host's ranks and of the launcher's
aggregator can be bound.

    python -m horovod_tpu_torch.runner.preflight   # one probe, from env
"""

from __future__ import annotations

import socket
import subprocess
import time
from typing import Callable, Dict, List, Optional

from ..utils import envvars as ev

_POLL_S = 0.2


def _local_addresses() -> List[str]:
    """This host's IPv4 addresses (``ip -o -4 addr`` and the host name's
    own), sorted."""
    addrs = set()
    try:
        out = subprocess.run(["ip", "-o", "-4", "addr", "show"],
                             capture_output=True, text=True,
                             timeout=5).stdout
        for line in out.splitlines():
            parts = line.split()
            if "inet" in parts:
                addrs.add(parts[parts.index("inet") + 1].split("/")[0])
    except (OSError, subprocess.SubprocessError):
        pass
    try:
        addrs.update(i[4][0] for i in socket.getaddrinfo(
            socket.gethostname(), None, socket.AF_INET))
    except OSError:
        pass
    return sorted(addrs)


def local_addr() -> str:
    """An address other hosts can reach this one on:
    ``HVDTPU_ADVERTISE_ADDR`` when set (the escape hatch of a host with
    several networks), else the first address of this host outside the
    loopback, else 127.0.0.1. (The JAX module asks the routing table for
    the way to a public address; this one looks at the host's own
    interfaces and sends nothing.)"""
    override = ev.get_str(ev.HVDTPU_ADVERTISE_ADDR)
    if override:
        return override
    for addr in _local_addresses():
        if not addr.startswith("127."):
            return addr
    return "127.0.0.1"


def _wait_key(client, key: str, deadline: float) -> Optional[bytes]:
    while time.monotonic() < deadline:
        try:
            val = client.get(key)
        except OSError:
            val = None
        if val:
            return val
        time.sleep(_POLL_S)
    return None


def _listen(client, host: str, ctrl_port: int, deadline: float) -> int:
    """Rank 0's host: hold the controller's port, and accept (and drop)
    the probes' connections until the launcher says it is done."""
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        srv.bind(("", ctrl_port))
        srv.listen(64)
    except OSError as e:
        srv.close()
        client.put(f"/preflight/result/{host}",
                   f"bind-failed on port {ctrl_port}: {e}".encode())
        return 1
    srv.settimeout(_POLL_S)
    try:
        # The addresses the launcher names when a connector cannot reach
        # this host: the candidates for --controller-advertise-address.
        client.put("/preflight/controller_addrs",
                   ", ".join(_local_addresses()).encode())
        client.put("/preflight/listening", b"1")
        client.put(f"/preflight/result/{host}", b"ok")
        while time.monotonic() < deadline:
            try:
                conn, _ = srv.accept()
                conn.close()
            except socket.timeout:
                pass
            try:
                if client.get("/preflight/done"):
                    break
            except OSError:
                pass
    finally:
        srv.close()
    return 0


def _connect(client, host: str, ctrl_host: str, ctrl_port: int,
             deadline: float) -> int:
    """Every other host: reach the controller's port."""
    if _wait_key(client, "/preflight/listening", deadline) is None:
        client.put(f"/preflight/result/{host}",
                   b"timeout waiting for the controller-side listener")
        return 1
    err = None
    for _ in range(3):
        try:
            with socket.create_connection((ctrl_host, ctrl_port),
                                          timeout=5.0):
                err = None
                break
        except OSError as e:
            err = e
            time.sleep(0.5)
    if err is None:
        client.put(f"/preflight/result/{host}", b"ok")
        return 0
    client.put(f"/preflight/result/{host}",
               f"cannot connect to controller {ctrl_host}:{ctrl_port}: "
               f"{err} (this host's addresses: "
               f"{', '.join(_local_addresses()) or 'unknown'})".encode())
    return 1


def probe_main() -> int:
    """One host's probe; its role and the endpoints come from the
    ``HVDTPU_PREFLIGHT_*`` variables."""
    from .http_kv import KVStoreClient

    client = KVStoreClient(
        ev.get_required(ev.HVDTPU_PREFLIGHT_KV_ADDR),
        int(ev.get_required(ev.HVDTPU_PREFLIGHT_KV_PORT)), timeout=5.0,
        secret=ev.get_str(ev.HVDTPU_SECRET))
    host = ev.get_required(ev.HVDTPU_PREFLIGHT_HOST)
    ctrl_host, ctrl_port = ev.get_required(
        ev.HVDTPU_PREFLIGHT_CONTROLLER).rsplit(":", 1)
    deadline = time.monotonic() + ev.get_float(ev.HVDTPU_PREFLIGHT_TIMEOUT,
                                               30.0)
    if ev.get_required(ev.HVDTPU_PREFLIGHT_ROLE) == "listen":
        return _listen(client, host, int(ctrl_port), deadline)
    return _connect(client, host, ctrl_host, int(ctrl_port), deadline)


def check_metrics_ports(hostnames: List[str], base_port: int,
                        aggregator_port: Optional[int] = None) -> None:
    """Bind each port the job's metrics endpoints will take on this host:
    rank r's ``base_port + r`` for the ranks of this host (a remote rank's
    port fails in its own ``init``, naming it) and the launcher's
    ``aggregator_port``. RuntimeError naming every busy port."""
    from .safe_exec import is_local_host

    failures = []
    probes = [(host, base_port + rank, f"rank {rank}")
              for rank, host in enumerate(hostnames)
              if is_local_host(host)]
    if aggregator_port is not None:
        probes.append(("localhost", aggregator_port, "driver aggregator"))
    for host, port, who in probes:
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("", port))
        except OSError as e:
            failures.append(f"  {who}: port {port} on {host}: {e}")
        finally:
            s.close()
    if failures:
        raise RuntimeError(
            "metrics-port preflight failed (HVDTPU_METRICS_PORT / "
            "--metrics-port assigns base+rank per worker):\n" +
            "\n".join(failures) +
            "\nPick a base port with world_size+1 free ports above it, "
            "or set it to 0 to disable the live-metrics endpoints.")


def check_connectivity(hostnames: List[str], controller_host: str,
                       controller_port: int,
                       spawn: Callable[[str, Dict[str, str]], object],
                       timeout: float = 30.0,
                       secret: Optional[str] = None,
                       listen_host: Optional[str] = None) -> None:
    """Probe every host before the workers start; RuntimeError naming
    every host that failed.

    ``spawn(host, env)`` starts the probe on ``host`` (over ssh or here:
    the launcher's own way of starting workers) and returns its
    :class:`~horovod_tpu_torch.runner.safe_exec.WorkerProcess`.
    ``controller_host`` is the address the workers dial, ``listen_host``
    the slot host that will run rank 0 (``controller_host`` unless
    ``--controller-advertise-address`` set another)."""
    from .http_kv import KVStoreServer

    uniq = list(dict.fromkeys(hostnames))
    listen_host = listen_host if listen_host is not None else controller_host
    server = KVStoreServer(secret=secret)
    server.start()
    kv_addr = local_addr()
    procs: Dict[str, object] = {}
    try:
        for host in uniq:
            env = {
                ev.HVDTPU_PREFLIGHT_KV_ADDR: kv_addr,
                ev.HVDTPU_PREFLIGHT_KV_PORT: str(server.port),
                ev.HVDTPU_PREFLIGHT_HOST: host,
                ev.HVDTPU_PREFLIGHT_ROLE:
                    "listen" if host == listen_host else "connect",
                ev.HVDTPU_PREFLIGHT_CONTROLLER:
                    f"{controller_host}:{controller_port}",
                ev.HVDTPU_PREFLIGHT_TIMEOUT: str(timeout),
            }
            if secret:
                env[ev.HVDTPU_SECRET] = secret
            procs[host] = spawn(host, env)

        deadline = time.monotonic() + timeout
        results: Dict[str, str] = {}
        while time.monotonic() < deadline and len(results) < len(uniq):
            for host in uniq:
                val = None if host in results else \
                    server.get(f"/preflight/result/{host}")
                if val:
                    results[host] = val.decode()
            time.sleep(_POLL_S)
        server.put("/preflight/done", b"1")

        failures = []
        for host in uniq:
            got = results.get(host)
            if got is None:
                failures.append(
                    f"  {host}: no response — the host cannot reach the "
                    f"launcher KV at {kv_addr}:{server.port} (or SSH/python "
                    "failed there)")
            elif got != "ok":
                failures.append(f"  {host}: {got}")
        if failures:
            cands = server.get("/preflight/controller_addrs")
            hint = (f"\nController-host candidate addresses: "
                    f"{cands.decode()}" if cands else "")
            raise RuntimeError(
                "connectivity preflight failed:\n" + "\n".join(failures) +
                "\nIf a host is multi-homed, set "
                "--controller-advertise-address / HVDTPU_ADVERTISE_ADDR to "
                "an address reachable from every worker." + hint)

        # Rank 0's host must let go of the controller's port before rank 0
        # binds it: wait for its probe to exit rather than kill the local
        # ssh client, which would leave the remote probe holding the port.
        listener = procs.get(listen_host)
        if listener is not None:
            exit_deadline = time.monotonic() + 10.0
            while time.monotonic() < exit_deadline and \
                    listener.poll() is None:
                time.sleep(_POLL_S)
    finally:
        for p in procs.values():
            p.terminate()
        server.stop()


if __name__ == "__main__":
    raise SystemExit(probe_main())
