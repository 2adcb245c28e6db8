"""Worker processes in their own process groups (counterpart of
``horovod_tpu/runner/safe_exec.py``: ``resolve_python`` :28, ``ssh_wrap``
:36, ``is_local_host`` :59, ``WorkerProcess`` :64, ``run_workers`` :106;
reference: ``horovod/runner/common/util/safe_shell_exec.py``).

Each worker starts a session of its own, so that stopping it stops every
process it started: a failed job leaves no orphan behind.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

# Stands for the interpreter at ``command[0]``: the launcher's own on a
# local slot, ``--remote-python`` on an ssh slot (one literal cannot be
# right for both).
PYTHON_PLACEHOLDER = "{python}"


def resolve_python(command: List[str], local: bool,
                   remote_python: str = "python3") -> List[str]:
    """``command`` with :data:`PYTHON_PLACEHOLDER` at its head replaced."""
    if command and command[0] == PYTHON_PLACEHOLDER:
        return [sys.executable if local else remote_python] + command[1:]
    return list(command)


def ssh_wrap(host: str, ssh_port: int, env: Dict[str, str],
             command: List[str]) -> List[str]:
    """The ssh command that runs ``command`` on ``host`` with every
    ``HVDTPU_*`` variable of ``env`` exported. The job's secret is never
    put on the command line, which ``ps`` shows to every user: the remote
    shell reads it from its standard input, which the caller fills
    (``WorkerProcess(..., stdin_data=secret + "\\n")``)."""
    exports = " ".join(
        f"{k}={v!r}" for k, v in env.items()
        if k.startswith("HVDTPU_") and k != "HVDTPU_SECRET")
    prefix = ""
    if env.get("HVDTPU_SECRET"):
        prefix = "IFS= read -r HVDTPU_SECRET; export HVDTPU_SECRET; "
    remote = (f"cd {os.getcwd()!r} 2>/dev/null; {prefix}env {exports} " +
              " ".join(command))
    return ["ssh", "-o", "StrictHostKeyChecking=no", "-p", str(ssh_port),
            host, remote]


def is_local_host(host: str) -> bool:
    return host in ("localhost", "127.0.0.1", socket.gethostname())


class WorkerProcess:
    """One worker, the leader of its own process group."""

    def __init__(self, cmd: List[str], env: Dict[str, str], name: str,
                 stdout=None, stderr=None,
                 stdin_data: Optional[bytes] = None):
        self.name = name
        self.proc = subprocess.Popen(
            cmd, env=env, stdout=stdout, stderr=stderr,
            stdin=subprocess.PIPE if stdin_data is not None else None,
            start_new_session=True)
        if stdin_data is not None:
            try:
                self.proc.stdin.write(stdin_data)
                self.proc.stdin.flush()
                self.proc.stdin.close()
            except OSError:
                pass  # it died at once; wait() reports how

    def poll(self) -> Optional[int]:
        return self.proc.poll()

    def wait(self) -> int:
        return self.proc.wait()

    def terminate(self, grace_s: float = 3.0) -> None:
        """SIGTERM to the whole group, SIGKILL after ``grace_s``."""
        if self.proc.poll() is not None:
            return
        try:
            os.killpg(os.getpgid(self.proc.pid), signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            return
        deadline = time.time() + grace_s
        while time.time() < deadline:
            if self.proc.poll() is not None:
                return
            time.sleep(0.05)
        try:
            os.killpg(os.getpgid(self.proc.pid), signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass


def run_workers(commands: List[List[str]], envs: List[Dict[str, str]],
                names: List[str], verbose: bool = False,
                stdin_datas: Optional[List[Optional[bytes]]] = None) -> int:
    """Run every worker to its end; the first that exits non-zero stops
    the others, and its code is the job's (reference: ``gloo_run.py``
    ``launch_gloo``)."""
    if stdin_datas is None:
        stdin_datas = [None] * len(commands)
    workers = [WorkerProcess(cmd, env, name, stdin_data=sd)
               for cmd, env, name, sd in zip(commands, envs, names,
                                             stdin_datas)]
    first_failure: List[int] = []
    lock = threading.Lock()

    def watch(w: WorkerProcess):
        rc = w.wait()
        if rc == 0:
            return
        with lock:
            if first_failure:
                return
            first_failure.append(rc)
        sys.stderr.write(f"hvdrun: worker {w.name} exited with code {rc}; "
                         "terminating remaining workers\n")
        for other in workers:
            if other is not w:
                other.terminate()

    threads = [threading.Thread(target=watch, args=(w,), daemon=True)
               for w in workers]
    for t in threads:
        t.start()
    try:
        for t in threads:
            t.join()
    except KeyboardInterrupt:
        for w in workers:
            w.terminate()
        return 130
    return first_failure[0] if first_failure else 0
