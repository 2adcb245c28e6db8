"""A process-mode world whose ranks end with ``hvd.shutdown()`` alone.

Horovod's examples end a script with ``hvd.shutdown()`` and no
``hvd.join()``. The last op is then often a large allreduce that one rank
finishes before the other: its last bytes may still sit in the shared
memory ring, unread by the peer, when it shuts down. The port's core
negotiates the shutdown (``horovod_tpu_torch/native/core.cpp``,
``Core::Shutdown``): every rank leaves its loop at the same cycle, after
every op a peer still reads, and only then closes its lanes, without the
abort flag. A core that closed its lanes at once aborted the peer's last
op (ROADMAP C7).

Each rank runs ``WORLDS`` fresh worlds of 2 one after the other in one
process (rank 0 draws each next controller port and broadcasts it through
the current core): init, a ``PAYLOAD``-element allreduce, and shutdown,
nothing else. Rank 1 reads late: it keeps to one CPU, which ``SPINNERS``
busy processes of its own share, and runs at the lowest priority
(``nice`` 19), so its core's thread often waits for the CPU while rank 0,
done, shuts down. Every rank must finish every world with
the right sum. This file is also the workers' script
(``HVDTPU_TEST_WORKER``).
"""

import os
import sys

import pytest

HERE = os.path.abspath(__file__)
WORLDS = 8
PAYLOAD = 4 * 1024 * 1024  # fp32 values: 16 MiB, sixteen 1 MiB shm rings
SPINNERS = 1


@pytest.fixture(scope="module")
def worlds():
    from conftest import launch_world
    return launch_world(2, HERE, {"HVDTPU_TEST_WORKER": "shutdown",
                                  "HVDTPU_STALL_CHECK_DISABLE": "1",
                                  "HVDTPU_FORMUP_TIMEOUT_SECONDS": "30"},
                        timeout=240)


def test_shutdown_without_join_leaves_the_peer_whole(worlds):
    report = "\n".join(f"rank {r} exited {rc}:\n{out}\n{err[-2000:]}"
                       for r, (rc, out, err) in enumerate(worlds))
    for rc, out, _ in worlds:
        assert rc == 0, report
        assert out.splitlines()[-1] == f"worlds={WORLDS}", report


def _worker() -> None:
    import socket
    import subprocess

    import torch

    import horovod_tpu_torch as hvd
    r = int(os.environ["HVDTPU_RANK"])
    x = torch.full((PAYLOAD,), float(r + 1))
    spinners = []
    if r == 1:
        # The spinners inherit the one CPU.
        os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
        torch.set_num_threads(1)
        spinners = [subprocess.Popen([sys.executable, "-c",
                                      "while True: pass"])
                    for _ in range(SPINNERS)]
        os.nice(19)  # after the spinners, which keep the default
    try:
        _worlds(hvd, torch, socket, r, x)
    finally:
        for p in spinners:
            p.kill()
            p.wait()
    print(f"worlds={WORLDS}", flush=True)


def _worlds(hvd, torch, socket, r, x) -> None:
    for world in range(WORLDS):
        hvd.init(mode="process", device="cpu")
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1] if r == 0 else 0
        s.close()
        port = int(hvd.broadcast(torch.tensor([port]), 0,
                                 name="shutdown.port")[0])
        total = hvd.allreduce(x, op=hvd.Sum, name="shutdown.last")
        hvd.shutdown()
        if not bool((total == 3.0).all()):
            raise AssertionError(f"world {world}: wrong sum")
        os.environ["HVDTPU_CONTROLLER_PORT"] = str(port)
        print(f"world {world} done", flush=True)


if __name__ == "__main__" and os.environ.get("HVDTPU_TEST_WORKER"):
    sys.exit(_worker())
