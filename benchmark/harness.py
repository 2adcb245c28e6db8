"""One run of one cell: set-up, the measured window, the traced window, and
the comparison with the plain reference.

Each rank is one process on one card. A rank builds the program from the
cell's files (:class:`Program`: the port's model, ``DistributedOptimizer``
and step), feeds it the weights and batches of ``inputs``, and drives it
through the checked steps, whose outputs it keeps for the comparison. It
then times a few steps to size the window (the ranks agree on the longest
estimate), and runs the window: ``N`` steps back to back, ``N`` the steps
that fill ``--seconds``, a CUDA event recorded after each, one
``torch.cuda.synchronize()`` at the end. A traced run then times the host's
enqueue of a few steps, each started on an idle device, and runs
``trace_steps`` more under ``torch.profiler``. Every rank frees the
program before rank 0 runs the reference; ``run.py`` adds to each rank's
record the modules of JAX or of the JAX package its process has loaded.

At a world above one, rank 0 is the process the benchmark started; it
starts the other ranks (``run.py --rank``), each writing its record to a
directory of its own, and stops them all.
"""

from __future__ import annotations

import gc
import importlib
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

import compare
import inputs
import spec as specs
import trace_read

FORBIDDEN = ("jax", "jaxlib", "flax", "horovod_tpu")
RANK_TIMEOUT_S = 330.0
# Steps timed to size the window, and the fewest steps it holds.
CALIBRATION_STEPS = 3
MIN_WINDOW_STEPS = 10
# Steps of a traced run whose enqueue the host clock times.
HOST_PROBE_STEPS = 10


def process_age() -> float:
    """Seconds since this process started (the kernel's clock ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def _lr(config: dict, world: int) -> float:
    opt = config["optimizer"]
    per = opt.get("lr_per_images")
    return opt["lr"] * (config["batch_per_chip"] * world / per if per
                        else 1.0)


class Program:
    """The system under test, built from the cell's files: the port's
    model with the benchmark's weights, ``DistributedOptimizer`` over SGD
    with the traffic's reducer, and the step (``data_parallel_step`` of
    the training step for ``entry: "graph"``, the training step itself for
    ``"eager"``)."""

    def __init__(self, cell: specs.Cell, seed: int, device=None):
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch import compression
        self.hvd = hvd
        hvd.init(device=device)
        self.device = hvd.device()
        self.rank, self.world = hvd.rank(), hvd.size()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        cfg, traffic = cell.config, cell.traffic
        # cuDNN's default heuristics: the algorithms do not move from run
        # to run.
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = False
        module, attr = cfg["port"]["model"].split(":")
        with torch.device(self.device):
            model = getattr(importlib.import_module(module), attr)(
                **cfg["port"]["kwargs"])
        if cfg["channels_last"]:
            model = model.to(memory_format=torch.channels_last)
        with torch.device("meta"):
            shapes = [(n, p.shape) for n, p in
                      cell.reference().build(cfg).named_parameters()]
        weights = inputs.weights(shapes, cfg["init"], seed, self.device)
        params = dict(model.named_parameters())
        if {n: tuple(p.shape) for n, p in params.items()} != \
                {n: tuple(s) for n, s in shapes}:
            raise ValueError(f"{cfg['port']['model']} and the reference name "
                             f"or shape their parameters differently")
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(weights[name])
        del weights
        self.order = list(params)
        self.model = model
        red = traffic["reducer"]
        comp = None
        if red.get("quantizer"):
            comp = compression.CompressionConfig(
                getattr(compression, red["quantizer"])(
                    bits=red["bits"], bucket_size=red["bucket_size"]),
                reduction=red["reduction"],
                error_feedback=red["error_feedback"])
        sgd = torch.optim.SGD(model.parameters(), lr=_lr(cfg, self.world),
                              momentum=cfg["optimizer"]["momentum"])
        self.opt = hvd.DistributedOptimizer(
            sgd, named_parameters=model.named_parameters(), compression=comp)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        step = train_step(cfg["autocast"] and getattr(torch, cfg["autocast"]),
                          self.device.type, traffic["entry"] == "eager")
        self.step = hvd.data_parallel_step(step) \
            if traffic["entry"] == "graph" else step

    def __call__(self, batch) -> torch.Tensor:
        return self.step(self.model, self.opt, batch)

    def optimizer_state(self, residual_state: Optional[str]):
        """Each parameter's momentum buffer (zeros where SGD holds none)
        and, at a world of one with error feedback, its residual
        (``residual_state``: the optimizer's state key), by name on the
        host; the residuals None otherwise."""
        bufs, res = {}, {}
        for n, p in self.model.named_parameters():
            s = self.opt.state.get(p, {})
            bufs[n] = s.get("momentum_buffer",
                            torch.zeros_like(p)).detach().to("cpu", copy=True)
            if residual_state in s:
                res[n] = s[residual_state].detach().to("cpu", copy=True)
        whole = self.world == 1 and len(res) == len(bufs)
        return bufs, (res if whole else None)

    def weights(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach().to("cpu", copy=True)
                for n, p in self.model.named_parameters()}

    def close(self) -> None:
        """Free the program's state and shut its runtime down."""
        del self.step, self.opt, self.model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
        self.hvd.shutdown()


def train_step(dtype: Optional[torch.dtype], device_type: str,
               cache: bool) -> Callable:
    """The step as a Horovod user writes it, under autocast to ``dtype``
    (None: none). ``cache``: autocast's cache of the weights' casts, which
    a step captured in a CUDA graph turns off."""
    def step(model, opt, batch):
        images, labels = batch
        opt.zero_grad(set_to_none=True)
        with torch.autocast(device_type, dtype=dtype or torch.bfloat16,
                            enabled=dtype is not None, cache_enabled=cache):
            logits = model(images)
        loss = F.cross_entropy(logits, labels)
        loss.backward()
        opt.step()
        return loss.detach()
    return step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Clock:
    """Marks after each step: CUDA events on the step's stream, read after
    the window; the host clock on the CPU."""

    def __init__(self, device: torch.device, steps: int):
        self.cuda = device.type == "cuda"
        self.marks = ([torch.cuda.Event(enable_timing=True)
                       for _ in range(steps + 1)] if self.cuda else [])
        self.i = 0

    def mark(self) -> None:
        if self.cuda:
            self.marks[self.i].record()
        else:
            self.marks.append(time.perf_counter())
        self.i += 1

    def step_ms(self) -> List[float]:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.marks,
                                                      self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def _agree_max(value: float, prog: Program) -> float:
    if prog.world == 1:
        return value
    import torch.distributed as dist
    t = torch.tensor([value], dtype=torch.float64, device=prog.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def _barrier(prog: Program) -> None:
    if prog.world > 1:
        import torch.distributed as dist
        dist.barrier()


def run_rank(cell: specs.Cell, seed: int, seconds: float, trace: bool,
             device=None, scratch: Optional[str] = None) -> dict:
    """This rank's part of a run. Returns its record; rank 0's also holds
    ``snapshots`` (tensors on the host) for the comparison."""
    marks = {"imported": process_age()}
    # Few host threads a rank: the ranks of a world share the host's cores.
    torch.set_num_threads(max(1, (os.cpu_count() or 1) //
                              cell.traffic["world"]))
    prog = Program(cell, seed, device)
    marks["built"] = process_age()
    cfg, traffic = cell.config, cell.traffic
    dev, rank = prog.device, prog.rank

    def batch(step):
        return inputs.batch(cfg, seed, rank, step, dev)

    # Rank 0 keeps the optimizer's state after the first step and, at a
    # world of one, after the last two (in a graph cell, replays of the
    # captured step).
    checked = traffic["checked_steps"]
    kept = set() if rank else {0} if prog.world > 1 else \
        {0, checked - 2, checked - 1}
    losses, states = [], {}
    for k in range(checked):
        losses.append(float(prog(batch(k))))
        if k in kept:
            states[k] = prog.optimizer_state(
                traffic["reducer"].get("residual_state"))
    after = prog.weights() if rank == 0 else None
    marks["checked"] = process_age()
    feed = inputs.Feed(cfg, seed, rank, dev)

    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(CALIBRATION_STEPS):
        prog(feed())
    _sync(dev)
    estimate = _agree_max((time.perf_counter() - t0) / CALIBRATION_STEPS,
                          prog)
    steps = max(MIN_WINDOW_STEPS, math.ceil(seconds / estimate))

    clock = _Clock(dev, steps)
    _sync(dev)
    setup_s = process_age()
    t0 = time.perf_counter()
    clock.mark()
    for i in range(steps):
        last = prog(feed())
        clock.mark()
    _sync(dev)
    window_s = time.perf_counter() - t0
    marks["sized"] = setup_s
    record = {"rank": rank, "setup_s": setup_s, "setup_marks": marks,
              "window_steps": steps,
              "window_s": window_s, "step_ms": clock.step_ms(),
              "losses": losses, "last_loss": float(last),
              "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else 0),
              "device_name": (torch.cuda.get_device_name(dev)
                              if dev.type == "cuda" else "cpu")}
    if trace:
        record.update(_traced(prog, feed, traffic, scratch or
                              tempfile.gettempdir()))
    _barrier(prog)
    order = prog.order
    prog.close()
    if rank == 0:
        first, res = states[0]
        record["snapshots"] = {
            "first_grad": first,
            "first_raw": None if res is None else
            {n: first[n] + res[n] for n in order},
            "late": _late(states[checked - 2], states[checked - 1],
                          cfg["optimizer"]["momentum"], order)
            if checked - 1 in states else None,
            "weights": after, "order": order}
    return record


def _late(before, after, momentum: float, order: List[str]
          ) -> Optional[Dict[str, torch.Tensor]]:
    """The reducer's work at a step, from the optimizer's state before and
    after it, as flat float32 in the fused order: what it gave SGD
    (``out``; SGD's momentum buffer became ``momentum * buf + out``) and
    the residual it kept (``kept``). None without residuals."""
    (buf0, _), (buf1, res1) = before, after
    if res1 is None:
        return None
    out = [(buf1[n].double() - (buf0[n] * momentum).double()).float()
           for n in order]
    return {"out": torch.cat([t.reshape(-1) for t in out]),
            "kept": torch.cat([res1[n].reshape(-1) for n in order])}


def _traced(prog: Program, feed, traffic: dict, scratch: str) -> dict:
    """The host's enqueue time of ``HOST_PROBE_STEPS`` steps, each started
    on an idle device, then ``trace_steps`` steps under the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function
    host_ms = []
    for _ in range(HOST_PROBE_STEPS):
        _sync(prog.device)
        t0 = time.perf_counter()
        prog(feed())
        host_ms.append((time.perf_counter() - t0) * 1e3)
    _sync(prog.device)
    activities = [ProfilerActivity.CPU]
    if prog.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(trace_read.WINDOW):
            for _ in range(traffic["trace_steps"]):
                prog(feed())
            _sync(prog.device)
    path = os.path.join(scratch, f"hvdbench_trace_{os.getpid()}.json")
    try:
        prof.export_chrome_trace(path)
        digest = trace_read.digest(path)
    finally:
        if os.path.exists(path):
            os.remove(path)
    return {"host_ms": host_ms, "traced_steps": traffic["trace_steps"],
            "trace": digest}


# ---------------------------------------------------------------------------
# rank 0: the comparison, the metrics and the result line
# ---------------------------------------------------------------------------

class Run:
    """What a metric reader reads: the cell, every rank's record, the
    card's data-sheet rates, the training FLOPs of one image and the
    reducer's kernel table."""

    def __init__(self, cell: specs.Cell, records: List[dict], peaks: dict):
        self.cell = cell
        self.records = records
        self.peaks = peaks
        self.world = cell.traffic["world"]
        self.batch = cell.config["batch_per_chip"]
        from flops import train_flops_per_image
        self.flops_per_image = train_flops_per_image(
            cell.flops().forward_macs(cell.config))
        self.kernel_work = cell.kernel_work()

    def images_per_s(self) -> float:
        """Images of every rank in the window over the slowest rank's
        window."""
        steps = self.records[0]["window_steps"]
        return self.world * self.batch * steps / max(
            r["window_s"] for r in self.records)

    def traces(self) -> List[dict]:
        return [r["trace"] for r in self.records if r.get("trace")]


def reducer(cell: specs.Cell) -> Callable:
    """The plain reference of the cell's gradient reducer."""
    red = cell.traffic["reducer"]
    return importlib.import_module(f"reference.{red['reference']}").make(red)


def reference_outputs(cell: specs.Cell, seed: int, order: List[str],
                      device, precision: str = "fp32",
                      fault: Optional[str] = None):
    """The plain reference's first steps on the run's weights and batches
    (float32 with TF32 off, or the control's ``precision``; ``fault``
    planted, see ``reference/train.py``), and those weights."""
    from reference import train as ref_train
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, traffic = cell.config, cell.traffic
    try:
        with torch.device(device):
            model = cell.reference().build(cfg, precision)
        shapes = [(n, p.shape) for n, p in model.named_parameters()]
        weights = inputs.weights(shapes, cfg["init"], seed, device)
        red = traffic["reducer"]
        return ref_train.train(
            model, weights, order,
            lambda rank, step: inputs.batch(cfg, seed, rank, step, device),
            traffic["world"], traffic["checked_steps"], reducer(cell),
            red["error_feedback"], _lr(cfg, traffic["world"]),
            cfg["optimizer"]["momentum"], fault), weights
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def readings(cell: specs.Cell, seed: int, records: List[dict], device
             ) -> Dict[str, float]:
    """Every number of ``compare`` on a run's records."""
    snaps = records[0]["snapshots"]
    ref, weights = reference_outputs(cell, seed, snaps["order"], device)
    program = {
        "ranks": [r["rank"] for r in records],
        "losses": [r["losses"] for r in records],
        "first_grad": {n: t.to(device) for n, t in
                       snaps["first_grad"].items()},
        "change": {n: snaps["weights"][n].to(device) - weights[n]
                   for n in snaps["order"]},
    }
    if snaps["first_raw"] is not None:
        program["first_raw"] = {n: t.to(device) for n, t in
                                snaps["first_raw"].items()}
    if snaps["late"] is not None:
        program["late"] = {k: t.to(device) for k, t in snaps["late"].items()}
    return compare.readings(program, ref, reducer(cell))


def check(cell: specs.Cell, seed: int, records: List[dict], device
          ) -> Dict[str, dict]:
    """Each compared number beside its limit."""
    return compare.judged(readings(cell, seed, records, device), cell.limits)


def _finite(x: float) -> float:
    return x if math.isfinite(x) else (1e300 if x > 0 else -1e300)


def _power_limit(index: int) -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", str(index)],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def result(cell: specs.Cell, seed: int, records: List[dict], trace: bool,
           device) -> dict:
    """The result line of a run whose every rank has finished."""
    records = sorted(records, key=lambda r: r["rank"])
    checks = check(cell, seed, records, device)
    finite = all(math.isfinite(r["last_loss"]) for r in records)
    correct = compare.passed(checks) and finite
    attempted = sum(r["window_steps"] for r in records)
    name = records[0]["device_name"]
    run = Run(cell, records, specs.peaks(name) if device.type == "cuda"
              else {})
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": name, "count": len(records),
           "memory_peak_bytes": max(r["peak_bytes"] for r in records)}
    if device.type == "cuda":
        limit = _power_limit(device.index or 0)
        if limit:
            dev["power_limit"] = limit
    out = {"correct": correct, "attempted": attempted,
           "failed": 0 if finite else attempted, "metrics": metrics,
           "device": dev}
    traces = run.traces()
    if trace and traces:
        dev["busy_s"] = sum(trace_read.length((d[2], d[3])
                                              for d in t["device"]) * 1e-6
                            for t in traces) / len(traces)
        dev["window_s"] = sum(t["window_us"] * 1e-6
                              for t in traces) / len(traces)
        out["breakdown"] = {
            "device_ops": [[n, us * 1e-6] for n, us in
                           trace_read.top_ops(traces[0]["device"])],
            "idle_gaps": [[n, us * 1e-6] for n, us in traces[0]["gaps"]]}
    # Where rank 0's set-up went: seconds from its start to the imports'
    # end, the program built (runtime, model, weights, optimizer), the
    # checked steps done, and the window sized.
    out["setup_marks"] = records[0]["setup_marks"]
    out["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                     for k, c in checks.items()}
    return out


# ---------------------------------------------------------------------------
# the world of ranks
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_argv(args, rank: int, world_dir: str) -> List[str]:
    """The command of rank ``rank`` (>0): this run's ``run.py`` with
    ``--rank`` and the directory its record goes to."""
    argv = [sys.executable, str(specs.HERE / "run.py"),
            "--workload", args.workload, "--seed", str(args.seed),
            "--seconds", str(args.seconds), "--trace", str(args.trace),
            "--rank", str(rank), "--world-dir", world_dir]
    if args.device:
        argv += ["--device", args.device]
    if args.checkout:
        argv += ["--checkout", args.checkout]
    return argv


class World:
    """Ranks 1..n-1 of a run, started by rank 0 with the rendezvous in
    their environment; a rank that fails ends the run."""

    def __init__(self, args, world: int):
        self.dir = tempfile.mkdtemp(prefix="hvdbench_world_")
        port = str(_free_port())
        base = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port,
                "WORLD_SIZE": str(world), "LOCAL_WORLD_SIZE": str(world)}
        os.environ.update(base, RANK="0", LOCAL_RANK="0")
        self.procs = []
        for rank in range(1, world):
            log = open(os.path.join(self.dir, f"rank{rank}.log"), "w")
            env = dict(os.environ, **base, RANK=str(rank),
                       LOCAL_RANK=str(rank))
            self.procs.append((rank, log, subprocess.Popen(
                rank_argv(args, rank, self.dir), env=env, stdout=log,
                stderr=subprocess.STDOUT)))
        self._done = threading.Event()
        self._lock = threading.Lock()
        self._watch = threading.Thread(target=self._watchdog, daemon=True)
        self._watch.start()

    def _tail(self, rank: int) -> str:
        with open(os.path.join(self.dir, f"rank{rank}.log")) as f:
            return f.read()[-4000:]

    def _watchdog(self) -> None:
        """Rank 0 would wait for ever in a collective of a rank that
        died: end the run at the first rank that fails."""
        start = time.monotonic()
        while not self._done.wait(0.5):
            for rank, _, proc in self.procs:
                code = proc.poll()
                if code not in (None, 0):
                    print(f"rank {rank} exited {code}:\n{self._tail(rank)}",
                          file=sys.stderr, flush=True)
                    self.stop()
                    os._exit(1)
            if time.monotonic() - start > RANK_TIMEOUT_S:
                print(f"the world did not finish in {RANK_TIMEOUT_S} s",
                      file=sys.stderr, flush=True)
                self.stop()
                os._exit(1)

    def records(self) -> List[dict]:
        """Every other rank's record, once each has exited."""
        out = []
        for rank, _, proc in self.procs:
            proc.wait(timeout=RANK_TIMEOUT_S)
        self._done.set()
        for rank, _, proc in self.procs:
            if proc.returncode != 0:
                raise RuntimeError(f"rank {rank} exited {proc.returncode}:\n"
                                   f"{self._tail(rank)}")
            with open(os.path.join(self.dir, f"rank{rank}.json")) as f:
                out.append(json.load(f))
        return out

    def stop(self) -> None:
        """Kill what still runs, wait for every rank, remove the
        directory (once, from whichever thread comes first)."""
        self._done.set()
        with self._lock:
            for _, log, proc in self.procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
                log.close()
            shutil.rmtree(self.dir, ignore_errors=True)


def write_record(record: dict, world_dir: str) -> None:
    path = Path(world_dir) / f"rank{record['rank']}.json"
    tmp = path.with_suffix(".tmp")
    with open(tmp, "w") as f:
        json.dump(record, f)
    os.replace(tmp, path)
