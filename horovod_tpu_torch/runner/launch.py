"""``hvdrun-torch``: the port's launcher (counterpart of
``horovod_tpu/runner/launch.py``: ``parse_args`` :26, ``_check_build_text``
:292, ``_apply_tuning_env`` :364, ``_build_env`` :557, ``_resolve_chaos``
:578, ``run_elastic_launcher`` :610, ``run_launcher`` :691, ``main`` :978;
reference: ``horovod/runner/launch.py`` and ``gloo_run.py``).

It starts N workers, here or over ssh, each with the ``HVDTPU_*``
topology variables the runtime reads (rank, size, local and cross ranks,
host name, and the controller's address and port: rank 0's host), and
supervises them: the first worker to fail stops the others. With
``--host-discovery-script`` it runs an elastic job instead, under
:mod:`horovod_tpu_torch.runner.elastic`.

    hvdrun-torch -np 4 python train.py
    hvdrun-torch -np 8 -H host1:4,host2:4 python train.py
    hvdrun-torch --host-discovery-script ./hosts.sh --min-np 2 --max-np 4 \\
        python train.py
    python -m horovod_tpu_torch.runner.launch -np 2 python train.py

The flags are the JAX launcher's, parsed the same way. Those whose work
needs the observability modules, which come later (ROADMAP A9), are
refused with an error that says so: ``--metrics-port`` (or a
``HVDTPU_METRICS_PORT`` above 0), ``--top``, ``--debugz``, ``--trace``,
``--perf-profile``, ``--grad-profile``, ``--profile`` and
``--postmortem``. Every other knob goes to the workers as its
``HVDTPU_*`` variable, whether or not the port's core reads it, so that
the two launchers give workers the same environment.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import sys
from typing import List

from . import hosts as hosts_mod
from . import safe_exec
from ..utils import envvars as ev

PROG = "hvdrun-torch"

# Flags refused until the observability modules are ported: their
# argparse destination and the flag's name.
OBSERVABILITY_FLAGS = (("top", "--top"), ("debugz", "--debugz"),
                       ("trace", "--trace"),
                       ("perf_profile", "--perf-profile"),
                       ("grad_profile", "--grad-profile"),
                       ("profile", "--profile"),
                       ("postmortem", "--postmortem"))


def parse_args(argv: List[str] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog=PROG,
        description="Launch a horovod_tpu_torch job (Horovod-parity "
                    "runner; reference: horovodrun)")
    p.add_argument("-np", "--num-proc", type=int, default=None,
                   help="total number of worker processes (required unless "
                        "--check-build)")
    p.add_argument("-H", "--hosts", default=None,
                   help='host list "h1:slots,h2:slots" (default: localhost)')
    p.add_argument("--hostfile", default=None,
                   help="mpirun-style hostfile (host slots=N per line)")
    p.add_argument("-p", "--start-port", type=int, default=0,
                   help="controller port (default: free ephemeral port)")
    p.add_argument("--ssh-port", type=int, default=22)
    p.add_argument("--controller-advertise-address", default=None,
                   help="address workers dial for the rank-0 controller "
                        "(escape hatch of a host with several networks)")
    p.add_argument("--no-preflight", action="store_true",
                   help="skip the multi-host connectivity preflight")
    p.add_argument("--preflight-timeout", type=float, default=30.0)
    p.add_argument("--remote-python", default="python3",
                   help="python executable on remote hosts")
    p.add_argument("--timeline", default=None,
                   help="write per-rank Chrome-trace timelines to "
                        "FILE.rank.json (HVDTPU_TIMELINE)")
    p.add_argument("--timeline-mark-cycles", action="store_true")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="cross-rank distributed tracing (HVDTPU_TRACE); "
                        "refused until observability is ported")
    p.add_argument("--trace-sample", type=int, default=None,
                   help="emit per-hop trace spans for every Nth collective "
                        "op (HVDTPU_TRACE_SAMPLE)")
    p.add_argument("--postmortem", default=None, metavar="DIR",
                   help="post-mortem flight-recorder dumps "
                        "(HVDTPU_FLIGHTREC_DIR); refused until "
                        "observability is ported")
    p.add_argument("--debugz", action="store_true",
                   help="print each worker's /debugz URL; refused until "
                        "observability is ported")
    p.add_argument("--fusion-threshold-mb", type=float, default=64.0,
                   help="tensor fusion threshold (HVDTPU_FUSION_THRESHOLD)")
    p.add_argument("--cycle-time-ms", type=float, default=1.0,
                   help="background cycle time (HVDTPU_CYCLE_TIME)")
    p.add_argument("--allreduce-algo", default="auto",
                   choices=list(ev.ALLREDUCE_ALGOS),
                   help="the core's allreduce algorithm "
                        "(HVDTPU_ALLREDUCE_ALGO)")
    p.add_argument("--sa-group", type=int, default=None,
                   help="group-size floor of auto's scatter-allgather "
                        "(HVDTPU_ALLREDUCE_SA_GROUP)")
    p.add_argument("--no-ctrl-batch", action="store_true",
                   help="one syscall per control frame "
                        "(HVDTPU_CTRL_BATCH=0)")
    p.add_argument("--bcast-flat-max", type=int, default=None,
                   help="largest broadcast in bytes on the flat fan-out "
                        "(HVDTPU_BCAST_FLAT_MAX)")
    p.add_argument("--hier", action="store_true",
                   help="force the two-level allreduce "
                        "(HVDTPU_ALLREDUCE_HIER=1)")
    p.add_argument("--no-hier", action="store_true",
                   help="disable the two-level allreduce "
                        "(HVDTPU_ALLREDUCE_HIER=0)")
    p.add_argument("--no-shm", action="store_true",
                   help="TCP between ranks of one host too (HVDTPU_SHM=0)")
    p.add_argument("--shm-ring-bytes", type=int, default=None,
                   help="shm ring capacity a direction "
                        "(HVDTPU_SHM_RING_BYTES)")
    p.add_argument("--tcp-zerocopy", default=None,
                   choices=sorted(ev.TCP_ZEROCOPY_MODES),
                   help="zero-copy TCP sends (HVDTPU_TCP_ZEROCOPY)")
    p.add_argument("--shm-numa", default=None,
                   choices=sorted(ev.SHM_NUMA_MODES),
                   help="NUMA placement of the shm rings (HVDTPU_SHM_NUMA)")
    p.add_argument("--doorbell-batch", type=int, default=None,
                   help="shm doorbell coalescing window in bytes "
                        "(HVDTPU_DOORBELL_BATCH)")
    p.add_argument("--compression", default=None,
                   choices=["none", "fp16", "int8", "int4", "auto"],
                   help="the core's wire compression (HVDTPU_COMPRESSION)")
    p.add_argument("--compression-min-bytes", type=int, default=None,
                   help="payloads below this stay uncompressed "
                        "(HVDTPU_COMPRESSION_MIN_BYTES)")
    p.add_argument("--top", action="store_true",
                   help="live fleet console; refused until observability "
                        "is ported")
    p.add_argument("--top-once", action="store_true",
                   help="with --top: print one frame")
    p.add_argument("--perf-profile", default=None, metavar="DIR",
                   help="per-rank perf baselines (HVDTPU_PERF_PROFILE_DIR);"
                        " refused until observability is ported")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="sampling profiler output (HVDTPU_PROF_DIR); "
                        "refused until observability is ported")
    p.add_argument("--prof-hz", type=int, default=None,
                   help="profiler sampling rate in Hz (HVDTPU_PROF_HZ)")
    p.add_argument("--prof-clock", default=None, choices=["cpu", "wall"],
                   help="profiler clock (HVDTPU_PROF_CLOCK)")
    p.add_argument("--perf-slowdown-pct", type=float, default=None,
                   help="slowdown-sentry threshold in percent "
                        "(HVDTPU_PERF_SLOWDOWN_PCT)")
    p.add_argument("--no-perfstats", action="store_true",
                   help="disable the perf baselines (HVDTPU_PERFSTATS=0)")
    p.add_argument("--grad-profile", default=None, metavar="DIR",
                   help="per-rank gradient-health baselines "
                        "(HVDTPU_GRAD_PROFILE_DIR); refused until "
                        "observability is ported")
    p.add_argument("--nancheck", default=None,
                   choices=["off", "warn", "abort"],
                   help="non-finite gradient policy (HVDTPU_NANCHECK)")
    p.add_argument("--gradcheck-sample", type=int, default=None,
                   help="fingerprint every Nth allreduce's output "
                        "(HVDTPU_GRADCHECK_SAMPLE)")
    p.add_argument("--no-gradstats", action="store_true",
                   help="disable the gradient statistics "
                        "(HVDTPU_GRADSTATS=0)")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="base port of the live-metrics endpoints "
                        "(HVDTPU_METRICS_PORT); refused until observability "
                        "is ported")
    p.add_argument("--metrics-interval", type=float, default=None,
                   help="driver scrape period in seconds "
                        "(HVDTPU_METRICS_INTERVAL)")
    p.add_argument("--chaos", default=None,
                   help="fault-injection spec (HVDTPU_CHAOS): "
                        "'kill|hang|delay=<ms>|drop[=<peer>]@op=N|hop=N'. "
                        "Without a 'rankR:' prefix one randomly chosen "
                        "worker is the target; elastic jobs get a one-shot "
                        "marker")
    p.add_argument("--stall-check-disable", action="store_true")
    p.add_argument("--stall-check-warning-time-seconds", type=float,
                   default=60.0)
    p.add_argument("--stall-check-shutdown-time-seconds", type=float,
                   default=None,
                   help="abort after a collective stalls this long; 0 "
                        "disables (default: 10x the warning time)")
    p.add_argument("--check-build", action="store_true",
                   help="print what this build provides and exit")
    p.add_argument("--cache-capacity", type=int, default=1024,
                   help="response cache capacity; 0 disables "
                        "(HVDTPU_CACHE_CAPACITY)")
    p.add_argument("--autotune", action="store_true",
                   help="enable fusion/cycle autotuning")
    p.add_argument("--autotune-log-file", default=None)
    p.add_argument("--autotune-warmup-samples", type=int, default=None)
    p.add_argument("--autotune-steps-per-sample", type=int, default=None)
    p.add_argument("--autotune-bayes-opt-max-samples", type=int, default=None)
    p.add_argument("--autotune-gaussian-process-noise", type=float,
                   default=None)
    p.add_argument("--config-file", default=None,
                   help="YAML file with the flags' names as keys; a flag "
                        "given on the command line wins")
    p.add_argument("--min-np", type=int, default=None,
                   help="minimum workers for an elastic job")
    p.add_argument("--max-np", type=int, default=None,
                   help="maximum workers for an elastic job")
    p.add_argument("--host-discovery-script", default=None,
                   help="script printing 'host:slots' per line; enables "
                        "elastic mode")
    p.add_argument("--elastic-timeout", type=float, default=600.0)
    p.add_argument("--reset-limit", type=int, default=None,
                   help="max rendezvous rounds before aborting")
    p.add_argument("--slots", type=int, default=1,
                   help="default slots per discovered host")
    p.add_argument("--verbose", "-v", action="store_true")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="worker command, e.g. python train.py")
    # The file's values become the parser's defaults before the real
    # parse, so a flag given on the command line wins even at its default.
    pre, _ = p.parse_known_args(argv)
    if pre.config_file:
        _install_config_file_defaults(pre.config_file, p)
    args = p.parse_args(argv)
    if args.check_build:
        print(_check_build_text())
        raise SystemExit(0)
    if args.num_proc is None:
        p.error("the following arguments are required: -np/--num-proc")
    if not args.command:
        p.error("no worker command given")
    if args.command[0] == "--":
        args.command = args.command[1:]
    return args


def _check_build_text() -> str:
    """What this installation provides (reference: ``horovodrun
    --check-build``): the frameworks, the controllers and whether the
    native core's and the CUDA kernels' libraries are built for the
    sources in the package, or can be."""
    import shutil

    import torch
    import torch.distributed as dist

    from ..utils import cuda_build, native_build

    def mark(b: bool) -> str:
        return "[X]" if b else "[ ]"

    def yes(b: bool) -> str:
        return "yes" if b else "no"

    core_built = native_build.library_path().exists()
    kernels_built = (cuda_build.BUILD_DIR /
                     f"libhvd_kernels-{cuda_build.source_key()}.so").exists()
    gxx = shutil.which(os.environ.get("CXX") or "g++") is not None
    nvcc = shutil.which("nvcc") is not None or \
        os.path.exists("/usr/local/cuda/bin/nvcc")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return f"""\
horovod_tpu_torch (PyTorch {torch.__version__}, CUDA {torch.version.cuda}):

Available Frameworks:
    {mark(True)} PyTorch {torch.__version__}

Available Controllers:
    {mark(dist.is_nccl_available())} NCCL (torch.distributed, init())
    {mark(dist.is_gloo_available())} gloo (torch.distributed, device="cpu")
    {mark(core_built or gxx)} native core, process mode \
(built: {yes(core_built)}; g++: {yes(gxx)})

Available Devices:
    {mark(cards > 0)} CUDA device ({cards} visible)
    {mark(kernels_built or nvcc)} CUDA kernels, sm_90a \
(built: {yes(kernels_built)}; nvcc: {yes(nvcc)})

Available Tensor Operations:
    {mark(True)} allreduce / grouped_allreduce \
(Sum, Average, Adasum, Min, Max, Product)
    {mark(True)} allgather / broadcast / alltoall / reducescatter
    {mark(True)} join (process mode)
    {mark(True)} compressed allreduce (maxmin/norm/topk + error feedback)
    {mark(True)} elastic training (hvd.elastic.run, TorchState)
    {mark(False)} live metrics (observability, ROADMAP A9)"""


def _install_config_file_defaults(path: str, parser) -> None:
    import yaml  # only here: the flag is the one use of PyYAML
    with open(path) as f:
        doc = yaml.safe_load(f) or {}
    known = {a.dest for a in parser._actions}
    overlay = {}
    for key, value in doc.items():
        dest = key.replace("-", "_")
        if dest not in known:
            parser.error(f"unknown config-file key: {key}")
        overlay[dest] = value
    parser.set_defaults(**overlay)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _ensure_job_secret(args) -> str:
    """The job's one secret, which the core's controller and the
    key-value store require of every connection: ``HVDTPU_SECRET`` when
    the user exported one, else a new one (reference:
    ``runner/common/util/secret.py``)."""
    if not getattr(args, "_job_secret", None):
        import secrets
        args._job_secret = ev.get_str(ev.HVDTPU_SECRET) or \
            secrets.token_hex(16)
    return args._job_secret


def _refuse_observability(args) -> None:
    """SystemExit naming the flag when the job asks for work of the
    observability modules, which are not ported yet."""
    asked = [flag for dest, flag in OBSERVABILITY_FLAGS
             if getattr(args, dest)]
    metrics = args.metrics_port if args.metrics_port is not None else \
        ev.get_int(ev.HVDTPU_METRICS_PORT, 0)
    if metrics:
        asked.insert(0, "--metrics-port" if args.metrics_port is not None
                     else f"{ev.HVDTPU_METRICS_PORT}={metrics}")
    if asked:
        raise SystemExit(
            f"{PROG}: not available yet: {', '.join(asked)}. The work "
            "asked for is the observability modules' (metrics endpoints, "
            "flight recorder, tracing, profiler), which horovod_tpu_torch "
            "does not have yet: ROADMAP A9, observability")


def _apply_tuning_env(env: dict, args) -> dict:
    """The runtime's knobs, as the JAX launcher forwards them (flags that
    were not given leave a user-exported variable alone)."""
    _refuse_observability(args)
    env[ev.HVDTPU_SECRET] = _ensure_job_secret(args)
    env[ev.HVDTPU_CYCLE_TIME] = str(args.cycle_time_ms)
    env[ev.HVDTPU_FUSION_THRESHOLD] = str(
        int(args.fusion_threshold_mb * 1024 * 1024))
    env[ev.HVDTPU_ALLREDUCE_ALGO] = args.allreduce_algo

    def at_least_zero(flag: str, value, name: str) -> None:
        if value is None:
            return
        if value < 0:
            raise SystemExit(f"hvdrun: {flag} must be >= 0")
        env[name] = str(value)

    at_least_zero("--sa-group", args.sa_group, ev.HVDTPU_ALLREDUCE_SA_GROUP)
    if args.no_ctrl_batch:
        env[ev.HVDTPU_CTRL_BATCH] = "0"
    at_least_zero("--bcast-flat-max", args.bcast_flat_max,
                  ev.HVDTPU_BCAST_FLAT_MAX)
    if args.hier and args.no_hier:
        raise SystemExit("hvdrun: --hier and --no-hier are mutually exclusive")
    if args.hier:
        env[ev.HVDTPU_ALLREDUCE_HIER] = "1"
    elif args.no_hier:
        env[ev.HVDTPU_ALLREDUCE_HIER] = "0"
    else:
        env.setdefault(ev.HVDTPU_ALLREDUCE_HIER, "auto")
    if args.no_shm:
        env[ev.HVDTPU_SHM] = "0"
    if args.shm_ring_bytes is not None:
        env[ev.HVDTPU_SHM_RING_BYTES] = str(args.shm_ring_bytes)
    if args.tcp_zerocopy is not None:
        env[ev.HVDTPU_TCP_ZEROCOPY] = args.tcp_zerocopy
    if args.shm_numa is not None:
        env[ev.HVDTPU_SHM_NUMA] = args.shm_numa
    at_least_zero("--doorbell-batch", args.doorbell_batch,
                  ev.HVDTPU_DOORBELL_BATCH)
    if args.compression is not None:
        env[ev.HVDTPU_COMPRESSION] = args.compression
    at_least_zero("--compression-min-bytes", args.compression_min_bytes,
                  ev.HVDTPU_COMPRESSION_MIN_BYTES)
    if args.metrics_interval is not None:
        env[ev.HVDTPU_METRICS_INTERVAL] = str(args.metrics_interval)
    if args.timeline:
        # The base path; _build_env (static) or the driver (elastic) adds
        # the worker's suffix.
        env[ev.HVDTPU_TIMELINE] = args.timeline
    if args.timeline_mark_cycles:
        env[ev.HVDTPU_TIMELINE_MARK_CYCLES] = "1"
    at_least_zero("--trace-sample", args.trace_sample,
                  ev.HVDTPU_TRACE_SAMPLE)
    if args.no_perfstats:
        env[ev.HVDTPU_PERFSTATS] = "0"
    at_least_zero("--perf-slowdown-pct", args.perf_slowdown_pct,
                  ev.HVDTPU_PERF_SLOWDOWN_PCT)
    if args.no_gradstats:
        env[ev.HVDTPU_GRADSTATS] = "0"
    if args.nancheck is not None:
        env[ev.HVDTPU_NANCHECK] = args.nancheck
    at_least_zero("--gradcheck-sample", args.gradcheck_sample,
                  ev.HVDTPU_GRADCHECK_SAMPLE)
    if args.prof_hz is not None:
        if not 1 <= args.prof_hz <= ev.MAX_PROF_HZ:
            raise SystemExit(f"hvdrun: --prof-hz must be 1..{ev.MAX_PROF_HZ}")
        env[ev.HVDTPU_PROF_HZ] = str(args.prof_hz)
    if args.prof_clock is not None:
        env[ev.HVDTPU_PROF_CLOCK] = args.prof_clock
    if getattr(args, "_chaos_spec", None):
        env[ev.HVDTPU_CHAOS] = args._chaos_spec
        if getattr(args, "_chaos_marker", None):
            env[ev.HVDTPU_CHAOS_MARKER] = args._chaos_marker
    if args.stall_check_disable:
        env[ev.HVDTPU_STALL_CHECK_DISABLE] = "1"
    env[ev.HVDTPU_STALL_CHECK_TIME_SECONDS] = str(
        args.stall_check_warning_time_seconds)
    if args.stall_check_shutdown_time_seconds is not None:
        env[ev.HVDTPU_STALL_SHUTDOWN_TIME_SECONDS] = str(
            args.stall_check_shutdown_time_seconds)
    env[ev.HVDTPU_CACHE_CAPACITY] = str(args.cache_capacity)
    if args.autotune:
        env[ev.HVDTPU_AUTOTUNE] = "1"
        if args.autotune_log_file:
            env[ev.HVDTPU_AUTOTUNE_LOG] = args.autotune_log_file
        for value, name in (
                (args.autotune_warmup_samples,
                 ev.HVDTPU_AUTOTUNE_WARMUP_SAMPLES),
                (args.autotune_steps_per_sample,
                 ev.HVDTPU_AUTOTUNE_STEPS_PER_SAMPLE),
                (args.autotune_bayes_opt_max_samples,
                 ev.HVDTPU_AUTOTUNE_BAYES_OPT_MAX_SAMPLES),
                (args.autotune_gaussian_process_noise,
                 ev.HVDTPU_AUTOTUNE_GAUSSIAN_PROCESS_NOISE)):
            if value is not None:
                env[name] = str(value)
    return env


def _build_env(slot: hosts_mod.SlotInfo, args, controller_host: str,
               controller_port: int) -> dict:
    """A static worker's environment: this process's, the knobs, and the
    slot's topology."""
    env = _apply_tuning_env(dict(os.environ), args)
    env[ev.HVDTPU_RANK] = str(slot.rank)
    env[ev.HVDTPU_SIZE] = str(slot.size)
    env[ev.HVDTPU_LOCAL_RANK] = str(slot.local_rank)
    env[ev.HVDTPU_LOCAL_SIZE] = str(slot.local_size)
    env[ev.HVDTPU_CROSS_RANK] = str(slot.cross_rank)
    env[ev.HVDTPU_CROSS_SIZE] = str(slot.cross_size)
    env[ev.HVDTPU_HOSTNAME] = slot.hostname
    env[ev.HVDTPU_CONTROLLER_ADDR] = controller_host
    env[ev.HVDTPU_CONTROLLER_PORT] = str(controller_port)
    if args.timeline:
        env[ev.HVDTPU_TIMELINE] = f"{args.timeline}.{slot.rank}.json"
    return env


def _resolve_chaos(args, np_: int) -> None:
    """Check ``--chaos`` and choose its target: a spec without ``rankR:``
    is aimed at one worker drawn at random (a game-day kills a rank, not
    the world). An elastic job also gets a one-shot marker, so that the
    worker that takes the dead one's place does not arm the fault
    again."""
    if not args.chaos:
        return
    import random

    from .. import chaos as chaos_mod
    spec = args.chaos.strip()
    target = None
    if not spec.startswith("rank"):
        target = random.randrange(np_)
        spec = f"rank{target}:{spec}"
    try:
        chaos_mod.parse_chaos(spec, target if target is not None else 0)
    except ValueError as exc:
        raise SystemExit(f"hvdrun: {exc}")
    if target is not None:
        print(f"hvdrun: chaos: targeting rank {target} with {args.chaos!r}",
              file=sys.stderr)
    args._chaos_spec = spec
    if args.host_discovery_script:
        import tempfile
        fd, marker = tempfile.mkstemp(prefix="hvdtpu_chaos_")
        os.close(fd)
        os.unlink(marker)  # chaos.armed_chaos creates it, once
        args._chaos_marker = marker


def run_elastic_launcher(args: argparse.Namespace) -> int:
    """An elastic job (reference: ``_run_elastic``, ``launch.py:624``):
    the workers' topology comes from the driver's rendezvous; their
    environment carries the knobs and the elastic timeout."""
    from .elastic import ElasticSettings, HostDiscoveryScript, run_elastic

    _resolve_chaos(args, args.min_np or args.num_proc)
    settings = ElasticSettings(
        min_np=args.min_np or args.num_proc,
        max_np=args.max_np or args.num_proc,
        elastic_timeout_s=args.elastic_timeout,
        reset_limit=args.reset_limit,
        remote_python=args.remote_python)
    discovery = HostDiscoveryScript(args.host_discovery_script,
                                    slots=args.slots)
    env = _apply_tuning_env(dict(os.environ), args)
    env[ev.HVDTPU_ELASTIC_TIMEOUT] = str(args.elastic_timeout)
    return run_elastic(discovery, settings, list(args.command), env,
                       verbose=args.verbose)


def _preflight_spawn(args):
    """The connectivity probe's spawner: the way the workers start."""
    def spawn(host: str, env: dict):
        local = safe_exec.is_local_host(host)
        cmd = [sys.executable if local else args.remote_python,
               "-m", "horovod_tpu_torch.runner.preflight"]
        if local:
            return safe_exec.WorkerProcess(cmd, {**os.environ, **env},
                                           f"preflight@{host}")
        secret = env.get(ev.HVDTPU_SECRET)
        return safe_exec.WorkerProcess(
            safe_exec.ssh_wrap(host, args.ssh_port, env, cmd),
            dict(os.environ), f"preflight@{host}",
            stdin_data=(secret + "\n").encode() if secret else None)
    return spawn


def run_launcher(args: argparse.Namespace) -> int:
    """Run the job ``args`` describes; its exit code."""
    _refuse_observability(args)
    if args.host_discovery_script:
        return run_elastic_launcher(args)
    if args.top_once and not args.top:
        raise SystemExit("hvdrun: --top-once only makes sense with --top")
    _resolve_chaos(args, args.num_proc)
    host_list = (hosts_mod.parse_hostfile(args.hostfile) if args.hostfile
                 else hosts_mod.parse_hosts(args.hosts or
                                            f"localhost:{args.num_proc}"))
    slots = hosts_mod.get_host_assignments(host_list, args.num_proc)
    controller_host = args.controller_advertise_address or slots[0].hostname
    controller_port = args.start_port or _free_port()
    if args.verbose:
        groups = hosts_mod.host_groups(slots)
        lanes = "tcp-only" if args.no_shm else "shm intra-host"
        hier = "on" if args.hier else "off" if args.no_hier else "auto"
        print("hvdrun: host topology: " +
              ", ".join(f"{h}(ranks {r[0]}-{r[-1]})" if len(r) > 1 else
                        f"{h}(rank {r[0]})" for h, r in groups.items()) +
              f"; transports: {lanes}; hier={hier}", file=sys.stderr)

    # A job on other hosts: prove every host reaches the launcher and the
    # controller's port before any worker starts, so that a wrong address
    # fails at once, naming the host, instead of hanging in rendezvous.
    hostnames = [s.hostname for s in slots]
    if not args.no_preflight and not all(map(safe_exec.is_local_host,
                                             hostnames)):
        from .preflight import check_connectivity
        check_connectivity(hostnames, controller_host, controller_port,
                           _preflight_spawn(args),
                           timeout=args.preflight_timeout,
                           secret=_ensure_job_secret(args),
                           listen_host=slots[0].hostname)

    commands, envs, names, stdins = [], [], [], []
    for slot in slots:
        env = _build_env(slot, args, controller_host, controller_port)
        local = safe_exec.is_local_host(slot.hostname)
        cmd = safe_exec.resolve_python(args.command, local,
                                       args.remote_python)
        if local:
            commands.append(cmd)
            envs.append(env)
            stdins.append(None)
        else:
            commands.append(safe_exec.ssh_wrap(slot.hostname, args.ssh_port,
                                               env, cmd))
            envs.append(dict(os.environ))
            # The secret goes over ssh's standard input, never the command
            # line.
            secret = env.get(ev.HVDTPU_SECRET)
            stdins.append((secret + "\n").encode() if secret else None)
        names.append(f"rank{slot.rank}@{slot.hostname}")
        if args.verbose:
            print(f"hvdrun: {names[-1]}: {' '.join(commands[-1])}",
                  file=sys.stderr)
    return safe_exec.run_workers(commands, envs, names, verbose=args.verbose,
                                 stdin_datas=stdins)


def _stop(signum, frame):
    raise KeyboardInterrupt


def main(argv: List[str] = None) -> int:
    # SIGTERM (a scheduler's stop, a supervisor's time limit) stops the
    # workers' process groups as Ctrl-C does, instead of leaving them
    # running without their launcher.
    signal.signal(signal.SIGTERM, _stop)
    return run_launcher(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
