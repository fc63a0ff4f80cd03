"""``hvdrun`` — the launcher CLI:
``python -m horovod_tpu_torch.runner.launch -np N [-H hosts] command``.

Mirrors ``horovod_tpu/runner/launch.py`` (reference:
``horovod/runner/launch.py``: ``run_commandline`` at :763, ``_run`` at
:736 dispatching static vs elastic, ``parse_args`` with the full env-knob
mirror via ``config_parser``): the same flags, config-file schema and
knob-to-env mirror, so a command line written for one launcher runs under
the other. In the port a worker process drives one card
(``cuda:<local_rank>``), and rank 0's ``torch.distributed`` store is the
rendezvous.

``--tpu`` enumerates the hosts from the cloud VM's metadata server
(:func:`~horovod_tpu_torch.runner.gpu_discovery.pod_hosts`; with
``--min-np``, elastic discovery re-reads it each refresh): a TPU VM's
``worker-network-endpoints``, or the same attribute set on a GPU VM's
instance template. A host's slots are this host's card count unless
``--slots`` or ``-np`` says otherwise. A multi-host static launch resolves
its rendezvous address through the task services' NIC probe
(``--network-interfaces``/``--nics`` restricts it, ``--no-nic-probe``
skips it). The config file needs PyYAML, imported only when
``--config-file`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List

from horovod_tpu_torch.runner.hosts import (HostInfo, parse_hostfile, parse_hosts)
from horovod_tpu_torch.runner.exec_run import launch_static
from horovod_tpu_torch.version import __version__


def parse_args(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="hvdrun",
        description="Launch a horovod_tpu_torch distributed job "
                    "(Horovod-class launcher, one process per card)")
    p.add_argument("--version", action="version", version=__version__)
    p.add_argument("-cb", "--check-build", action="store_true",
                   help="print available frameworks/controllers/ops and "
                        "exit (reference: horovodrun --check-build)")
    p.add_argument("-np", "--num-proc", type=int, default=None,
                   help="number of worker processes (one per card)")
    p.add_argument("-H", "--hosts", default=None,
                   help='host list "h1:slots,h2:slots"')
    p.add_argument("--hostfile", default=None,
                   help="hostfile with lines 'host slots=N'")
    p.add_argument("--tpu", action="store_true",
                   help="enumerate the pod's worker VMs from the GCE "
                        "metadata service instead of -H/--hostfile (the "
                        "TPU analog of the reference's MPI/LSF environment "
                        "detection; a GPU VM's instance template sets the "
                        "same attribute); with --min-np, elastic discovery "
                        "re-reads it each refresh")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--config-file", default=None,
                   help="YAML file with the reference's config schema "
                        "(params/autotune/timeline/stall_check/"
                        "library_options/logging sections); explicit CLI "
                        "flags override it (reference: config_parser.py)")
    p.add_argument("--start-timeout", type=float, default=None,
                   help="seconds for all workers to start and connect "
                        "(static: mesh-connect deadline; elastic: initial "
                        "min-host wait; reference flag of the same name)")
    p.add_argument("--elastic-timeout", type=float, default=None,
                   help="seconds to re-reach min-np slots after a world "
                        "change (reference flag of the same name)")
    p.add_argument("-s", "--slots", "--slots-per-host",
                   dest="slots_per_host", type=int, default=None,
                   help="default slots for discovered hosts that do not "
                        "state their own ':slots' (reference: --slots)")
    # elastic (reference: --min-np/--max-np/--host-discovery-script)
    p.add_argument("--min-np", type=int, default=None)
    p.add_argument("--max-np", type=int, default=None)
    p.add_argument("--host-discovery-script", default=None,
                   help="script printing 'host:slots' lines; enables "
                        "elastic mode")
    p.add_argument("--reset-limit", type=int, default=None,
                   help="max elastic relaunch generations before giving up")
    # control-plane HA (docs/ELASTIC.md "Driver failover & takeover")
    p.add_argument("--driver-journal-dir", default=None,
                   help="journal every elastic-driver decision to this "
                        "directory and supervise the driver: a crashed "
                        "driver is respawned with --takeover and adopts "
                        "the running workers (mirrors "
                        "HVD_TPU_DRIVER_JOURNAL_DIR)")
    p.add_argument("--takeover", action="store_true",
                   help="replay the driver journal and adopt a running "
                        "elastic job instead of launching a new one "
                        "(requires a journal dir via "
                        "--driver-journal-dir or "
                        "HVD_TPU_DRIVER_JOURNAL_DIR)")
    p.add_argument("--no-driver-supervisor", action="store_true",
                   help="run the elastic driver in THIS process even "
                        "when a journal dir is configured (no crash "
                        "respawn; the supervisor uses it for its own "
                        "child)")
    # knobs mirrored to env (reference: config_parser.py — full set; see
    # docs/KNOBS.md for the table)
    p.add_argument("--fusion-threshold-mb", type=float, default=None)
    p.add_argument("--cycle-time-ms", type=float, default=None)
    p.add_argument("--cache-capacity", type=int, default=None)
    p.add_argument("--hierarchical-allreduce", action="store_true")
    p.add_argument("--hierarchical-allgather", action="store_true")
    p.add_argument("--autotune", action="store_true")
    p.add_argument("--autotune-log-file", default=None)
    p.add_argument("--autotune-warmup-samples", type=int, default=None)
    p.add_argument("--autotune-steps-per-sample", type=int, default=None)
    p.add_argument("--autotune-bayes-opt-max-samples", type=int,
                   default=None)
    p.add_argument("--autotune-gaussian-process-noise", type=float,
                   default=None)
    p.add_argument("--timeline-filename", default=None)
    p.add_argument("--timeline-mark-cycles", action="store_true")
    p.add_argument("--no-stall-check", action="store_true")
    p.add_argument("--stall-warning-timeout-seconds", type=float,
                   default=None)
    p.add_argument("--stall-shutdown-timeout-seconds", type=float,
                   default=None)
    # back-compat alias for the r1 flag name
    p.add_argument("--stall-timeout-seconds", type=float, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--gloo-timeout-seconds", type=float, default=None,
                   help="rendezvous/mesh connect deadline")
    p.add_argument("--network-interfaces", "--nics", dest="nics",
                   default=None,
                   help="comma-separated NIC allowlist for the multi-host "
                        "routability probe (reference: --network-interfaces)")
    p.add_argument("--no-nic-probe", action="store_true",
                   help="skip the task-service NIC probe on multi-host "
                        "launches")
    p.add_argument("--thread-affinity", type=int, default=None,
                   help="pin the core background thread to this CPU")
    p.add_argument("--output-filename", default=None,
                   help="directory collecting per-worker output as "
                        "<dir>/rank.N/{stdout,stderr} (reference: "
                        "horovodrun --output-filename)")
    p.add_argument("--prefix-output-with-timestamp", action="store_true",
                   help="timestamp every pumped worker output line "
                        "(reference flag of the same name)")
    p.add_argument("--log-level", default=None,
                   choices=["TRACE", "DEBUG", "INFO", "WARNING", "ERROR",
                            "FATAL"])
    p.add_argument("--log-hide-timestamp", action="store_true")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="program and args to run on every worker")
    args = p.parse_args(argv)
    if not args.command and not args.check_build:
        p.error("no command given")
    # one host source only — enforced here so the elastic path can't
    # silently ignore a conflicting -H/--hostfile/--host-discovery-script
    if sum(bool(x) for x in (args.hosts, args.hostfile, args.tpu,
                             args.host_discovery_script)) > 1:
        p.error("specify only one of -H/--hosts, --hostfile, --tpu, "
                "--host-discovery-script")
    if args.takeover and args.host_discovery_script is None \
            and args.min_np is None:
        p.error("--takeover requires elastic mode (--min-np or "
                "--host-discovery-script)")
    # launcher flags end where the user command begins: the probe below
    # must never see the command's own options
    launcher_argv = list(argv)[:len(argv) - len(args.command)]
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]
    if args.config_file:
        apply_config_file(args, _explicit_flags(p, launcher_argv), p)
    validate_config_args(args)
    return args


def _explicit_flags(parser: argparse.ArgumentParser,
                    launcher_argv: List[str]) -> set:
    """Dests the user actually passed on the CLI (these override the
    config file, reference: ``config_parser``'s override_args). A probe
    parser with ``SUPPRESS`` defaults leaves only explicitly-given
    attributes on its namespace; abbreviation rules match the main
    parser so an abbreviated flag still counts as explicit."""
    probe = argparse.ArgumentParser(add_help=False)
    for a in parser._actions:
        if not a.option_strings or isinstance(
                a, (argparse._HelpAction, argparse._VersionAction)):
            continue
        kwargs = {"dest": a.dest, "default": argparse.SUPPRESS}
        if a.nargs == 0:  # store_true-style flags take no value
            kwargs["action"] = "store_true"
        probe.add_argument(*a.option_strings, **kwargs)
    ns, _ = probe.parse_known_args(launcher_argv)
    return set(vars(ns).keys())


# YAML section -> {config key -> args attribute}; keys accept both
# hyphen and underscore spelling. Schema mirrors the reference's
# (``config_parser.set_args_from_config``) with this launcher's arg names.
_CONFIG_SECTIONS = {
    "params": {
        "fusion_threshold_mb": "fusion_threshold_mb",
        "cycle_time_ms": "cycle_time_ms",
        "cache_capacity": "cache_capacity",
        "hierarchical_allreduce": "hierarchical_allreduce",
        "hierarchical_allgather": "hierarchical_allgather",
    },
    "autotune": {
        "enabled": "autotune",
        "log_file": "autotune_log_file",
        "warmup_samples": "autotune_warmup_samples",
        "steps_per_sample": "autotune_steps_per_sample",
        "bayes_opt_max_samples": "autotune_bayes_opt_max_samples",
        "gaussian_process_noise": "autotune_gaussian_process_noise",
    },
    "timeline": {
        "filename": "timeline_filename",
        "mark_cycles": "timeline_mark_cycles",
    },
    "stall_check": {
        # "enabled" inverts onto no_stall_check below
        "warning_time_seconds": "stall_warning_timeout_seconds",
        "shutdown_time_seconds": "stall_shutdown_timeout_seconds",
    },
    "library_options": {
        "thread_affinity": "thread_affinity",
        "gloo_timeout_seconds": "gloo_timeout_seconds",
    },
    "logging": {
        "level": "log_level",
        "hide_timestamp": "log_hide_timestamp",
    },
    "": {  # top-level keys
        "verbose": "verbose",
        "start_timeout": "start_timeout",
        "elastic_timeout": "elastic_timeout",
        "slots": "slots_per_host",
    },
}


def _coerce_bool(v):
    """YAML booleans plus their common string spellings — ``bool('false')``
    would silently be True."""
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)) and v in (0, 1):
        return bool(v)
    if isinstance(v, str):
        s = v.strip().lower()
        if s in ("1", "true", "yes", "on"):
            return True
        if s in ("0", "false", "no", "off"):
            return False
    raise ValueError(f"not a boolean: {v!r}")


def apply_config_file(args: argparse.Namespace, explicit: set,
                      parser: argparse.ArgumentParser) -> None:
    """Fill non-explicit args from the YAML config (reference:
    ``config_parser.set_args_from_config``). Values are coerced through
    the flag's own argparse type so ``start-timeout: '120'`` (a quoted
    number) behaves like the CLI flag would."""
    import yaml

    with open(args.config_file) as f:
        config = yaml.safe_load(f) or {}

    types = {a.dest: (_coerce_bool if a.nargs == 0 else a.type)
             for a in parser._actions if a.option_strings}

    def norm(d):
        return {str(k).replace("-", "_"): v for k, v in d.items()} \
            if isinstance(d, dict) else {}

    config = norm(config)
    for section, mapping in _CONFIG_SECTIONS.items():
        values = config if section == "" else norm(config.get(section))
        for key, dest in mapping.items():
            if dest in explicit:
                continue
            v = values.get(key)
            if v is not None:
                coerce = types.get(dest)
                if coerce is not None:
                    try:
                        v = coerce(v)
                    except (TypeError, ValueError) as e:
                        raise ValueError(
                            f"config file {args.config_file}: key "
                            f"{key!r} = {v!r} is not a valid "
                            f"{getattr(coerce, '__name__', coerce)}") \
                            from e
                setattr(args, dest, v)
    stall = norm(config.get("stall_check"))
    if "enabled" in stall and "no_stall_check" not in explicit:
        args.no_stall_check = not stall["enabled"]


def validate_config_args(args: argparse.Namespace) -> None:
    """Reject negatives the env parser would otherwise carry through
    (reference: ``config_parser.validate_config_args``)."""
    for name in ("fusion_threshold_mb", "cycle_time_ms", "cache_capacity",
                 "autotune_warmup_samples", "autotune_steps_per_sample",
                 "autotune_bayes_opt_max_samples",
                 "stall_warning_timeout_seconds",
                 "stall_shutdown_timeout_seconds", "thread_affinity",
                 "gloo_timeout_seconds", "start_timeout",
                 "elastic_timeout"):
        v = getattr(args, name, None)
        if v is not None and v < 0:
            raise ValueError(f"{name}={v} must be >= 0")
    slots = getattr(args, "slots_per_host", None)
    if slots is not None and slots < 1:
        raise ValueError(f"slots_per_host={slots} must be >= 1")
    noise = getattr(args, "autotune_gaussian_process_noise", None)
    if noise is not None and not (0 <= noise <= 1):
        raise ValueError(
            f"autotune_gaussian_process_noise={noise} must be in [0, 1]")


def knobs_to_env(args: argparse.Namespace) -> Dict[str, str]:
    """CLI knob → env mirror (reference: ``config_parser.set_env_from_args``)."""
    env: Dict[str, str] = {}

    def put(flag_value, name, convert=str):
        if flag_value is not None and flag_value is not False:
            env[name] = "1" if flag_value is True else convert(flag_value)

    put(None if args.fusion_threshold_mb is None
        else int(args.fusion_threshold_mb * 1024 * 1024),
        "HOROVOD_FUSION_THRESHOLD")
    put(args.cycle_time_ms, "HOROVOD_CYCLE_TIME")
    put(args.cache_capacity, "HOROVOD_CACHE_CAPACITY")
    put(args.hierarchical_allreduce, "HOROVOD_HIERARCHICAL_ALLREDUCE")
    put(args.hierarchical_allgather, "HOROVOD_HIERARCHICAL_ALLGATHER")
    put(args.autotune, "HOROVOD_AUTOTUNE")
    put(args.autotune_log_file, "HOROVOD_AUTOTUNE_LOG")
    put(args.autotune_warmup_samples, "HOROVOD_AUTOTUNE_WARMUP_SAMPLES")
    put(args.autotune_steps_per_sample,
        "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE")
    put(args.autotune_bayes_opt_max_samples,
        "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES")
    put(args.autotune_gaussian_process_noise,
        "HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE")
    put(args.timeline_filename or None, "HOROVOD_TIMELINE")
    put(args.timeline_mark_cycles, "HOROVOD_TIMELINE_MARK_CYCLES")
    put(args.no_stall_check, "HOROVOD_STALL_CHECK_DISABLE")
    put(args.stall_warning_timeout_seconds
        if args.stall_warning_timeout_seconds is not None
        else args.stall_timeout_seconds,
        "HOROVOD_STALL_CHECK_TIME_SECONDS")
    put(args.stall_shutdown_timeout_seconds,
        "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS")
    put(args.gloo_timeout_seconds, "HOROVOD_GLOO_TIMEOUT_SECONDS")
    put(args.thread_affinity, "HOROVOD_THREAD_AFFINITY")
    put(args.log_level, "HOROVOD_LOG_LEVEL")
    put(args.log_hide_timestamp, "HOROVOD_LOG_HIDE_TIME")
    return env


def resolve_hosts(args: argparse.Namespace) -> List[HostInfo]:
    if sum(bool(x) for x in
           (args.hosts, args.hostfile, getattr(args, "tpu", False))) > 1:
        raise ValueError(
            "Specify only one of --hosts, --hostfile, --tpu")
    if getattr(args, "tpu", False):
        from horovod_tpu_torch.runner.gpu_discovery import pod_hosts
        return pod_hosts(slots=getattr(args, "slots_per_host", None),
                         num_proc=args.num_proc)
    if args.hostfile:
        return parse_hostfile(args.hostfile)
    if args.hosts:
        return parse_hosts(args.hosts)
    np = args.num_proc or 1
    return [HostInfo("localhost", np)]


def check_build() -> str:
    """Capability report (reference: ``check_build``, ``launch.py:110-145``)
    in the reference's checkbox format: the framework this install drives
    and the ``torch.distributed`` backends it can start."""
    import torch
    import torch.distributed as dist

    def mark(v):
        return "X" if v else " "

    return f"""\
horovod_tpu_torch v{__version__}:

Available Frameworks:
    [X] PyTorch {torch.__version__}

Available Controllers:
    [{mark(dist.is_gloo_available())}] Gloo (torch.distributed TCP store)

Available Tensor Operations:
    [{mark(dist.is_nccl_available() and torch.cuda.is_available())}] NCCL
    [{mark(dist.is_gloo_available())}] Gloo
    [X] Local (single process)"""


def supervise_driver(argv: List[str], env: Dict[str, str],
                     journal_dir: str, takeover: bool = False) -> int:
    """Driver supervisor loop (docs/ELASTIC.md "Driver failover &
    takeover"): run the elastic driver as a CHILD process and, when it
    dies without journaling a ``clean_exit``, respawn it with
    ``--takeover`` so it replays the journal and adopts the running
    fleet.  Workers lead their own process groups (safe_exec setsid),
    so a driver crash — or a SIGKILL from the chaos ``driver`` seam —
    leaves them training; the respawned driver re-publishes the last
    committed world verbatim and they ride the outage out inside
    ``HVD_TPU_DRIVER_OUTAGE_GRACE_S`` without re-meshing."""
    import subprocess
    from horovod_tpu_torch.common.config import env_int
    from horovod_tpu_torch.common.logging import get_logger
    from horovod_tpu_torch.runner.elastic import journal as journal_mod
    log = get_logger()
    # --takeover is the supervisor's decision from here on: the child is
    # respawned into takeover only after a crash is confirmed
    base = [a for a in argv if a != "--takeover"]
    max_takeovers = max(0, env_int("DRIVER_MAX_TAKEOVERS", 3))
    path = os.path.join(journal_dir, journal_mod.JOURNAL_NAME)
    takeovers = 0
    while True:
        cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch"] + \
            (["--takeover"] if takeover else []) + base
        child_env = dict(env)
        child_env["HVD_TPU_DRIVER_SUPERVISED"] = "1"
        child_env["HVD_TPU_DRIVER_JOURNAL_DIR"] = journal_dir
        rc = subprocess.run(cmd, env=child_env).returncode
        try:
            state = journal_mod.load(path)
        except Exception as exc:
            log.error("driver supervisor: journal %s unreadable (%s); "
                      "passing driver rc %d through", path, exc, rc)
            return rc
        if state.clean_exit is not None:
            # the driver finished ON PURPOSE (success or classified
            # failure) — its verdict stands, no takeover
            return rc
        takeovers += 1
        if takeovers > max_takeovers:
            log.error(
                "driver supervisor: driver died again (rc %d) after %d "
                "takeover(s); HVD_TPU_DRIVER_MAX_TAKEOVERS exhausted — "
                "giving up (docs/TROUBLESHOOTING.md \"My driver died\")",
                rc, takeovers - 1)
            return rc or 1
        try:
            state.check_takeover()
        except journal_mod.TakeoverRefused as exc:
            log.error(
                "driver supervisor: driver died (rc %d) but takeover is "
                "refused: %s — recover manually (docs/TROUBLESHOOTING.md "
                "\"My driver died\")", rc, exc)
            return rc or 1
        log.warning(
            "driver supervisor: driver died (rc %d) without a clean "
            "exit; respawning into journal takeover %d/%d",
            rc, takeovers, max_takeovers)
        takeover = True


def run_commandline(argv: List[str] = None) -> int:
    """Reference: ``run_commandline`` (``launch.py:763``)."""
    args = parse_args(argv if argv is not None else sys.argv[1:])
    if args.check_build:
        print(check_build())
        return 0
    env = dict(os.environ)
    env.update(knobs_to_env(args))

    elastic = args.host_discovery_script is not None or \
        args.min_np is not None
    if elastic:
        from horovod_tpu_torch.runner.elastic.driver import run_elastic
        from horovod_tpu_torch.runner.elastic.discovery import (
            FixedHosts, HostDiscoveryScript)
        if args.host_discovery_script:
            discovery = HostDiscoveryScript(
                args.host_discovery_script,
                default_slots=1 if args.slots_per_host is None
                else args.slots_per_host)
        elif args.tpu:
            from horovod_tpu_torch.runner.gpu_discovery import PodDiscovery
            discovery = PodDiscovery(slots=args.slots_per_host,
                                     num_proc=args.max_np or args.num_proc)
        else:
            discovery = FixedHosts(resolve_hosts(args))
        journal_dir = args.driver_journal_dir or \
            env.get("HVD_TPU_DRIVER_JOURNAL_DIR") or None
        if journal_dir:
            # the driver (and the supervisor's respawned child) read the
            # dir from the environment; a CLI flag must reach them too
            env["HVD_TPU_DRIVER_JOURNAL_DIR"] = journal_dir
        if journal_dir and not args.no_driver_supervisor \
                and os.environ.get("HVD_TPU_DRIVER_SUPERVISED") != "1":
            return supervise_driver(
                list(argv) if argv is not None else sys.argv[1:],
                env, journal_dir, takeover=args.takeover)
        return run_elastic(
            discovery, args.num_proc, args.command,
            min_np=args.min_np or 1, max_np=args.max_np,
            env=env, verbose=args.verbose, reset_limit=args.reset_limit,
            timestamp_output=args.prefix_output_with_timestamp,
            start_timeout=args.start_timeout,
            elastic_timeout=args.elastic_timeout,
            journal_dir=journal_dir, takeover=args.takeover)

    if args.start_timeout is not None:
        # STATIC path only (elastic generations use --elastic-timeout for
        # re-scale waits — a short start deadline must not bound their
        # mesh reconnects): every worker must reach the coordinator mesh
        # inside this window. An explicit --gloo-timeout-seconds wins —
        # knobs_to_env already set it above.
        env.setdefault("HOROVOD_GLOO_TIMEOUT_SECONDS",
                       str(args.start_timeout))
    hosts = resolve_hosts(args)
    np = args.num_proc or sum(h.slots for h in hosts)
    nics = [n.strip() for n in args.nics.split(",") if n.strip()] \
        if args.nics else None
    return launch_static(hosts, np, args.command, env=env,
                         nics=nics, nic_probe=not args.no_nic_probe,
                         verbose=args.verbose,
                         output_dir=args.output_filename,
                         timestamp_output=args.prefix_output_with_timestamp)


def main() -> None:
    sys.exit(run_commandline())


if __name__ == "__main__":
    main()
