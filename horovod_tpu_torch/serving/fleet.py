"""The elastic replica fleet: spawn, watch, heal, drain, scale out.

Mirrors ``horovod_tpu/serving/fleet.py``: a :class:`ReplicaFleet` owns N
replica PROCESSES (``python -m horovod_tpu_torch.serving.replica``),
monitors their
``/readyz`` probes, classifies every exit — **DRAINED** (exit code 0:
preemption/admin drain completed; a planned event, never failure
evidence) vs **FAILURE** (crash/SIGKILL) — and heals back to the
target size by respawning replacements.  The router's endpoint view is
the fleet's live READY set, so a draining or dead replica drops out of
rotation before requests discover it.

Ports: the JAX fleet picks a free port (binds port 0, closes the socket)
and hands the number to a child that binds it seconds later, a window in
which another socket can take it (``horovod_tpu/serving/fleet.py:40``;
the race that failed the port's spawned test worlds, ROADMAP queue 3 item
9). Here each child binds port 0 itself and reports the port it got
through ``--port-file`` (written atomically once it serves); a replica is
not an endpoint until its file exists.

``scale_out`` is the autopilot seam: the ``serving-slo-scaleout`` policy
(finding ``slo_breach`` → action ``scale_out``) runs the hook
:meth:`ReplicaFleet.register_autopilot_hook` registers.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple

from horovod_tpu_torch.common.config import env_float
from horovod_tpu_torch.common.logging import get_logger
from horovod_tpu_torch.diagnostics.flight_recorder import record_event
from horovod_tpu_torch.serving import metrics as smetrics

Endpoint = Tuple[str, int]

#: the directory holding ``horovod_tpu_torch``: a child's ``python -m``
#: must import this package whatever its working directory
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _flight(kind: str, **fields) -> None:
    record_event(kind, **fields)


class _Replica:
    def __init__(self, slot: int, incarnation: int, port_file: str,
                 proc: subprocess.Popen, log_path: str) -> None:
        self.slot = slot
        self.incarnation = incarnation
        self.port: Optional[int] = None   # known once port_file exists
        self.port_file = port_file
        self.proc = proc
        self.log_path = log_path
        self.ready = False
        # last observed serving state (from the readyz probes / pin
        # responses): the per-version membership view reads these
        self.version: Optional[int] = None
        self.pinned: Optional[int] = None

    def read_port(self) -> Optional[int]:
        """The port the child bound, once it has written it."""
        if self.port is None:
            try:
                with open(self.port_file) as f:
                    self.port = int(json.load(f)["port"])
            except (OSError, ValueError, KeyError):
                return None
        return self.port

    def log_tail(self, n: int = 2000) -> str:
        try:
            with open(self.log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - n))
                return f.read().decode(errors="replace")
        except OSError:
            return ""

    @property
    def endpoint(self) -> Endpoint:
        return ("127.0.0.1", self.port)

    def name(self) -> str:
        return f"slot{self.slot}.{self.incarnation}"


class ReplicaFleet:
    """Local replica-process fleet.

    Args:
      size: initial target replica count.
      store_dir: durable sharded store every replica restores from and
        watches for hot swaps.
      dim: demo-model width forwarded to replicas.
      extra_env: env overrides for spawned replicas (serving knobs).
      poll_s: monitor loop interval.
      mode: ``"infer"`` or ``"generate"`` (forwarded as ``--mode``).
      device: forwarded as ``--device`` (None: each replica takes the
        process's card and refuses to start without one).
      extra_args: more replica CLI arguments (``["--flagship"]``).
    """

    MAX_EXITS = 100  # bounded exit-classification audit

    def __init__(self, size: int = 2, store_dir: Optional[str] = None,
                 dim: int = 16, extra_env: Optional[dict] = None,
                 poll_s: Optional[float] = None, mode: str = "infer",
                 device: Optional[str] = None,
                 extra_args: Sequence[str] = ()) -> None:
        self.target = size
        self.store_dir = store_dir
        self.dim = dim
        self.mode = mode
        self.device = device
        self.extra_args = list(extra_args)
        self.extra_env = dict(extra_env or {})
        self._tmp = tempfile.mkdtemp(prefix="hvd_serving_fleet_")
        self.poll_s = poll_s if poll_s is not None \
            else env_float("SERVING_FLEET_POLL_S", 0.25)
        self._replicas: Dict[int, _Replica] = {}
        self._incarnations = 0
        # per-slot version pins (docs/SERVING.md "Canary rollout"):
        # _pins is what the slot's replica serves NOW (re-applied on a
        # drained respawn); _heal_pins is what a replacement after a
        # FAILURE restores — the rollout controller sets it to the
        # incumbent for canary slots, so a crashed canary heals at the
        # incumbent version, not the candidate
        self._pins: Dict[int, int] = {}
        self._heal_pins: Dict[int, int] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self.exits: List[dict] = []  # classification audit

    # -- lifecycle ----------------------------------------------------------
    def start(self, ready_timeout_s: float = 60.0) -> "ReplicaFleet":
        for slot in range(self.target):
            self._spawn(slot)
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         name="hvd-serving-fleet",
                                         daemon=True)
        self._monitor.start()
        if not self.wait_ready(self.target, timeout_s=ready_timeout_s):
            raise RuntimeError(
                f"fleet: {self.target} replicas not ready within "
                f"{ready_timeout_s}s")
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5)
        with self._lock:
            replicas = list(self._replicas.values())
        for r in replicas:
            try:
                r.proc.terminate()
            except OSError:
                pass
        for r in replicas:
            try:
                r.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                r.proc.kill()
            for path in (r.log_path, r.port_file):
                try:
                    os.unlink(path)
                except OSError:
                    pass
        try:
            os.rmdir(self._tmp)
        except OSError:
            pass

    # -- spawning -----------------------------------------------------------
    def _spawn(self, slot: int) -> _Replica:
        with self._lock:
            self._incarnations += 1
            inc = self._incarnations
        # the child binds port 0 and writes the port it got here
        port_file = os.path.join(self._tmp, f"slot{slot}.{inc}.port")
        env = dict(os.environ)
        # rank-scoped rules address replicas by SLOT (stable across
        # respawns — a replacement in the slot is the same logical
        # replica)
        env["HVD_TPU_RANK"] = str(slot)
        env["PYTHONPATH"] = os.pathsep.join(
            [_PKG_ROOT] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        env.update(self.extra_env)
        cmd = [sys.executable, "-m", "horovod_tpu_torch.serving.replica",
               "--port", "0", "--port-file", port_file,
               "--dim", str(self.dim), "--mode", self.mode,
               "--replica-id", f"slot{slot}.{inc}", *self.extra_args]
        if self.device is not None:
            cmd += ["--device", str(self.device)]
        if self.store_dir:
            cmd += ["--store-dir", self.store_dir]
        with self._lock:
            pin = self._pins.get(slot)
        if pin is not None:
            # a pinned slot's replacement joins AT the pin, never at
            # latest — a respawn during a rollout must not widen the
            # canary (docs/SERVING.md "Canary rollout")
            cmd += ["--pin-version", str(pin)]
        # log to a FILE, not a pipe: nobody drains a pipe while the
        # replica lives, and a full pipe would wedge it mid-request
        log_path = os.path.join(self._tmp, f"slot{slot}.{inc}.log")
        with open(log_path, "wb") as log_fh:
            proc = subprocess.Popen(cmd, env=env, stdout=log_fh,
                                    stderr=subprocess.STDOUT)
        replica = _Replica(slot, inc, port_file, proc, log_path)
        with self._lock:
            self._replicas[slot] = replica
        _flight("serving_replica_spawn", slot=slot, incarnation=inc,
                pid=proc.pid)
        return replica

    # -- monitoring ---------------------------------------------------------
    def _note_ready_doc(self, replica: _Replica, raw: bytes) -> None:
        try:
            doc = json.loads(raw)
        except Exception:
            return
        if isinstance(doc, dict):
            replica.version = doc.get("version")
            replica.pinned = doc.get("pinned")

    def _probe_ready(self, replica: _Replica) -> bool:
        if replica.read_port() is None:
            return False   # not serving yet
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{replica.port}/readyz",
                    timeout=1.0) as r:
                self._note_ready_doc(replica, r.read())
                return r.status == 200
        except urllib.error.HTTPError as e:
            # a 503 (draining / still restoring) raises, but its body
            # still carries the readyz doc — per-version membership
            # keeps tracking a not-ready replica's observed version
            try:
                self._note_ready_doc(replica, e.read())
            except Exception:
                pass
            return False
        except Exception:
            return False

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            with self._lock:
                replicas = dict(self._replicas)
                target = self.target
            live = 0
            for slot, replica in replicas.items():
                rc = replica.proc.poll()
                if rc is None:
                    replica.ready = self._probe_ready(replica)
                    live += 1 if replica.ready else 0
                    continue
                # exited: classify.  Exit code 0 = the replica finished
                # its drain (preemption notice, admin drain) — DRAINED,
                # a planned event that is NEVER failure evidence
                # against the slot; anything else (SIGKILL shows as a
                # negative returncode) is a failure
                outcome = "drained" if rc == 0 else "failure"
                smetrics.inc_replica_exit(outcome)
                self.exits.append({
                    "slot": slot, "incarnation": replica.incarnation,
                    "rc": rc, "outcome": outcome,
                    "tail": replica.log_tail()})
                # the tail is captured; the dead incarnation's log file
                # must not accumulate under a respawn loop, nor may the
                # audit list grow without bound
                for path in (replica.log_path, replica.port_file):
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                if len(self.exits) > self.MAX_EXITS:
                    del self.exits[: len(self.exits) - self.MAX_EXITS]
                _flight("serving_replica_exit", slot=slot,
                        incarnation=replica.incarnation, rc=rc,
                        outcome=outcome)
                get_logger().warning(
                    "serving fleet: replica %s exited rc=%s (%s); "
                    "respawning", replica.name(), rc, outcome)
                smetrics.inc_respawn()
                if outcome == "failure":
                    # heal-at-incumbent: a crash mid-rollout is not
                    # evidence the candidate deserves more traffic —
                    # the replacement joins at the heal pin (the
                    # rollout controller sets it to the incumbent for
                    # canary slots) rather than rejoining the canary
                    with self._lock:
                        heal = self._heal_pins.get(slot)
                        if heal is not None:
                            self._pins[slot] = heal
                self._spawn(slot)
            # scale-out: spawn slots beyond the current map.  NOT a
            # respawn — planned growth must not read as crash-healing
            # on the respawns counter (hvd_serving_scale_out_total
            # already audits it)
            with self._lock:
                missing = [s for s in range(target)
                           if s not in self._replicas]
            for slot in missing:
                self._spawn(slot)
            smetrics.set_fleet_gauges(live, target)

    # -- views --------------------------------------------------------------
    def endpoints(self) -> List[Endpoint]:
        """READY endpoints — wire this as the router's endpoint
        provider.  When NO replica reads ready (a probe-starved or
        mid-heal moment), degrade to every LIVE endpoint instead of an
        empty list: an accepted request retrying against a maybe-
        overloaded replica (503s are retried) beats failing outright —
        the zero-drop guarantee outranks probe freshness."""
        with self._lock:
            ready = [r.endpoint for r in self._replicas.values()
                     if r.ready and r.proc.poll() is None]
            if ready:
                return ready
            return [r.endpoint for r in self._replicas.values()
                    if r.proc.poll() is None and r.port is not None]

    def all_endpoints(self) -> List[Endpoint]:
        with self._lock:
            return [r.endpoint for r in self._replicas.values()
                    if r.proc.poll() is None and r.port is not None]

    def live_count(self) -> int:
        """STRICTLY ready replicas — health surfaces (the front's
        /readyz, heal checks) must not inherit endpoints()'s
        degrade-to-live fallback: an alive-but-draining fleet is not
        'ready'."""
        with self._lock:
            return sum(1 for r in self._replicas.values()
                       if r.ready and r.proc.poll() is None)

    def wait_ready(self, n: int, timeout_s: float = 60.0) -> bool:
        end = time.monotonic() + timeout_s
        while time.monotonic() < end:
            with self._lock:
                replicas = list(self._replicas.values())
            ready = 0
            for r in replicas:
                if r.proc.poll() is None and self._probe_ready(r):
                    r.ready = True
                    ready += 1
            if ready >= n:
                return True
            time.sleep(0.2)
        return False

    def slots(self) -> List[int]:
        with self._lock:
            return sorted(s for s, r in self._replicas.items()
                          if r.proc.poll() is None)

    def pins(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._pins)

    def versions(self) -> Dict[int, Optional[int]]:
        """slot -> last observed serving weight version (refreshed by
        the monitor loop's readyz probes and by pin responses)."""
        with self._lock:
            return {s: r.version for s, r in self._replicas.items()
                    if r.proc.poll() is None}

    def members_by_version(self) -> Dict[Optional[int], List[Endpoint]]:
        """READY endpoints grouped by observed weight version — the
        router's version-split arms draw from this view."""
        out: Dict[Optional[int], List[Endpoint]] = {}
        with self._lock:
            for r in self._replicas.values():
                if r.ready and r.proc.poll() is None:
                    out.setdefault(r.version, []).append(r.endpoint)
        return out

    def endpoints_at(self, version: int) -> List[Endpoint]:
        """READY endpoints currently serving ``version``."""
        return self.members_by_version().get(int(version), [])

    # -- actions ------------------------------------------------------------
    def pin_slot(self, slot: int, version: Optional[int],
                 reason: str = "pin",
                 heal_version: Optional[int] = None) -> bool:
        """Pin one slot's replica to ``version`` via its ``/pin`` seam
        (``None`` unpins), and remember the pin so a respawn in the
        slot joins at the right version.  ``heal_version`` overrides
        what a replacement after a FAILURE restores: the rollout
        controller heals canary slots at the INCUMBENT — a crash
        mid-canary must shrink the canary, not re-grow it."""
        with self._lock:
            if version is None:
                self._pins.pop(slot, None)
                self._heal_pins.pop(slot, None)
            else:
                self._pins[slot] = int(version)
                self._heal_pins[slot] = int(
                    heal_version if heal_version is not None else version)
            replica = self._replicas.get(slot)
        _flight("serving_fleet_pin", slot=slot, version=version,
                reason=reason, heal_version=heal_version)
        if replica is None or replica.proc.poll() is not None \
                or replica.read_port() is None:
            return False
        body = json.dumps({"version": version, "reason": reason}).encode()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{replica.port}/pin", data=body,
                method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=10.0) as r:
                doc = json.loads(r.read())
            if isinstance(doc, dict):
                replica.version = doc.get("version")
                replica.pinned = doc.get("pinned")
            return True
        except Exception:
            get_logger().warning(
                "serving fleet: pin slot %d -> %s (%s) failed", slot,
                version, reason, exc_info=True)
            return False

    def unpin_slot(self, slot: int) -> bool:
        """Clear a slot's pin; its replica resumes chasing latest."""
        return self.pin_slot(slot, None, reason="unpin")

    def drain(self, slot: int) -> bool:
        """Ask one replica to drain (admin path; preemption notices
        reach replicas directly through the chaos/maintenance seam)."""
        with self._lock:
            replica = self._replicas.get(slot)
        if replica is None or replica.proc.poll() is not None \
                or replica.read_port() is None:
            return False
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{replica.port}/drain", data=b"{}",
                method="POST")
            urllib.request.urlopen(req, timeout=2.0)
        except Exception:
            return False
        # out of the router's view now, not at the next readiness probe
        # (the JAX fleet waits for the probe's 503)
        replica.ready = False
        return True

    def scale_out(self, n: int = 1) -> int:
        """Raise the target size (the autopilot ``scale_out`` hook).
        Returns the new target; the monitor loop spawns the slots."""
        with self._lock:
            self.target += max(1, int(n))
            target = self.target
        _flight("serving_scale_out", target=target)
        get_logger().warning("serving fleet: scaling out to %d replicas",
                             target)
        smetrics._reg().counter(
            "hvd_serving_scale_out_total",
            help="fleet scale-outs (autopilot slo_breach remediation "
                 "or manual)").inc()
        return target

    def register_autopilot_hook(self) -> None:
        """Wire this fleet as the ``scale_out`` remediation target
        (``horovod_tpu/serving/fleet.py:445-446``)."""
        from horovod_tpu_torch.autopilot import actions
        actions.register_scale_out_hook(lambda: self.scale_out(1))
