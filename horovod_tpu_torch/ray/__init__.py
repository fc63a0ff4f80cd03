"""Ray cluster integration.

A copy of ``horovod_tpu/ray/__init__.py`` (reference:
``horovod/ray/runner.py`` — ``RayExecutor`` creates a placement group of
workers, a Coordinator collects each worker's host/rank info into env
vars, then all workers run the user fn (:41-360); elastic variant with
``RayHostDiscovery``, ``ray/elastic.py:38-149``). Each actor is one
worker process of the port: it drives one card (``cuda:<local_rank>``,
the local rank counted among the actors on its node) under an NCCL world,
or the CPU under gloo where it has no card. ``ElasticRayExecutor.run(fn)``
rides the agent transport (:mod:`horovod_tpu_torch.runner.elastic.agent`).

Importing it needs no ray: the executors check for it when built.
"""

from __future__ import annotations

import socket
from typing import Any, Callable, Dict, List, Optional


def _require_ray():
    try:
        import ray
        return ray
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.ray requires the ray package, which is not "
            "installed in this environment. Install ray to use Ray-cluster "
            "launching; the rest of horovod_tpu_torch works without it."
        ) from e


class RayExecutor:
    """Reference: ``RayExecutor`` (``ray/runner.py:128-360``): start
    num_workers actors, coordinate env, run fns on all workers."""

    def __init__(self, num_workers: int = 1, cpus_per_worker: int = 1,
                 use_current_placement_group: bool = False,
                 env: Optional[Dict[str, str]] = None) -> None:
        self._ray = _require_ray()
        self.num_workers = num_workers
        self.cpus_per_worker = cpus_per_worker
        self._env = dict(env or {})
        self._workers: List[Any] = []
        self._has_executable = False

    def start(self, executable_cls=None, executable_args=None,
              executable_kwargs=None) -> None:
        """Spin up the worker actors and wire the coordinator; with
        ``executable_cls``, also instantiate it on every worker for
        ``execute``/``execute_single`` (reference: ``RayExecutor.start``,
        ``ray/runner.py:250-280``)."""
        ray = self._ray
        self._has_executable = False  # a restart may drop the executable

        @ray.remote(num_cpus=self.cpus_per_worker)
        class _Worker:
            def __init__(self, rank: int, size: int,
                         base_env: Dict[str, str]) -> None:
                import os
                self.rank = rank
                self._held = None
                os.environ.update(base_env)
                os.environ.update({
                    "HOROVOD_RANK": str(rank),
                    "HOROVOD_SIZE": str(size),
                })

            def hostname(self) -> str:
                return socket.gethostname()

            def pick_free_port(self) -> int:
                # held until this worker's store binds it (hvd.init)
                from horovod_tpu_torch.runner.exec_run import reserve_port
                self._held = reserve_port()
                return self._held.getsockname()[1]

            def set_coordinator(self, addr: str, port: int,
                                local_rank: int, local_size: int) -> None:
                import os
                for k in ("HVD_TPU_COORD_ADDR", "HVD_TPU_RENDEZVOUS_ADDR",
                          "HOROVOD_GLOO_RENDEZVOUS_ADDR"):
                    os.environ[k] = addr
                for k in ("HVD_TPU_COORD_PORT", "HVD_TPU_RENDEZVOUS_PORT",
                          "HOROVOD_GLOO_RENDEZVOUS_PORT"):
                    os.environ[k] = str(port)
                os.environ["HOROVOD_LOCAL_RANK"] = str(local_rank)
                os.environ["HOROVOD_LOCAL_SIZE"] = str(local_size)

            def _init(self) -> None:
                import horovod_tpu_torch as hvd
                try:
                    hvd.init()
                finally:
                    if self._held is not None:
                        self._held.close()
                        self._held = None

            def execute(self, fn_blob: bytes):
                from horovod_tpu_torch.common import payload
                fn, args, kwargs = payload.loads(fn_blob)
                self._init()
                # return the VALUE (ray serializes it): run_remote futures
                # must resolve to results, reference-style
                return fn(*args, **kwargs)

            def make_executable(self, blob: bytes) -> None:
                # reference: start(executable_cls=...) instantiates the
                # user's class on every worker (ray/runner.py:250-280)
                from horovod_tpu_torch.common import payload
                cls, a, k = payload.loads(blob)
                self._init()
                self.executable = cls(*a, **k)

            def execute_obj(self, fn_blob: bytes):
                from horovod_tpu_torch.common import payload
                fn = payload.loads(fn_blob)
                return fn(self.executable)

            def shutdown(self) -> None:
                import horovod_tpu_torch as hvd
                hvd.shutdown()

        self._workers = [
            _Worker.remote(r, self.num_workers, self._env)
            for r in range(self.num_workers)]
        # coordinator = rank 0's host (reference: Coordinator collecting
        # host info, ray/runner.py:41-128)
        from horovod_tpu_torch.common import payload
        hosts = ray.get([w.hostname.remote() for w in self._workers])
        # the rendezvous store binds on rank 0's host, so pick the port
        # THERE
        port = ray.get(self._workers[0].pick_free_port.remote())
        ray.get([w.set_coordinator.remote(
            hosts[0], port, hosts[:r].count(hosts[r]), hosts.count(hosts[r]))
            for r, w in enumerate(self._workers)])
        if executable_cls is not None:
            blob = payload.dumps((executable_cls,
                                  tuple(executable_args or ()),
                                  dict(executable_kwargs or {})))
            ray.get([w.make_executable.remote(blob)
                     for w in self._workers])
            self._has_executable = True

    def _require_started(self, need_executable: bool = False) -> None:
        if not self._workers:
            raise ValueError("RayExecutor: call start() first")
        if need_executable and not self._has_executable:
            raise ValueError(
                "RayExecutor: call start(executable_cls=...) first")

    def run_remote(self, fn: Callable, args: tuple = (),
                   kwargs: Optional[dict] = None) -> List[Any]:
        """Async variant (reference: ``run_remote``, ``ray/runner.py:312``):
        one future per worker; ``ray.get`` resolves them to the fns'
        return values."""
        from horovod_tpu_torch.common import payload
        self._require_started()
        blob = payload.dumps((fn, args, kwargs or {}))
        return [w.execute.remote(blob) for w in self._workers]

    def run(self, fn: Callable, args: tuple = (),
            kwargs: Optional[dict] = None) -> List[Any]:
        return self._ray.get(self.run_remote(fn, args, kwargs))

    def execute(self, fn: Callable) -> List[Any]:
        """Apply ``fn(executable)`` on every worker (reference:
        ``RayExecutor.execute``, ``ray/runner.py:281``); requires
        ``start(executable_cls=...)``."""
        from horovod_tpu_torch.common import payload
        self._require_started(need_executable=True)
        blob = payload.dumps(fn)
        return self._ray.get([w.execute_obj.remote(blob)
                              for w in self._workers])

    def execute_single(self, fn: Callable) -> Any:
        """Apply ``fn(executable)`` on the rank-0 worker only (reference:
        ``execute_single``, ``ray/runner.py:332``)."""
        from horovod_tpu_torch.common import payload
        self._require_started(need_executable=True)
        blob = payload.dumps(fn)
        return self._ray.get(self._workers[0].execute_obj.remote(blob))

    def shutdown(self) -> None:
        ray = self._ray
        if self._workers:
            ray.get([w.shutdown.remote() for w in self._workers])
            for w in self._workers:
                ray.kill(w)
            self._workers = []


class RayHostDiscovery:
    """Host discovery over a live Ray cluster for the elastic driver
    (reference: ``RayHostDiscovery``, ``ray/elastic.py:38-88``): available
    hosts are Ray nodes with enough free CPUs for a worker slot."""

    def __init__(self, cpus_per_slot: int = 1) -> None:
        self._ray = _require_ray()
        self._cpus = cpus_per_slot

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        ray = self._ray
        hosts: Dict[str, int] = {}
        for node in ray.nodes():
            if not node.get("Alive"):
                continue
            cpus = int(node.get("Resources", {}).get("CPU", 0))
            slots = cpus // max(self._cpus, 1)
            if slots > 0:
                hosts[node["NodeManagerAddress"]] = slots
        return hosts


class ElasticRayExecutor:
    """Elastic executor over Ray (reference: ``ElasticRayExecutor``,
    ``ray/elastic.py:149+``). Two modes, matching the reference's two
    deployment styles:

    - ``run()`` with a ``command``: the generation-based elastic driver
      with Ray-node discovery; workers launch via ssh to Ray nodes.
    - ``run(fn)``: reference-style in-cluster execution — Ray actors host
      the shared agent transport (:mod:`horovod_tpu_torch.runner.elastic.agent`)
      and the driver execs workers through them, no ssh; per-rank results
      of the completed generation are returned.

    Gated on ray availability."""

    def __init__(self, command=None, min_np: int = 1,
                 max_np: Optional[int] = None,
                 cpus_per_slot: int = 1, env: Optional[Dict[str, str]] = None,
                 reset_limit: Optional[int] = None) -> None:
        _require_ray()
        self._discovery = RayHostDiscovery(cpus_per_slot)
        self._command = command
        self._cpus = cpus_per_slot
        self._min_np = min_np
        self._max_np = max_np
        self._env = env
        self._reset_limit = reset_limit

    def start(self) -> None:
        """Reference API shape (``ElasticRayExecutor.start``): agents are
        created lazily by ``run(fn)``, so this only validates ray."""
        _require_ray()

    def run(self, fn: Optional[Callable] = None, args: tuple = (),
            kwargs: Optional[dict] = None):
        if fn is None:
            if self._command is None:
                raise ValueError("ElasticRayExecutor.run() needs either a "
                                 "constructor command or a fn argument")
            from horovod_tpu_torch.runner.elastic.driver import ElasticDriver
            driver = ElasticDriver(self._discovery, self._command,
                                   min_np=self._min_np,
                                   max_np=self._max_np,
                                   env=self._env,
                                   reset_limit=self._reset_limit)
            return driver.run()
        return self._run_fn(fn, args, kwargs)

    def _run_fn(self, fn: Callable, args: tuple, kwargs: Optional[dict]):
        import time as _time
        ray = _require_ray()
        from horovod_tpu_torch.runner.elastic.agent import run_agent_elastic

        @ray.remote(num_cpus=self._cpus)
        class _AgentActor:
            def run_agent(self, ordinal, kv_addr, kv_port, secret_hex,
                          world_secret_hex):
                from horovod_tpu_torch.runner.elastic.agent import (
                    agent_loop, resolve_kv_addr)
                agent_loop(int(ordinal), resolve_kv_addr(kv_addr),
                           kv_port, secret_hex, world_secret_hex)
                return True

        def start_agents(ctx):
            import json as _json
            import threading
            from horovod_tpu_torch.runner.elastic.agent import STALE_S

            kv = ctx["kv"]  # in-process server handle (driver side)
            port = ctx["kv_port"]
            actors = []
            stop = threading.Event()
            next_ordinal = [0]

            def spawn():
                a = _AgentActor.remote()
                a.run_agent.remote(next_ordinal[0], ctx["kv_addr"], port,
                                   ctx["secret_hex"],
                                   ctx["world_secret_hex"])
                next_ordinal[0] += 1
                actors.append(a)

            for _ in range(ctx["max_np"]):
                spawn()

            def fresh_agent_count():
                n = 0
                for blob in kv.scope("agents").values():
                    if _time.time() - _json.loads(blob)["ts"] < STALE_S:
                        n += 1
                return n

            def respawner():
                # Ray actors are not auto-restarted (unlike Spark task
                # retry): top the registry back up to max_np when actor
                # loss shrinks it, so the driver can grow back. Bounded:
                # a replacement that never registers (no capacity, node
                # permanently gone) must not turn into an unbounded
                # stream of pending actors
                budget = 4 * ctx["max_np"]
                misses = 0
                while not stop.wait(5.0):
                    misses = misses + 1 \
                        if fresh_agent_count() < ctx["max_np"] else 0
                    if misses >= 2 and budget > 0:
                        spawn()
                        budget -= 1
                        misses = -4  # cooldown: let the replacement land

            mon = threading.Thread(target=respawner, daemon=True)
            mon.start()

            def cleanup():
                stop.set()
                mon.join(timeout=10)
                # shutdown is already posted; give loops one poll cycle to
                # exit cleanly, then reclaim the actors
                _time.sleep(1.0)
                for a in actors:
                    ray.kill(a)
            return cleanup

        return run_agent_elastic(
            start_agents, fn, args, kwargs,
            num_proc=self._max_np or self._min_np, min_np=self._min_np,
            max_np=self._max_np, env=self._env,
            reset_limit=self._reset_limit)
