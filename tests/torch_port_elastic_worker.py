"""A trainer of the flagship for the port's launcher and elastic tests,
without JAX. The card's ``chip_smoke.py`` runs it too.

Under ``hvdrun`` (static)::

    python -m horovod_tpu_torch.runner.launch -np 2 -H localhost:2 \\
        python tests/torch_port_elastic_worker.py static --out DIR --device cpu --tiny

each rank takes ``--steps`` AdamW steps of ``make_train_step(cfg, mesh)``
over ``dp = size`` on its rows of ``entry()``'s batch (seed-0 weights,
seed-1 tokens) and writes ``DIR/static.rank<r>.json``: the identity the
launcher handed it (rank, size, rendezvous address and port, elastic
generation), its losses and the kernels' launch counts.

Under the elastic driver (``elastic``), each rank trains the same model
under ``horovod_tpu_torch.elastic.run`` with a ``TorchState`` (model,
optimizer, an ``ElasticSampler`` over a seeded corpus, the step count) and
commits after every step. A step draws each rank's ``--rows`` rows from
the sampler's remaining indices over the current world and records the
global batch (every rank's rows, gathered) as processed, so the processed
set is the same on every rank and a re-mesh repartitions exactly what is
left. Every event is a JSON line of ``DIR/events.jsonl`` (``boot``,
``step``, ``kill``, ``done``) stamped with the process's PID; rank 0
saves the state of the commit at ``--save-commit`` steps
(``commit.pt``), and the first step after a re-mesh saves its synced
gradients (``grads_healed.rank<r>.pt``). ``--kill RANK:STEP`` makes that
rank ``os._exit(1)`` right after its commit of STEP, once, and
``--kill-group RANK:STEP`` SIGKILLs the rank's process group there (a host
agent and its worker die together); ``--marker-at STEP:NAME`` makes rank 0 create ``DIR/NAME`` after that
commit (the discovery scripts of the growth and shrink tests read it).

Under the agent transport (``run_agent_elastic``), :func:`agent_payload`
is the payload (a module-level function, which ``pickle`` carries
without ``cloudpickle``): the elastic trainer, returning the rank's
``done`` record. :func:`start_local_agents` starts the host agents as
processes of this host, each in its own process group, and respawns a
lost one.

Under a fault plan (``HVD_TPU_FAULT_PLAN``) each step begins with the
chaos ``step`` seam at the committed step count (a ``tick`` event comes
just before it, so a kill's time is the killed PID's last tick). With
``--guard`` the step is the guarded overlap engine
(``make_overlap_train_step``), and a step whose ``grad`` fault the guard
skipped is a ``guard_skip`` event saying whether the parameters and the
optimizer state stayed bit-equal. ``--ckpt-every N`` makes rank 0 save the
model to ``DIR/model_ckpt`` every N steps (a waited sharded save, so an
injected ``checkpoint.write`` error is a ``ckpt`` event with ``ok`` false).
A rank whose preemption watcher published a drain notice records a
``drain_notice`` event (``at``: the notice's time). ``--until-size N``
keeps stepping past ``--steps`` until the world is N again (a drained
slot re-admitted) and ``--min-generation G`` until the world's
generation is at least G, two steps into that world, and ``--until-marker
PATH:N`` until N steps after PATH appeared, at most ``4 x --steps``. ``--local`` trains
each rank's own replica with no collective a step (rows drawn from a
seeded generator), each step inside a ``StepTimer`` with the chaos tick
in its timed window, so a stalled rank shows as the fleet's straggler.
``--outage-autopsy`` makes a rank that finds the driver unreachable at a
commit write one hang autopsy (``outage_autopsy`` event: its
``driver_outage``). ``done`` carries the rank's chaos counters and its
re-mesh episodes.
"""

import argparse
import json
import os
import signal
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CORPUS_SEED = 2


def _args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("static", "elastic"))
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None,
                    help="cpu, or cuda:<i> (every rank on that card); "
                         "default: the rank's card")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="elastic: the flagship cut to this depth")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--rows", type=int, default=8,
                    help="elastic: rows a rank takes a step")
    ap.add_argument("--corpus", type=int, default=0,
                    help="elastic: corpus rows (default: enough for "
                         "--steps at 3 ranks, or 4x that for a run that "
                         "may step on)")
    ap.add_argument("--kill", default="", help="RANK:STEP")
    ap.add_argument("--kill-group", default="",
                    help="RANK:STEP, SIGKILL to the rank's process group "
                         "(its host agent with it)")
    ap.add_argument("--marker-at", default="", help="STEP:NAME")
    ap.add_argument("--save-commit", type=int, default=-1)
    ap.add_argument("--sleep", type=float, default=0.0,
                    help="seconds after each commit")
    ap.add_argument("--guard", action="store_true",
                    help="elastic: the guarded overlap step")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="elastic: rank 0 saves the model every N steps")
    ap.add_argument("--until-size", type=int, default=0,
                    help="elastic: step on until the world has N ranks")
    ap.add_argument("--min-generation", type=int, default=0,
                    help="elastic: step on until this generation")
    ap.add_argument("--local", action="store_true",
                    help="elastic: unsynchronized local steps, timed")
    ap.add_argument("--outage-autopsy", action="store_true",
                    help="elastic: an autopsy during a driver outage")
    ap.add_argument("--until-marker", default="",
                    help="elastic: PATH:N, step on until N steps after "
                         "PATH exists")
    return ap.parse_args(argv)


def _emit(out, kind, **fields):
    rec = dict(kind=kind, pid=os.getpid(), t=time.time(), **fields)
    with open(os.path.join(out, "events.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")


def _identity():
    env = os.environ
    return {"rank": env.get("HOROVOD_RANK"), "size": env.get("HOROVOD_SIZE"),
            "local_rank": env.get("HOROVOD_LOCAL_RANK"),
            "rendezvous_addr": env.get("HVD_TPU_RENDEZVOUS_ADDR"),
            "rendezvous_port": env.get("HVD_TPU_RENDEZVOUS_PORT"),
            "gloo_rendezvous_addr": env.get("HOROVOD_GLOO_RENDEZVOUS_ADDR"),
            "generation": env.get("HVD_ELASTIC_GENERATION")}


def _launches():
    from horovod_tpu_torch.ops import attention, xent
    return {"flash_attention_fwd": attention.flash_attn_fwd_cuda.launches,
            "xent_fwd": xent.xent_fwd_cuda.launches}


def _digest(model) -> str:
    import hashlib
    h = hashlib.sha256()
    for t in model.state_dict().values():
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _opt_digest(opt) -> str:
    import hashlib

    import torch
    h = hashlib.sha256()
    for st in opt.state_dict()["state"].values():
        for k in sorted(st):
            v = st[k]
            if isinstance(v, torch.Tensor):
                h.update(v.detach().float().cpu().numpy().tobytes())
            else:
                h.update(repr(v).encode())
    return h.hexdigest()


def _chaos_record() -> dict:
    """This process's ``hvd_chaos_injected_total`` by ``seam/kind``, how
    often it armed the plan, its drain notices, its re-mesh episodes from
    the flight ring, its anomaly findings and its autopilot counters."""
    import re

    from horovod_tpu_torch.diagnostics.flight_recorder import recorder
    from horovod_tpu_torch.metrics.registry import default_registry
    snap = default_registry().snapshot()
    injected = {}
    for k, v in snap.items():
        m = re.match(r'hvd_chaos_injected_total\{kind="([^"]+)",'
                     r'seam="([^"]+)"\}', k)
        if m:
            injected[f"{m.group(2)}/{m.group(1)}"] = int(v["value"])
    episodes = [{f: e.get(f) for f in ("trigger", "total_s",
                                        "failure_detect_s", "drain_s",
                                        "rendezvous_s", "rebuild_s",
                                        "restore_s", "first_step_s",
                                        "generation", "ts")}
                for e in recorder().events()
                if e["kind"] == "remesh_complete"]
    from horovod_tpu_torch.metrics import anomaly
    findings = [{f: x.get(f) for f in ("kind", "ts", "rank", "trace")}
                for x in anomaly.recent_findings()]
    return {"injected": injected, "episodes": episodes,
            "findings": findings,
            "autopilot": {k: v["value"] for k, v in snap.items()
                          if k.startswith("hvd_autopilot_")
                          and "value" in v},
            # each arming (a rank this process held) restarts the seams'
            # invocation counters, as in the JAX package
            "armed": sum(1 for e in recorder().events()
                         if e["kind"] == "chaos_armed"),
            "drain_notices": int(sum(
                v["value"] for k, v in snap.items()
                if k.startswith("hvd_drain_notices_total")))}


def _remesh_record() -> dict:
    import re

    from horovod_tpu_torch.metrics.registry import default_registry
    snap = default_registry().snapshot()
    phases = {}
    for k, s in snap.items():
        m = re.match(r'hvd_remesh_seconds\{phase="([^"]+)"\}', k)
        if m and s.get("count", 0) > 0:
            phases[m.group(1)] = s["sum"]
    return {"total": int(snap.get("hvd_remesh_total", {}).get("value", 0)),
            "phases": phases}


def static_main(args) -> int:
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.basics import backend
    from horovod_tpu_torch.entry import entry
    from horovod_tpu_torch.models import adamw, init_opt_state, \
        make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    ident = _identity()
    hvd.init()
    _, (model, tokens, targets) = entry(device=args.device, tiny=args.tiny)
    mesh = hvd.build_mesh(dp=hvd.size())
    local = hvd.shard_batch(tokens, targets, mesh)
    opt = init_opt_state(adamw, model)
    step = make_train_step(model.cfg, mesh)
    losses = [float(step(model, opt, *local)[2]) for _ in range(args.steps)]
    res = dict(ident, hvd_rank=hvd.rank(), hvd_size=hvd.size(),
               backend=backend(), losses=losses, launches=_launches(),
               digest=_digest(model), pid=os.getpid())
    with open(os.path.join(args.out, f"static.rank{hvd.rank()}.json"),
              "w") as f:
        json.dump(res, f)
    hvd.shutdown()
    return 0


def corpus(cfg, n: int):
    """The elastic runs' data: ``n`` rows of ``max_seq`` tokens (seed
    CORPUS_SEED) and their next-token targets."""
    rng = np.random.RandomState(CORPUS_SEED)
    tokens = rng.randint(0, cfg.vocab_size, (n, cfg.max_seq)).astype(np.int64)
    return tokens, np.roll(tokens, -1, 1)


def _model(args):
    """``entry()``'s seed-0 flagship, or with ``--layers`` the same width
    cut to that depth (seed-0 weights of the cut configuration)."""
    from horovod_tpu_torch.entry import _flagship_cfg, entry
    if not args.layers:
        return entry(device=args.device, tiny=args.tiny)[1][0]
    import dataclasses

    from horovod_tpu_torch.common.basics import resolve_device
    from horovod_tpu_torch.models import Transformer, from_jax_params, \
        init_params
    cfg = dataclasses.replace(_flagship_cfg(args.tiny), n_layers=args.layers)
    model = Transformer(cfg, resolve_device(args.device))
    model.load_state_dict(from_jax_params(init_params(
        np.random.RandomState(0), cfg)))
    return model


def elastic_main(args) -> int:
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.models import adamw, init_opt_state, \
        make_train_step
    from horovod_tpu_torch.torch.elastic import ElasticSampler, TorchState
    from horovod_tpu_torch.train.optimizer import allgather_object
    torch.backends.cuda.matmul.allow_tf32 = False
    out = args.out
    hvd.init()
    _emit(out, "boot", rank=hvd.rank(), size=hvd.size(), **{
        k: v for k, v in _identity().items() if k not in ("rank", "size")})
    model = _model(args)
    dev = next(model.parameters()).device
    cfg = model.cfg
    # a run that may step past --steps (at most 4x) draws from 4x the rows
    longer = args.until_size or args.min_generation or args.until_marker
    n = args.corpus or 3 * args.rows * args.steps * (4 if longer else 1)
    tokens, targets = corpus(cfg, n)
    sampler = ElasticSampler(list(range(n)), shuffle=True, seed=0)
    opt = init_opt_state(adamw, model)
    state = TorchState(model, opt, sampler=sampler, step=0)
    kill = tuple(map(int, args.kill.split(":"))) if args.kill else None
    kill_group = tuple(map(int, args.kill_group.split(":"))) \
        if args.kill_group else None
    marker = args.marker_at.split(":", 1) if args.marker_at else None
    healed = {"pending": False}

    def on_reset():
        healed["pending"] = True

    state.register_reset_callbacks([on_reset])

    from horovod_tpu_torch import chaos
    from horovod_tpu_torch.elastic import preemption
    ckpt = None
    if args.ckpt_every and hvd.rank() == 0:
        from horovod_tpu_torch.checkpoint import (ShardedCheckpointer,
                                                  model_state)
        ckpt = ShardedCheckpointer(os.path.join(out, "model_ckpt"),
                                   rank=0, world_size=1)
    noticed = {"done": False}

    def note_drain(step) -> None:
        """A ``drain_notice`` event once this process's watcher published
        (after a step, or at exit: the drained process leaves from its
        commit)."""
        if not preemption.draining() or noticed["done"]:
            return
        from horovod_tpu_torch.diagnostics.flight_recorder import recorder
        at = [e["ts"] for e in recorder().events()
              if e["kind"] == "preemption_notice"]
        noticed["done"] = True
        # the launched rank: at exit the group is already gone
        _emit(out, "drain_notice", rank=int(os.environ.get("HOROVOD_RANK",
                                                          "-1")), step=step,
              at=at[-1] if at else None,
              counted=_chaos_record()["drain_notices"])

    import atexit
    atexit.register(lambda: note_drain(state.step))

    def loss_fn(m, batch):
        from horovod_tpu_torch.models.transformer import forward_loss_spmd
        loss, aux = forward_loss_spmd(m, batch[0], batch[1], None)
        return loss + 0.01 * aux

    def grad_fires(guarded) -> bool:
        """Will the guarded step's next call draw a grad fault?"""
        eng = chaos.engine()
        return eng is not None and any(
            r.decides_fire(eng.plan.seed, guarded._step) and not (
                r.marker and os.path.exists(
                    r.marker.replace("{rank}", str(eng.rank))))
            for r in eng.plan.rules_for("grad", eng.rank))

    seen = {}

    def finished(state) -> bool:
        if args.until_marker:
            # one verdict for every rank (each step's collectives must
            # pair): the marker is seen once any rank sees it
            path, n = args.until_marker.rsplit(":", 1)
            if any(allgather_object(os.path.exists(path))):
                seen.setdefault("at", state.step)
            if state.step < seen.get("at", 4 * args.steps) + int(n):
                return state.step >= 4 * args.steps
        if state.step < args.steps:
            return False
        if state.step >= 4 * args.steps:
            return True
        gen = int(os.environ.get("HVD_ELASTIC_GENERATION", "0"))
        if seen.get("gen") != gen:
            seen.update(gen=gen, since=state.step)
        # a world reached by a re-mesh takes two steps before the end, so
        # a re-admitted process trains too
        settled = not (args.until_size or args.min_generation) or \
            state.step - seen["since"] >= 2
        return (not args.until_size or hvd.size() == args.until_size) \
            and gen >= args.min_generation and settled

    autopsied = {"done": False}

    def keep_commit() -> None:
        """Rank 0 saves the commit of ``--save-commit`` (``commit.pt``)."""
        if hvd.rank() == 0 and state.step == args.save_commit:
            torch.save({"torch_snaps": state.torch_snaps,
                        "step": state.step}, os.path.join(out, "commit.pt"))

    @elastic.run
    def train(state):
        mesh = hvd.build_mesh(dp=hvd.size())
        if args.guard:
            step = hvd.make_overlap_train_step(loss_fn, mesh)
        elif args.local:
            from horovod_tpu_torch.train.callbacks import StepTimer
            step, timer = make_train_step(cfg), StepTimer(unit="examples")
        else:
            step = make_train_step(cfg, mesh)
        while not finished(state):
            _emit(out, "tick", rank=hvd.rank(), step=state.step)
            if args.local:
                # each rank's own rows; the tick (a stall) inside the
                # timed window, as TelemetryCallback.on_step_begin fires it
                rng = np.random.RandomState(1000 * state.step + hvd.rank())
                rows = mine = sorted(rng.choice(n, args.rows, False).tolist())
                timer.start_step()
                chaos.step_tick(state.step)
            else:
                chaos.step_tick(state.step)
                sampler.reset()
                mine = list(iter(sampler))[:args.rows]
                rows = [i for part in allgather_object(mine) for i in part]
            tok = torch.from_numpy(tokens[mine]).to(dev)
            tgt = torch.from_numpy(targets[mine]).to(dev)
            if args.guard:
                before = (_digest(model), _opt_digest(opt)) \
                    if grad_fires(step) else None
                skipped = step.skipped
                _, _, loss = step(model, opt, (tok, tgt))
                step.flush()
                if step.skipped > skipped:
                    _emit(out, "guard_skip", rank=hvd.rank(),
                          step=state.step + 1, expected=before is not None,
                          same_state=before == (_digest(model),
                                                _opt_digest(opt)))
            else:
                _, _, loss, _ = step(model, opt, tok, tgt)
            loss = float(loss)
            if args.local:
                timer.end_step(args.rows)
            if healed["pending"]:
                healed["pending"] = False
                # the first re-mesh's: a later one (a growth) keeps it
                path = os.path.join(out, f"grads_healed.rank{hvd.rank()}.pt")
                if not os.path.exists(path):
                    torch.save({k: p.grad.detach().cpu()
                                for k, p in model.named_parameters()}, path)
            if not args.local:
                sampler.record_indices(rows)
            state.step += 1
            try:
                state.commit()
            except elastic.HostsUpdatedInterrupt:
                # commit() takes its snapshot before it checks for a newer
                # world: a survivor whose check already sees the healed
                # world (the driver reaped the killed rank first) still
                # committed this step
                keep_commit()
                raise
            keep_commit()
            if args.outage_autopsy and not autopsied["done"]:
                from horovod_tpu_torch.elastic import outage
                if outage.active():
                    from horovod_tpu_torch.diagnostics.autopsy import \
                        write_autopsy
                    bundle = write_autopsy(
                        os.path.join(out, f"outage_rank{hvd.rank()}"),
                        reason="driver_outage", fetch_peers=False)
                    summary = [f for f in os.listdir(bundle)
                               if f.startswith("summary_rank")]
                    with open(os.path.join(bundle, summary[0])) as f:
                        doc = json.load(f)
                    autopsied["done"] = True
                    _emit(out, "outage_autopsy", rank=hvd.rank(),
                          step=state.step,
                          driver_outage=doc["driver_outage"])
            _emit(out, "step", rank=hvd.rank(), size=hvd.size(),
                  step=state.step, loss=loss, rows=rows,
                  generation=os.environ.get("HVD_ELASTIC_GENERATION"))
            if marker and hvd.rank() == 0 and state.step == int(marker[0]):
                open(os.path.join(out, marker[1]), "w").close()
            once = os.path.join(out, "killed_once")
            if kill and (hvd.rank(), state.step) == kill and \
                    not os.path.exists(once):
                open(once, "w").close()
                _emit(out, "kill", rank=hvd.rank(), step=state.step)
                os._exit(1)
            if kill_group and (hvd.rank(), state.step) == kill_group and \
                    not os.path.exists(once):
                open(once, "w").close()
                _emit(out, "kill", rank=hvd.rank(), step=state.step,
                      group=True)
                os.killpg(os.getpgid(0), signal.SIGKILL)
            if ckpt is not None and state.step % args.ckpt_every == 0:
                try:
                    ckpt.save(state.step, {"model": model_state(model)},
                              wait=True)
                    _emit(out, "ckpt", step=state.step, ok=True)
                except OSError as e:
                    _emit(out, "ckpt", step=state.step, ok=False,
                          error=str(e))
            note_drain(state.step)
            if args.sleep:
                time.sleep(args.sleep)

    train(state)
    if ckpt is not None:
        ckpt.close()
    _emit(out, "done", rank=hvd.rank(), size=hvd.size(), step=state.step,
          digest=_digest(model), remesh=_remesh_record(),
          launches=_launches(), chaos=_chaos_record(),
          generation=os.environ.get("HVD_ELASTIC_GENERATION"))
    hvd.shutdown()
    return 0


def soak_plan(out) -> dict:
    """The compound plan of the chaos soak (the CPU test's and
    ``chip_smoke.py``'s ``[chaos_soak]``): a grad NaN at guarded step 2
    on every rank, one checkpoint write error on rank 0, a KV blackout over
    each arming's first two requests, and rank 1 killed at step 3, each
    rank once (``{rank}`` markers under ``out``)."""
    return {"seed": 7, "faults": [
        {"seam": "grad", "kind": "nan", "start": 2, "stop": 3,
         "marker": os.path.join(str(out), "nan_{rank}")},
        {"seam": "checkpoint.write", "kind": "io_error", "rank": 0,
         "count": 1},
        {"seam": "kv.request", "kind": "blackout", "start": 0, "stop": 2},
        {"seam": "step", "kind": "kill", "rank": 1, "start": 3, "stop": 4,
         "marker": os.path.join(str(out), "killed_{rank}")}]}


def agent_payload(argv) -> dict:
    """The elastic trainer (``elastic`` and ``argv``) as an agent
    transport payload: returns this rank's ``done`` record."""
    args = _args(["elastic", *map(str, argv)])
    elastic_main(args)
    return [e for e in events(args.out)
            if e["kind"] == "done" and e["pid"] == os.getpid()][-1]


_AGENT_MAIN = ("import json, sys\n"
               "from horovod_tpu_torch.runner.elastic.agent import "
               "agent_loop\n"
               "agent_loop(**json.loads(sys.stdin.readline()))\n")


def start_local_agents(ctx: dict, n: int, env=None, host=None,
                       hold=lambda: False, stats=None):
    """``start_agents`` for ``run_agent_elastic``: ``n`` host agents as
    processes of this host (each the leader of its own process group, its
    secrets on stdin), registering under ``host`` (default: the
    hostname). A thread respawns a lost agent, under the next ordinal,
    once its heartbeat has gone stale and ``hold()`` is false (as
    ``ElasticRayExecutor``'s respawner tops the registry up). Returns
    once all ``n`` have registered. ``stats``
    (a dict) gets ``stale_at``: when the lost agent's heartbeat was seen
    stale, ``respawned_at``, and ``pgids``: every agent's process group.
    Returns the cleanup callable."""
    import subprocess
    import threading

    from horovod_tpu_torch.runner.elastic.agent import STALE_S
    kv = ctx["kv"]
    wenv = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]), **(env or {}))
    procs, stop = [], threading.Event()
    stats = {} if stats is None else stats

    def spawn():
        p = subprocess.Popen([sys.executable, "-c", _AGENT_MAIN],
                             stdin=subprocess.PIPE, env=wenv, cwd=REPO,
                             start_new_session=True, text=True)
        p.stdin.write(json.dumps(dict(
            ordinal=len(procs), kv_addr="127.0.0.1", kv_port=ctx["kv_port"],
            secret_hex=ctx["secret_hex"],
            world_secret_hex=ctx["world_secret_hex"], host=host)) + "\n")
        p.stdin.close()
        procs.append(p)
        stats.setdefault("pgids", []).append(p.pid)

    def fresh() -> int:
        return sum(time.time() - json.loads(b)["ts"] < STALE_S
                   for b in kv.scope("agents").values())

    def respawner():
        while not stop.wait(0.1):
            lost = sum(p.poll() is not None for p in procs)
            if lost and fresh() < n:
                stats.setdefault("stale_at", time.time())
                if not hold() and len(procs) < n + lost:
                    spawn()
                    stats["respawned_at"] = time.time()

    for _ in range(n):
        spawn()
    # the first world is all n: the driver starts once min_np registered
    deadline = time.time() + 120
    while len(kv.scope("agents")) < n:
        if time.time() > deadline or any(p.poll() is not None
                                         for p in procs):
            raise RuntimeError(f"{len(kv.scope('agents'))} of {n} host "
                               f"agents registered")
        time.sleep(0.05)
    th = threading.Thread(target=respawner, daemon=True)
    th.start()

    def cleanup():
        stop.set()
        th.join(10)
        for p in procs:   # shutdown is posted: the loops return
            try:
                p.wait(10)
            except subprocess.TimeoutExpired:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    return cleanup


def events(out) -> list:
    """The JSON lines of ``out/events.jsonl``, in order."""
    with open(os.path.join(out, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def command(out, *extra) -> list:
    """This program's elastic command line, writing to ``out``."""
    return [sys.executable, os.path.abspath(__file__), "elastic", "--out",
            str(out), *map(str, extra)]


def kill_live_workers(state) -> list:
    """SIGKILL the process group of every worker that the journal
    ``state`` records as live and that is still the process the driver
    spawned (its pid and start time): a pid whose worker has ended may
    name another test's process by now. Returns the pids signalled."""
    from horovod_tpu_torch.runner.safe_exec import kill_group_of
    return [rec["pid"] for rec in state.live.values()
            if rec.get("pid") is not None and
            kill_group_of(int(rec["pid"]), rec.get("start"), signal.SIGKILL)]


def run_driver(discovery, cmd, out, min_np=2, max_np=3, env=None,
               timeout=120.0, **driver_kw):
    """Run an ``ElasticDriver`` over ``discovery`` in a thread of this
    process (checkpoints under ``out/ckpt``, the journal under
    ``out/journal``) and return ``(rc, driver, seconds)``. Past
    ``timeout`` every worker the journal records is killed and the call
    fails."""
    import threading

    from horovod_tpu_torch.runner.elastic import journal
    from horovod_tpu_torch.runner.elastic.driver import ElasticDriver
    wenv = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                HOROVOD_TPU_OPERATIONS="GLOO")
    wenv.update(env or {})
    driver = ElasticDriver(discovery, cmd, min_np=min_np, max_np=max_np,
                           env=wenv, ckpt_dir=os.path.join(out, "ckpt"),
                           journal_dir=os.path.join(out, "journal"),
                           **driver_kw)
    box = {}
    t0 = time.monotonic()
    th = threading.Thread(target=lambda: box.setdefault("rc", driver.run()),
                          daemon=True)
    th.start()
    th.join(timeout)
    if th.is_alive():
        kill_live_workers(journal.load(os.path.join(
            out, "journal", journal.JOURNAL_NAME)))
        th.join(30)
        raise AssertionError(f"the elastic driver outlived {timeout} s")
    return box.get("rc"), driver, time.monotonic() - t0


if __name__ == "__main__":
    a = _args(sys.argv[1:])
    sys.exit(static_main(a) if a.mode == "static" else elastic_main(a))
