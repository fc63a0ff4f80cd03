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
rank ``os._exit(1)`` right after its commit of STEP, once;
``--marker-at STEP:NAME`` makes rank 0 create ``DIR/NAME`` after that
commit (the discovery scripts of the growth and shrink tests read it).
"""

import argparse
import json
import os
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
                         "--steps at 3 ranks)")
    ap.add_argument("--kill", default="", help="RANK:STEP")
    ap.add_argument("--marker-at", default="", help="STEP:NAME")
    ap.add_argument("--save-commit", type=int, default=-1)
    ap.add_argument("--sleep", type=float, default=0.0,
                    help="seconds after each commit")
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
    n = args.corpus or 3 * args.rows * args.steps
    tokens, targets = corpus(cfg, n)
    sampler = ElasticSampler(list(range(n)), shuffle=True, seed=0)
    opt = init_opt_state(adamw, model)
    state = TorchState(model, opt, sampler=sampler, step=0)
    kill = tuple(map(int, args.kill.split(":"))) if args.kill else None
    marker = args.marker_at.split(":", 1) if args.marker_at else None
    healed = {"pending": False}

    def on_reset():
        healed["pending"] = True

    state.register_reset_callbacks([on_reset])

    @elastic.run
    def train(state):
        mesh = hvd.build_mesh(dp=hvd.size())
        step = make_train_step(cfg, mesh)
        while state.step < args.steps:
            sampler.reset()
            mine = list(iter(sampler))[:args.rows]
            rows = [i for part in allgather_object(mine) for i in part]
            tok = torch.from_numpy(tokens[mine]).to(dev)
            tgt = torch.from_numpy(targets[mine]).to(dev)
            _, _, loss, _ = step(model, opt, tok, tgt)
            loss = float(loss)
            if healed["pending"]:
                healed["pending"] = False
                torch.save({k: p.grad.detach().cpu()
                            for k, p in model.named_parameters()},
                           os.path.join(out, f"grads_healed.rank"
                                        f"{hvd.rank()}.pt"))
            sampler.record_indices(rows)
            state.step += 1
            state.commit()
            _emit(out, "step", rank=hvd.rank(), size=hvd.size(),
                  step=state.step, loss=loss, rows=rows,
                  generation=os.environ.get("HVD_ELASTIC_GENERATION"))
            if hvd.rank() == 0 and state.step == args.save_commit:
                torch.save({"torch_snaps": state.torch_snaps,
                            "step": state.step},
                           os.path.join(out, "commit.pt"))
            if marker and hvd.rank() == 0 and state.step == int(marker[0]):
                open(os.path.join(out, marker[1]), "w").close()
            once = os.path.join(out, "killed_once")
            if kill and (hvd.rank(), state.step) == kill and \
                    not os.path.exists(once):
                open(once, "w").close()
                _emit(out, "kill", rank=hvd.rank(), step=state.step)
                os._exit(1)
            if args.sleep:
                time.sleep(args.sleep)

    train(state)
    _emit(out, "done", rank=hvd.rank(), size=hvd.size(), step=state.step,
          digest=_digest(model), remesh=_remesh_record(),
          launches=_launches(),
          generation=os.environ.get("HVD_ELASTIC_GENERATION"))
    hvd.shutdown()
    return 0


def events(out) -> list:
    """The JSON lines of ``out/events.jsonl``, in order."""
    with open(os.path.join(out, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def command(out, *extra) -> list:
    """This program's elastic command line, writing to ``out``."""
    return [sys.executable, os.path.abspath(__file__), "elastic", "--out",
            str(out), *map(str, extra)]


def run_driver(discovery, cmd, out, min_np=2, max_np=3, env=None,
               timeout=120.0, **driver_kw):
    """Run an ``ElasticDriver`` over ``discovery`` in a thread of this
    process (checkpoints under ``out/ckpt``, the journal under
    ``out/journal``) and return ``(rc, driver, seconds)``. Past
    ``timeout`` every worker the journal records is killed and the call
    fails."""
    import signal
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
        state = journal.load(os.path.join(out, "journal",
                                          journal.JOURNAL_NAME))
        for rec in state.live.values():
            try:
                os.killpg(os.getpgid(int(rec["pid"])), signal.SIGKILL)
            except (ProcessLookupError, TypeError, ValueError):
                pass
        th.join(30)
        raise AssertionError(f"the elastic driver outlived {timeout} s")
    return box.get("rc"), driver, time.monotonic() - t0


if __name__ == "__main__":
    a = _args(sys.argv[1:])
    sys.exit(static_main(a) if a.mode == "static" else elastic_main(a))
