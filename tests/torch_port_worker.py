"""Gloo worlds of the port's multi-process tests, without JAX: the
spawner (:func:`spawn_world`) and a worker's entry (:func:`worker_main`,
one rank running a group of cases and saving its arrays). The card tests
use them on a machine that has no JAX."""

import os
import signal
import socket
import subprocess
import sys
import time

_T0 = time.monotonic()

import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the messages of a rendezvous whose port another process took (torch's
# TCPStore: "EADDRINUSE ... address already in use")
_PORT_TAKEN = ("eaddrinuse", "address already in use")


def reserve_port() -> socket.socket:
    """A free port, held: a socket bound to it with ``SO_REUSEADDR`` and
    not listening, kept open while the world runs. Rank 0's TCP store
    (``SO_REUSEADDR`` too) can still bind and listen on it, while the
    kernel gives it to no other ``bind(0)`` or outgoing connection, so no
    other test's socket can take it between the pick and rank 0's bind."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    return s


def reserve_ports(n: int):
    """``n`` consecutive free ports, held as :func:`reserve_port` holds
    one (bound with ``SO_REUSEADDR``, not listening) until the caller
    closes the returned sockets: a world's exporters bind ``base +
    local_rank`` over them, and no other socket of the machine takes one
    in between. Returns ``(base, sockets)``."""
    for _ in range(100):
        first = reserve_port()
        base = first.getsockname()[1]
        socks = [first]
        try:
            for i in range(1, n):
                s = socket.socket()
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                socks.append(s)
                s.bind(("127.0.0.1", base + i))
            return base, socks
        except (OSError, OverflowError):
            for s in socks:
                s.close()
    raise RuntimeError(f"no block of {n} free ports")


def spawn_world(script: str, group: str, n: int, out_dir, extra_env=None,
                timeout: float = 150):
    """Run the worker ``group`` of ``script`` (``script --worker GROUP
    --out DIR``) as a gloo world of ``n`` processes and return each rank's
    results (dicts of arrays). A rank that fails or outlives ``timeout``
    fails the call, with every rank's log tail (each rank logs its start,
    init and finish times); once one rank has failed the others are
    killed at once, and every process of the world is killed on the way
    out. A rendezvous whose port was taken is started again, once."""
    try:
        return _spawn(group, n, str(out_dir), extra_env, timeout, script)
    except AssertionError as e:
        if not any(m in str(e).lower() for m in _PORT_TAKEN):
            raise
        return _spawn(group, n, str(out_dir), extra_env, timeout, script)


def _spawn(group, n, out_dir, extra_env, timeout, script):
    reserved = reserve_port()
    port = reserved.getsockname()[1]
    procs, logs = [], []
    t0 = time.monotonic()
    try:
        for r in range(n):
            env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
                       HVD_TPU_RANK=str(r), HVD_TPU_SIZE=str(n),
                       HVD_TPU_LOCAL_RANK=str(r), HVD_TPU_LOCAL_SIZE=str(n),
                       HVD_TPU_CROSS_RANK="0", HVD_TPU_CROSS_SIZE="1",
                       HVD_TPU_RENDEZVOUS_ADDR="127.0.0.1",
                       HVD_TPU_RENDEZVOUS_PORT=str(port),
                       HVD_TPU_GLOO_TIMEOUT_SECONDS=str(timeout),
                       OMP_NUM_THREADS="1")
            env.update(extra_env(r) if callable(extra_env)
                       else extra_env or {})
            log = open(os.path.join(out_dir, f"{group}.rank{r}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(script), "--worker", group,
                 "--out", out_dir], env=env, cwd=REPO, stdout=log,
                stderr=subprocess.STDOUT, start_new_session=True))
        # wait for all; the first rank to fail ends the world
        while time.monotonic() - t0 < timeout:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or \
                    any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.05)
    finally:
        reserved.close()
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            os.killpg(p.pid, signal.SIGKILL)
        for p in hung:
            p.wait(timeout=30)
    wall = time.monotonic() - t0
    texts = []
    for log in logs:
        log.seek(0)
        texts.append(log.read())
        log.close()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(
            f"worker group {group!r} failed after {wall:.1f} s (timeout "
            f"{timeout} s, port {port}):\n" + "\n".join(
                f"rank {r} exit {p.returncode}"
                f"{' (killed)' if p in hung else ''}:\n{text[-3000:]}"
                for r, (p, text) in enumerate(zip(procs, texts))))
    return [dict(np.load(os.path.join(out_dir, f"{group}.rank{r}.npz")))
            for r in range(n)]


def log_time(what: str) -> None:
    """One line of a rank's log: seconds since the process started."""
    print(f"[worker] {what} at {time.monotonic() - _T0:.2f} s", flush=True)


def leave(hvd) -> None:
    """End a rank whose results are saved: wait at a barrier until every
    rank has run its cases (a rank that left while another still set up a
    group with it reset that rank's connection), destroy the process
    group, and exit without the interpreter's teardown: torch's gloo
    threads have aborted a rank there ("terminate called without an
    active exception", about one 4-rank world in 30 on a loaded box),
    failing a world whose every result was already on disk."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
    hvd.shutdown()
    log_time("shut down")
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def worker_main(workers, argv) -> int:
    """``--worker GROUP --out DIR``: one rank of a gloo world (the
    launcher's identity in the environment) runs ``workers[GROUP]`` and
    saves its arrays to ``DIR/GROUP.rank<r>.npz``."""
    import argparse

    import torch

    import horovod_tpu_torch as hvd
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", choices=sorted(workers), required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    log_time("imported")
    hvd.init()
    log_time("initialized")
    res = workers[args.worker]()
    log_time("ran its cases")
    assert not [m for m in sys.modules if m.split(".")[0] in
                ("jax", "jaxlib", "horovod_tpu")], "a worker imported JAX"
    np.savez(os.path.join(args.out, f"{args.worker}.rank{hvd.rank()}.npz"),
             **res)
    leave(hvd)
