"""Gloo worlds of the port's multi-process tests, without JAX: the
spawner (:func:`spawn_world`) and a worker's entry (:func:`worker_main`,
one rank running a group of cases and saving its arrays). The card tests
use them on a machine that has no JAX."""

import os
import signal
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_world(script: str, group: str, n: int, out_dir, extra_env=None,
                timeout: float = 150):
    """Run the worker ``group`` of ``script`` (``script --worker GROUP
    --out DIR``) as a gloo world of ``n`` processes and return each rank's
    results (dicts of arrays). A rank that fails or outlives ``timeout``
    fails the call; every process of the world is killed on the way out. A
    rendezvous port taken between its pick and rank 0's bind is picked
    again, once."""
    try:
        return _spawn(group, n, str(out_dir), extra_env, timeout, script)
    except AssertionError as e:
        if "Address already in use" not in str(e):
            raise
        return _spawn(group, n, str(out_dir), extra_env, timeout, script)


def _spawn(group, n, out_dir, extra_env, timeout, script):
    port = _free_port()
    procs, logs = [], []
    for r in range(n):
        env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
                   HVD_TPU_RANK=str(r), HVD_TPU_SIZE=str(n),
                   HVD_TPU_LOCAL_RANK=str(r), HVD_TPU_LOCAL_SIZE=str(n),
                   HVD_TPU_CROSS_RANK="0", HVD_TPU_CROSS_SIZE="1",
                   HVD_TPU_RENDEZVOUS_ADDR="127.0.0.1",
                   HVD_TPU_RENDEZVOUS_PORT=str(port),
                   HVD_TPU_GLOO_TIMEOUT_SECONDS=str(timeout),
                   OMP_NUM_THREADS="1")
        env.update(extra_env(r) if callable(extra_env) else extra_env or {})
        log = open(os.path.join(out_dir, f"{group}.rank{r}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(script), "--worker", group,
             "--out", out_dir], env=env, cwd=REPO, stdout=log,
            stderr=subprocess.STDOUT, start_new_session=True))
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            os.killpg(p.pid, signal.SIGKILL)
        for p in hung:
            p.wait(timeout=30)
    failed = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        if p.returncode != 0:
            failed.append(f"rank {r} exit {p.returncode}:\n{text[-3000:]}")
    if failed:
        raise AssertionError(f"worker group {group!r} failed (timeout "
                             f"{timeout} s):\n" + "\n".join(failed))
    return [dict(np.load(os.path.join(out_dir, f"{group}.rank{r}.npz")))
            for r in range(n)]




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
    hvd.init()
    res = workers[args.worker]()
    assert not [m for m in sys.modules if m.split(".")[0] in
                ("jax", "jaxlib", "horovod_tpu")], "a worker imported JAX"
    np.savez(os.path.join(args.out, f"{args.worker}.rank{hvd.rank()}.npz"),
             **res)
    hvd.shutdown()
    return 0
