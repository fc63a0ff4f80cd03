"""One rank of a world driving a native core directly, the same operations
on the same seeded inputs in either package: ``--pkg jax`` runs the JAX
package's ``CoreBackend`` over numpy arrays (its own ``libhvdcore``),
``--pkg port`` the port's over torch tensors (the port's build of the same
``cpp/`` sources), and ``--pkg dist`` the port's ``torch.distributed``
plane over a gloo world (``init()`` with ``HVD_TPU_EAGER_BACKEND=dist``;
no join, which that plane refuses). Each rank saves every result's bytes to
``DIR/<pkg>.rank<r>.npz``, so the two packages' results compare bit for
bit. Launched with the core's identity in the environment
(``HOROVOD_RANK``/``SIZE``, ``HVD_TPU_COORD_ADDR``/``PORT``) by
``test_torch_port_core.py``."""

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FLOATS = ("float32", "float64", "float16", "bfloat16")
INTS = ("int32", "int64", "uint8", "int8")
SUM, AVG, ADASUM, MIN, MAX, PRODUCT = 1, 0, 2, 3, 4, 5


def make(dt: str, shape, seed: int, rank: int) -> np.ndarray:
    """A seeded input as numpy (bf16 as its uint16 bits, which each
    package views as its own bf16)."""
    rng = np.random.RandomState(seed * 100 + rank)
    if dt in FLOATS:
        x = np.asarray(rng.randn(*shape))
        if dt == "bfloat16":
            f = x.astype(np.float32).view(np.uint32)
            return np.asarray((f + 0x7FFF + ((f >> 16) & 1)) >> 16,
                              np.uint16)
        return np.asarray(x, dt)
    if dt == "bool":
        return np.asarray(rng.randint(0, 2, size=shape)).astype(np.bool_)
    lo = 0 if dt == "uint8" else -9
    return np.asarray(rng.randint(lo, 10, size=shape)).astype(dt)


def cases(rank: int, size: int):
    """``(key, kind, inputs, args)`` in submission order, the same on
    every rank (inputs differ by rank)."""
    out = []
    seed = 0
    for dt in FLOATS + INTS:
        seed += 1
        ops = [("sum", SUM, 1.0, 1.0), ("min", MIN, 1.0, 1.0),
               ("max", MAX, 1.0, 1.0), ("prod", PRODUCT, 1.0, 1.0)]
        if dt in FLOATS:
            ops += [("avg", AVG, 1.0, 1.0), ("scaled", SUM, 0.5, 3.0)]
        elif dt in ("int32", "int64"):
            ops += [("scaled", SUM, 2.0, 3.0)]
        if dt in ("float32", "float64"):
            ops += [("adasum", ADASUM, 1.0, 1.0)]
        for i, (name, op, pre, post) in enumerate(ops):
            shape = [(17,), (3, 5), ()][i % 3]
            out.append((f"ar_{name}.{dt}", "allreduce",
                        [make(dt, shape, seed * 10 + i, rank)],
                        (op, pre, post)))
        out.append((f"grouped.{dt}", "grouped",
                     [make(dt, s, seed * 10 + 7, rank)
                      for s in ((5,), (2, 3), ())],
                     (AVG if dt in FLOATS else SUM,)))
        out.append((f"allgather.{dt}", "allgather",
                     [make(dt, (rank + 1, 3), seed * 10 + 8, rank)], ()))
        for root in range(size):
            out.append((f"broadcast{root}.{dt}", "broadcast",
                        [make(dt, (4, 2), seed * 10 + 9, rank)], (root,)))
        splits = [(rank + i) % 3 for i in range(size)]
        out.append((f"alltoall.{dt}", "alltoall",
                     [make(dt, (sum(splits), 2), seed * 10 + 5, rank)],
                     (splits,)))
        out.append((f"reducescatter.{dt}", "reducescatter",
                     [make(dt, (size * 2, 3), seed * 10 + 6, rank)], (SUM,)))
    for name, op in (("max", MAX), ("min", MIN)):
        out.append((f"ar_{name}.bool", "allreduce",
                     [make("bool", (9,), 90, rank)], (op, 1.0, 1.0)))
    out.append(("allgather.bool", "allgather",
                [make("bool", (rank + 2,), 91, rank)], ()))
    return out


def _jax_backend():
    from horovod_tpu.core.core_backend import CoreBackend

    import ml_dtypes

    def conv(a):
        return a.view(ml_dtypes.bfloat16) if a.dtype == np.uint16 else a

    def back(o):
        return np.asarray(o)
    return CoreBackend(), conv, back


def _port_backend(pkg: str):
    import torch

    from horovod_tpu_torch.core.core_backend import CoreBackend

    def conv(a):
        if a.dtype == np.uint16:
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a)

    def back(o):
        if o.dtype == torch.bfloat16:
            return o.view(torch.int16).numpy()
        return o.numpy()
    if pkg == "dist":
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.common.basics import eager_backend
        hvd.init()
        return eager_backend(), conv, back
    return CoreBackend(), conv, back


def run(pkg: str, out_dir: str) -> None:
    be, conv, back = _jax_backend() if pkg == "jax" else _port_backend(pkg)
    rank, size = be.rank, be.size
    res = {}

    def keep(key, o):
        a = np.ascontiguousarray(back(o))
        res[key] = np.frombuffer(a.tobytes(), np.uint8)
        res[key + ".shape"] = np.asarray(a.shape, np.int64)

    for key, kind, ins, args in cases(rank, size):
        xs = [conv(a) for a in ins]
        if kind == "allreduce":
            keep(key, be.allreduce_async(key, xs[0], args[0], args[1],
                                         args[2]).wait(60))
        elif kind == "grouped":
            outs = be.grouped_allreduce_async(
                [f"{key}.{i}" for i in range(len(xs))], xs,
                args[0]).wait(60)
            for i, o in enumerate(outs):
                keep(f"{key}.{i}", o)
        elif kind == "allgather":
            keep(key, be.allgather_async(key, xs[0]).wait(60))
        elif kind == "broadcast":
            keep(key, be.broadcast_async(key, xs[0], args[0]).wait(60))
        elif kind == "alltoall":
            o, recv = be.alltoall_async(key, xs[0], args[0]).wait(60)
            keep(key, o)
            res[key + ".splits"] = np.asarray(recv, np.int64)
        elif kind == "reducescatter":
            keep(key, be.reducescatter_async(key, xs[0], args[0]).wait(60))
    if pkg == "dist":
        import horovod_tpu_torch as hvd
        hvd.shutdown()
    else:
        # join: odd ranks join at once, even ranks reduce once more (a
        # joined rank contributes zeros)
        if rank % 2 == 1:
            last = be.join()
        else:
            keep("post_join", be.allreduce_async(
                "post_join", conv(make("float32", (6,), 99, rank)),
                SUM).wait(60))
            last = be.join()
        res["join_last"] = np.asarray([last], np.int64)
        res["responses_executed"] = np.asarray(
            [be.counters()["responses_executed"]])
        be.barrier()
        be.shutdown()
    np.savez(os.path.join(out_dir, f"{pkg}.rank{rank}.npz"), **res)
    if pkg != "jax":
        assert not [m for m in sys.modules if m.split(".")[0] in
                    ("jax", "jaxlib", "horovod_tpu")], "the port imported JAX"
    print(f"{pkg} core worker {rank}: OK", flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--pkg", choices=("jax", "port", "dist"), required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    run(a.pkg, a.out)
