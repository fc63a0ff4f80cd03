"""One rank of a two-rank world driving a native core directly under a
transport fault plan, in either package: ``--pkg jax`` runs the JAX
package's ``CoreBackend`` over numpy arrays, ``--pkg port`` the port's over
torch tensors (its build of the same ``cpp/`` sources). The plan
(``HVD_TPU_FAULT_PLAN``, set by ``test_torch_port_chaos_seams.py`` and by
``chip_smoke.py``'s ``[transport_chaos_2rank]``) arms a ``transport.recv``
delay on rank 1 and a ``transport.send`` bit_flip on rank 1 (first frame
of at least 1024 bytes to rank 0).

The rank runs a small grouped allreduce (frames under the flip's gate, the
delay firing), then a 16 KiB allreduce whose frame rank 1 corrupts: the
collective fails on both ranks and rank 0's checksum counter reads 1. It
writes ``DIR/<pkg>.rank<r>.json``: the grouped result, its host reference,
the error, and the core's counters.

Rank 0's reader thread finds the bad checksum, records it and shuts the
socket (``cpp/transport.cc:450``). In the JAX package's core the error a
collective thread then surfaces is a race: one blocked in a receive names
the checksum and peer 1, one that sends next fails with ``socket send
failed`` (``cpp/transport.cc:101``). The port's copy of ``transport.cc``
fails such a send with the recorded checksum message too, so its rank 0
always names the checksum. Rank 1, the sender, finds its socket closed
either way. ``ERROR_CLASSES`` lists what each package's rank may surface;
:func:`error_class` names an error's class."""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_BIG = 4096  # 16 KiB of fp32: ring chunks far over the flip's min_bytes
SUM = 1       # the core's reduce-op code

PLAN = {"faults": [
    {"seam": "transport.recv", "kind": "delay", "rank": 1, "peer": 0,
     "start": 0, "count": 4, "delay_ms": 30},
    {"seam": "transport.send", "kind": "bit_flip", "rank": 1, "peer": 0,
     "count": 1, "min_bytes": 1024}]}


# package -> rank -> the classes of error the corrupted frame may surface
ERROR_CLASSES = {"jax": {0: ("checksum", "send_failed"),
                         1: ("closed", "send_failed")},
                 "port": {0: ("checksum",), 1: ("closed", "send_failed")}}


def error_class(err):
    """The class of a rank's error under ``PLAN``'s bit flip, or ``None``
    when the collective did not fail."""
    if err is None:
        return None
    if not err.startswith("collective failed: "):
        return "other"
    if "wire checksum mismatch on frame from peer 1 " in err:
        return "checksum"
    if "socket send failed: " in err:
        return "send_failed"
    if err.endswith("connection closed"):
        return "closed"
    return "other"


def group_inputs(rank: int):
    """The grouped allreduce's seeded inputs (small: under min_bytes)."""
    rng = np.random.RandomState(7 + rank)
    return [rng.randn(*s).astype(np.float32) for s in ((5,), (2, 3), (7,))]


def _backend(pkg: str, device: str):
    if pkg == "jax":
        from horovod_tpu.core.core_backend import CoreBackend
        from horovod_tpu.elastic import HorovodInternalError
        return CoreBackend(), np.asarray, np.asarray, HorovodInternalError
    import torch

    from horovod_tpu_torch.core.core_backend import CoreBackend
    from horovod_tpu_torch.elastic import HorovodInternalError

    def conv(a):
        return torch.from_numpy(a).to(device)
    return (CoreBackend(), conv, lambda t: t.detach().cpu().numpy(),
            HorovodInternalError)


def _await(be, key, minimum, timeout=5.0):
    """The core mirrors transport counters once a cycle: wait for one."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        c = be.counters()
        if c.get(key, 0) >= minimum:
            return c
        time.sleep(0.01)
    return be.counters()


def run(pkg: str, out_dir: str, device: str = "cpu") -> dict:
    be, conv, back, internal_error = _backend(pkg, device)
    rank, size = be.rank, be.size
    assert size == 2, size
    res = {"rank": rank}
    out = back(be.allreduce_async("warm", conv(np.ones(4, np.float32)),
                                  SUM).wait(60))
    res["warm"] = out.tolist()
    t0 = time.monotonic()
    xs = group_inputs(rank)
    outs = be.grouped_allreduce_async(
        [f"g.{i}" for i in range(len(xs))], [conv(x) for x in xs],
        SUM).wait(60)
    res["grouped_s"] = time.monotonic() - t0
    res["grouped"] = [back(o).tolist() for o in outs]
    ref = [a + b for a, b in zip(group_inputs(0), group_inputs(1))]
    res["grouped_ref"] = [r.tolist() for r in ref]
    res["grouped_equal"] = all(np.array_equal(back(o), r)
                               for o, r in zip(outs, ref))
    res["chaos_injected"] = _await(
        be, "transport_chaos_injected", 4 if rank == 1 else 0).get(
        "transport_chaos_injected", 0)
    try:
        be.allreduce_async("big", conv(np.ones(N_BIG, np.float32)),
                           SUM).wait(60)
        res["error"] = None
    except internal_error as e:
        res["error"] = str(e)
    res["checksum_failures"] = _await(
        be, "transport_checksum_failures", 1 if rank == 0 else 0).get(
        "transport_checksum_failures", 0)
    with open(os.path.join(out_dir, f"{pkg}.rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--pkg", choices=("jax", "port"), required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cpu")
    a = ap.parse_args()
    run(a.pkg, a.out, a.device)
    sys.stdout.flush()
    # the failed collective left the core's ring broken: no negotiated
    # shutdown can complete, so the rank leaves at once
    os._exit(0)
