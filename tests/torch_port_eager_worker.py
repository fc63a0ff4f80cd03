"""Gloo worlds of the port's eager collectives, without JAX: each group is
one rank's cases (the assertions of the JAX package's ``hvd_worker.py``,
``torch_worker.py``, ``psets_worker.py``, ``adasum_worker.py``,
``cache_worker.py``, ``error_worker.py`` and ``stall_worker.py``, over
the port's public API), run as ``python tests/torch_port_eager_worker.py
--worker GROUP --out DIR`` by ``spawn_world``. The eager backend is the
core unless ``HVD_TPU_EAGER_BACKEND=dist``. A group returns the arrays
its test compares with the JAX package."""

import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_port_worker import worker_main  # noqa: E402


def _dist_plane() -> bool:
    from horovod_tpu_torch.ops.backend import eager_backend_name
    return eager_backend_name() == "dist"


def hvd_full():
    """``hvd_worker.py``: the top-level API on torch tensors."""
    import horovod_tpu_torch as hvd
    r, n = hvd.rank(), hvd.size()
    out = hvd.allreduce(torch.arange(8.0) + r, op=hvd.Sum, name="x")
    assert torch.equal(out, sum(torch.arange(8.0) + k for k in range(n)))
    avg = hvd.allreduce(torch.ones(4) * (r + 1), name="avg")
    assert torch.allclose(avg, torch.full((4,), np.mean(
        [k + 1 for k in range(n)], dtype=np.float32)))
    params = {"w": torch.full((3,), float(r)), "b": {"c": torch.ones(2) * r}}
    hvd.broadcast_parameters(params, root_rank=0)
    assert float(params["w"].abs().sum()) == 0.0
    assert hvd.broadcast_object({"val": r * 7}, root_rank=1) == {"val": 7}
    got = hvd.allgather_object({"rank": r, "pad": "x" * (r * 13)})
    assert [g["rank"] for g in got] == list(range(n))
    p = torch.nn.Parameter(torch.zeros(4))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([p], lr=1.0))
    p.grad = torch.full((4,), float(r + 1))
    opt.step()
    mean_grad = np.mean([k + 1 for k in range(n)])
    assert torch.allclose(p.detach(), torch.full((4,), -mean_grad))
    g = hvd.allgather(torch.ones(r + 1, 2) * r, name="ag")
    assert tuple(g.shape) == (sum(k + 1 for k in range(n)), 2)
    t, rs = hvd.alltoall(torch.arange(float(n * 2)).reshape(n * 2, 1))
    assert tuple(t.shape) == (n * 2, 1) and rs.tolist() == [2] * n
    ps = hvd.add_process_set([0, 1])
    if r < 2:
        o = hvd.allreduce(torch.ones(2), op=hvd.Sum, name="ps",
                          process_set=ps)
        assert torch.equal(o, torch.full((2,), 2.0))
    hvd.barrier()
    rsc = hvd.reducescatter(torch.ones(n * 2, 3), op=hvd.Sum, name="rs")
    assert tuple(rsc.shape) == (2, 3) and float(rsc[0, 0]) == n
    h = hvd.allreduce_async(torch.ones(3), op=hvd.Sum, name="async")
    assert torch.equal(hvd.synchronize(h), torch.full((3,), float(n)))
    assert hvd.poll(h)
    if _dist_plane():
        try:
            hvd.join()
            raise AssertionError("join must raise on the dist plane")
        except NotImplementedError:
            pass
    else:
        assert isinstance(hvd.join(), int)
    return {"x": out.numpy(), "avg": avg.numpy(), "ag": g.numpy()}


def torch_adapter():
    """``torch_worker.py``: ``horovod_tpu_torch.torch`` as a reference
    script uses it."""
    import horovod_tpu_torch.torch as hvd
    rank, size = hvd.rank(), hvd.size()
    out = hvd.allreduce(torch.arange(6, dtype=torch.float32) + rank,
                        op=hvd.Sum, name="d")
    assert torch.allclose(out, sum(torch.arange(6, dtype=torch.float32) + r
                                   for r in range(size)))
    i = torch.tensor([[0, rank + 1], [0, 0]])
    sp = torch.sparse_coo_tensor(i, torch.tensor([1.0, 2.0]), (size + 2, 2))
    dense = hvd.synchronize(hvd.sparse_allreduce_async(
        sp, name="sp", op=hvd.Sum)).to_dense()
    expect = torch.zeros(size + 2, 2)
    expect[0, 0] = float(size)
    for r in range(size):
        expect[r + 1, 0] += 2.0
    assert torch.allclose(dense, expect), (dense, expect)
    metas = hvd.allgather_object({"rank": rank, "loss": 0.5 * rank})
    assert [m["rank"] for m in metas] == list(range(size))
    t = torch.full((3,), float(rank + 1))
    assert hvd.synchronize(hvd.allreduce_async_(t, op=hvd.Sum,
                                                name="ip")) is t
    assert torch.allclose(t, torch.full((3,), float(sum(
        r + 1 for r in range(size)))))
    b = torch.full((2,), float(rank))
    hvd.synchronize(hvd.broadcast_async_(b, root_rank=0, name="ipb"))
    assert torch.allclose(b, torch.zeros(2))
    g1, g2 = torch.full((2,), float(rank)), torch.full((4,), 2.0 * rank)
    outs = hvd.grouped_allreduce([g1, g2], op=hvd.Average, name="ga")
    mean_r = float(sum(range(size))) / size
    assert torch.allclose(outs[0], torch.full((2,), mean_r))
    assert torch.allclose(outs[1], torch.full((4,), 2 * mean_r))
    hvd.synchronize(hvd.grouped_allreduce_async_([g1, g2], op=hvd.Average,
                                                 name="ga_"))
    assert torch.allclose(g1, torch.full((2,), mean_r))
    hvd.grouped_allreduce_([g2], op=hvd.Average, name="ga2_")
    assert torch.allclose(g2, torch.full((4,), 2 * mean_r))
    a2a = torch.arange(size, dtype=torch.float32) + rank * 10
    at, asplits = hvd.synchronize(hvd.alltoall_async(a2a, splits=[1] * size,
                                                     name="a2a"))
    assert at.shape[0] == size and list(asplits) == [1] * size
    assert float(at[0]) == float(rank)

    # DistributedOptimizer: equal shards give full-batch SGD
    torch.manual_seed(0)
    model = hvd.broadcast_object(torch.nn.Linear(4, 1), 0, name="m")
    ref = torch.nn.Linear(4, 1)
    ref.load_state_dict(model.state_dict())
    rng = np.random.RandomState(0)
    X = torch.from_numpy(rng.randn(8 * size, 4).astype(np.float32))
    Y = torch.from_numpy(rng.randn(8 * size, 1).astype(np.float32))
    mine = slice(rank * 8, (rank + 1) * 8)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    ref_opt = torch.optim.SGD(ref.parameters(), lr=0.1)
    for _ in range(5):
        opt.zero_grad()
        torch.nn.functional.mse_loss(model(X[mine]), Y[mine]).backward()
        opt.step()
        ref_opt.zero_grad()
        torch.nn.functional.mse_loss(ref(X), Y).backward()
        ref_opt.step()
    for a, b in zip(model.parameters(), ref.parameters()):
        assert torch.allclose(a, b, atol=1e-5), (a, b)

    # hook mode: the allreduces are in flight when backward returns
    hX = torch.from_numpy(rng.randn(8, 4).astype(np.float32))
    hY = torch.from_numpy(rng.randn(8, 1).astype(np.float32))
    hmodel = hvd.broadcast_object(torch.nn.Linear(4, 1), 0, name="hm")
    hopt = hvd.DistributedOptimizer(
        torch.optim.SGD(hmodel.parameters(), lr=0.1),
        named_parameters=hmodel.named_parameters())
    assert hopt._use_hooks
    hopt.zero_grad()
    torch.nn.functional.mse_loss(hmodel(hX), hY).backward()
    assert len(hopt._handles) == 2, hopt._handles
    hopt.step()
    assert not hopt._handles

    # backward_passes_per_step=2: the second backward enqueues, and the
    # step is the full-batch step on the mean of the two gradients
    amodel = hvd.broadcast_object(torch.nn.Linear(4, 1), 0, name="am")
    aref = torch.nn.Linear(4, 1)
    aref.load_state_dict(amodel.state_dict())
    aopt = hvd.DistributedOptimizer(
        torch.optim.SGD(amodel.parameters(), lr=0.1),
        named_parameters=amodel.named_parameters(),
        backward_passes_per_step=2)
    aopt.zero_grad()
    torch.nn.functional.mse_loss(amodel(hX[:4]), hY[:4]).backward()
    assert not aopt._handles
    torch.nn.functional.mse_loss(amodel(hX[4:]), hY[4:]).backward()
    assert len(aopt._handles) == 2
    aopt.step()
    aref_opt = torch.optim.SGD(aref.parameters(), lr=0.1)
    torch.nn.functional.mse_loss(aref(hX[:4]), hY[:4]).backward()
    torch.nn.functional.mse_loss(aref(hX[4:]), hY[4:]).backward()
    for p in aref.parameters():
        p.grad.div_(2.0)
    aref_opt.step()
    for a, b in zip(amodel.parameters(), aref.parameters()):
        assert torch.allclose(a, b, atol=1e-5), (a, b)
    aopt.zero_grad()
    torch.nn.functional.mse_loss(amodel(hX[:4]), hY[:4]).backward()
    torch.nn.functional.mse_loss(amodel(hX[4:]), hY[4:]).backward()
    try:
        torch.nn.functional.mse_loss(amodel(hX[:4]), hY[:4]).backward()
        raise AssertionError("expected the over-backward error")
    except (ValueError, RuntimeError) as e:
        assert "backward_passes_per_step" in str(e), e
    aopt.synchronize()

    # HVD_TORCH_HOOKS=0: every gradient submitted in step()
    os.environ["HVD_TORCH_HOOKS"] = "0"
    try:
        fmodel = hvd.broadcast_object(torch.nn.Linear(4, 1), 0, name="fm")
        fopt = hvd.DistributedOptimizer(
            torch.optim.SGD(fmodel.parameters(), lr=0.1),
            named_parameters=fmodel.named_parameters())
        assert not fopt._use_hooks
        fopt.zero_grad()
        torch.nn.functional.mse_loss(fmodel(hX), hY).backward()
        assert not fopt._handles
        fopt.step()
    finally:
        del os.environ["HVD_TORCH_HOOKS"]

    # SyncBatchNorm: the sharded batch gives plain BN on the full batch
    torch.manual_seed(1)
    X = torch.from_numpy(rng.randn(4 * size, 3, 5, 5).astype(np.float32))
    mine = slice(rank * 4, (rank + 1) * 4)
    sbn = hvd.SyncBatchNorm(3, momentum=0.1)
    bn = torch.nn.BatchNorm2d(3, momentum=0.1)
    bn.load_state_dict({k: v.clone() for k, v in sbn.state_dict().items()})
    xs = X[mine].clone().requires_grad_(True)
    xf = X.clone().requires_grad_(True)
    out_s, out_f = sbn(xs), bn(xf)
    assert torch.allclose(out_s, out_f[mine], atol=1e-5)
    out_s.sum().backward()
    out_f.sum().backward()
    assert torch.allclose(xs.grad, xf.grad[mine], atol=1e-5)
    gw = hvd.allreduce(sbn.weight.grad, op=hvd.Sum, name="sbn.gw")
    gb = hvd.allreduce(sbn.bias.grad, op=hvd.Sum, name="sbn.gb")
    assert torch.allclose(gw, bn.weight.grad, atol=1e-4)
    assert torch.allclose(gb, bn.bias.grad, atol=1e-4)
    assert torch.allclose(sbn.running_mean, bn.running_mean, atol=1e-5)
    assert torch.allclose(sbn.running_var, bn.running_var, atol=1e-5)

    # join with uneven batches: rank r trains r+1 batches
    jmodel = hvd.broadcast_object(torch.nn.Linear(4, 1), 0, name="jm")
    jopt = hvd.DistributedOptimizer(
        torch.optim.SGD(jmodel.parameters(), lr=0.05),
        named_parameters=jmodel.named_parameters())
    for _ in range(rank + 1):
        jopt.zero_grad()
        xb = torch.from_numpy(rng.randn(4, 4).astype(np.float32))
        yb = torch.from_numpy(rng.randn(4, 1).astype(np.float32))
        torch.nn.functional.mse_loss(jmodel(xb), yb).backward()
        jopt.step()
    last = hvd.join()
    lasts = hvd.allgather_object(last)
    assert len(set(lasts)) == 1, lasts
    hvd.broadcast_parameters(jmodel.state_dict(), root_rank=lasts[0])
    ws = hvd.allgather_object([p.detach().numpy()
                               for p in jmodel.parameters()])
    for other in ws[1:]:
        for a, b in zip(ws[0], other):
            assert np.allclose(a, b, atol=1e-6)
    hvd.barrier()
    return {"dense": dense.numpy(), "last": np.asarray([lasts[0]])}


def psets():
    """``psets_worker.py``: two disjoint sets of a world of four, each
    reducing concurrently with the other, interleaved with global ops."""
    import horovod_tpu_torch as hvd
    rank = hvd.rank()
    assert hvd.size() == 4
    low = hvd.add_process_set([0, 1])
    high = hvd.add_process_set([2, 3])
    assert hvd.process_set_ids() == [0, low.process_set_id,
                                     high.process_set_id]
    assert hvd.get_process_set_by_id(high.process_set_id) is high
    mine = low if rank < 2 else high
    base = 0 if rank < 2 else 2
    for it in range(10):
        out = hvd.allreduce(torch.full((64,), float(rank + 1)), op=hvd.Sum,
                            name=f"ps.{it}", process_set=mine)
        assert torch.equal(out, torch.full((64,), (base + 1.0) + (base + 2.0)))
        g = hvd.allreduce(torch.ones(8), op=hvd.Sum, name=f"glob.{it}")
        assert torch.equal(g, torch.full((8,), 4.0))
    outs = hvd.grouped_allreduce([torch.full((5,), float(rank)),
                                  torch.ones(2, 3)],
                                 op=hvd.Sum, name="ps.grp", process_set=mine)
    assert torch.equal(outs[0], torch.full((5,), base + base + 1.0))
    assert torch.equal(outs[1], torch.full((2, 3), 2.0))
    out = hvd.allgather(torch.full((mine.rank() + 1, 2), float(rank)),
                        name="ps.ag", process_set=mine)
    assert out.shape[0] == 3
    b = hvd.broadcast(torch.full((3,), float(rank)), root_rank=base + 1,
                      name="ps.bc", process_set=mine)
    assert torch.equal(b, torch.full((3,), float(base + 1)))
    # the registered set's torch group serves the training API too
    p = torch.nn.Parameter(torch.zeros(2))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([p], lr=1.0),
                                   process_set=mine)
    p.grad = torch.full((2,), float(rank))
    opt.step()
    assert torch.equal(p.detach(), torch.full((2,), -(base + 0.5)))
    if _dist_plane():
        from horovod_tpu_torch.ops.collectives import _backend_for
        try:
            _backend_for(mine).join()
            raise AssertionError("a set's join must raise on the dist plane")
        except NotImplementedError:
            pass
    hvd.barrier()
    hvd.remove_process_set(high)
    assert hvd.process_set_ids() == [0, low.process_set_id]
    return {"out": outs[0].numpy()}


def restricted():
    """``init(ranks=[0, 1])`` in a world of three: the global set is the
    two, the third process joins the core's world and submits nothing."""
    import horovod_tpu_torch as hvd
    launched = int(os.environ["HVD_TPU_RANK"])
    if launched == 2:
        assert hvd.rank() == -1 and hvd.size() == 2
    else:
        assert hvd.rank() == launched and hvd.size() == 2
        out = hvd.allreduce(torch.full((4,), float(launched + 1)),
                            op=hvd.Sum, name="r")
        assert torch.equal(out, torch.full((4,), 3.0))
        b = hvd.broadcast(torch.full((2,), float(launched)), root_rank=1,
                          name="rb")
        assert torch.equal(b, torch.ones(2))
        g = hvd.allgather(torch.full((launched + 1,), float(launched)),
                          name="rg")
        assert g.tolist() == [0.0, 1.0, 1.0]
    return {"rank": np.asarray([hvd.rank()])}


def adasum():
    """``adasum_worker.py``: the core's VHDD Adasum on identical,
    orthogonal and random inputs, and ``DistributedOptimizer(op=Adasum)``
    in the eager and the axis regimes; the test holds the arrays to the
    JAX functions."""
    import horovod_tpu_torch as hvd
    rank, size = hvd.rank(), hvd.size()
    a = torch.linspace(1, 2, 32)
    same = hvd.allreduce(a.clone(), op=hvd.Adasum, name="ad.same")
    assert torch.allclose(same, a, rtol=1e-5)
    x = torch.zeros(size * 4)
    x[rank * 4:(rank + 1) * 4] = rank + 1.0
    orth = hvd.allreduce(x, op=hvd.Adasum, name="ad.orth")
    expect = torch.cat([torch.full((4,), r + 1.0) for r in range(size)])
    assert torch.allclose(orth, expect, rtol=1e-5)
    contribs = np.random.RandomState(7).randn(size, 64).astype(np.float32)
    rand = hvd.allreduce(torch.from_numpy(contribs[rank].copy()),
                         op=hvd.Adasum, name="ad.rand")
    f64 = hvd.allreduce(torch.from_numpy(contribs[rank].astype(np.float64)),
                        op=hvd.Adasum, name="ad.f64")
    grads = np.random.RandomState(11).randn(size, 2, 6).astype(np.float32)
    out = {"rand": rand.numpy(), "f64": f64.numpy(), "contribs": contribs,
           "grads": grads}
    for regime in ("eager", "axis"):
        w = torch.nn.Parameter(torch.zeros(6))
        v = torch.nn.Parameter(torch.zeros(6))
        axis = hvd.build_mesh(dp=size).axis("dp") if regime == "axis" \
            else None
        opt = hvd.DistributedOptimizer(torch.optim.SGD([w, v], lr=1.0),
                                       named_parameters=[("w", w), ("v", v)],
                                       op=hvd.Adasum, axis=axis)
        w.grad = torch.from_numpy(grads[rank, 0].copy())
        v.grad = torch.from_numpy(grads[rank, 1].copy())
        opt.step()
        out[f"opt_{regime}"] = np.stack([w.detach().numpy(),
                                         v.detach().numpy()])
    return out


def cache():
    """``cache_worker.py``: the response cache under eviction pressure
    (``HOROVOD_CACHE_CAPACITY=4``), its steady-state hits, fused ragged
    allgathers against a per-tensor oracle, and the core's timeline
    restarted while collectives flow."""
    import horovod_tpu_torch as hvd
    rank, size = hvd.rank(), hvd.size()
    names = [f"cache.{i}" for i in range(12)]
    for epoch in range(6):
        hs = [(i, hvd.allreduce_async(
            torch.full((32,), float(rank + i + epoch)), op=hvd.Sum, name=n))
              for i, n in enumerate(names)]
        for i, h in hs:
            assert torch.equal(h.wait(), torch.full((32,), float(sum(
                r + i + epoch for r in range(size)))))
    c = hvd.counters()
    assert c["cache_evictions"] > 0, c
    for j in range(5):
        out = hvd.allreduce(torch.full((16,), float(rank + j)), op=hvd.Sum,
                            name="cache.hot")
        assert torch.equal(out, torch.full((16,), float(sum(
            r + j for r in range(size)))))
    c = hvd.counters()
    assert c["cache_hits"] > 0, c
    snap = hvd.metrics_snapshot()
    assert snap["engine"]["cache_hits"] > 0
    assert snap["derived"]["cache_hit_rate"] > 0

    def shard(r, i):
        rows = (r + i) % 3 + 1
        return (torch.arange(rows * (i + 1), dtype=torch.float32)
                .reshape(rows, i + 1) + 1000 * r + i)

    hs = [(i, hvd.allgather_async(shard(rank, i), name=f"fag.{i}"))
          for i in range(10)]
    for i, h in hs:
        assert torch.equal(h.wait(), torch.cat([shard(r, i)
                                                for r in range(size)]))
    assert hvd.counters()["bytes_allgathered"] > 0
    from horovod_tpu_torch.common.basics import eager_backend
    be = eager_backend()
    tl1, tl2 = os.environ["HVD_TEST_TL1"], os.environ["HVD_TEST_TL2"]
    be.start_core_timeline(tl1, mark_cycles=True)
    assert torch.equal(hvd.allreduce(torch.ones(8), op=hvd.Sum, name="tl.a"),
                       torch.full((8,), float(size)))
    be.stop_core_timeline()
    be.start_core_timeline(tl2)
    assert torch.equal(hvd.allreduce(torch.ones(8), op=hvd.Sum, name="tl.b"),
                       torch.full((8,), float(size)))
    be.stop_core_timeline()
    hvd.barrier()
    return {"hits": np.asarray([c["cache_hits"]])}


def errors():
    """``error_worker.py``: shape mismatch, a duplicate in-flight name and
    a poisoned group fail cleanly on every rank; the engine works after."""
    import horovod_tpu_torch as hvd
    rank = hvd.rank()
    try:
        hvd.allreduce(torch.ones(5 if rank == 0 else 10), op=hvd.Sum,
                      name="mismatch")
        raise AssertionError("mismatch did NOT error")
    except RuntimeError as e:
        assert "mismatched" in str(e), e
    mine, theirs = f"dup.{rank}", f"dup.{1 - rank}"
    h1 = hvd.allreduce_async(torch.ones(4), op=hvd.Sum, name=mine)
    try:
        hvd.allreduce_async(torch.ones(4), op=hvd.Sum, name=mine).wait(5)
        raise AssertionError("duplicate did NOT error")
    except RuntimeError as e:
        assert "duplicate" in str(e).lower(), e
    hvd.barrier()
    h2 = hvd.allreduce_async(torch.ones(4), op=hvd.Sum, name=theirs)
    assert torch.equal(h1.wait(30), torch.full((4,), 2.0))
    assert torch.equal(h2.wait(30), torch.full((4,), 2.0))
    try:
        hvd.grouped_allreduce([torch.ones(4),
                               torch.ones(7 if rank == 0 else 9)],
                              op=hvd.Sum, name="g")
        raise AssertionError("grouped mismatch did NOT error")
    except RuntimeError as e:
        assert "mismatched" in str(e).lower() or "group" in str(e).lower(), e
    try:
        hvd.allreduce(torch.arange(4, dtype=torch.int32), op=hvd.Sum,
                      prescale_factor=0.5)
        raise AssertionError("a fractional int scale did NOT error")
    except ValueError:
        pass
    assert torch.equal(hvd.allreduce(torch.ones(3), op=hvd.Sum, name="after"),
                       torch.full((3,), 2.0))
    return {"ok": np.asarray([1])}


def engine():
    """The engine's counters on ``/metrics`` (``hvd_engine_*`` from the
    ``EngineCollector``), and their drop at a re-mesh (shutdown, init)."""
    import urllib.request

    import horovod_tpu_torch as hvd
    rank = hvd.rank()
    port = int(os.environ["HVD_TPU_METRICS_PORT"]) + hvd.local_rank()

    def scrape():
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as r:
            return r.read().decode()

    assert "hvd_engine_" not in scrape()      # not started: nothing yet
    for i in range(6):
        hvd.allreduce(torch.ones(64) * rank, op=hvd.Sum, name="hot")
    text = scrape()
    assert "hvd_engine_cache_hits" in text, text[:2000]
    assert "hvd_engine_cache_hit_rate" in text
    health = json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}/healthz", timeout=10).read())
    assert health["engine_alive"] is True, health
    hits = hvd.metrics_snapshot()["engine"]["cache_hits"]
    hvd.shutdown()
    hvd.init()      # the re-mesh: a new world, a new exporter
    assert "hvd_engine_" not in scrape()
    hvd.allreduce(torch.ones(4), op=hvd.Sum, name="again")
    assert "hvd_engine_responses_executed" in scrape()
    return {"hits": np.asarray([hits])}


def reinit():
    """``shutdown(); init()`` on the same rendezvous port while rank 0 is
    slow to close its store (its ``destroy_process_group`` sleeps first):
    rank 1 must not rendezvous at the old store, so every new world forms
    and reduces. Returns rank 1's shutdown times."""
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    delay = float(os.environ["HVD_TEST_DESTROY_DELAY_S"])
    if hvd.rank() == 0:
        destroy = dist.destroy_process_group

        def slow_destroy(*a, **k):
            time.sleep(delay)
            return destroy(*a, **k)
        dist.destroy_process_group = slow_destroy
    waits = []
    for cycle in range(3):
        out = hvd.allreduce(torch.ones(4) * (hvd.rank() + 1), op=hvd.Sum,
                            name=f"cycle{cycle}")
        assert torch.equal(out, torch.full((4,), 3.0)), out
        t0 = time.monotonic()
        hvd.shutdown()
        waits.append(time.monotonic() - t0)
        hvd.init()
    out = hvd.allreduce(torch.ones(4), op=hvd.Sum, name="last")
    assert torch.equal(out, torch.full((4,), 2.0)), out
    return {"waits": np.asarray(waits)}


def stall():
    """``stall_worker.py``: rank 0 submits a tensor rank 1 never does.
    Rank 0's autopsy names the tensor and the missing rank; the stall
    shutdown (``HOROVOD_STALL_SHUTDOWN_TIME_SECONDS``) fails its wait
    instead of hanging, and the engine keeps working."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.diagnostics.autopsy import write_autopsy
    rank = hvd.rank()
    hvd.allreduce(torch.ones(2), op=hvd.Sum, name="warm")
    summary = {}
    if rank == 0:
        h = hvd.allreduce_async(torch.ones(4), op=hvd.Sum, name="stuck")
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:   # published at <= 2 Hz
            if any(p["name"] == "stuck" for d in hvd.engine_state().get(
                    "domains", []) for p in d.get("pending", [])):
                break
            time.sleep(0.1)
        bundle = write_autopsy(os.environ["HVD_TPU_AUTOPSY_DIR"],
                               reason="test stall", fetch_peers=False)
        with open(os.path.join(bundle, "summary_rank0.json")) as f:
            summary = json.load(f)
        try:
            h.wait(30)
            raise AssertionError("the stalled tensor did not fail")
        except RuntimeError as e:
            assert "stalled beyond" in str(e), e
    else:
        # submit the recovery tensor before rank 0's stall error fires
        # (the shutdown is 4 s; rank 0 joins at ~4 s)
        time.sleep(3)
    out = hvd.allreduce(torch.full((3,), float(rank + 1)), op=hvd.Sum,
                        name="after")
    assert torch.equal(out, torch.full((3,), 3.0))
    return {"summary": np.frombuffer(json.dumps(summary).encode(),
                                     np.uint8)}


def rank_tensor(rank: int, n: int = 1000, seed: int = 0) -> np.ndarray:
    """``quantized_worker._rank_tensor``: rank-dependent seeded data."""
    rng = np.random.RandomState(seed + rank)
    return (rng.randn(n) * (1.0 + rank)).astype(np.float32)


def quantized():
    """``quantized_worker.py``: int8 quantized (grouped) allreduce over
    the eager backend; the test holds it to the JAX codec."""
    import horovod_tpu_torch as hvd
    rank = hvd.rank()
    q = hvd.Compression.int8
    x = torch.from_numpy(rank_tensor(rank))
    out = hvd.quantized_allreduce(x, q, op=hvd.Sum, name="qsum")
    y = torch.from_numpy(rank_tensor(rank, seed=100))
    outs = hvd.quantized_grouped_allreduce([x, y.reshape(10, 100)], q,
                                           op=hvd.Average, name="qgrp")
    assert outs[1].shape == (10, 100)
    return {"sum": out.numpy(), "avg_x": outs[0].numpy(),
            "avg_y": outs[1].numpy()}


def spans():
    """Every eager collective opens and closes a span on the host
    timeline's shard, with the span id every rank gives it."""
    import horovod_tpu_torch as hvd
    for i in range(3):
        hvd.allreduce(torch.ones(4), op=hvd.Sum, name=f"step.{i}")
    hvd.grouped_allreduce([torch.ones(2), torch.ones(3)], op=hvd.Sum,
                          name="grp")
    return {"ok": np.asarray([1])}


WORKERS = {"hvd": hvd_full, "torch": torch_adapter, "psets": psets,
           "restricted": restricted, "adasum": adasum, "cache": cache,
           "errors": errors, "engine": engine, "reinit": reinit,
           "stall": stall, "quantized": quantized, "spans": spans}

if __name__ == "__main__":
    sys.exit(worker_main(WORKERS, sys.argv[1:], lambda g: (
        {"ranks": [0, 1]} if g == "restricted" else {})))
