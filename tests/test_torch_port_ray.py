"""The port's Ray integration (``horovod_tpu_torch.ray``) against the JAX
package's, over ``tests/fake_ray`` (every actor a subprocess, every call
shipped by cloudpickle): ``RayExecutor`` end to end, ``RayHostDiscovery``
from fake nodes, ``ElasticRayExecutor`` recovering from a crash over the
agent transport, and the executable surface. The actors find no card
here and start gloo worlds."""

import os
import sys

import numpy as np
import pytest

from horovod_tpu.core import core_available

FAKE_RAY = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fake_ray")

NODES = [{"Alive": True, "NodeManagerAddress": "10.0.0.1",
          "Resources": {"CPU": 8.0}},
         {"Alive": True, "NodeManagerAddress": "10.0.0.2",
          "Resources": {"CPU": 3.0}},
         {"Alive": False, "NodeManagerAddress": "10.0.0.3",
          "Resources": {"CPU": 8.0}},
         {"Alive": True, "NodeManagerAddress": "10.0.0.4",
          "Resources": {}}]


@pytest.fixture
def fake_ray(monkeypatch):
    monkeypatch.syspath_prepend(FAKE_RAY)
    for mod in [m for m in sys.modules if m.split(".")[0] == "ray"]:
        monkeypatch.delitem(sys.modules, mod, raising=False)
    yield
    for mod in [m for m in sys.modules if m.split(".")[0] == "ray"]:
        sys.modules.pop(mod, None)


def test_ray_executor_end_to_end(fake_ray):
    """Two actors form a world (the rendezvous port held on rank 0's
    actor), run a closure that allreduces, and run again on the same
    actors; the sums are the JAX package's on its core."""
    from horovod_tpu_torch.ray import RayExecutor
    vec = np.random.RandomState(4).randn(3).astype(np.float32)

    ex = RayExecutor(num_workers=2, env={"HVD_RAY_TEST_KNOB": "7"})
    ex.start()
    try:
        def fn(offset):
            import os

            import torch
            import torch.distributed as dist

            import horovod_tpu_torch as hvd
            t = torch.from_numpy(vec) * (hvd.rank() + offset)
            dist.all_reduce(t)
            return {"rank": hvd.rank(), "size": hvd.size(),
                    "local": (hvd.local_rank(), hvd.local_size()),
                    "sum": t.tolist(),
                    "knob": os.environ.get("HVD_RAY_TEST_KNOB")}

        results = ex.run(fn, args=(1.0,))
        want = (vec * 1.0 + vec * 2.0).tolist()
        for rank, res in enumerate(results):
            assert (res["rank"], res["size"], res["local"], res["knob"]) \
                == (rank, 2, (rank, 2), "7")
            np.testing.assert_allclose(res["sum"], want, rtol=1e-6)
        assert ex.run(lambda: "alive") == ["alive", "alive"]
    finally:
        ex.shutdown()
    if core_available():
        from horovod_tpu.ray import RayExecutor as JxRayExecutor

        def jfn(offset):
            import numpy as np

            import horovod_tpu as hvd
            out = hvd.allreduce(np.asarray(vec) * (hvd.rank() + offset),
                                op=hvd.Sum, name="ray_parity")
            return np.asarray(out).tolist()

        def jax_run():
            jx = JxRayExecutor(num_workers=2)
            jx.start()
            try:
                return jx.run(jfn, args=(1.0,))
            finally:
                jx.shutdown()

        # taken again once if the JAX world failed: its launcher hands the
        # core a port another process can take first (ROADMAP queue 3
        # item 14); the port's side is never retried
        try:
            ref = jax_run()
        except RuntimeError:
            ref = jax_run()
        assert ref == [r["sum"] for r in results]


def test_ray_host_discovery(fake_ray):
    import ray as fake_ray_mod

    from horovod_tpu.ray import RayHostDiscovery as JxDiscovery
    from horovod_tpu_torch.ray import RayHostDiscovery
    fake_ray_mod._FAKE_NODES[:] = NODES
    try:
        for cpus in (1, 2, 3):
            got = RayHostDiscovery(cpus_per_slot=cpus) \
                .find_available_hosts_and_slots()
            assert got == JxDiscovery(cpus_per_slot=cpus) \
                .find_available_hosts_and_slots()
        assert RayHostDiscovery(cpus_per_slot=2) \
            .find_available_hosts_and_slots() == {"10.0.0.1": 4,
                                                  "10.0.0.2": 1}
    finally:
        fake_ray_mod._FAKE_NODES[:] = []


def test_ray_executor_requires_ray():
    for mod in [m for m in sys.modules if m.split(".")[0] == "ray"]:
        sys.modules.pop(mod, None)
    if any(os.path.isdir(os.path.join(p, "ray")) for p in sys.path):
        pytest.skip("real or fake ray importable in this environment")
    from horovod_tpu_torch.ray import (ElasticRayExecutor, RayExecutor,
                                       RayHostDiscovery)
    for make in (lambda: RayExecutor(num_workers=1), RayHostDiscovery,
                 ElasticRayExecutor):
        with pytest.raises(ImportError, match="horovod_tpu_torch.ray"):
            make()


def test_elastic_ray_executor_fn_recovers_from_crash(fake_ray, tmp_path):
    """``ElasticRayExecutor.run(fn)``: actors host the agent transport, a
    rank-1 crash in generation 0 restarts the generation on the same
    actors, and the retry completes."""
    from horovod_tpu_torch.ray import ElasticRayExecutor
    marker = str(tmp_path / "crashed_once")

    def train():
        import os

        import torch
        import torch.distributed as dist

        import horovod_tpu_torch as hvd
        hvd.init()
        if hvd.rank() == 1 and not os.path.exists(marker):
            open(marker, "w").close()
            os._exit(17)
        t = torch.ones(2) * (hvd.rank() + 1)
        dist.all_reduce(t)
        hvd.shutdown()
        return float(t[0])

    ex = ElasticRayExecutor(min_np=2, max_np=2,
                            env={"HOROVOD_TPU_OPERATIONS": "GLOO"})
    ex.start()
    assert ex.run(train) == [3.0, 3.0]
    assert os.path.exists(marker)
    with pytest.raises(ValueError, match="command"):
        ex.run()


def test_ray_executor_executable_surface(fake_ray):
    """start(executable_cls=...) + execute/execute_single/run_remote: the
    user class is built once a worker with the world up, fn(executable)
    applies to it, and run_remote's futures resolve to the values."""
    import ray

    from horovod_tpu_torch.ray import RayExecutor

    class Trainer:
        def __init__(self, base):
            import horovod_tpu_torch as hvd
            self.base = base
            self.rank = hvd.rank()
            self.steps = 0

        def step(self):
            import torch
            import torch.distributed as dist
            self.steps += 1
            t = torch.ones(1) * (self.rank + self.base)
            dist.all_reduce(t)
            return float(t[0])

    ex = RayExecutor(num_workers=2)
    ex.start(executable_cls=Trainer, executable_args=(10.0,))
    try:
        assert ex.execute(lambda t: t.step()) == [21.0, 21.0]
        assert ex.execute(lambda t: (t.steps, t.rank)) == [(1, 0), (1, 1)]
        assert ex.execute_single(lambda t: t.base) == 10.0
        assert ray.get(ex.run_remote(lambda: "async")) == ["async", "async"]
    finally:
        ex.shutdown()
    fresh = RayExecutor(num_workers=1)
    with pytest.raises(ValueError, match="start"):
        fresh.run(lambda: 1)
    with pytest.raises(ValueError, match="executable_cls"):
        fresh._workers = ["sentinel"]
        fresh.execute(lambda t: t)
