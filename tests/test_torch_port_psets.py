"""Process sets registered at run time and the restricted global set, on
the CPU: ``psets_worker.py``'s concurrent disjoint sets of a world of four
(on the core and on the ``torch.distributed`` plane), ``init(ranks=...)``
in a world of three, and the set table in a world of one (the JAX
package's ``add_process_set``/``remove_process_set`` semantics)."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_worker import REPO, build_core, spawn_world  # noqa: E402

EAGER_WORKER = os.path.join(REPO, "tests", "torch_port_eager_worker.py")


@pytest.fixture(scope="module", autouse=True)
def _core_built():
    """The core is built before any world starts (a cold build under load
    must not eat a world's timeout)."""
    build_core()


@pytest.mark.parametrize("plane", ["core", "dist"])
def test_concurrent_disjoint_process_sets(tmp_path, plane):
    """Sets {0,1} and {2,3} reduce concurrently, interleaved with global
    ops: allreduce, grouped, ragged allgather, broadcast from a global
    root, the training API over a set's torch group, and removal."""
    spawn_world(EAGER_WORKER, "psets", 4, tmp_path,
                extra_env={"HVD_TPU_EAGER_BACKEND": plane}, timeout=90)


@pytest.mark.parametrize("plane", ["core", "dist"])
def test_init_restricted_to_ranks(tmp_path, plane):
    """``init(ranks=[0, 1])`` of three launched processes: rank and size
    are the set's, the third process has rank -1 and still completes the
    engine's rendezvous."""
    res = spawn_world(EAGER_WORKER, "restricted", 3, tmp_path,
                      extra_env={"HVD_TPU_EAGER_BACKEND": plane}, timeout=90)
    assert [int(r["rank"][0]) for r in res] == [0, 1, -1]


@pytest.fixture
def world_of_one(monkeypatch):
    import horovod_tpu_torch as hvd
    hvd.shutdown()
    for k in ("HVD_TPU_SIZE", "HOROVOD_SIZE", "HVD_TPU_RANK", "HOROVOD_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_TPU_OPERATIONS", "GLOO")
    hvd.init()
    yield hvd
    hvd.shutdown()


def test_set_table_in_a_world_of_one(world_of_one):
    """The global set is id 0; a set of every rank is the global set; the
    global set cannot be removed; an unknown set is refused; a set made
    without registration has no torch group."""
    hvd = world_of_one
    assert hvd.process_set_ids() == [0]
    ps = hvd.add_process_set([0])
    assert ps.process_set_id == 0 and ps.group is not None
    assert hvd.get_process_set_by_id(0) is hvd.global_process_set
    with pytest.raises(ValueError):
        hvd.remove_process_set(hvd.global_process_set)
    with pytest.raises(ValueError):
        hvd.allreduce(torch.ones(2), process_set=hvd.ProcessSet([0, 1]))
    with pytest.raises(NotImplementedError):
        hvd.ProcessSet([0]).group
    assert torch.equal(hvd.allreduce(torch.ones(2), process_set=ps),
                       torch.ones(2))


def test_init_registers_process_sets(world_of_one):
    """``init(process_sets=[...])`` registers each set at once."""
    hvd = world_of_one
    hvd.shutdown()
    ps = hvd.ProcessSet([0])
    hvd.init(process_sets=[ps])
    assert ps.process_set_id == 0
    assert hvd.process_set_ids() == [0]


def test_process_set_matches_the_jax_surface():
    """The port's set has the JAX package's user-facing surface."""
    import horovod_tpu.common.process_sets as jps

    import horovod_tpu_torch.common.process_sets as tps
    for name in ("add_process_set", "remove_process_set", "process_set_ids",
                 "get_process_set_by_id", "global_process_set"):
        assert hasattr(tps, name) and hasattr(jps, name), name
    for attr in ("included", "rank", "size", "process_set_id", "ranks"):
        assert hasattr(tps.ProcessSet([0]), attr), attr
    assert tps.global_process_set.process_set_id == \
        jps.global_process_set.process_set_id == 0
