"""Elastic training on the port, on the CPU: the port's ``ElasticDriver``
over ``FixedHosts`` of three slots runs three gloo ranks of the tiny
flagship (``tests/torch_port_elastic_worker.py``: ``elastic.run``,
``TorchState``, ``ElasticSampler``, a commit a step). Rank 2 dies after
its commit of step 3: the survivors recover in place (same PIDs) with one
replacement, every survivor books the six re-mesh phases, the replicas
end equal, the trajectory is the uninterrupted run's, and the journal
replays to the driver's final state (the port's version of
``tests/test_elastic.py:422``)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_elastic_worker as worker  # noqa: E402

from horovod_tpu_torch.runner.elastic import journal  # noqa: E402
from horovod_tpu_torch.runner.elastic.discovery import FixedHosts  # noqa
from horovod_tpu_torch.runner.hosts import HostInfo  # noqa: E402

STEPS, ROWS, KILL = 6, 2, "2:3"
PHASES = {"failure_detect", "drain", "rendezvous", "rebuild", "restore",
          "first_step"}


def _run(out, *extra):
    os.makedirs(out, exist_ok=True)
    cmd = worker.command(out, "--device", "cpu", "--tiny", "--steps", STEPS,
                         "--rows", ROWS, *extra)
    rc, driver, secs = worker.run_driver(
        FixedHosts([HostInfo("localhost", 3)]), cmd, str(out),
        reset_limit=3, env={"HVD_TPU_GLOO_TIMEOUT_SECONDS": "60"})
    assert rc == 0, worker.events(out)
    return driver, worker.events(out)


def _losses(evs) -> dict:
    """step -> the loss every rank reported (they must agree)."""
    out = {}
    for e in evs:
        if e["kind"] == "step":
            assert out.setdefault(e["step"], e["loss"]) == e["loss"], e
    return out


def _digests(evs) -> set:
    return {e["digest"] for e in evs if e["kind"] == "done"}


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("plain"))[1]


def test_uninterrupted_runs_agree_to_the_bit(uninterrupted, tmp_path):
    again = _run(tmp_path)[1]
    assert sorted(_losses(uninterrupted)) == list(range(1, STEPS + 1))
    assert _losses(again) == _losses(uninterrupted)
    assert len(_digests(again)) == 1
    assert _digests(again) == _digests(uninterrupted)


def test_crash_recovers_in_place_with_a_replacement(uninterrupted, tmp_path):
    driver, evs = _run(tmp_path, "--kill", KILL)
    boots = [e for e in evs if e["kind"] == "boot"]
    dones = [e for e in evs if e["kind"] == "done"]
    # the original three and ONE replacement; survivors were not restarted
    assert sorted(b["rank"] for b in boots) == [0, 1, 2, 2], boots
    assert [e["rank"] for e in evs if e["kind"] == "kill"] == [2]
    boot_pid = {b["rank"]: b["pid"] for b in boots if b["rank"] < 2}
    replacement = [b for b in boots if b["rank"] == 2][1]
    assert replacement["generation"] == "1"
    assert sorted(d["rank"] for d in dones) == [0, 1, 2]
    for d in dones:
        assert d["size"] == 3 and d["step"] == STEPS
        if d["rank"] < 2:
            assert d["pid"] == boot_pid[d["rank"]]
            assert d["remesh"]["total"] >= 1
            assert set(d["remesh"]["phases"]) >= PHASES, d["remesh"]
        else:
            assert d["pid"] == replacement["pid"]
            assert d["remesh"] == {"total": 0, "phases": {}}
    # the replicas end equal, on the uninterrupted trajectory (which is
    # bit-repeatable: test_uninterrupted_runs_agree_to_the_bit)
    assert len(_digests(evs)) == 1
    assert _losses(evs) == _losses(uninterrupted)
    assert _digests(evs) == _digests(uninterrupted)
    # the journal replays to the driver's final state
    state = journal.load(os.path.join(tmp_path, "journal",
                                      journal.JOURNAL_NAME))
    assert state.clean_exit == 0 and state.unknown == 0
    assert state.world_gen == driver.final_generation == 1
    assert state.reset_count == driver._registry.reset_count
    assert not state.live_workers()
    exits = {k: r["state"] for k, r in state.exits.items()}
    assert exits[(0, 2)] == "FAILURE"
    assert [exits[k] for k in ((0, 0), (0, 1), (1, 2))] == ["SUCCESS"] * 3
    assert state.world["doc"]["size"] == 3
    assert state.blocklist == {} and state.drains == {}


def test_peer_loss_is_an_internal_error():
    """The one translation of the collective layer: a gloo peer's reset
    and any ``DistError`` become ``HorovodInternalError``; other errors
    pass through unchanged."""
    import torch.distributed as dist

    from horovod_tpu_torch.elastic import HorovodInternalError
    from horovod_tpu_torch.ops.mesh_collectives import peer_loss
    for err in (RuntimeError("[pair.cc:553] Connection closed by peer "
                             "[127.0.0.1]:1"),
                RuntimeError("Connection reset by peer"),
                dist.DistBackendError("NCCL communicator was aborted")):
        with pytest.raises(HorovodInternalError) as ei:
            with peer_loss():
                raise err
        assert ei.value.__cause__ is err
    for err in (RuntimeError("shape mismatch"), ValueError("x")):
        with pytest.raises(type(err)) as ei:
            with peer_loss():
                raise err
        assert not isinstance(ei.value, HorovodInternalError)
