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
import time

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


SAMPLER_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "torch_port_sampler_worker.py")


def _sampler_world(pkg, tmp_path) -> list:
    """Both ranks' documents of ``torch_port_sampler_worker.py``."""
    import json

    from torch_port_worker import launch_env_world
    if pkg == "jax":
        from horovod_tpu.core import core_available
        if not core_available():
            pytest.skip("the JAX package's libhvdcore.so is not built")
    launch_env_world([SAMPLER_WORKER, "--pkg", pkg, "--out", str(tmp_path)],
                     2, tmp_path, name=pkg, timeout=90)
    docs = []
    for r in range(2):
        with open(tmp_path / f"{pkg}.rank{r}.json") as f:
            docs.append(json.load(f))
    return docs


def test_sync_unions_every_ranks_sampler_progress(tmp_path):
    """Two ranks that processed different rows sync one ``TorchState``:
    every rank then holds the union of the processed rows, and no row
    that any rank processed is drawn again (reference:
    ``SamplerStateHandler.sync``; ROADMAP queue 3 item 15)."""
    docs = _sampler_world("port", tmp_path)
    done = sorted(i for d in docs for i in d["processed"])
    assert done == [0, 1, 2, 3]
    for d in docs:
        assert d["after"] == done, d
    left = [i for d in docs for i in d["left"]]
    assert not set(left) & set(done), docs
    assert sorted(left) == list(range(4, 12))


def test_jax_sync_keeps_rank0_sampler_progress(tmp_path):
    """Pins the JAX package's sync: rank 0's processed rows only, so rank
    1's rows 1 and 3 are drawn again after the sync."""
    docs = _sampler_world("jax", tmp_path)
    for d in docs:
        assert d["after"] == [0, 2], d
    left = [i for d in docs for i in d["left"]]
    assert {1, 3} <= set(left)


def test_a_recorded_pid_of_another_process_is_never_signalled():
    """A journal's pid that names another live process (its start time is
    not the recorded one) is left alone by the test driver's timeout kill;
    the process the record names is killed."""
    import signal
    import subprocess
    from types import SimpleNamespace

    from horovod_tpu_torch.runner.safe_exec import process_start_time
    other = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(120)"],
                             start_new_session=True)
    try:
        start = process_start_time(other.pid)
        assert start is not None
        stale = SimpleNamespace(live={(0, 0): {"pid": other.pid,
                                               "start": start - 1},
                                      (0, 1): {"pid": other.pid},
                                      (0, 2): {"pid": None}})
        assert worker.kill_live_workers(stale) == []
        time.sleep(0.2)
        assert other.poll() is None
        same = SimpleNamespace(live={(0, 0): {"pid": other.pid,
                                              "start": start}})
        assert worker.kill_live_workers(same) == [other.pid]
        assert other.wait(10) == -signal.SIGKILL
    finally:
        if other.poll() is None:
            other.kill()
            other.wait()


def test_adopting_driver_never_signals_a_reused_pid():
    """A takeover driver's monitor of an adopted worker whose pid now
    names another process (a start time that is not the spawn record's)
    takes the worker as ended and signals nothing, even with the
    generation torn down; a pid that still names its worker gets SIGTERM
    and is watched until it ends."""
    import subprocess
    import threading
    from types import SimpleNamespace

    from horovod_tpu_torch.runner.elastic.driver import ElasticDriver
    from horovod_tpu_torch.runner.safe_exec import process_start_time

    class Stub:
        def __init__(self):
            self.exits = []

        def _adopted_result_ok(self, g, key):
            return False

        def _classify_exit(self, g, slot, key, rc):
            self.exits.append(rc)

    g = SimpleNamespace(failure=threading.Event(),
                        teardown=threading.Event())
    g.teardown.set()
    other = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(120)"],
                             start_new_session=True)
    try:
        start = process_start_time(other.pid)
        stub = Stub()
        ElasticDriver._monitor_adopted(stub, g, (0, 0), None, other.pid,
                                       start - 1)
        assert stub.exits == [1]
        time.sleep(0.2)
        assert other.poll() is None
        # the real worker: its parent (here, this test) reaps it, as
        # init reaps an orphan
        reaper = threading.Thread(target=other.wait, daemon=True)
        reaper.start()
        ElasticDriver._monitor_adopted(stub, g, (0, 0), None, other.pid,
                                       start)
        reaper.join(10)
        assert stub.exits == [1, 1] and other.returncode == -15
    finally:
        if other.poll() is None:
            other.kill()
            other.wait()
