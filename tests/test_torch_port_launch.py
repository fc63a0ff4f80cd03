"""The port's launcher and shutdown, on the CPU: ``hvdrun`` static on
``localhost:2`` trains the tiny flagship over a gloo world it launched
(the identity and rendezvous reach each rank, the losses are the
one-process step's), propagates a failing worker's exit code and collects
per-rank output (the port's versions of ``tests/test_runner.py:328-394``);
``shutdown`` ends a world whose peer died within a few seconds, forced or
not. Run as ``python tests/test_torch_port_launch.py --worker GROUP --out
DIR``, this file is one rank of a gloo world."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_worker import REPO, spawn_world, worker_main  # noqa: E402

WORKER = os.path.join(REPO, "tests", "torch_port_elastic_worker.py")
STEPS = 3


def _hvdrun(*argv, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               HOROVOD_TPU_OPERATIONS="GLOO")
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def test_hvdrun_static_trains_over_the_world_it_launched(tmp_path):
    r = _hvdrun("-np", "2", "-H", "localhost:2", sys.executable, WORKER,
                "static", "--out", str(tmp_path), "--device", "cpu",
                "--tiny", "--steps", str(STEPS))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    ranks = [json.loads((tmp_path / f"static.rank{i}.json").read_text())
             for i in range(2)]
    for i, res in enumerate(ranks):
        assert (res["rank"], res["size"]) == (str(i), "2")
        assert (res["hvd_rank"], res["hvd_size"]) == (i, 2)
        assert res["rendezvous_addr"] == res["gloo_rendezvous_addr"] \
            == "127.0.0.1"
        assert res["generation"] is None        # a static launch
        assert res["backend"] == "gloo"
    assert ranks[0]["rendezvous_port"] == ranks[1]["rendezvous_port"]
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert ranks[0]["digest"] == ranks[1]["digest"]
    # the same steps in one process on the whole batch
    from horovod_tpu_torch.entry import entry
    from horovod_tpu_torch.models import adamw, init_opt_state, \
        make_train_step
    _, (model, tokens, targets) = entry(device="cpu", tiny=True)
    opt = init_opt_state(adamw, model)
    step = make_train_step(model.cfg)
    ref = [float(step(model, opt, tokens, targets)[2]) for _ in range(STEPS)]
    np.testing.assert_allclose(ranks[0]["losses"], ref, rtol=1e-5)


def test_hvdrun_propagates_a_failing_workers_exit_code(tmp_path):
    r = _hvdrun("-np", "2", sys.executable, "-c",
                "import os, sys; sys.exit(3 if os.environ['HOROVOD_RANK'] "
                "== '1' else 0)", timeout=60)
    assert r.returncode == 3, r.stderr[-2000:]


def test_hvdrun_returns_the_first_failure_not_a_terminated_ranks_code():
    """Rank 1 exits 3 at once while rank 0 sleeps, so the launcher
    terminates rank 0 (-15): ``hvdrun`` returns 3, the first failure by
    time, in every repeat (a rank-order scan returns rank 0's -15)."""
    from horovod_tpu_torch.runner import launch
    worker = ("import os, sys, time\n"
              "if os.environ['HOROVOD_RANK'] == '1':\n"
              "    sys.exit(3)\n"
              "time.sleep(60)\n")
    rcs = [launch.run_commandline(["-np", "2", sys.executable, "-c", worker])
           for _ in range(20)]
    assert rcs == [3] * 20


def test_hvdrun_output_filename(tmp_path):
    out_dir = tmp_path / "logs"
    r = _hvdrun("-np", "2", "--output-filename", str(out_dir),
                sys.executable, "-c",
                "import os, sys\n"
                "print('hello from rank', os.environ['HOROVOD_RANK'])\n"
                "print('warn', os.environ['HOROVOD_RANK'], file=sys.stderr)\n",
                timeout=60)
    assert r.returncode == 0, r.stderr[-2000:]
    for i in (0, 1):
        assert f"hello from rank {i}" in \
            (out_dir / f"rank.{i}" / "stdout").read_text()
        assert f"warn {i}" in (out_dir / f"rank.{i}" / "stderr").read_text()


# -- shutdown after a peer died ------------------------------------------------
def _w_peer_dies(force: bool):
    """Rank 1 leaves without a word; rank 0's next collective raises
    ``HorovodInternalError`` and its shutdown returns within seconds.
    Each rank saves its own results and exits here: the world is gone."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.elastic import HorovodInternalError
    from horovod_tpu_torch.ops.mesh_collectives import preduce
    axis = hvd.build_mesh(dp=2).axis("dp")
    preduce(torch.ones(2), axis)
    if hvd.rank() == 1:
        np.savez(os.path.join(os.environ["TEST_OUT"], f"{_group(force)}"
                              f".rank1.npz"), ok=np.array(1))
        os._exit(0)
    t0 = time.monotonic()
    try:
        preduce(torch.ones(2), axis)
        raised = False
    except HorovodInternalError:
        raised = True
    detect = time.monotonic() - t0
    t0 = time.monotonic()
    hvd.shutdown(force=force)
    np.savez(os.path.join(os.environ["TEST_OUT"],
                          f"{_group(force)}.rank0.npz"),
             raised=np.array(raised), detect_s=np.array(detect),
             shutdown_s=np.array(time.monotonic() - t0),
             initialized=np.array(hvd.is_initialized()))
    os._exit(0)


def _group(force: bool) -> str:
    return "forced" if force else "negotiated"


WORKERS = {"forced": lambda: _w_peer_dies(True),
           "negotiated": lambda: _w_peer_dies(False)}


@pytest.mark.parametrize("force", [True, False])
def test_survivor_shutdown_returns_when_its_peer_was_killed(tmp_path, force):
    ranks = spawn_world(__file__, _group(force), 2, tmp_path,
                        extra_env={"TEST_OUT": str(tmp_path),
                                   "HVD_TPU_SHUTDOWN_GRACE_S": "3"},
                        timeout=90)
    r0 = ranks[0]
    assert bool(r0["raised"]) and not bool(r0["initialized"])
    assert float(r0["shutdown_s"]) < 5.0, float(r0["shutdown_s"])


if __name__ == "__main__":
    sys.exit(worker_main(WORKERS, sys.argv[1:]))
