"""The port's elastic backstops, on the CPU: the generation restart (a job
whose workers commit without ``elastic.run`` cannot recover in place, so
the driver relaunches the generation and the workers resume from
``HVD_ELASTIC_CKPT``: the port's version of ``tests/test_elastic.py:258``)
and the driver's takeover from its journal (``tests/test_driver_ha.py:197``:
a new driver becomes the dead one: same secret, KV port and world doc,
restored exclusions, reset budget and listener registrations)."""

import json
import os
import sys
import textwrap

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_elastic_worker as worker  # noqa: E402
from torch_port_worker import REPO, reserve_port  # noqa: E402

from horovod_tpu_torch.runner.elastic import journal as journal_mod  # noqa
from horovod_tpu_torch.runner.elastic.discovery import FixedHosts  # noqa
from horovod_tpu_torch.runner.elastic.driver import ElasticDriver  # noqa
from horovod_tpu_torch.runner.hosts import HostInfo, SlotInfo  # noqa: E402

BACKSTOP_WORKER = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, {repo!r})
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.ops.mesh_collectives import preduce

    hvd.init()
    gen = int(os.environ["HVD_ELASTIC_GENERATION"])
    state = elastic.ObjectState(name="backstop", step=0)
    start = state.step
    axis = hvd.build_mesh(dp=hvd.size()).axis("dp")
    for step in range(state.step, 5):
        out = preduce(torch.ones(4), axis)
        assert float(out[0]) == hvd.size()
        state.step = step + 1
        state.save()
        if gen == 0 and step == 1:
            # a fence after the commit: rank 1 dies only once rank 0 has
            # committed step 2 too (the driver tears rank 0 down as soon
            # as rank 1 is gone)
            preduce(torch.ones(1), axis)
            if hvd.rank() == 1:
                os._exit(17)
    with open({log!r}, "a") as f:
        f.write(json.dumps(dict(rank=hvd.rank(), gen=gen, start=start,
                                step=state.step)) + "\\n")
    hvd.shutdown()
""")


def test_generation_restart_resumes_from_the_elastic_checkpoint(tmp_path):
    log = tmp_path / "done.jsonl"
    prog = tmp_path / "train.py"
    prog.write_text(BACKSTOP_WORKER.format(repo=REPO, log=str(log)))
    rc, driver, _ = worker.run_driver(
        FixedHosts([HostInfo("localhost", 2)]), [sys.executable, str(prog)],
        str(tmp_path), min_np=2, max_np=2, reset_limit=3,
        env={"HVD_TPU_GLOO_TIMEOUT_SECONDS": "30",
             "HVD_ELASTIC_SHRINK_WAIT_S": "2"})
    assert rc == 0
    done = sorted((json.loads(line) for line in log.read_text().splitlines()),
                  key=lambda d: d["rank"])
    # only generation 1 finishes, and it resumed from the committed step 2
    assert done == [dict(rank=r, gen=1, start=2, step=5) for r in (0, 1)]
    assert driver.final_generation == 1 and driver.final_np == 2
    state = journal_mod.load(os.path.join(tmp_path, "journal",
                                          journal_mod.JOURNAL_NAME))
    assert state.exits[(0, 1)]["state"] == "FAILURE"
    assert state.clean_exit == 0 and state.world_gen == 1


def test_takeover_rebuilds_driver_state(tmp_path):
    held = reserve_port()
    port = held.getsockname()[1]
    secret = "cd" * 16
    slots = [SlotInfo(hostname="localhost", rank=r, local_rank=r,
                      cross_rank=0, size=2, local_size=2, cross_size=1)
             for r in range(2)]
    doc = {"generation": 0, "size": 2, "coord_addr": "localhost",
           "coord_port": 7777, "slots": {}, "sig": "original-sig"}
    runtime = ElasticDriver._runtime_record(
        0, slots, "localhost", 7777, [(0, 0), (0, 1)],
        {(0, 0): 0, (0, 1): 1}, 0, 0)
    j = journal_mod.DriverJournal(str(tmp_path))
    j.append("job_open", secret=secret, kv_port=port,
             driver_addr="localhost", ckpt_dir=str(tmp_path),
             min_np=1, max_np=2, target_np=2, pid=1,
             ts=journal_mod.now_wall())
    evidence = {"reason": "quarantine", "rank": 1}
    j.append("blocklist", host="badhost", evidence=evidence,
             ts=journal_mod.now_wall())
    j.append("token", scope="action", key="a1", raw="req-bytes")
    j.append("reset", count=2)
    j.append("world_publish", doc=doc, **runtime)
    j.append("spawn", key=[0, 0], host="localhost", rank=0, pid=111,
             ts=journal_mod.now_wall())
    j.append("spawn", key=[0, 1], host="localhost", rank=1, pid=None,
             ts=journal_mod.now_wall())
    j.append("exit", key=[0, 0], state="SUCCESS", rank=0,
             host="localhost")
    j.append("notify", rank="1", addr="localhost:45678")
    j.close()
    pre = journal_mod.load(j.path)

    driver = ElasticDriver(
        FixedHosts([HostInfo("localhost", 2)]),
        [sys.executable, "-c", "pass"], min_np=1, max_np=2,
        ckpt_dir=str(tmp_path / "other"),
        journal_dir=str(tmp_path), takeover=True)
    held.close()
    g = None
    try:
        # identity adopted from the journal, not minted fresh
        assert driver._world_secret == bytes.fromhex(secret)
        assert driver._kv.port == port
        assert driver._ckpt_dir == str(tmp_path)
        assert driver._generation == pre.world_gen + 1

        g = driver._begin_takeover()
        # the last committed world is served again, verbatim
        assert json.loads(driver._kv.get("world", "current")) == doc
        assert g.world_gen == 0 and g.essential_keys == [(0, 0), (0, 1)]
        assert ("action", "a1", b"req-bytes") in g.handled_tokens
        assert driver._hosts.block_evidence("badhost") == evidence
        assert set(driver._hosts.dump_state()["blocklist"]) == \
            set(pre.blocklist)
        assert driver._registry.reset_count == 2
        assert driver._kv.get("notify", "1") == b"localhost:45678"
        assert g.results[(0, 0)] == "SUCCESS"
        assert (0, 1) in g.threads and g.threads[(0, 1)].is_alive()
        assert journal_mod.load(j.path).takeovers
    finally:
        if g is not None:
            g.teardown.set()
        driver._kv.stop()
        if driver._journal is not None:
            driver._journal.close()
