"""Elastic membership changes on the port, on the CPU: discovery grows the
job from 2 to 3 slots (the survivors re-mesh in place at a commit and the
new rank joins: the port's version of ``tests/test_elastic.py:307``), and
discovery drops a slot (the kept ranks shrink in place, the dropped one
leaves through the not-in-the-new-world path: ``:482``). The workers are
``tests/torch_port_elastic_worker.py``'s tiny flagship under
``elastic.run``."""

import os
import stat
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_elastic_worker as worker  # noqa: E402

from horovod_tpu_torch.runner.elastic.discovery import \
    HostDiscoveryScript  # noqa: E402


def _discovery(tmp_path, marker, before, after):
    script = tmp_path / "discover.sh"
    script.write_text(f"#!/bin/sh\nif [ -f {tmp_path / marker} ]; then "
                      f"echo localhost:{after}; else echo localhost:{before};"
                      f" fi\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return HostDiscoveryScript(str(script))


def _run(tmp_path, marker, before, after):
    out = str(tmp_path)
    cmd = worker.command(out, "--device", "cpu", "--tiny", "--steps", 16,
                         "--rows", 2, "--sleep", 0.3, "--marker-at",
                         f"2:{marker}")
    rc, _, _ = worker.run_driver(_discovery(tmp_path, marker, before, after),
                                 cmd, out, reset_limit=3,
                                 env={"HVD_TPU_GLOO_TIMEOUT_SECONDS": "60"})
    evs = worker.events(out)
    assert rc == 0, evs
    return ([e for e in evs if e["kind"] == "boot"],
            [e for e in evs if e["kind"] == "done"], evs)


def test_growth_keeps_every_survivor_running(tmp_path):
    boots, dones, evs = _run(tmp_path, "grow", 2, 3)
    # three boots: ranks 0 and 1 once each (not restarted), the new rank 2
    assert sorted(b["rank"] for b in boots) == [0, 1, 2], boots
    assert [b["size"] for b in boots if b["rank"] == 2] == [3]
    pid = {b["rank"]: b["pid"] for b in boots}
    assert sorted(d["rank"] for d in dones) == [0, 1, 2]
    for d in dones:
        assert d["size"] == 3 and d["pid"] == pid[d["rank"]]
        assert d["remesh"]["total"] == (1 if d["rank"] < 2 else 0)
    assert len({d["digest"] for d in dones}) == 1
    sizes = [e["size"] for e in evs if e["kind"] == "step" and
             e["rank"] == 0]
    assert sizes[0] == 2 and sizes[-1] == 3


def test_capacity_loss_shrinks_in_place(tmp_path):
    boots, dones, evs = _run(tmp_path, "shrink", 3, 2)
    assert sorted(b["rank"] for b in boots) == [0, 1, 2], boots
    pid = {b["rank"]: b["pid"] for b in boots}
    # the kept ranks finish in the world of two under the PIDs they booted
    assert sorted(d["rank"] for d in dones) == [0, 1]
    for d in dones:
        assert d["size"] == 2 and d["pid"] == pid[d["rank"]]
        assert d["remesh"]["total"] == 1
    assert len({d["digest"] for d in dones}) == 1
    assert not [e for e in evs if e["kind"] == "step" and e["rank"] == 2
                and e["size"] == 2]
