"""The port's launcher and elastic control plane against the JAX package's,
on the same inputs: host parsing and slot assignment, the launcher's
arguments, knob mirror and config file, host discovery's change detection,
blocklist and drains, the worker registry, the KV relay's addressing, the
driver journal's replay (the record streams of tests/test_driver_ha.py),
the world documents' signatures, ``ElasticSampler``'s indices, and durable
``ObjectState`` commits read by the other package."""

import json
import os
import textwrap

import numpy as np
import pytest

import horovod_tpu.elastic as jx_elastic
import horovod_tpu.runner.elastic.discovery as jx_discovery
import horovod_tpu.runner.elastic.journal as jx_journal
import horovod_tpu.runner.elastic.registration as jx_registration
import horovod_tpu.runner.hosts as jx_hosts
import horovod_tpu.runner.kv_relay as jx_relay
import horovod_tpu.runner.launch as jx_launch
import horovod_tpu.torch.elastic as jx_torch_elastic
import horovod_tpu_torch.elastic as pt_elastic
import horovod_tpu_torch.runner.elastic.discovery as pt_discovery
import horovod_tpu_torch.runner.elastic.journal as pt_journal
import horovod_tpu_torch.runner.elastic.registration as pt_registration
import horovod_tpu_torch.runner.hosts as pt_hosts
import horovod_tpu_torch.runner.kv_relay as pt_relay
import horovod_tpu_torch.runner.launch as pt_launch
import horovod_tpu_torch.torch.elastic as pt_torch_elastic

BOTH_HOSTS = (jx_hosts, pt_hosts)


# -- hosts -------------------------------------------------------------------
@pytest.mark.parametrize("spec,np_", [
    ("localhost:4", 4), ("a:2,b:2", 4), ("a:2,b:2", 3), ("a:3,b:1,c:2", 6),
    ("a:1,b:4,c:2", 5), ("h1,h2:3", 4)])
def test_host_assignments_match(spec, np_):
    outs = []
    for m in BOTH_HOSTS:
        hosts = m.parse_hosts(spec)
        slots = m.get_host_assignments(hosts, np_)
        outs.append(([(h.hostname, h.slots) for h in hosts],
                     [s.to_env() for s in slots],
                     [(s.hostname, s.rank, s.local_rank, s.cross_rank,
                       s.size, s.local_size, s.cross_size) for s in slots]))
    assert outs[0] == outs[1]


def test_hostfile_and_too_few_slots_match(tmp_path):
    f = tmp_path / "hosts"
    f.write_text("# comment\nnode1 slots=4\n\nnode2\nnode3 slots=2 x=1\n")
    got = [[(h.hostname, h.slots) for h in m.parse_hostfile(str(f))]
           for m in BOTH_HOSTS]
    assert got[0] == got[1] == [("node1", 4), ("node2", 1), ("node3", 2)]
    msgs = []
    for m in BOTH_HOSTS:
        with pytest.raises(ValueError) as ei:
            m.get_host_assignments(m.parse_hosts("a:1,b:1"), 3)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


# -- the launcher's arguments -------------------------------------------------
FULL_KNOBS = [
    "-np", "2",
    "--fusion-threshold-mb", "8", "--cycle-time-ms", "0.5",
    "--cache-capacity", "2048",
    "--hierarchical-allreduce", "--hierarchical-allgather",
    "--autotune", "--autotune-log-file", "/tmp/at.log",
    "--autotune-warmup-samples", "5",
    "--autotune-steps-per-sample", "20",
    "--autotune-bayes-opt-max-samples", "40",
    "--autotune-gaussian-process-noise", "1e-5",
    "--timeline-filename", "/tmp/tl.json", "--timeline-mark-cycles",
    "--no-stall-check",
    "--stall-warning-timeout-seconds", "30",
    "--stall-shutdown-timeout-seconds", "120",
    "--gloo-timeout-seconds", "45",
    "--thread-affinity", "0",
    "--log-level", "DEBUG", "--log-hide-timestamp",
    "python", "t.py"]


@pytest.mark.parametrize("argv", [
    FULL_KNOBS,
    ["-np", "4", "-H", "a:2,b:2", "--verbose", "python", "train.py", "--lr",
     "0.1"],
    ["--min-np", "2", "--max-np", "3", "--host-discovery-script", "d.sh",
     "--slots-per-host", "2", "--reset-limit", "3", "python", "t.py"],
    ["--start-timeout", "45", "--elastic-timeout", "60", "--", "python",
     "t.py"],
    ["--start-timeout", "45", "--gloo-timeout-seconds", "60", "python",
     "t.py"]])
def test_parse_args_and_knobs_to_env_match(argv):
    """The same namespace (the NIC-probe flags included) and
    environment."""
    got = []
    for m in (jx_launch, pt_launch):
        args = m.parse_args(list(argv))
        got.append((vars(args), m.knobs_to_env(args),
                    [(h.hostname, h.slots) for h in m.resolve_hosts(args)]
                    if not args.host_discovery_script else None))
    assert got[0] == got[1]
    if argv is FULL_KNOBS:
        assert len(got[1][1]) == 20


def test_config_file_env_matches(tmp_path):
    cfg = tmp_path / "hvd.yaml"
    cfg.write_text(textwrap.dedent("""\
        verbose: true
        start-timeout: 120
        elastic-timeout: 300
        slots: 4
        params:
          fusion-threshold-mb: 32
          cycle-time-ms: 2.5
          cache-capacity: 512
          hierarchical-allreduce: true
        autotune:
          enabled: true
          warmup_samples: 7
          gaussian-process-noise: 0.5
        timeline:
          filename: /tmp/tl.json
          mark-cycles: true
        stall_check:
          enabled: false
          warning_time_seconds: 33
        library_options:
          thread-affinity: 1
          gloo-timeout-seconds: 77
        logging:
          level: DEBUG
          hide-timestamp: true
        """))
    argv = ["-np", "2", "--config-file", str(cfg), "--cycle-time-ms",
            "9.0", "python", "t.py"]
    envs = [m.knobs_to_env(m.parse_args(list(argv)))
            for m in (jx_launch, pt_launch)]
    assert envs[0] == envs[1]
    assert envs[1]["HOROVOD_CYCLE_TIME"] == "9.0"          # the CLI wins
    assert envs[1]["HOROVOD_STALL_CHECK_DISABLE"] == "1"
    bad = tmp_path / "bad.yaml"
    bad.write_text("params:\n  cache-capacity: -5\n")
    for m in (jx_launch, pt_launch):
        with pytest.raises(ValueError, match="cache_capacity"):
            m.parse_args(["--config-file", str(bad), "python", "t.py"])


def test_check_build_and_tpu_refusal(capsys, monkeypatch):
    """check_build names the port's framework and backends. ``--tpu`` no
    longer refuses: off a metadata server it fails with the discovery's
    ``OSError`` (tests/test_torch_port_pod_discovery.py drives it against
    one), and the NIC-probe flags parse as the JAX launcher's."""
    report = pt_launch.check_build()
    assert "PyTorch" in report and "Gloo" in report and "JAX" not in report
    assert pt_launch.run_commandline(["--check-build"]) == 0
    monkeypatch.setenv("HVD_TPU_METADATA_ENDPOINT", "http://127.0.0.1:1")
    with pytest.raises(OSError, match="worker-network-endpoints"):
        pt_launch.run_commandline(["--tpu", "python", "t.py"])
    argv = ["--nics", "eth0, eth1", "--no-nic-probe", "python", "t.py"]
    args = pt_launch.parse_args(argv)
    assert (args.nics, args.no_nic_probe) == ("eth0, eth1", True)
    assert vars(args) == vars(jx_launch.parse_args(argv))


# -- discovery and the registry ------------------------------------------------
def _mock(module, seqs):
    class Mock(module.HostDiscovery):
        def __init__(self):
            self.i = 0

        def find_available_hosts_and_slots(self):
            seq = seqs[min(self.i, len(seqs) - 1)]
            self.i += 1
            return dict(seq)
    return Mock()


def _drive_host_manager(module):
    seqs = [{"a": 2}, {"a": 2}, {"a": 2, "b": 2}, {"b": 2, "a": 2},
            {"b": 2}, {"b": 2, "c": 1, "a": 1}, {"a": 2, "b": 2, "c": 2}]
    hm = module.HostManager(_mock(module, seqs))
    trace = []

    def note(changed):
        trace.append((changed, [(h.hostname, h.slots)
                                for h in hm.current_hosts()],
                      hm.slot_count()))
    for _ in range(3):
        note(hm.update_available_hosts())
    hm.blacklist("a", evidence={"reason": "test"})
    trace.append(hm.is_blacklisted("a"))
    note(hm.update_available_hosts())
    note(hm.update_available_hosts())
    hm.drain("b", 1, cooldown_s=60.0)
    note(None)
    hm.undrain("b", 1)
    note(None)
    note(hm.update_available_hosts())
    st = hm.dump_state()
    trace.append((sorted(st["blocklist"]), st["blocklist"]["a"]["evidence"],
                  sorted(st["drains"])))
    trace.append(hm.block_evidence("a"))
    return trace


def test_host_manager_matches():
    assert _drive_host_manager(jx_discovery) == \
        _drive_host_manager(pt_discovery)


def test_host_discovery_script_matches(tmp_path):
    script = tmp_path / "disc.sh"
    script.write_text("#!/bin/sh\necho hostA\necho hostB:8\necho\n")
    script.chmod(0o755)
    got = [m.HostDiscoveryScript(str(script), default_slots=4)
           .find_available_hosts_and_slots()
           for m in (jx_discovery, pt_discovery)]
    assert got[0] == got[1] == {"hostA": 4, "hostB": 8}


def _drive_registry(module):
    reg = module.WorkerStateRegistry(reset_limit=2)
    out = []
    reg.reset(3)
    reg.record(0, "a", module.SUCCESS)
    reg.record(1, "b", module.FAILURE)
    reg.record(2, "b", module.FAILURE)
    reg.record(3, "c", module.DRAINED)
    out += [reg.count(module.SUCCESS), reg.count(module.FAILURE),
            reg.failed_hosts(), reg.state_of(3), reg.state_of(9),
            reg.reset_count, reg.reset_limit_reached()]
    reg.note_reset()
    reg.restore_reset_count(1)
    out += [reg.reset_count, reg.reset_limit_reached()]
    reg.reset(3)
    out += [reg.reset_count, reg.reset_limit_reached(), reg.failed_hosts()]
    return out


def test_worker_state_registry_matches():
    assert _drive_registry(jx_registration) == \
        _drive_registry(pt_registration)


def test_relay_addressing_matches():
    for arity in range(0, 5):
        for rank in range(-1, 40):
            assert jx_relay.relay_parent(rank, arity) == \
                pt_relay.relay_parent(rank, arity), (rank, arity)
    assert pt_relay.FORWARD_SCOPES == jx_relay.FORWARD_SCOPES
    assert pt_relay.CACHED_SCOPES == jx_relay.CACHED_SCOPES


# -- the driver journal --------------------------------------------------------
def _fill(j) -> None:
    """tests/test_driver_ha.py's record stream."""
    j.append("job_open", secret="ab" * 16, kv_port=4567,
             driver_addr="localhost", ckpt_dir="/tmp/ck", min_np=1,
             max_np=3, target_np=2, pid=123, ts=1000.0)
    j.append("blocklist", host="badhost",
             evidence={"reason": "all_workers_failed"}, ts=1001.0)
    j.append("drain", host="oldhost", slots=2, remaining_s=60.0,
             ts=1002.0)
    j.append("token", scope="drain", key="k1", raw="payload")
    j.append("reset", count=2)
    j.append("notify", rank="9", addr="oldhost:1111")
    j.append("world_publish", doc={"generation": 0, "size": 2},
             world_gen=0, numbering_gen=0, essential_gen=0, np=2,
             coord_addr="localhost", coord_port=7777,
             slots=[], essential_keys=[[0, 0], [0, 1]],
             current_rank=[[[0, 0], 0], [[0, 1], 1]],
             expected_exits=[], drained_exits=[])
    j.append("spawn", key=[0, 0], host="localhost", rank=0, pid=111,
             ts=1003.0)
    j.append("spawn", key=[0, 1], host="localhost", rank=1, pid=222,
             ts=1003.5)
    j.append("exit", key=[0, 0], state="SUCCESS", rank=0,
             host="localhost")
    j.append("notify", rank="1", addr="localhost:9999")


_STATE_ATTRS = ("meta", "world", "live", "exits", "blocklist", "drains",
                "tokens", "notify", "reset_count", "takeovers", "clean_exit",
                "unknown", "torn_tail")


def _state(s) -> dict:
    out = {a: getattr(s, a) for a in _STATE_ATTRS}
    out["live_workers"] = s.live_workers()
    out["world_gen"], out["numbering_gen"] = s.world_gen, s.numbering_gen
    try:
        s.check_takeover()
        out["takeover"] = "ok"
    except Exception as e:     # the two packages' TakeoverRefused
        out["takeover"] = str(e)
    return out


def _tail_torn_spawn(path):
    with open(path, "ab") as f:
        f.write(b'{"t": "spawn", "key": [0, 2], "ho')


def _tail_torn_world(path):
    with open(path, "ab") as f:
        f.write(b'{"t": "world_publish", "doc": {"generation"')


def _extra_unknown(j):
    j.append("hologram", key=[9, 9])


def _extra_clean_exit(j):
    j.append("clean_exit", rc=0)


def _extra_newer_world(j):
    j.append("exit", key=[1, 0], state="FAILURE", rank=0, host="gone")
    j.append("world_publish", doc={"generation": 3, "size": 1},
             world_gen=3, numbering_gen=3, essential_gen=3, np=1,
             coord_addr="localhost", coord_port=7777, slots=[],
             essential_keys=[[3, 0]], current_rank=[[[3, 0], 0]],
             expected_exits=[], drained_exits=[])


@pytest.mark.parametrize("extra,tail,compact", [
    (None, None, False), (None, _tail_torn_spawn, False),
    (None, _tail_torn_world, False), (_extra_unknown, None, False),
    (_extra_clean_exit, None, False), (None, None, True),
    (_extra_newer_world, None, True)],
    ids=["plain", "torn_spawn", "torn_world_publish", "unknown_type",
         "clean_exit", "compacted", "compacted_newer_world"])
def test_journal_replay_matches(tmp_path, extra, tail, compact):
    """The same record stream replays to the same state in both packages,
    each reading its own journal and the other's (the files are byte for
    byte the same), once and twice over (idempotence)."""
    paths = {}
    for name, mod in (("jax", jx_journal), ("port", pt_journal)):
        j = mod.DriverJournal(str(tmp_path / name))
        _fill(j)
        if extra is not None:
            extra(j)
        if compact:
            assert j.maybe_compact(max_bytes=64) is True
        j.close()
        if tail is not None:
            tail(j.path)
        paths[name] = j.path
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    states = []
    for mod in (jx_journal, pt_journal):
        for path in paths.values():
            records, torn = mod.read_journal(path)
            once = _state(mod.replay(records, torn))
            twice = _state(mod.replay(records + records, torn))
            # every fold is last-wins or set-add; only the count of
            # skipped unknown records grows with the stream
            twice["unknown"] = once["unknown"]
            assert once == twice
            states.append(once)
    assert all(s == states[0] for s in states[1:])
    if tail is _tail_torn_world:
        assert "backstop" in states[0]["takeover"]


# -- world documents -----------------------------------------------------------
def test_world_doc_signatures_match_and_validate_across():
    secret = bytes(range(16))
    doc = {"generation": 3, "size": 2, "coord_addr": "127.0.0.1",
           "coord_port": 4321, "drain": {"ranks": [1], "hosts": ["h"]},
           "slots": {"0": {"HOROVOD_RANK": "0"}, "1": {"HOROVOD_RANK": "1"}}}
    sigs = [m.world_doc_signature(secret, dict(doc))
            for m in (jx_elastic, pt_elastic)]
    assert sigs[0] == sigs[1]
    assert sigs[0] == pt_elastic.world_doc_signature(
        secret, dict(doc, sig="ignored"))
    env = {"HVD_ELASTIC_SECRET": secret.hex()}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        for signer, reader in ((jx_elastic, pt_elastic),
                               (pt_elastic, jx_elastic)):
            signed = dict(doc, sig=signer.world_doc_signature(secret, doc))
            reader._current_generation = 2
            assert reader._validate_doc(json.dumps(signed).encode()) == \
                signed
            forged = dict(signed, coord_port=1)
            assert reader._validate_doc(json.dumps(forged).encode()) is None
            reader._current_generation = 3     # not newer: ignored
            assert reader._validate_doc(json.dumps(signed).encode()) is None
    finally:
        jx_elastic._current_generation = None
        pt_elastic._current_generation = None
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# -- ElasticSampler --------------------------------------------------------------
@pytest.mark.parametrize("n,size,shuffle,epoch,batches", [
    (10, 1, False, 0, []), (37, 3, True, 0, [(0, 4), (1, 4)]),
    (37, 4, True, 2, [(2, 3)]), (64, 2, True, 1, [(0, 8), (3, 8), (5, 2)]),
    (10, 4, False, 0, [(0, 9)])])
def test_elastic_sampler_indices_match(monkeypatch, n, size, shuffle, epoch,
                                       batches):
    got = []
    for mod in (jx_torch_elastic, pt_torch_elastic):
        monkeypatch.setattr(mod, "size", lambda: size)
        per_rank = []
        for r in range(size):
            monkeypatch.setattr(mod, "rank", lambda r=r: r)
            s = mod.ElasticSampler(list(range(n)), shuffle=shuffle, seed=5)
            s.set_epoch(epoch)
            first = list(iter(s))
            for b, bs in batches:
                s.record_batch(b, bs)
            st = s.state_dict()
            s2 = mod.ElasticSampler(list(range(n)), shuffle=shuffle, seed=5)
            s2.load_state_dict(st)
            per_rank.append((first, sorted(st["processed_indices"]),
                             list(iter(s2)), len(s2)))
        got.append(per_rank)
    assert got[0] == got[1]


# -- durable ObjectState commits, both ways ---------------------------------------
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_durable_object_state_restores_in_the_other_package(
        tmp_path, monkeypatch, writer):
    monkeypatch.setenv("HVD_TPU_CHECKPOINT_DIR", str(tmp_path))
    monkeypatch.delenv("HVD_ELASTIC_CKPT", raising=False)
    rng = np.random.RandomState(3)
    vals = {"step": 7, "lr": 0.25,
            "w": rng.randn(4, 6).astype(np.float32),
            "table": {"ids": rng.randint(0, 9, (5,)).astype(np.int64)}}
    src, dst = (jx_elastic, pt_elastic) if writer == "jax" else \
        (pt_elastic, jx_elastic)
    st = src.ObjectState(name="both_ways", durable=True, **vals)
    st.w = st.w * 2
    st.step = 8
    st.commit = st.save      # no driver: a plain durable save
    st.save()
    st.flush()
    back = dst.ObjectState(name="both_ways", durable=True, step=0, lr=0.0,
                           w=np.zeros((4, 6), np.float32),
                           table={"ids": np.zeros(5, np.int64)})
    assert back.step == 8 and back.lr == 0.25
    np.testing.assert_array_equal(np.asarray(back.w), vals["w"] * 2)
    np.testing.assert_array_equal(np.asarray(back.table["ids"]),
                                  vals["table"]["ids"])
