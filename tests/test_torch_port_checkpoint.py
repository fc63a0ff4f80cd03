"""The port's durable sharded checkpoint store against the JAX package's, on
the CPU: each test of the JAX store battery (``tests/test_checkpoint_
store.py``: leaf kinds, manifest, cross-world restore, commit barrier,
crash artifacts, GC, integrity, async errors, metrics), the restore
fallback of ``tests/test_integrity.py`` and the ``CheckpointCallback``
tests, at the JAX tests' expectations; then the two stores on one
directory both ways (the tiny flagship's parameters with a bf16 leaf, the
data cursor, the step), equal manifest leaves, torch optimizer state, the
cut under in-place updates, and a ``{tp:2}`` sharded commit of two gloo
ranks restored at world 1 and at ``{dp:2}``.

The gloo ranks run ``python tests/test_torch_port_checkpoint.py --worker
tp2 --out DIR``, importing no JAX. The six elastic ``ObjectState`` tests
wait for the elastic slice.
"""

import collections
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_worker import worker_main  # noqa: E402

CKPT_STEP = 1


def _tiny_cfg():
    import dataclasses

    from horovod_tpu_torch.entry import _flagship_cfg
    return dataclasses.replace(_flagship_cfg(tiny=True), n_layers=2)


# -- the worker (torch only) ---------------------------------------------------

def _w_tp2():
    """A {tp:2} world: one AdamW step, then a commit of the model and the
    optimizer state in which each rank writes its own blocks; then the
    same world as {dp:2} restores it onto whole leaves."""
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.checkpoint import (init_optimizer_state,
                                              load_model_state, model_state,
                                              optimizer_state)
    from horovod_tpu_torch.models import (Transformer, adamw, init_opt_state,
                                          init_params, make_train_step,
                                          shard_params)

    out_dir = os.environ["CKPT_TEST_DIR"]
    cfg = _tiny_cfg()
    mesh = hvd.build_mesh(tp=2)
    model = Transformer(cfg, "cpu", mesh)
    model.load_state_dict(shard_params(
        init_params(np.random.RandomState(0), cfg), cfg, mesh))
    opt = init_opt_state(adamw, model)
    rng = np.random.RandomState(1)
    tok = torch.from_numpy(rng.randint(0, cfg.vocab_size, (4, 16))).long()
    make_train_step(cfg, mesh)(model, opt, tok, torch.roll(tok, -1, 1))
    store = hvd.ShardedCheckpointer(out_dir, commit_timeout_s=60)
    store.save(CKPT_STEP, {"model": model_state(model),
                           "optim": optimizer_state(opt, model),
                           "step": CKPT_STEP}, wait=True)
    dist.barrier()
    res = {"rank": np.array(hvd.rank())}
    for k, p in model.state_dict().items():
        res[f"tp_param_{k}"] = p.numpy().copy()
    names = [k for k, _ in model.named_parameters()]
    for i, st in opt.state_dict()["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            res[f"tp_{k}_{names[i]}"] = st[k].numpy().copy()

    dp_mesh = hvd.build_mesh(dp=2)
    model2 = Transformer(cfg, "cpu", dp_mesh)
    opt2 = init_optimizer_state(adamw(model2.parameters()))
    like = {"model": model_state(model2),
            "optim": optimizer_state(opt2, model2), "step": 0}
    got = hvd.ShardedCheckpointer(out_dir).restore_latest(like=like)
    load_model_state(model2, got["model"])
    opt2.load_state_dict(got["optim"])
    res["dp_step"] = np.array(got["step"])
    for k, p in model2.state_dict().items():
        res[f"dp_param_{k}"] = p.numpy().copy()
    for i, st in opt2.state_dict()["state"].items():
        res[f"dp_step_{names[i]}"] = st["step"].numpy().copy()
        for k in ("exp_avg", "exp_avg_sq"):
            res[f"dp_{k}_{names[i]}"] = st[k].numpy().copy()
    return res


if __name__ == "__main__":
    sys.exit(worker_main({"tp2": _w_tp2}, sys.argv[1:]))


# -- the tests (JAX side in this process) ----------------------------------------

import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from horovod_tpu.checkpoint import ShardedCheckpointer as JaxStore  # noqa: E402
from horovod_tpu.checkpoint import format as jfmt  # noqa: E402
from horovod_tpu.models import init_params as jax_init_params  # noqa: E402

from horovod_tpu_torch.checkpoint import (CheckpointError, Shard,  # noqa: E402
                                          ShardedCheckpointer,
                                          init_optimizer_state,
                                          load_model_state, model_state,
                                          optimizer_state)
from horovod_tpu_torch.checkpoint import format as fmt  # noqa: E402
from horovod_tpu_torch.diagnostics.flight_recorder import recorder  # noqa: E402
from horovod_tpu_torch.metrics.registry import default_registry  # noqa: E402
from horovod_tpu_torch.models import (Transformer, adamw,  # noqa: E402
                                      from_jax_params, init_params,
                                      make_train_step)


@pytest.fixture(autouse=True)
def fresh_observability():
    default_registry().clear()
    recorder().clear()
    yield
    default_registry().clear()
    recorder().clear()


def _store(path, **kw):
    kw.setdefault("rank", 0)
    kw.setdefault("world_size", 1)
    return ShardedCheckpointer(str(path), **kw)


def _rich_state():
    return {
        "params": {"w": torch.arange(64.0).reshape(8, 8),
                   "b": torch.ones(8, dtype=torch.bfloat16)},
        "step": 7, "lr": 0.5, "name": "run1", "flag": True,
        # np.float64 subclasses python float — must stay a np scalar
        "hist": [1, 2, (3.5, np.float32(2.0)), np.float64(4.0)],
        "blob": collections.deque([1, 2]),  # pickle-fallback leaf
        "none": None,
    }


def _bits(t):
    """A tensor's raw bits, for equality to the bit."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


# ---------------------------------------------------------------- format


def test_roundtrip_all_leaf_kinds(tmp_path):
    """Python scalars stay python, np scalars stay np, bf16 survives the
    uint-view storage, arbitrary picklable leaves ride along; with
    ``like`` tuples stay tuples and ``None`` stays ``None`` (the JAX
    test's treedef path: the port writes no treedef), without it they are
    rebuilt from ``parts`` as lists."""
    ck = _store(tmp_path)
    state = _rich_state()
    ck.save(3, state, wait=True)
    for like in (state, None):
        out = ck.restore_latest(like=like)
        np.testing.assert_allclose(out["params"]["w"].numpy(),
                                   np.arange(64.0).reshape(8, 8))
        assert out["params"]["b"].dtype == torch.bfloat16
        assert out["step"] == 7 and type(out["step"]) is int
        assert out["lr"] == 0.5 and out["flag"] is True
        assert out["name"] == "run1"
        assert isinstance(out["hist"][2], tuple if like else list)
        assert type(out["hist"][2][1]) is np.float32
        assert type(out["hist"][3]) is np.float64 and out["hist"][3] == 4.0
        assert isinstance(out["blob"], collections.deque)
    assert "none" in ck.restore_latest(like=state)
    assert ck.restore_latest(like=state)["none"] is None
    ck.close()


def test_restore_with_like_places_on_layout(tmp_path):
    """A :class:`Shard` ``like`` leaf gets the current layout's block of
    the global leaf (the elastic re-layout contract), a tensor ``like``
    the whole leaf in the stored dtype."""
    ck = _store(tmp_path)
    state = _rich_state()
    ck.save(0, state, wait=True)
    like = dict(state)
    like["params"] = {
        "w": Shard(torch.empty(4, 2), (8, 8), [[4, 8], [2, 4]], True),
        "b": torch.zeros(8, dtype=torch.float32)}
    out = ck.restore(0, like=like)
    np.testing.assert_array_equal(
        out["params"]["w"].numpy(), np.arange(64.0).reshape(8, 8)[4:8, 2:4])
    assert out["params"]["b"].dtype == torch.bfloat16
    bad = dict(like, params={"w": Shard(torch.empty(4, 4), (8, 16),
                                        [[0, 4], [0, 4]], True)})
    with pytest.raises(CheckpointError, match="current layout"):
        ck.restore(0, like=bad)
    ck.close()


def test_restore_missing_leaf_raises(tmp_path):
    ck = _store(tmp_path)
    ck.save(0, {"a": torch.ones(4)}, wait=True)
    with pytest.raises(CheckpointError, match="has no value"):
        ck.restore(0, like={"a": torch.ones(4), "extra": torch.ones(2)})
    ck.close()


def test_manifest_contract(tmp_path):
    """The on-disk manifest carries what an external reader needs: world
    size, per-file sha256, global shapes/dtypes, shard→rank map; the
    treedef is null."""
    ck = _store(tmp_path)
    ck.save(5, {"w": torch.arange(16.0)}, wait=True)
    man = fmt.read_manifest(str(tmp_path), 5)
    assert man["version"] == fmt.SPEC_VERSION == jfmt.SPEC_VERSION
    assert man["world_size"] == 1 and man["step"] == 5
    assert man["treedef"] is None
    assert set(man["files"]) == {"shard_0.npz"}
    sha = fmt.file_sha256(os.path.join(fmt.step_dir(str(tmp_path), 5),
                                       "shard_0.npz"))
    assert man["files"]["shard_0.npz"] == sha
    (leaf,) = man["leaves"]
    assert leaf["kind"] == "array" and leaf["shape"] == [16]
    assert leaf["dtype"] == "float32"
    assert leaf["shards"][0]["rank"] == 0
    ck.close()


# --------------------------------------------- multi-rank save / reshard


def test_two_rank_save_restores_at_other_world_sizes(tmp_path):
    """Both ranks of a world-2 save write only their axis-0 slices; the
    committed checkpoint reassembles identically under stores configured
    for world sizes 1 and 3."""
    state = {"w": torch.arange(24.0).reshape(6, 4), "b": np.ones(5), "k": 3}
    s1 = _store(tmp_path, rank=1, world_size=2, commit_timeout_s=30)
    s1.save(10, state)  # queued: rank 1 waits for rank 0's attempt token
    assert s1.latest_step() is None
    s0 = _store(tmp_path, rank=0, world_size=2, commit_timeout_s=30)
    s0.save(10, state, wait=True)  # opens the attempt, then commits
    s1.wait()
    assert s0.latest_step() == 10

    man = fmt.read_manifest(str(tmp_path), 10)
    w_leaf = [rec for rec in man["leaves"] if rec["path"] == "['w']"][0]
    by_rank = {s["rank"]: s["index"] for s in w_leaf["shards"]}
    assert by_rank[0][0] == [0, 3] and by_rank[1][0] == [3, 6]

    for world in (1, 3):
        r = _store(tmp_path, rank=0, world_size=world)
        out = r.restore_latest()
        np.testing.assert_allclose(out["w"].numpy(), state["w"].numpy())
        np.testing.assert_allclose(out["b"].numpy(), state["b"])
        assert out["k"] == 3
    s0.close()
    s1.close()


def test_commit_times_out_without_peer_marker(tmp_path):
    """Rank 0 of a world-2 save whose peer never writes: the commit times
    out with an error, the tmp dir stays, and no checkpoint appears; once
    idle past the ttl, GC reclaims it."""
    s0 = _store(tmp_path, rank=0, world_size=2, commit_timeout_s=0.5)
    with pytest.raises(CheckpointError, match="timed out"):
        s0.save(4, {"w": torch.ones(4)}, wait=True)
    assert s0.latest_step() is None
    assert fmt.list_tmp_steps(str(tmp_path)) != []
    time.sleep(0.05)
    s0.gc(tmp_ttl=0.01)
    assert fmt.list_tmp_steps(str(tmp_path)) == []


def test_stale_attempt_marker_cannot_satisfy_commit(tmp_path):
    """A crashed generation's shard marker in ``step_N.tmp`` never
    satisfies a new attempt's commit barrier."""
    stale = np.zeros(8)
    fmt.write_shard(fmt.tmp_dir(str(tmp_path), 7), 1,
                    {"L0S0": stale[4:]},
                    [{"key": "L0S0", "leaf": 0, "index": [[4, 8]]}])
    s0 = _store(tmp_path, rank=0, world_size=2, commit_timeout_s=0.5)
    with pytest.raises(CheckpointError, match="timed out"):
        s0.save(7, {"w": torch.arange(8.0)}, wait=True)
    assert s0.latest_step() is None
    s0.close()


def test_fresh_peer_marker_after_stale_cleanup_commits(tmp_path):
    """Same wreckage, but the peer writes its FRESH shard after rank 0
    cleared the stale attempt: the commit restores the new state."""
    stale = np.zeros(8)
    fmt.write_shard(fmt.tmp_dir(str(tmp_path), 7), 1,
                    {"L0S0": stale[4:]},
                    [{"key": "L0S0", "leaf": 0, "index": [[4, 8]]}])
    fresh = {"w": torch.arange(8.0)}
    s0 = _store(tmp_path, rank=0, world_size=2, commit_timeout_s=20)
    s1 = _store(tmp_path, rank=1, world_size=2)
    s0.save(7, fresh)          # clears the stale tmp, commit pending
    s1.save(7, fresh, wait=True)
    s0.wait()
    out = s0.restore(7)
    np.testing.assert_array_equal(out["w"].numpy(), np.arange(8.0))
    s0.close()
    s1.close()


# ------------------------------------------------- crash artifacts + GC


def test_crash_artifacts_ignored_and_gced(tmp_path):
    ck = _store(tmp_path)
    ck.save(1, {"w": torch.ones(4)}, wait=True)
    os.makedirs(str(tmp_path / "step_2.tmp"))
    with open(str(tmp_path / "step_2.tmp" / "shard_0.npz"), "wb") as f:
        f.write(b"partial")
    os.makedirs(str(tmp_path / "step_3"))
    with open(str(tmp_path / "step_3" / "shard_0.npz"), "wb") as f:
        f.write(b"no manifest")

    assert ck.latest_step() == 1
    out = ck.restore_latest()
    np.testing.assert_allclose(out["w"].numpy(), np.ones(4))
    time.sleep(0.05)
    ck.gc(tmp_ttl=0.01)
    assert not os.path.exists(str(tmp_path / "step_2.tmp"))
    assert not os.path.exists(str(tmp_path / "step_3"))
    assert os.path.isdir(str(tmp_path / "step_1"))
    ck.close()


def test_restore_latest_warns_on_foreign_layout(tmp_path, caplog):
    import logging
    os.makedirs(str(tmp_path / "12"))
    ck = _store(tmp_path)
    with caplog.at_level(logging.WARNING):
        assert ck.restore_latest() is None
    assert any("another layout" in r.message for r in caplog.records)
    ck.close()


def test_gc_keeps_max_to_keep(tmp_path):
    ck = _store(tmp_path, max_to_keep=2)
    for step in range(5):
        ck.save(step, {"w": torch.ones(4)}, wait=True)
    assert ck.all_steps() == [3, 4]
    assert ck.latest_step() == 4
    ck.close()


def test_gc_never_touches_active_tmp(tmp_path):
    ck = _store(tmp_path)
    os.makedirs(str(tmp_path / "step_9.tmp"))
    with open(str(tmp_path / "step_9.tmp" / "shard_1.npz"), "wb") as f:
        f.write(b"still coming")
    ck.gc(tmp_ttl=60.0)
    assert os.path.isdir(str(tmp_path / "step_9.tmp"))
    ck.close()


def test_knobs_come_from_the_environment(tmp_path, monkeypatch):
    """``HVD_TPU_CHECKPOINT_MAX_TO_KEEP``/``_INFLIGHT``/``_COMMIT_TIMEOUT_S``
    are read when a store is made."""
    monkeypatch.setenv("HVD_TPU_CHECKPOINT_MAX_TO_KEEP", "1")
    monkeypatch.setenv("HVD_TPU_CHECKPOINT_COMMIT_TIMEOUT_S", "0.3")
    monkeypatch.setenv("HVD_TPU_CHECKPOINT_INFLIGHT", "1")
    ck = _store(tmp_path)
    for step in range(3):
        ck.save(step, {"w": torch.ones(4)}, wait=True)
    assert ck.all_steps() == [2]
    assert ck._writer._cap == 1
    s0 = _store(tmp_path / "w2", world_size=2)
    t0 = time.monotonic()
    with pytest.raises(CheckpointError, match="timed out"):
        s0.save(1, {"w": torch.ones(4)}, wait=True)
    assert time.monotonic() - t0 < 10
    ck.close()


# ---------------------------------------------------- integrity + errors


def test_corrupt_shard_detected(tmp_path):
    ck = _store(tmp_path)
    ck.save(0, {"w": torch.arange(32.0)}, wait=True)
    npz = os.path.join(fmt.step_dir(str(tmp_path), 0), "shard_0.npz")
    data = bytearray(open(npz, "rb").read())
    data[len(data) // 2] ^= 0xFF
    with open(npz, "wb") as f:
        f.write(data)
    with pytest.raises(CheckpointError, match="sha256 mismatch"):
        ck.restore(0)
    ck.close()


def test_unknown_spec_version_refused(tmp_path):
    ck = _store(tmp_path)
    ck.save(0, {"w": torch.ones(2)}, wait=True)
    path = os.path.join(fmt.step_dir(str(tmp_path), 0), fmt.MANIFEST)
    man = json.loads(open(path, "rb").read())
    man["version"] = 999
    with open(path, "w") as f:
        json.dump(man, f)
    with pytest.raises(CheckpointError, match="spec version"):
        ck.restore(0)
    ck.close()


def test_async_error_surfaces_on_wait(tmp_path, monkeypatch):
    """A background write failure is re-raised at the next wait/save,
    never swallowed, and the store stays usable."""
    ck = _store(tmp_path)

    def boom(*a, **k):
        raise OSError("disk gone")
    monkeypatch.setattr(fmt, "write_shard", boom)
    ck.save(0, {"w": torch.ones(2)})
    with pytest.raises(OSError, match="disk gone"):
        ck.wait()
    monkeypatch.undo()
    ck.save(1, {"w": torch.ones(2)}, wait=True)
    assert ck.latest_step() == 1
    snap = default_registry().snapshot()
    assert snap["hvd_checkpoint_failures_total"]["value"] == 1
    ck.close()


def test_save_under_backpressure_takes_its_cut_after_a_slot_frees(
        tmp_path, monkeypatch):
    """With one writer slot busy, a second ``save`` waits for the slot
    before it takes its snapshot, so at most ``max_inflight`` copies of
    the state are held; its commit is still the state at the call."""
    import threading
    ck = _store(tmp_path, max_inflight=1)
    release = threading.Event()
    write_shard = fmt.write_shard

    def slow(*a, **k):
        release.wait(30)
        return write_shard(*a, **k)
    monkeypatch.setattr(fmt, "write_shard", slow)
    cuts = []
    snapshot = ck._snapshot
    monkeypatch.setattr(ck, "_snapshot",
                        lambda state: cuts.append(1) or snapshot(state))
    ck.save(1, {"w": torch.ones(4)})
    second = threading.Thread(target=ck.save, args=(2, {"w": torch.zeros(4)}))
    second.start()
    time.sleep(0.3)
    assert len(cuts) == 1 and second.is_alive()
    release.set()
    second.join(30)
    assert not second.is_alive() and len(cuts) == 2
    ck.wait()
    assert torch.equal(ck.restore(1)["w"], torch.ones(4))
    assert torch.equal(ck.restore(2)["w"], torch.zeros(4))
    ck.close()


def test_double_save_same_step_rejected(tmp_path):
    ck = _store(tmp_path)
    ck.save(0, {"w": torch.ones(2)}, wait=True)
    with pytest.raises(CheckpointError, match="already committed"):
        ck.save(0, {"w": torch.ones(2)})
    ck.close()


def test_checkpoint_metrics_recorded(tmp_path):
    ck = _store(tmp_path)
    ck.save(2, {"w": torch.ones(128)}, wait=True)
    ck.restore(2)
    snap = default_registry().snapshot()
    assert snap["hvd_checkpoint_save_bytes_total"]["value"] >= 128 * 4
    assert snap["hvd_checkpoint_restore_bytes_total"]["value"] > 0
    assert snap["hvd_checkpoint_save_seconds"]["count"] >= 1
    assert snap["hvd_checkpoint_restore_seconds"]["count"] >= 1
    assert snap["hvd_checkpoint_last_step"]["value"] >= 2
    assert snap["hvd_checkpoint_inflight"]["value"] == 0
    kinds = [e["kind"] for e in recorder().events()]
    assert {"ckpt_save", "ckpt_commit", "ckpt_restore"} <= set(kinds)
    ck.close()


def _corrupt(path):
    b = bytearray(open(path, "rb").read())
    b[len(b) // 2] ^= 0xFF
    open(path, "wb").write(bytes(b))


def test_restore_latest_falls_back_past_corrupt_newest(tmp_path):
    ck = _store(tmp_path)
    ck.save(1, {"w": torch.arange(8.0)}, wait=True)
    ck.save(2, {"w": torch.arange(8.0) * 2}, wait=True)
    _corrupt(str(tmp_path / "step_2" / "shard_0.npz"))
    step, out = ck.restore_latest(return_step=True)
    assert step == 1
    np.testing.assert_array_equal(out["w"].numpy(), np.arange(8.0))
    snap = default_registry().snapshot()
    assert snap["hvd_checkpoint_restore_fallback_total"]["value"] == 1
    assert any(e["kind"] == "ckpt_restore_fallback" and e["step"] == 2
               and e["fallback_step"] == 1 for e in recorder().events())


def test_restore_latest_raises_when_every_commit_is_corrupt(tmp_path):
    ck = _store(tmp_path)
    ck.save(1, {"w": torch.arange(4.0)}, wait=True)
    ck.save(2, {"w": torch.arange(4.0)}, wait=True)
    _corrupt(str(tmp_path / "step_1" / "shard_0.npz"))
    _corrupt(str(tmp_path / "step_2" / "shard_0.npz"))
    with pytest.raises(CheckpointError):
        ck.restore_latest()


# --------------------------------------------------- CheckpointCallback


def test_checkpoint_callback_roundtrip(tmp_path):
    from horovod_tpu_torch.train.callbacks import CheckpointCallback
    cb = CheckpointCallback(str(tmp_path / "cb"), every_n_steps=2)
    state = {"w": torch.zeros(4), "step": 0}
    state = cb.on_train_begin(state)  # nothing to restore
    assert cb.restored_step is None and cb.next_step == 0
    for step in range(5):
        state = {"w": state["w"] + 1, "step": step}
        cb.on_step_end(step, state)
    cb.on_train_end(4, state)
    assert cb.store.latest_step() == 4
    cb.close()

    cb2 = CheckpointCallback(str(tmp_path / "cb"), every_n_steps=2)
    out = cb2.on_train_begin({"w": torch.zeros(4), "step": 0})
    assert cb2.restored_step == 4 and cb2.next_step == 5
    np.testing.assert_allclose(out["w"].numpy(), np.full(4, 5.0))
    assert int(out["step"]) == 4
    cb2.on_step_end(6, {"w": out["w"], "step": 6})
    cb2.store.wait()
    assert cb2.store.latest_step() == 6
    cb2.close()


def test_checkpoint_callback_needs_directory(monkeypatch):
    from horovod_tpu_torch.train.callbacks import CheckpointCallback
    monkeypatch.delenv("HVD_TPU_CHECKPOINT_DIR", raising=False)
    monkeypatch.delenv("HOROVOD_CHECKPOINT_DIR", raising=False)
    with pytest.raises(ValueError, match="CHECKPOINT_DIR"):
        CheckpointCallback()



def test_checkpoint_callback_directory_from_the_knob(tmp_path, monkeypatch):
    from horovod_tpu_torch.train.callbacks import CheckpointCallback
    monkeypatch.setenv("HVD_TPU_CHECKPOINT_DIR", str(tmp_path / "knob"))
    cb = CheckpointCallback()
    assert cb.store.directory == str(tmp_path / "knob")
    cb.close()


def test_checkpoint_callback_names_the_step_it_fell_back_to(tmp_path):
    """After a fallback past a corrupt newest commit, ``restored_step`` is
    the step actually restored (the JAX callback reads ``latest_step()``
    there, the corrupt one)."""
    from horovod_tpu_torch.train.callbacks import CheckpointCallback
    ck = _store(tmp_path)
    ck.save(3, {"w": torch.full((4,), 3.0)}, wait=True)
    ck.save(6, {"w": torch.full((4,), 6.0)}, wait=True)
    _corrupt(str(tmp_path / "step_6" / "shard_0.npz"))
    cb = CheckpointCallback(store=ck, every_n_steps=3)
    out = cb.on_train_begin({"w": torch.zeros(4)})
    assert cb.restored_step == 3 and cb.next_step == 4
    np.testing.assert_array_equal(out["w"].numpy(), np.full(4, 3.0))


# ------------------------------------------- the two packages, both ways


def _jax_state():
    """The tiny flagship's parameters (``ln_f`` in bf16), a data cursor
    and the step, as the JAX package holds them."""
    from __graft_entry__ import _flagship_cfg as jax_cfg
    params = jax_init_params(np.random.RandomState(0), jax_cfg(tiny=True), 1)
    params["ln_f"] = jnp.asarray(params["ln_f"] * 1.5).astype(jnp.bfloat16)
    return {"params": params, "data": {"epoch": 0, "cursor": 3}, "step": 3}


def _torch_state():
    """The same values as the port holds them: a Transformer's nested
    ``state_dict``."""
    from horovod_tpu_torch.entry import _flagship_cfg
    tree = _jax_state()
    ln_f = tree["params"].pop("ln_f")
    model = Transformer(_flagship_cfg(tiny=True), device="cpu")
    sd = from_jax_params(tree["params"])
    sd["ln_f"] = torch.from_numpy(
        np.asarray(ln_f).view(np.int16).copy()).view(torch.bfloat16)
    model.ln_f.data = model.ln_f.data.to(torch.bfloat16)
    model.load_state_dict(sd)
    return {"params": model_state(model),
            "data": {"epoch": 0, "cursor": 3}, "step": 3}


def _flat_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_leaves(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def _as_bits(x):
    if isinstance(x, torch.Tensor):
        return _bits(x)
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def test_jax_commit_restores_into_the_port_to_the_bit(tmp_path):
    jstore = JaxStore(str(tmp_path), rank=0, world_size=1)
    jstore.save(3, _jax_state(), wait=True)
    jstore.close()
    like = _torch_state()
    like["params"] = {k: torch.zeros_like(v) if isinstance(v, torch.Tensor)
                      else {kk: torch.zeros_like(vv) for kk, vv in v.items()}
                      for k, v in like["params"].items()}
    like["data"] = {"epoch": 9, "cursor": 9}
    out = _store(tmp_path).restore_latest(like=like)
    want = _flat_leaves(_jax_state()["params"])
    got = _flat_leaves(out["params"])
    assert sorted(got) == sorted(want)
    assert got["ln_f"].dtype == torch.bfloat16
    for k in want:
        np.testing.assert_array_equal(_as_bits(got[k]), _as_bits(want[k]),
                                      err_msg=k)
    assert out["data"] == {"epoch": 0, "cursor": 3} and out["step"] == 3
    model = Transformer(_tiny_flagship(), device="cpu")
    model.ln_f.data = model.ln_f.data.to(torch.bfloat16)
    load_model_state(model, out["params"])


def _tiny_flagship():
    from horovod_tpu_torch.entry import _flagship_cfg
    return _flagship_cfg(tiny=True)


def test_port_commit_restores_into_the_jax_store_to_the_bit(tmp_path):
    _store(tmp_path).save(3, _torch_state(), wait=True)
    out = JaxStore(str(tmp_path), rank=0, world_size=1).restore_latest()
    want = _flat_leaves(_jax_state()["params"])
    got = _flat_leaves(out["params"])
    assert sorted(got) == sorted(want)
    assert np.asarray(got["ln_f"]).dtype == jnp.bfloat16
    for k in want:
        np.testing.assert_array_equal(_as_bits(got[k]), _as_bits(want[k]),
                                      err_msg=k)
    assert out["data"] == {"epoch": 0, "cursor": 3} and out["step"] == 3


@pytest.mark.parametrize("world", [1, 2])
def test_manifests_of_the_same_state_have_equal_leaves(tmp_path, world):
    """The two packages' manifests of the same state, from every rank of
    the world, list the same leaves: paths, parts, kinds, shapes, dtypes
    and shard maps (the stored bytes are equal too)."""
    def commit(store_cls, path, state):
        stores = [store_cls(str(path), rank=r, world_size=world,
                            commit_timeout_s=30) for r in range(world)]
        for s in reversed(stores):
            s.save(3, state, wait=s is stores[0])
        for s in stores:
            s.wait()
            s.close()
        return fmt.read_manifest(str(path), 3)

    jm = commit(JaxStore, tmp_path / "jax", _jax_state())
    tm = commit(ShardedCheckpointer, tmp_path / "torch", _torch_state())
    assert jm["leaves"] == tm["leaves"]
    assert jm["treedef"] is not None and tm["treedef"] is None
    for r in range(world):
        j = np.load(str(tmp_path / "jax" / "step_3" / f"shard_{r}.npz"))
        t = np.load(str(tmp_path / "torch" / "step_3" / f"shard_{r}.npz"))
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            assert j[k].dtype == t[k].dtype
            np.testing.assert_array_equal(j[k], t[k])


def test_optimizer_state_roundtrips(tmp_path):
    """A fused AdamW's state (int-keyed ``state``, ``param_groups`` with
    the ``betas`` tuple, ``foreach`` None, bools, the ``step`` tensors)
    restores into a fresh optimizer made ready by
    ``init_optimizer_state``, and the next step is the uninterrupted
    run's to the bit."""
    cfg = _tiny_flagship()
    rng = np.random.RandomState(1)
    tok = torch.from_numpy(rng.randint(0, cfg.vocab_size, (4, 16))).long()
    tgt = torch.roll(tok, -1, 1)

    def fresh(seed):
        m = Transformer(cfg, device="cpu")
        m.load_state_dict(from_jax_params(init_params(
            np.random.RandomState(seed), cfg)))
        return m, adamw(m.parameters())

    step = make_train_step(cfg)
    model, opt = fresh(0)
    for _ in range(2):
        step(model, opt, tok, tgt)
    ck = _store(tmp_path)
    ck.save(2, {"model": model_state(model),
                "optim": optimizer_state(opt, model), "step": 2}, wait=True)
    step(model, opt, tok, tgt)

    model2, opt2 = fresh(5)
    init_optimizer_state(opt2)
    like = {"model": model_state(model2),
            "optim": optimizer_state(opt2, model2), "step": 0}
    out = ck.restore_latest(like=like)
    assert out["optim"]["param_groups"][0]["betas"] == (0.9, 0.999)
    assert out["optim"]["param_groups"][0]["foreach"] is None
    assert out["optim"]["param_groups"][0]["fused"] is True
    load_model_state(model2, out["model"])
    opt2.load_state_dict(out["optim"])
    assert float(opt2.state_dict()["state"][0]["step"]) == 2.0
    step(model2, opt2, tok, tgt)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(model2.state_dict()[k].numpy(),
                                      v.numpy(), err_msg=k)


def test_init_optimizer_state_moves_no_parameter():
    cfg = _tiny_flagship()
    m = Transformer(cfg, device="cpu")
    m.load_state_dict(from_jax_params(init_params(np.random.RandomState(0),
                                                  cfg)))
    before = {k: v.clone() for k, v in m.state_dict().items()}
    opt = init_optimizer_state(adamw(m.parameters()))
    assert len(opt.state) == len(before)
    assert all(p.grad is None for p in m.parameters())
    assert opt.param_groups[0]["lr"] == 1e-3
    for k, v in m.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_the_cut_is_the_state_at_save(tmp_path):
    """Every tensor updated in place right after ``save`` returns: the
    commit holds the values at the call."""
    ck = _store(tmp_path)
    state = {"a": torch.arange(1000.0), "b": {"c": torch.ones(7, 9),
                                              "d": torch.ones(3).bfloat16()}}
    want = {"a": state["a"].clone(), "c": state["b"]["c"].clone(),
            "d": state["b"]["d"].clone()}
    ck.save(1, state)
    for t in (state["a"], state["b"]["c"], state["b"]["d"]):
        t.mul_(-3.0).add_(1.0)
    ck.wait()
    out = ck.restore(1)
    assert torch.equal(out["a"], want["a"])
    assert torch.equal(out["b"]["c"], want["c"])
    assert torch.equal(out["b"]["d"], want["d"])


def test_goodput_books_the_inline_stall(tmp_path, monkeypatch):
    """A save inside an open goodput window books the seconds it held
    the caller as ``checkpoint_stall``."""
    from horovod_tpu_torch.metrics import goodput
    monkeypatch.setenv("HVD_TPU_GOODPUT_WINDOW", "2")
    goodput.reset()
    try:
        ck = _store(tmp_path)
        goodput.note_step_begin()
        goodput.note_step_end(0.001)
        ck.save(1, {"w": torch.ones(1 << 16)}, wait=True)
        assert ck.last_stall_s > 0
        goodput.note_step_begin()
        goodput.note_step_end(0.001)
        rec = goodput.ledger().last_window()
        assert rec["seconds"]["checkpoint_stall"] > 0
        assert rec["closed"]
    finally:
        goodput.reset()


# ------------------------------------------ a sharded commit, two ranks


@pytest.fixture(scope="module")
def tp2_world(tmp_path_factory):
    from test_torch_port_dp import spawn
    out = tmp_path_factory.mktemp("tp2")
    ckpt = tmp_path_factory.mktemp("tp2_ckpt")
    ranks = spawn("tp2", 2, out, extra_env={"CKPT_TEST_DIR": str(ckpt)},
                  script=__file__)
    return ranks, str(ckpt)


def test_tp2_commit_each_rank_wrote_its_blocks(tp2_world):
    ranks, ckpt = tp2_world
    man = fmt.read_manifest(ckpt, CKPT_STEP)
    assert man["world_size"] == 2
    by_path = {rec["path"]: rec for rec in man["leaves"]}
    wq = by_path["['model']['layers']['wq']"]
    assert sorted(s["rank"] for s in wq["shards"]) == [0, 1]
    assert [s["index"][3] for s in sorted(wq["shards"],
                                          key=lambda s: s["rank"])] \
        == [[0, 32], [32, 64]]
    ln = by_path["['model']['ln_f']"]
    assert [s["rank"] for s in ln["shards"]] == [0]
    moment = by_path["['optim']['state'][1]['exp_avg']"]   # layers.ln1
    assert [s["rank"] for s in moment["shards"]] == [0]


def test_tp2_commit_restores_at_world_1_and_dp2(tp2_world):
    """World 1 reassembles the global leaves, of which each tp rank held
    its block; the same world as ``{dp:2}`` restores whole leaves equal to
    world 1's, into a fresh model and optimizer."""
    from horovod_tpu_torch.models.transformer import _SPECS
    ranks, ckpt = tp2_world
    cfg = _tiny_cfg()
    full = _store(ckpt).restore_latest()
    model = Transformer(cfg, device="cpu")
    load_model_state(model, full["model"])
    names = [k for k, _ in model.named_parameters()]
    tp_dims = {k: [d for d, a in _SPECS.get(k.split(".")[-1], {}).items()
                   if a == "tp"] for k in names}
    for r, res in enumerate(ranks):
        assert int(res["rank"]) == r
        for k, v in model.state_dict().items():
            np.testing.assert_array_equal(
                res[f"tp_param_{k}"], _block(v.numpy(), tp_dims[k], r),
                err_msg=k)
        for i, name in enumerate(names):
            st = full["optim"]["state"][i]
            for m in ("exp_avg", "exp_avg_sq"):
                np.testing.assert_array_equal(
                    res[f"tp_{m}_{name}"],
                    _block(st[m].numpy(), tp_dims[name], r), err_msg=name)
        assert int(res["dp_step"]) == CKPT_STEP
        for k, v in model.state_dict().items():
            np.testing.assert_array_equal(res[f"dp_param_{k}"], v.numpy(),
                                          err_msg=k)
        for i, name in enumerate(names):
            st = full["optim"]["state"][i]
            assert float(res[f"dp_step_{name}"]) == 1.0
            for m in ("exp_avg", "exp_avg_sq"):
                np.testing.assert_array_equal(res[f"dp_{m}_{name}"],
                                              st[m].numpy(), err_msg=name)


def test_tp2_optimizer_state_restores_into_a_world_1_optimizer(tp2_world):
    """The ``{tp:2}`` commit's AdamW state, loaded into a fresh world-1
    optimizer through a ``like``: each moment is the two tp ranks' blocks
    side by side, and the step counts are the saved ones."""
    from horovod_tpu_torch.models.transformer import _SPECS
    ranks, ckpt = tp2_world
    cfg = _tiny_cfg()
    model = Transformer(cfg, device="cpu")
    opt = init_optimizer_state(adamw(model.parameters()))
    like = {"model": model_state(model),
            "optim": optimizer_state(opt, model), "step": 0}
    got = _store(ckpt).restore_latest(like=like)
    load_model_state(model, got["model"])
    opt.load_state_dict(got["optim"])
    names = [k for k, _ in model.named_parameters()]
    for i, name in enumerate(names):
        st = opt.state_dict()["state"][i]
        assert float(st["step"]) == 1.0, name
        dims = [d for d, a in _SPECS.get(name.split(".")[-1], {}).items()
                if a == "tp"]
        for m in ("exp_avg", "exp_avg_sq"):
            blocks = [res[f"tp_{m}_{name}"] for res in ranks]
            want = np.concatenate(blocks, axis=dims[0]) if dims \
                else blocks[0]
            np.testing.assert_array_equal(st[m].numpy(), want,
                                          err_msg=f"{m} {name}")


def _block(full, dims, r):
    """Block ``r`` of 2 along each of ``dims``."""
    for d in dims:
        n = full.shape[d] // 2
        full = np.take(full, range(r * n, (r + 1) * n), axis=d)
    return full
