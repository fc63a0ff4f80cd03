"""The port's timeline shards, shard merger, causal reader and clock
offset against the JAX package's, on the CPU: a shard written by each
package's ``Timeline`` holds the same events (wall-clock fields apart),
and either package's merger folds the other's; ``merge_shards`` gives the
same document on the skewed, unreadable and truncated shards of
``tests/test_diagnostics.py:133-223``; ``merge_directory`` and the
``diagnostics`` CLI write the same trace; the reader's
``spans_from_events``, ``collect``, ``build_tree``, ``render_trace`` and
``build_timeline`` agree on the planes of ``tests/test_tracing.py:448-497``;
``estimate_wall_offset`` agrees when forced (to 1e-9) and, in a gloo world
of 2, measures a finite offset under a second that the shards carry.

The gloo ranks run ``python tests/test_torch_port_timeline.py --worker
clock --out DIR``, importing no JAX.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_worker import spawn_world, worker_main  # noqa: E402


# -- the worker (torch only) ---------------------------------------------------

def _w_clock():
    import json

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.basics import _state
    from horovod_tpu_torch.diagnostics.clock import estimate_wall_offset
    from horovod_tpu_torch.diagnostics.flight_recorder import wall_offset

    res = {"measured": np.array(estimate_wall_offset()),
           "at_init": np.array(wall_offset())}
    path = _state.timeline._file.name
    _state.timeline.instant("step", {"step": hvd.rank()})
    _state.timeline.close()
    with open(path) as f:
        meta = json.loads(f.read().splitlines()[1].rstrip(","))
    res["shard_offset_us"] = np.array(meta["args"]["wall_offset_us"])
    res["shard_rank"] = np.array(meta["args"]["rank"])
    return res


if __name__ == "__main__":
    sys.exit(worker_main({"clock": _w_clock}, sys.argv[1:]))


# -- the tests (JAX side in this process) ----------------------------------------

import io  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
from contextlib import redirect_stdout  # noqa: E402

import pytest  # noqa: E402

from horovod_tpu.common import timeline as j_timeline  # noqa: E402
from horovod_tpu.diagnostics import __main__ as j_cli  # noqa: E402
from horovod_tpu.diagnostics import clock as j_clock  # noqa: E402
from horovod_tpu.diagnostics import merge as j_merge  # noqa: E402
from horovod_tpu.tracing import reader as j_reader  # noqa: E402

from horovod_tpu_torch.common import timeline as t_timeline  # noqa: E402
from horovod_tpu_torch.diagnostics import __main__ as t_cli  # noqa: E402
from horovod_tpu_torch.diagnostics import clock as t_clock  # noqa: E402
from horovod_tpu_torch.diagnostics import merge as t_merge  # noqa: E402
from horovod_tpu_torch.tracing import reader as t_reader  # noqa: E402

HERE = os.path.abspath(__file__)
# wall-clock fields: compared for presence and type, not value
_WALL = ("ts", "epoch_us")


def _strip_wall(ev):
    out = {k: (type(v).__name__ if k in _WALL else v) for k, v in ev.items()}
    if isinstance(ev.get("args"), dict):
        out["args"] = _strip_wall(ev["args"])
    return out


def _shard(path, rank, epoch_s, offset_s, events):
    """A synthetic host shard anchored at shard ts=0 (the JAX tests')."""
    doc = [{"ph": "i", "name": "SHARD_META", "pid": rank, "tid": "meta",
            "ts": 0.0, "s": "g",
            "args": {"epoch_us": epoch_s * 1e6, "rank": rank,
                     "source": "host",
                     "wall_offset_us": offset_s * 1e6}}]
    doc.extend(events)
    with open(path, "w") as f:
        json.dump(doc, f)
    return str(path)


# -- timeline shards -------------------------------------------------------------

def _write_shards(mod, directory, offset_s):
    paths = []
    for rank in (0, 1):
        tl = mod.Timeline(rank)
        path = mod.shard_path(str(directory) + os.sep, rank)
        tl.start_shard(path, wall_offset_s=offset_s)
        assert tl.enabled
        tl.instant("step", {"step": 1, "rank": rank})
        tl.instant("checkpoint", {"step": 1})
        tl.stop()
        tl.instant("after_stop")  # dropped, in both packages
        paths.append(path)
    return paths


def test_timeline_shard_round_trip(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jp = _write_shards(j_timeline, tmp_path / "j", 0.25)
    tp = _write_shards(t_timeline, tmp_path / "t", 0.25)
    assert [os.path.basename(p) for p in tp] == \
        [os.path.basename(p) for p in jp] == \
        ["timeline.rank0.json", "timeline.rank1.json"]
    assert t_timeline.shard_paths_for(str(tmp_path / "t")) == sorted(tp)
    assert t_timeline.shard_path("/x/tl.json", 3) == \
        j_timeline.shard_path("/x/tl.json", 3) == "/x/tl.json.rank3.json"
    for j, t in zip(jp, tp):
        jev, tev = j_merge.load_shard(j), t_merge.load_shard(t)
        assert [_strip_wall(e) for e in tev] == [_strip_wall(e) for e in jev]
        assert tev[0]["args"]["wall_offset_us"] == 0.25e6
    # each package's merger folds the other's shards, one track a rank
    for merge, paths in ((j_merge, tp), (t_merge, jp)):
        doc = merge.merge_shards(paths)
        steps = {e["pid"]: e["args"]["rank"] for e in doc["traceEvents"]
                 if e.get("name") == "step"}
        assert steps == {0: 0, 1: 1}


def test_timeline_file_on_rank0_only(tmp_path):
    for mod, name in ((j_timeline, "j"), (t_timeline, "t")):
        for rank in (0, 1):
            path = tmp_path / f"{name}{rank}.json"
            tl = mod.Timeline(rank, str(path))
            tl.instant("x")
            tl.close()
            assert path.exists() == (rank == 0)
    assert [_strip_wall(e) for e in t_merge.load_shard(str(tmp_path / "t0.json"))] \
        == [_strip_wall(e) for e in j_merge.load_shard(str(tmp_path / "j0.json"))]


# -- the merger on the JAX fixtures -------------------------------------------------

def _case_skewed(tmp_path):
    ev = [{"ph": "B", "name": "ALLREDUCE", "cat": "collective",
           "tid": "grads", "ts": 1e6, "args": {"span": "grads#1"}}]
    return [_shard(tmp_path / "t.rank0.json", 0, 1000.0, 0.0, list(ev)),
            _shard(tmp_path / "t.rank1.json", 1, 1100.0, 100.0, list(ev))]


def _case_no_offset(tmp_path):
    ev = [{"ph": "B", "name": "A", "cat": "c", "tid": "x", "ts": 0.0}]
    return [_shard(tmp_path / "t.rank0.json", 0, 1000.0, 0.0, list(ev)),
            _shard(tmp_path / "t.rank1.json", 1, 1100.0, 0.0, list(ev))]


def _case_unreadable(tmp_path):
    ev = [{"ph": "B", "name": "A", "cat": "c", "tid": "x", "ts": 0.0}]
    good = _shard(tmp_path / "t.rank0.json", 0, 10.0, 0.0, ev)
    bad = tmp_path / "t.rank1.json"
    bad.write_text("")
    return [good, str(bad)]


def _case_truncated(tmp_path):
    path = tmp_path / "t.rank0.json"
    path.write_text('[\n{"ph": "B", "name": "A", "cat": "c", "tid": "x",'
                    ' "ts": 5.0},\n{"ph": "E", "na')
    cut = tmp_path / "t.rank1.json"
    cut.write_text('[\n{"ph": "i", "name": "SHARD_META", "pid": 1, "ts": 0.0,'
                   ' "args": {"epoch_us": 2e7, "rank": 1}},\n'
                   '{"ph": "i", "name": "m", "tid": "marker", "ts": 7.0},\n')
    return [str(path), str(cut)]


def _case_collision(tmp_path):
    """Two shards of one rank (host + core) and one without a meta."""
    ev = [{"ph": "B", "name": "A", "cat": "c", "tid": "x", "ts": 3.0}]
    a = _shard(tmp_path / "a.rank0.json", 0, 50.0, 0.0, list(ev))
    core = tmp_path / "core.rank0.json"
    core.write_text(json.dumps([
        {"ph": "i", "name": "SHARD_META", "ts": 1.0,
         "args": {"epoch_us": 5e7, "rank": 0, "source": "core"}},
        {"ph": "X", "name": "NEGOTIATE", "tid": "grads", "ts": 4.0,
         "dur": 2.0}, {}]))
    bare = tmp_path / "bare_rank_2.json"
    bare.write_text(json.dumps({"traceEvents": [
        {"ph": "i", "name": "z", "tid": "m", "ts": 9.0}]}))
    return [a, str(core), str(bare)]


@pytest.mark.parametrize("case", [_case_skewed, _case_no_offset,
                                  _case_unreadable, _case_truncated,
                                  _case_collision],
                         ids=lambda f: f.__name__[len("_case_"):])
def test_merge_shards_equals_jax(tmp_path, case):
    paths = case(tmp_path)
    jdoc = j_merge.merge_shards(paths, str(tmp_path / "j_merged.json"))
    tdoc = t_merge.merge_shards(paths, str(tmp_path / "t_merged.json"))
    assert tdoc == jdoc
    with open(tmp_path / "t_merged.json") as f:
        assert json.load(f) == jdoc
    for p in paths:
        try:
            want = j_merge.load_shard(p)
        except (OSError, ValueError):
            with pytest.raises((OSError, ValueError)):
                t_merge.load_shard(p)
            continue
        assert t_merge.load_shard(p) == want


def test_merge_aligns_skew_like_jax(tmp_path):
    doc = t_merge.merge_shards(_case_skewed(tmp_path))
    bs = [e for e in doc["traceEvents"] if e.get("ph") == "B"]
    assert len(bs) == 2 and abs(bs[0]["ts"] - bs[1]["ts"]) < 1.0
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e.get("ph") == "M" and e["name"] == "process_name"}
    assert names == {"rank 0", "rank 1"}


def test_merge_directory_and_cli_equal_jax(tmp_path):
    ev = [{"ph": "B", "name": "A", "cat": "c", "tid": "x", "ts": 0.0}]
    _shard(tmp_path / "timeline.rank0.json", 0, 10.0, 0.0, list(ev))
    _shard(tmp_path / "timeline.rank1.json", 1, 10.5, 0.5, list(ev))
    (tmp_path / "merged_old.json").write_text("[]")  # never an input
    assert t_merge.find_shards(str(tmp_path)) == \
        j_merge.find_shards(str(tmp_path))
    out = t_merge.merge_directory(str(tmp_path))
    assert out == os.path.join(str(tmp_path), "merged_trace.json")
    with open(out) as f:
        tdoc = json.load(f)
    assert tdoc == j_merge.merge_shards(
        j_merge.find_shards(str(tmp_path)))
    assert t_merge.merge_directory(str(tmp_path / "empty_nothing")) is None
    texts = {}
    for name, cli in (("j", j_cli), ("t", t_cli)):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert cli.main(["merge", "--dir", str(tmp_path), "-o",
                             str(tmp_path / "cli.json")]) == 0
        texts[name] = buf.getvalue()
        with open(tmp_path / "cli.json") as f:
            assert json.load(f) == tdoc
    assert texts["t"] == texts["j"]
    assert "2 track(s)" in texts["t"]
    with redirect_stdout(io.StringIO()):
        assert t_cli.main(["merge"]) == j_cli.main(["merge"]) == 2


# -- the reader on the tracing planes -------------------------------------------------

_TRACE, _ROOT, _CHILD = "ab" * 16, "12" * 8, "34" * 8


def _planes(tmp_path, offset_s=100.0):
    """The planes of tests/test_tracing.py's ``_fake_planes`` at a fixed
    time: a flight dump (request spans, skewed clock), an OBS store (a
    traced re-mesh point and a decision), a request log and a shard."""
    now = 1.7e9
    flight = {"rank": 1, "wall_offset_s": offset_s, "events": [
        {"ts": now + offset_s, "kind": "trace_span", "plane": "serving",
         "name": "request", "start": now + offset_s - 0.2, "dur_s": 0.2,
         "trace": _TRACE, "span": _ROOT, "seq": 1},
        {"ts": now + offset_s, "kind": "trace_span", "plane": "serving",
         "name": "dispatch", "start": now + offset_s - 0.19, "dur_s": 0.18,
         "trace": _TRACE, "span": _CHILD, "parent": _ROOT, "target": "h:1",
         "seq": 2},
        {"ts": now + offset_s, "kind": "serving_swap", "version": 3,
         "seq": 3},
        {"ts": now + offset_s + 0.01, "kind": "step_end", "step": 4,
         "trace": _TRACE, "span": _ROOT, "seq": 4},
        {"ts": now + offset_s + 0.02, "kind": "anomaly", "trace": _TRACE,
         "seq": 5}]}
    with open(tmp_path / "hvd_flight_rank1.json", "w") as f:
        json.dump(flight, f)
    (tmp_path / "flight_rank9.json").write_text("{garbled")
    obs = tmp_path / "obs"
    obs.mkdir()
    with open(obs / "obs_rank0.jsonl", "w") as f:
        f.write(json.dumps({
            "ts": now, "remesh": {"drain": 0.1}, "remesh_total_s": 0.5,
            "trigger": "preemption_drain", "trace": _TRACE,
            "span": "56" * 8, "parent": _ROOT}) + "\n")
        f.write(json.dumps({"ts": now, "step": 3}) + "\n")
    with open(obs / "actions_rank0.jsonl", "w") as f:
        f.write(json.dumps({
            "ts": now, "policy": "p", "outcome": "fired", "trace": _TRACE,
            "span": "78" * 8, "parent": _ROOT}) + "\n")
    reqlog = tmp_path / "reqlog.jsonl"
    with open(reqlog, "w") as f:
        f.write(json.dumps({
            "ts": now, "id": "r1", "outcome": "ok", "latency_s": 0.2,
            "trace": _TRACE, "span": _ROOT}) + "\n")
        f.write(json.dumps({"ts": now, "id": "r2", "outcome": "shed"})
                + "\n{torn")
    _shard(tmp_path / "timeline.rank0.json", 0, now, 0.0,
           [{"ph": "i", "name": "step", "tid": "marker", "ts": 5.0}])
    return obs, reqlog


def test_reader_equals_jax(tmp_path):
    obs, reqlog = _planes(tmp_path)
    flights = t_reader.find_flight_dumps(str(tmp_path))
    assert flights == j_reader.find_flight_dumps(str(tmp_path))
    assert len(flights) == 2
    assert t_reader.load_flight_dump(flights[0]) is None  # garbled
    doc = t_reader.load_flight_dump(flights[1])
    assert doc == j_reader.load_flight_dump(flights[1])
    for kw in ({}, {"offset_s": 100.0, "source": "s"},
               {"trace_id": _TRACE}, {"trace_id": "ffff"}):
        assert t_reader.spans_from_events(doc["events"], **kw) == \
            j_reader.spans_from_events(doc["events"], **kw)
    assert t_reader.read_jsonl(str(reqlog)) == j_reader.read_jsonl(str(reqlog))
    for tid in (None, _TRACE):
        data = t_reader.collect(flights, str(obs), [str(reqlog)], tid)
        assert data == j_reader.collect(flights, str(obs), [str(reqlog)], tid)
        assert t_reader.build_tree(data) == j_reader.build_tree(data)
        assert t_reader.render_trace(_TRACE, data) == \
            j_reader.render_trace(_TRACE, data)
    text = t_reader.render_trace(_TRACE, data)
    assert "serving:request" in text and "<< slow hop" in text
    assert t_reader.flight_to_chrome(doc) == j_reader.flight_to_chrome(doc)
    docs = t_reader.read_jsonl(str(reqlog))
    assert t_reader.jsonl_to_chrome(docs, "outcome") == \
        j_reader.jsonl_to_chrome(docs, "outcome")
    shards = [str(tmp_path / "timeline.rank0.json")]
    tdoc = t_reader.build_timeline(flights, shards, [str(reqlog)], str(obs),
                                   str(tmp_path / "t_tl.json"))
    assert tdoc == j_reader.build_timeline(flights, shards, [str(reqlog)],
                                           str(obs))
    with open(tmp_path / "t_tl.json") as f:
        assert json.load(f) == tdoc
    # the skew correction: the flight request span and the request log's
    # ok span (the same 0.2 s window) land together
    spans = [e for e in tdoc["traceEvents"] if e.get("ph") == "X"]
    req = [e for e in spans if e["name"] == "serving:request"][0]
    ok = [e for e in spans if e["name"] == "ok"][0]
    assert abs(req["ts"] - ok["ts"]) < 0.05e6


@pytest.mark.parametrize("verb", ["timeline", "trace", "trace_missing",
                                  "flight"])
def test_diagnostics_cli_equals_jax(tmp_path, verb):
    obs, reqlog = _planes(tmp_path)
    planes = ["--dir", str(tmp_path), "--obs-dir", str(obs),
              "--reqlog", str(reqlog)]
    argv = {"timeline": ["timeline", *planes],
            "trace": ["trace", _TRACE[:8], *planes],
            "trace_missing": ["trace", "ffff0000", "--dir", str(tmp_path)],
            "flight": ["flight", str(tmp_path / "hvd_flight_rank1.json"),
                       "--tail", "3"]}[verb]
    outs = {}
    for name, cli in (("j", j_cli), ("t", t_cli)):
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = cli.main(list(argv))
        outs[name] = (rc, buf.getvalue())
        if verb == "timeline":
            with open(tmp_path / "merged_timeline.json") as f:
                outs[name + "_doc"] = json.load(f)
    assert outs["t"] == outs["j"]
    assert outs["t"][0] == (1 if verb == "trace_missing" else 0)
    if verb == "timeline":
        assert outs["t_doc"] == outs["j_doc"]


# -- the clock offset ------------------------------------------------------------------

def test_wall_offset_forced_and_alone(monkeypatch):
    from horovod_tpu_torch.diagnostics import flight_recorder as t_flight
    monkeypatch.delenv("HVD_TPU_CLOCK_OFFSET_S", raising=False)
    # no process group: nothing to measure against, in both packages
    assert t_clock.estimate_wall_offset() == 0.0 == \
        j_clock.estimate_wall_offset(None)
    for forced in ("12.345678901", "-0.000001", "1e-9"):
        monkeypatch.setenv("HVD_TPU_CLOCK_OFFSET_S", forced)
        got, want = t_clock.estimate_wall_offset(), \
            j_clock.estimate_wall_offset(None)
        assert abs(got - want) <= 1e-9 and got == float(forced)
        assert t_flight.wall_offset() == float(forced)
    monkeypatch.setenv("HVD_TPU_CLOCK_OFFSET_S", "not-a-number")
    assert t_clock.estimate_wall_offset() == 0.0
    monkeypatch.delenv("HVD_TPU_CLOCK_OFFSET_S")
    t_flight.set_wall_offset(0.125)
    try:
        assert t_flight.wall_offset() == 0.125
        assert t_flight.recorder().dump()["wall_offset_s"] == 0.125
    finally:
        t_flight.set_wall_offset(0.0)


def test_wall_offset_in_a_gloo_world(tmp_path):
    out = spawn_world(HERE, "clock", 2, tmp_path, extra_env={
        "HVD_TPU_TIMELINE": str(tmp_path) + os.sep,
        "HVD_TPU_TIMELINE_ALL_RANKS": "1",
        "HVD_TPU_CLOCK_OFFSET_S": ""})
    for r, res in enumerate(out):
        measured = float(res["measured"])
        assert math.isfinite(measured) and abs(measured) < 1.0
        # init measured the offset, handed it to the flight recorder and
        # anchored the shard with it
        at_init = float(res["at_init"])
        assert abs(float(res["shard_offset_us"]) - at_init * 1e6) < 1e-3
        assert int(res["shard_rank"]) == r
    assert float(out[0]["measured"]) == 0.0  # the coordinator's own clock
    doc = t_merge.merge_shards(t_merge.find_shards(str(tmp_path)))
    assert doc == j_merge.merge_shards(j_merge.find_shards(str(tmp_path)))
    rows = sorted(e["args"]["name"] for e in doc["traceEvents"]
                  if e.get("name") == "process_name")
    assert rows == ["rank 0", "rank 1"]


def test_shard_anchor_on_disk_before_the_first_event(tmp_path):
    """A live shard with no event yet: the port's anchor is on disk, so
    an autopsy merging it mid-run still finds the rank. The JAX
    ``Timeline`` keeps ``SHARD_META`` in its file buffer until the first
    event reaches the writer (ROADMAP queue 3): pinned here, so a fix
    there shows."""
    jp, tp = tmp_path / "j.rank0.json", tmp_path / "t.rank0.json"
    jt, tt = j_timeline.Timeline(0), t_timeline.Timeline(0)
    jt.start_shard(str(jp), wall_offset_s=0.5)
    tt.start_shard(str(tp), wall_offset_s=0.5)
    try:
        assert jp.read_text() == ""
        with pytest.raises(ValueError):
            j_merge.load_shard(str(jp))
        events = t_merge.load_shard(str(tp))
        assert [e["name"] for e in events] == ["SHARD_META"]
        assert events[0]["args"]["wall_offset_us"] == 0.5e6
        doc = t_merge.merge_shards([str(tp)])
        assert [e["args"]["name"] for e in doc["traceEvents"]
                if e.get("name") == "process_name"] == ["rank 0"]
    finally:
        jt.stop()
        tt.stop()
    assert [_strip_wall(e) for e in t_merge.load_shard(str(tp))] == \
        [_strip_wall(e) for e in j_merge.load_shard(str(jp))]
