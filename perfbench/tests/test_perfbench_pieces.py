"""The harness's pieces on the CPU: cells found by name, the contract of
``BENCHMARK.json``, the counts, the generator, the trace reduction, the
metric readers on a recorded trace, and the window's statistics."""

import json
import math
import re
import statistics
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from perfbench import flops, generator, harness, judge, trace

ROOT = Path(__file__).resolve().parents[2]
PERFBENCH = ROOT / "perfbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_pieces_by_name(cell):
    c = harness.Cell(cell)
    assert c.ranks == next(w["chips"] for w in BENCH["workloads"]
                           if w["name"] == cell)
    for fn in ("init", "build", "flops", "work", "ranges"):
        assert callable(getattr(c.module, fn)), fn
    assert generator.KINDS[c.traffic["kind"]]
    assert {"loss_gap", "window_nonfinite"} <= set(c.limits)
    assert any(k.startswith("grad_") for k in c.limits)
    assert any(k.startswith("change_") for k in c.limits)
    assert ("replicas_differ" in c.limits) == (c.ranks > 1)
    for m in c.per_layer:
        assert callable(c.reader(m["name"]))
    names = {m["name"] for m in c.end_to_end}
    assert {"setup_s", "samples_per_s"} <= names


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).exists()
        assert (PERFBENCH / "configs" / f"{c['name']}.py").exists()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (PERFBENCH / "traffic" / f"{w['traffic']}.json").exists()
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)
    layers = {}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert (PERFBENCH / "metrics" / f"{m['name']}.py").exists()
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values()), layers


def test_resnet50_operations_match_the_published_count():
    cfg = json.loads((PERFBENCH / "configs/resnet50.json").read_text())
    assert abs(flops.resnet_forward_macs(cfg) - 4.09e9) / 4.09e9 < 0.01


def test_bert_operations_per_token():
    cfg = json.loads((PERFBENCH / "configs/bert_large.json").read_text())
    b = {"input_ids": torch.zeros(2, 128, dtype=torch.long),
         "mlm_mask": torch.zeros(2, 128)}
    # no masked token: the encoder and the next-sentence head only
    H, I = 1024, 4096
    per_token = 6 * 24 * (4 * H * H + 2 * H * I) + 12 * 24 * 128 * H
    got = flops.bert_step(cfg, b) / 256
    assert abs(got - per_token) / per_token < 1e-4


def test_generator_is_a_function_of_the_seed():
    tr = json.loads((PERFBENCH / "traffic/pretrain_s128_b128.json")
                    .read_text())
    cfg = {"vocab_size": 1000}
    tr = {**tr, "rows_per_rank": 8}
    big = 2 ** 31 + 7
    a = generator.batch(tr, cfg, big, 1, "cpu")
    b = generator.batch(tr, cfg, big, 1, "cpu")
    c = generator.batch(tr, cfg, big, 2, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["input_ids"], c["input_ids"])
    lengths = a["attention_mask"].sum(1)
    assert lengths.min() >= tr["min_len"] and lengths.max() <= tr["max_len"]
    assert (a["mlm_mask"].bool() <= a["attention_mask"]).all()
    w1 = generator.draw_weights({"a": ((3, 4), "x"), "b": ((2,), "y")},
                                lambda s, r: ("normal", 0.5) if r == "x"
                                else ("fill", 1.0), big, "cpu")
    w2 = generator.draw_weights({"a": ((3, 4), "x"), "b": ((2,), "y")},
                                lambda s, r: ("normal", 0.5) if r == "x"
                                else ("fill", 1.0), big, "cpu")
    assert torch.equal(w1["a"], w2["a"]) and torch.equal(w1["b"],
                                                         torch.ones(2))
    assert generator.sub_seed(big, "w") != generator.sub_seed(big + 1, "w")


def _ev(name, start, end, device, thread=1, annotation=False, dev_us=0.0):
    return SimpleNamespace(
        name=name, device_type=device, is_user_annotation=annotation,
        thread=thread, device_time_total=dev_us,
        time_range=SimpleNamespace(start=start, end=end,
                                   elapsed_us=lambda: end - start))


def test_trace_reduction_of_a_recorded_timeline():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [
        _ev("perfbench.step", 0, 1000, cpu, dev_us=700),
        _ev("aten::conv", 10, 100, cpu),
        _ev("perfbench.bn", 100, 300, cpu, dev_us=250),
        _ev("aten::item", 400, 600, cpu),
        _ev("perfbench.optimizer", 700, 900, cpu, dev_us=100),
        _ev("conv_kernel", 50, 300, cuda),
        _ev("bn_kernel", 250, 500, cuda),        # overlaps the conv
        _ev("ncclDevKernel_AllReduce", 700, 800, cuda),
        _ev("adam_kernel", 800, 850, cuda),
        _ev("perfbench.bn", 260, 300, cuda, annotation=True),
    ]
    t = trace.reduce_events(events, steps=2, window_s=1e-3)
    assert t["busy_s"] == pytest.approx((500 - 50 + 850 - 700) / 1e6)
    assert t["range_us"] == {"step": 700, "bn": 250, "optimizer": 100}
    assert t["launches"] == 4
    assert t["breakdown"]["idle_gaps"] == [["aten::item", 200 / 1e6]]
    assert t["breakdown"]["device_ops"][0] == ["conv_kernel", 250 / 1e6]


def _record(t):
    return {"window": {"steps": 100, "window_s": 20.0,
                       "flops_per_step": 6.0e12},
            "trace": t, "host_step_ms": [30.0, 10.0, 20.0],
            "work": {"bn_bytes": 3.35e10, "attention_flops": 9.89e12,
                     "attention_bytes": 3.35e9},
            "peak": {"flops": 989e12, "bytes_per_s": 3.35e12}}


RECORDED = {"steps": 2, "window_s": 0.5, "busy_s": 0.4,
            "kernel_us": {"ncclDevKernel_AllReduce_Sum_f32": 1000.0,
                          "elementwise": 5000.0},
            "range_us": {"bn": 200000.0, "attention": 40000.0,
                         "optimizer": 3000.0}}


@pytest.mark.parametrize("metric,want", [
    ("step_mfu", 100.0 * 6.0e12 * 100 / 20.0 / 989e12),
    ("host_step_ms", 20.0),
    ("device_idle_pct", 20.0),
    ("grad_allreduce_ms", 0.5),
    ("optimizer_ms", 1.5),
    ("bn_ms", 100.0),
    ("bn_roofline", 10.0),        # 10 ms of bytes in 100 ms
    ("attention_ms", 20.0),
    ("attention_roofline", 50.0),  # 10 ms of operations in 20 ms
])
def test_metric_readers_on_a_recorded_trace(metric, want):
    read = harness.load_module(PERFBENCH / "metrics" / f"{metric}.py").read
    assert read(_record(RECORDED)) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["device_idle_pct", "grad_allreduce_ms",
                                    "optimizer_ms", "bn_ms", "bn_roofline",
                                    "attention_ms", "attention_roofline"])
def test_a_reader_with_nothing_to_read_returns_nothing(metric):
    read = harness.load_module(PERFBENCH / "metrics" / f"{metric}.py").read
    empty = {**RECORDED, "kernel_us": {}, "range_us": {}, "busy_s": 0.0}
    assert read({**_record(empty), "work": {}}) is None
    assert read({**_record(None), "trace": None}) is None


def test_percentile_and_rate_over_a_synthetic_window():
    ms = [100.0] * 89 + [300.0] * 11       # 100 steps, 11 slow ones
    assert harness._p90(ms) == 300.0
    assert harness._p90([100.0] * 90 + [300.0] * 10) == 100.0
    rec = {"rank": 0, "steps": 100, "step_ms": ms, "step_ms_p90": 300.0,
           "samples": 100 * 128, "window_s": 12.8, "window_nonfinite": 0,
           "memory_peak_bytes": 40e9, "window_start_wall": 1030.0,
           "digest_checked": [], "digest_end": [],
           "program": {"losses": [1.0], "grad": {"a": 1.0},
                       "change": {"a": 1.0},
                       "diff": {"grad": {"a": 0.0}}},
           "reference": {"losses": [1.0], "grad": {"a": 1.0},
                         "change": {"a": 1.0}, "matrices": ["a"]}}
    cell = harness.Cell("bert_large.s128.b128")
    out = harness.summarize(cell, [rec], 1000.0, False, "NVIDIA H100")
    m = out["metrics"]
    assert m["samples_per_s"]["value"] == pytest.approx(1000.0)
    assert m["step_ms_p90"]["value"] == 300.0
    assert m["setup_s"]["value"] == pytest.approx(30.0)
    assert m["peak_mem_gb"]["value"] == pytest.approx(40.0)
    assert out["correct"] is True and list(out)[-1] == "checks"
    # four ranks: samples of all of them, the fullest card, replicas
    recs = [{**rec, "rank": r, "memory_peak_bytes": 40e9 + r,
             "digest_checked": [1, 2], "digest_end": [3, r == 3]}
            for r in range(4)]
    cell4 = harness.Cell("bert_large.dp4.s128.b128")
    out = harness.summarize(cell4, recs, 1000.0, False, "NVIDIA H100")
    assert out["metrics"]["samples_per_s"]["value"] == pytest.approx(4000.0)
    assert out["device"]["memory_peak_bytes"] == 40e9 + 3
    assert out["checks"]["replicas_differ"]["value"] == 1.0
    assert out["correct"] is False


def test_judge_by_the_worst_leaf():
    ref = {"losses": [2.0, 1.0], "grad": {"a": 1.0, "b": 4.0, "q": 1e-9},
           "change": {"a": 2.0, "b": 2.0, "q": 1e-3, "a.mean": 0.5},
           "matrices": ["b"]}
    prog = {"losses": [2.02, 1.0], "grad": {"a": 1.1, "b": 4.0, "q": 0.0},
            "change": {"a": 2.0, "b": 2.4, "q": 7.0, "a.mean": 0.5}}
    n = judge.compare(prog, ref)
    assert n["loss_gap"] == pytest.approx(0.01)
    assert n["grad_gap"] == pytest.approx(0.1)   # against the median leaf
    assert n["change_gap"] == pytest.approx(0.2)  # q is left out
    assert n["grad_gap_matrices"] == 0.0 and "grad_error" not in n
    assert n["change_gap_matrices"] == pytest.approx(0.2)
    assert n["change_gap_stats"] == 0.0          # a.mean alone
    frozen = {**prog, "change": {**prog["change"], "a.mean": 0.0}}
    assert judge.compare(frozen, ref)["change_gap_stats"] == 1.0
    no_stats = {**ref, "change": {k: v for k, v in ref["change"].items()
                                  if k != "a.mean"}}
    assert "change_gap_stats" not in judge.compare(prog, no_stats)
    ok, checks = judge.verdict({**n, "window_nonfinite": 0.0},
                               {"loss_gap": 0.05, "grad_gap": 0.05,
                                "window_nonfinite": 0})
    assert not ok and checks["grad_gap"]["value"] == pytest.approx(0.1)
    ok, _ = judge.verdict({"loss_gap": math.nan}, {"loss_gap": 1.0})
    assert not ok
    assert statistics.median([1.0, 4.0, 1e-9]) == 1.0
