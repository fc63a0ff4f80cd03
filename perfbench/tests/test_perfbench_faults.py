"""A whole run at a tiny size on the CPU (the harness's look for a card
skipped), with the timed path broken underneath: ``correct`` has to come
out false for every fault the cell can have. A world of two gloo ranks
stands in for the four-card cell."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
TINY = {
    "resnet50.b256": ({"stage_sizes": [1, 1, 1, 1], "num_classes": 10,
                       "image_size": 64, "cudnn_benchmark": False},
                      {"rows_per_rank": 8, "image_size": 64, "classes": 10}),
    "bert_large.s128.b128": (
        {"hidden_size": 64, "num_attention_heads": 4, "num_hidden_layers": 2,
         "intermediate_size": 128, "vocab_size": 100,
         "max_position_embeddings": 64},
        {"rows_per_rank": 4, "seq_len": 16, "min_len": 8, "max_len": 16,
         "reference_block_rows": 2}),
}
TINY["bert_large.dp4.s128.b128"] = (
    TINY["bert_large.s128.b128"][0],
    {**TINY["bert_large.s128.b128"][1], "ranks": 2})
SEED = 2 ** 31 + 77


def _cell(name):
    cfg, traffic = TINY[name]
    return harness.Cell(name, cfg=cfg, traffic=traffic)


def _run_one(name, fault):
    rec = harness.run_rank(_cell(name), SEED, 0.3, False, device="cpu",
                           fault=fault)
    return harness.summarize(_cell(name), [rec], 0.0, False, "cpu")


RANK = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench import harness
cfg, traffic = json.loads(sys.argv[1])
cell = harness.Cell({name!r}, cfg=cfg, traffic=traffic)
rec = harness.run_rank(cell, {seed}, 0.3, False, device="cpu",
                       fault=sys.argv[2] or None)
open(sys.argv[3], "w").write(json.dumps(rec))
"""


def _run_two(name, fault, tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = RANK.format(root=str(ROOT), name=name, seed=SEED)
    procs = []
    for r in range(2):
        env = {**os.environ, "HOROVOD_RANK": str(r), "HOROVOD_SIZE": "2",
               "HOROVOD_LOCAL_RANK": str(r), "HOROVOD_LOCAL_SIZE": "2",
               "HOROVOD_GLOO_RENDEZVOUS_ADDR": "127.0.0.1",
               "HOROVOD_GLOO_RENDEZVOUS_PORT": str(port),
               "HOROVOD_TPU_OPERATIONS": "GLOO"}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, json.dumps(TINY[name]),
             fault or "", str(tmp_path / f"rank{r}.json")],
            cwd=tmp_path, env=env))
    try:
        for p in procs:
            assert p.wait(timeout=240) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(2)]
    return harness.summarize(_cell(name), recs, 0.0, False, "cpu")


CASES = [(c, f) for c in ("resnet50.b256", "bert_large.s128.b128")
         for f in ("unchanged", "half_batch", "leaf_doubled")] + [
    ("resnet50.b256", "stats_frozen")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_fault_on_one_rank_comes_out_not_correct(cell, fault):
    out = _run_one(cell, fault)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault", ["no_exchange", "unchanged", "half_batch",
                                   "leaf_doubled"])
def test_a_fault_across_ranks_comes_out_not_correct(fault, tmp_path):
    out = _run_two("bert_large.dp4.s128.b128", fault, tmp_path)
    assert out["correct"] is False, out["checks"]


def test_a_sound_run_across_ranks(tmp_path):
    out = _run_two("bert_large.dp4.s128.b128", None, tmp_path)
    assert out["checks"]["replicas_differ"]["value"] == 0.0
    assert out["metrics"]["samples_per_s"]["value"] > 0
    assert out["correct"] is True, out["checks"]
