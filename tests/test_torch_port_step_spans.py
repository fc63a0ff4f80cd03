"""The train step's spans in the port, on the CPU at tiny sizes.

Each step factory that runs backward and the optimizer itself
(``make_classifier_step``, ``make_bert_train_step``, the flagship's
``make_train_step`` and ``make_overlap_train_step``) opens ``hvd.step``
around ``hvd.forward``, ``hvd.backward``, ``hvd.sync_grads`` (each
gradient bucket's ``hvd.pack``, ``hvd.reduce`` and ``hvd.unpack``) and
``hvd.optimizer``: under ``torch.profiler`` as ranges, under
``profiling.record_spans`` in memory, and with neither on as nothing at
all. Spans change no number a step computes.
"""

import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch import profiling
from horovod_tpu_torch.train.buckets import plan_buckets
from horovod_tpu_torch.train.overlap import jax_ordered_parameters

BUCKET_BYTES = 1024
FACTORIES = ["classifier", "bert", "transformer", "overlap",
             "overlap_hooked"]
PHASES = ["hvd.forward", "hvd.backward", "hvd.sync_grads", "hvd.optimizer"]


@pytest.fixture(scope="module")
def mesh():
    """A gloo world of one with small gradient buckets, so every step
    syncs several."""
    from horovod_tpu_torch.common.config import reset_config
    mp = pytest.MonkeyPatch()
    hvd.shutdown()
    for k in ("HVD_TPU_SIZE", "HOROVOD_SIZE", "HVD_TPU_RANK", "HOROVOD_RANK",
              "HVD_TPU_AUTOTUNE_MESH", "HVD_TPU_AUTOTUNE_CACHE_DIR"):
        mp.delenv(k, raising=False)
    mp.setenv("HOROVOD_TPU_OPERATIONS", "GLOO")
    mp.setenv("HVD_TPU_BUCKET_BYTES", str(BUCKET_BYTES))
    reset_config()
    hvd.init()
    yield hvd.build_mesh(dp=1)
    hvd.shutdown()
    mp.undo()
    reset_config()


class _Tiny(torch.nn.Module):
    """A classifier for ``make_classifier_step``: flattened images through
    two dense layers, built with the step's mesh."""

    def __init__(self, mesh):
        super().__init__()
        self.mesh = mesh
        gen = torch.Generator().manual_seed(0)
        self.a = torch.nn.Parameter(torch.randn(48, 16, generator=gen) / 7)
        self.b = torch.nn.Parameter(torch.zeros(16))
        self.c = torch.nn.Parameter(torch.randn(16, 4, generator=gen) / 4)

    def forward(self, images):
        return torch.tanh(images.flatten(1) @ self.a + self.b) @ self.c


def _images():
    gen = torch.Generator().manual_seed(1)
    return torch.rand(4, 3, 4, 4, generator=gen), torch.tensor([0, 1, 2, 3])


def _build(kind, mesh, scan_steps=1):
    """``(call, model, n_buckets)``: ``call()`` runs one call of the
    factory's step on a fixed batch and returns its loss."""
    if kind == "classifier":
        from horovod_tpu_torch.models._flax import make_classifier_step
        model = _Tiny(mesh)
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        step = make_classifier_step(model, mesh, scan_steps)
        x, y = _images()

        def call():
            return step(model, opt, x, y)[2]
    elif kind == "bert":
        from horovod_tpu_torch.models import bert
        cfg = bert.BertConfig(vocab_size=30, hidden_size=16, num_layers=1,
                              num_heads=2, intermediate_size=32,
                              max_position=16, type_vocab_size=2,
                              dtype=torch.float32)
        model = bert.init_bert(bert.Bert(cfg, "cpu", mesh), 0)
        opt = bert.adamw(model.parameters())
        step = bert.make_bert_train_step(model, mesh, scan_steps)
        gen = torch.Generator().manual_seed(2)
        batch = {"input_ids": torch.randint(0, 30, (2, 8), generator=gen),
                 "token_type_ids": torch.zeros(2, 8, dtype=torch.long),
                 "attention_mask": torch.ones(2, 8, dtype=torch.long),
                 "mlm_labels": torch.randint(0, 30, (2, 8), generator=gen),
                 "mlm_mask": (torch.arange(8) % 3 == 0).float().expand(2, 8),
                 "nsp_labels": torch.tensor([0, 1])}

        def call():
            return step(model, opt, batch)[2]
    elif kind == "transformer":
        from horovod_tpu_torch.entry import _flagship_cfg
        from horovod_tpu_torch.models import (Transformer, adamw,
                                              from_jax_params, init_params,
                                              make_train_step)
        cfg = _flagship_cfg(tiny=True)
        model = Transformer(cfg, device="cpu")
        model.load_state_dict(from_jax_params(
            init_params(np.random.RandomState(0), cfg)))
        opt = adamw(model.parameters())
        step = make_train_step(cfg, None, scan_steps)
        gen = torch.Generator().manual_seed(3)
        tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
        targets = torch.roll(tokens, -1, 1)

        def call():
            return step(model, opt, tokens, targets)[2]
        return call, model, 0
    else:
        from horovod_tpu_torch.train.overlap import make_overlap_train_step
        model = _Tiny(mesh)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        step = make_overlap_train_step(
            lambda m, b: F.cross_entropy(m(b[0]), b[1]), mesh, "dp",
            bucket_bytes=BUCKET_BYTES, overlap=kind == "overlap_hooked")
        batch = _images()

        def call():
            return step(model, opt, batch)[2]
    params = jax_ordered_parameters(model)[1]
    return call, model, plan_buckets(params, BUCKET_BYTES).num_buckets


def _spans(prof):
    cpu = torch.autograd.DeviceType.CPU
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == cpu and e.name.startswith("hvd.")),
                  key=lambda s: s[1])


def _inside(outer, spans, name=None):
    return [s for s in spans if s is not outer and outer[1] <= s[1]
            and s[2] <= outer[2] and (name is None or s[0] == name)]


@pytest.mark.parametrize("kind", FACTORIES)
def test_every_step_opens_its_phases_in_order(kind, mesh):
    call, _, n_buckets = _build(kind, mesh)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        call()
        call()
    spans = _spans(prof)
    steps = [s for s in spans if s[0] == "hvd.step"]
    assert len(steps) == 2
    for step in steps:
        phases = [s for s in _inside(step, spans)
                  if s[0] in PHASES]
        assert [s[0] for s in phases] == PHASES
        forward, backward, sync, _ = phases
        if kind == "transformer":      # no data axis: nothing to sync
            continue
        assert n_buckets >= 2
        # overlapped, the buckets are packed and issued in backward
        issued = backward if kind == "overlap_hooked" else sync
        for name in ("hvd.pack", "hvd.reduce"):
            assert len(_inside(issued, spans, name)) == n_buckets
        waited = _inside(sync, spans, "hvd.unpack")
        assert len(waited) >= n_buckets
        assert not _inside(forward, spans, "hvd.pack")


@pytest.mark.parametrize("kind", ["classifier", "bert", "transformer"])
def test_chained_steps_are_steps_of_their_own(kind, mesh):
    call, _, _ = _build(kind, mesh, scan_steps=2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        call()
    spans = _spans(prof)
    assert sum(s[0] == "hvd.step" for s in spans) == 2
    assert sum(s[0] == "hvd.optimizer" for s in spans) == 2


@pytest.mark.parametrize("kind", FACTORIES)
def test_spans_enter_no_range_when_nothing_listens(kind, mesh, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert profiling.annotate("hvd.a") is profiling.annotate("hvd.b")
    call, _, _ = _build(kind, mesh)
    assert torch.isfinite(call())
    with pytest.raises(AssertionError, match="entered"):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            call()


@pytest.mark.parametrize("kind", FACTORIES)
def test_tracing_changes_no_number(kind, mesh):
    plain, plain_model, _ = _build(kind, mesh)
    traced, traced_model, _ = _build(kind, mesh)
    want = [plain() for _ in range(3)]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.record_spans() as rec:
            got = [traced() for _ in range(3)]
    assert sum(s.name == "hvd.step" for s in rec.spans) == 3
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    for (k, a), (_, b) in zip(plain_model.state_dict().items(),
                              traced_model.state_dict().items()):
        assert torch.equal(a, b), k


def test_recorded_spans_nest_and_keep_threads_apart():
    def worker():
        with profiling.annotate("hvd.other"):
            with profiling.annotate("hvd.inner"):
                pass

    with profiling.record_spans() as rec:
        with profiling.annotate("hvd.outer"):
            with profiling.annotate("hvd.mid"):
                t = threading.Thread(target=worker)
                t.start()
                t.join(timeout=30)
                with profiling.annotate("hvd.leaf"):
                    pass
    assert not t.is_alive()
    by = {s.name: s for s in rec.spans}
    assert set(by) == {"hvd.outer", "hvd.mid", "hvd.leaf", "hvd.other",
                       "hvd.inner"}
    assert by["hvd.outer"].parent is None
    assert by["hvd.mid"].parent == by["hvd.outer"].id
    assert by["hvd.leaf"].parent == by["hvd.mid"].id
    # the other thread's spans start their own tree
    assert by["hvd.other"].parent is None
    assert by["hvd.inner"].parent == by["hvd.other"].id
    assert by["hvd.other"].thread != by["hvd.outer"].thread
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
    assert by["hvd.outer"].start_ns <= by["hvd.mid"].start_ns \
        <= by["hvd.leaf"].start_ns <= by["hvd.leaf"].end_ns \
        <= by["hvd.mid"].end_ns <= by["hvd.outer"].end_ns
    wall, mono = rec.anchor
    assert wall > 1e9 and mono > 0
    assert profiling.annotate("hvd.after") is profiling.annotate("hvd.x")


def test_recording_is_bounded_and_one_at_a_time():
    with profiling.record_spans(limit=3) as rec:
        for _ in range(5):
            with profiling.annotate("hvd.s"):
                pass
        with pytest.raises(RuntimeError, match="already"):
            with profiling.record_spans():
                pass
    assert len(rec.spans) == 3 and rec.dropped == 2
    with profiling.record_spans() as again:
        with profiling.annotate("hvd.s"):
            pass
    assert len(again.spans) == 1 and again.dropped == 0


@pytest.mark.parametrize("kind", ["classifier", "bert"])
def test_recorded_phases_fit_inside_their_step(kind, mesh):
    call, _, _ = _build(kind, mesh)
    with profiling.record_spans() as rec:
        call()
        call()
    steps = [s for s in rec.spans if s.name == "hvd.step"]
    assert len(steps) == 2
    for step in steps:
        phases = [s for s in rec.spans if s.parent == step.id]
        assert [s.name for s in phases] == PHASES
        assert sum(s.end_ns - s.start_ns for s in phases) \
            <= step.end_ns - step.start_ns
        for a, b in zip(phases, phases[1:]):
            assert a.end_ns <= b.start_ns
