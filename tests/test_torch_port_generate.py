"""The port's generative decode path against the JAX package's, on the CPU.

The decode math (``decode_step_paged``, ``prefill_chunk_paged``,
``reference_greedy_decode``) at the demo size (V 64, M 32, L 2, H 2) and a
wider one (V 512, M 128, H 4, L 2, ``max_seq`` 128) with the same numpy
weights and pools on both sides; the page planner, page pool and slot
scheduler under the same call sequences; the staggered continuous engine
against the JAX engine and the JAX oracle; and the JAX battery of
``tests/test_generate.py`` (admission limits, the prefill-emitted token in
``gen_tokens_total``, continuous against gang decode steps, deadline,
drain, metric names) and the generate cases of
``tests/test_serving_ledger.py`` (swap pause, slot wait against page wait)
run against the port at their expectations. The JAX side runs as its own
tests run it, in-process on the CPU.

Tolerances: next tokens are held equal; K/V pools within 1e-5 absolute
(fp32 products summed in another order: the measured gap is ~1e-6),
outside the scratch page, which holds masked lanes' writes whose order of
duplicates neither package fixes.
"""

import time

import numpy as np
import pytest
import torch

POOL_TOL = 1e-5

DEMO = dict(vocab=64, d_model=32, n_layers=2, n_heads=2, max_seq=64)
WIDE = dict(vocab=512, d_model=128, n_layers=2, n_heads=4, max_seq=128)


def _configs(size):
    """(JAX params, JAX cfg, port state_dict, port cfg) of one seed."""
    from horovod_tpu.serving.generate import demo_gen_setup as jax_setup

    from horovod_tpu_torch.serving.generate import demo_gen_setup
    jp, jcfg = jax_setup(**size)
    sd, cfg = demo_gen_setup(**size, device="cpu")
    return jp, jcfg, sd, cfg


def _port_engine(**over):
    from horovod_tpu_torch.serving.generate import (GenerateEngine,
                                                    demo_gen_setup)
    params, cfg = demo_gen_setup(device="cpu")
    kw = dict(n_slots=4, page_bytes=4096, prefill_chunk=8, device="cpu")
    kw.update(over)
    return GenerateEngine(params, cfg, **kw)


def _run_to_done(engine, reqs, guard=50_000):
    from horovod_tpu_torch.serving.generate.scheduler import DONE
    n = 0
    while any(r.state != DONE for r in reqs):
        engine.step_once()
        n += 1
        assert n < guard, "engine failed to converge"


def _reqset(rng, n, max_prompt=20, max_new_hi=8, vocab=64):
    """Mixed-length prompts/budgets off one seeded stream (the JAX
    test's ``_reqset``)."""
    out = []
    for _ in range(n):
        plen = int(rng.randint(1, max_prompt + 1))
        out.append(([int(t) for t in rng.randint(0, vocab, size=plen)],
                    int(rng.randint(1, max_new_hi + 1))))
    return out


# -- the decode math against JAX ----------------------------------------------
def _pools(rng, L, total, pt, width):
    return (rng.randn(L, total + 1, pt, width).astype(np.float32),
            rng.randn(L, total + 1, pt, width).astype(np.float32))


@pytest.mark.parametrize("size", [DEMO, WIDE], ids=["demo", "wide"])
def test_decode_step_matches_jax(size):
    import jax.numpy as jnp
    from horovod_tpu.models import transformer as JT

    from horovod_tpu_torch.models import transformer as PT
    jp, jcfg, sd, cfg = _configs(size)
    rng = np.random.RandomState(3)
    L, W = cfg.n_layers, cfg.n_heads * cfg.head_dim
    S, P, pt = 5, 4, 4
    total = 3 * P
    kp, vp = _pools(rng, L, total, pt, W)
    table = np.full((S, P), total, np.int32)
    table[0] = [0, 1, 2, 3]
    table[1] = [8, 5, 11, 4]
    table[3] = [7, 6, 9, 10]
    lengths = np.array([5, 14, 0, 3, 0], np.int32)
    last = rng.randint(0, cfg.vocab_size, size=S).astype(np.int32)
    active = np.array([True, True, False, True, False])
    jn, jk, jv = JT.decode_step_paged(
        JT.flatten_decode_params(jp), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(lengths), jnp.asarray(last),
        jnp.asarray(active), jcfg)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    pn, rk, rv = PT.decode_step_paged(
        PT.flatten_decode_params(sd), tk, tv, torch.from_numpy(table),
        torch.from_numpy(lengths), torch.from_numpy(last),
        torch.from_numpy(active), cfg)
    assert rk is tk and rv is tv              # written in place
    assert pn.dtype == torch.int32
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    for a, b in ((jk, tk), (jv, tv)):
        np.testing.assert_allclose(b.numpy()[:, :-1], np.asarray(a)[:, :-1],
                                   rtol=0, atol=POOL_TOL)
    # the active slots wrote their new position; nothing else changed
    changed = np.argwhere((tk.numpy()[:, :-1] != kp[:, :-1]).any(-1))
    assert {(int(p), int(o)) for _l, p, o in changed} == \
        {(1, 1), (4, 2), (7, 3)}


@pytest.mark.parametrize("size", [DEMO, WIDE], ids=["demo", "wide"])
@pytest.mark.parametrize("pos0,valid", [(0, 8), (4, 3), (8, 1)])
def test_prefill_chunk_matches_jax(size, pos0, valid):
    import jax.numpy as jnp
    from horovod_tpu.models import transformer as JT

    from horovod_tpu_torch.models import transformer as PT
    jp, jcfg, sd, cfg = _configs(size)
    rng = np.random.RandomState(4)
    L, W = cfg.n_layers, cfg.n_heads * cfg.head_dim
    P, pt, C = 5, 4, 8
    total = 2 * P
    kp, vp = _pools(rng, L, total, pt, W)
    row = np.array([6, 2, 9, 0, 4], np.int32)
    tokens = np.zeros(C, np.int32)
    tokens[:valid] = rng.randint(0, cfg.vocab_size, size=valid)
    jn, jk, jv = JT.prefill_chunk_paged(
        JT.flatten_decode_params(jp), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(row), jnp.asarray(tokens), np.int32(pos0),
        np.int32(valid), jcfg)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    pn, _, _ = PT.prefill_chunk_paged(
        PT.flatten_decode_params(sd), tk, tv, torch.from_numpy(row),
        torch.from_numpy(tokens), torch.tensor(pos0), torch.tensor(valid),
        cfg)
    assert int(pn) == int(jn)
    for a, b in ((jk, tk), (jv, tv)):
        np.testing.assert_allclose(b.numpy()[:, :-1], np.asarray(a)[:, :-1],
                                   rtol=0, atol=POOL_TOL)


@pytest.mark.parametrize("size", [DEMO, WIDE], ids=["demo", "wide"])
def test_reference_greedy_decode_matches_jax(size):
    from horovod_tpu.models.transformer import \
        reference_greedy_decode as jax_ref

    from horovod_tpu_torch.models import reference_greedy_decode
    jp, jcfg, sd, cfg = _configs(size)
    prompt = list(np.random.RandomState(5).randint(0, cfg.vocab_size, 9))
    want = jax_ref(jp, jcfg, prompt, 5)
    assert reference_greedy_decode(sd, cfg, prompt, 5) == want
    toks, margins = reference_greedy_decode(sd, cfg, prompt, 5,
                                            return_margins=True)
    assert toks == want and len(margins) == 5
    assert all(m >= 0 and mx > 0 for m, mx in margins)


def test_flatten_decode_params_collapses_stages_and_refuses_moe():
    import dataclasses

    from horovod_tpu_torch.models import (Transformer, flatten_decode_params,
                                          from_jax_params, init_params,
                                          kv_cache_spec)
    from horovod_tpu_torch.serving.generate import demo_gen_setup
    sd, cfg = demo_gen_setup(device="cpu")
    two = from_jax_params(init_params(np.random.RandomState(0), cfg,
                                      n_stages=2))
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(sd)
    for src in (sd, two, model):
        flat = flatten_decode_params(src)
        assert flat["layers"]["wq"].shape == (2, 32, 32)
        np.testing.assert_array_equal(flat["layers"]["w1"].numpy(),
                                      sd["layers.w1"].reshape(2, 32, 64))
    assert kv_cache_spec(cfg) == (2, 32, torch.float32)
    moe = dataclasses.replace(cfg, n_experts=2)
    with pytest.raises(NotImplementedError):
        flatten_decode_params(from_jax_params(
            init_params(np.random.RandomState(0), moe)))


# -- page plan + pool against JAX ---------------------------------------------
def test_page_plan_geometry_and_budget_precedence(monkeypatch):
    from horovod_tpu.serving.generate import pages as jpages

    from horovod_tpu_torch.serving.generate import pages
    assert pages.resolve_page_bytes(1234) == 1234
    monkeypatch.setenv("HVD_TPU_KV_PAGE_BYTES", "2048")
    assert pages.resolve_page_bytes(None) == 2048
    monkeypatch.delenv("HVD_TPU_KV_PAGE_BYTES")
    assert pages.resolve_page_bytes(None) == jpages.resolve_page_bytes(None)
    assert 1 <= pages.resolve_page_bytes(None) <= pages.DEFAULT_PAGE_BYTES_CAP
    plan = pages.plan_kv_pages(1, 8, torch.float32, slots=3, max_ctx=16,
                               page_bytes=256)
    assert (plan.page_tokens, plan.pages_per_slot, plan.total_pages,
            plan.slot_tokens, plan.token_bytes, plan.page_bytes) == \
        (4, 4, 12, 16, 64, 256)
    assert [plan.pages_for(n) for n in (1, 4, 5)] == [1, 1, 2]
    assert pages.plan_kv_pages(1, 8, torch.float32, slots=3, max_ctx=16,
                               page_bytes=256) is plan
    # every geometry as the JAX planner gives it, itemsize from the dtype
    for args in ((4, 512, 32, 256, None), (2, 32, 4, 64, 4096),
                 (3, 96, 5, 100, 777), (1, 8, 2, 16, 64)):
        L, W, S, ctx, pb = args
        for tdt, ndt in ((torch.float32, np.float32),
                         (torch.bfloat16, np.float16)):
            assert tuple(pages.plan_kv_pages(L, W, tdt, S, ctx, pb)) == \
                tuple(jpages.plan_kv_pages(L, W, ndt, S, ctx, pb)), args


def _alloc_free_script(pool):
    """One fixed call sequence; returns every answer."""
    out = [pool.alloc(3), pool.alloc(4), pool.alloc(2), pool.alloc(1)]
    pool.free(out[0])
    out.append(pool.alloc(1))
    pool.free(out[1][1:3])
    out += [pool.alloc(2), pool.alloc(3), pool.alloc(0)]
    out += [pool.in_use, pool.high_water, round(pool.fragmentation(), 6),
            pool.stats()]
    return out


def test_page_pool_same_page_ids_as_jax():
    from horovod_tpu.serving.generate import pages as jpages

    from horovod_tpu_torch.serving.generate import pages
    got = _alloc_free_script(pages.PagePool(pages.plan_kv_pages(
        1, 8, torch.float32, slots=2, max_ctx=16, page_bytes=256)))
    want = _alloc_free_script(jpages.PagePool(jpages.plan_kv_pages(
        1, 8, np.float32, slots=2, max_ctx=16, page_bytes=256)))
    assert got == want
    assert got[:2] == [[0, 1, 2], [3, 4, 5, 6]] and got[2] is None


def test_page_pool_fragmentation_reports_shredded_free_set():
    from horovod_tpu_torch.serving.generate.pages import (PagePool,
                                                          plan_kv_pages)
    plan = plan_kv_pages(1, 8, torch.float32, slots=2, max_ctx=32,
                         page_bytes=64)
    pool = PagePool(plan)
    pages = pool.alloc(plan.total_pages)
    pool.free(pages[::2])
    assert pool.fragmentation() > 0.4
    pool.free(pages[1::2])
    assert pool.fragmentation() == 0.0 and pool.in_use == 0


# -- slot scheduler against JAX -----------------------------------------------
def _sched(pkg, n_slots=2, pool_pages=4, page_tokens=4, prefill_chunk=4):
    import importlib
    pages = importlib.import_module(f"{pkg}.serving.generate.pages")
    sched = importlib.import_module(f"{pkg}.serving.generate.scheduler")
    plan = pages.plan_kv_pages(1, 8, np.float32, slots=pool_pages,
                               max_ctx=page_tokens,
                               page_bytes=64 * page_tokens)
    pool = pages.PagePool(plan)
    return sched, sched.SlotScheduler(n_slots, pool, prefill_chunk,
                                      max_ctx=pool_pages * page_tokens), pool


def _admission_script(pkg):
    """The JAX tests' scheduler sequences in one: head-of-line page
    gating, slot gating, chunking, eviction, drop_waiting."""
    mod, sched, pool = _sched(pkg, n_slots=3, pool_pages=6, page_tokens=4)
    R = mod.GenRequest
    log = []
    held = pool.alloc(3)
    big, small, mid = R("big", [1] * 8, 8), R("small", [1], 1), \
        R("mid", list(range(10)), 2)
    for r in (big, small, mid):
        sched.add_waiting(r)
    log.append([r.id for r in sched.admit()])          # head blocks
    pool.free(held)
    log.append([(r.id, r.slot, r.pages) for r in sched.admit()])
    log.append((sched.occupied(), sched.waiting_count(), pool.in_use))
    sched.evict(small, "length")
    log.append([(r.id, r.slot, r.pages) for r in sched.admit()])
    chunks = []
    while True:
        c = sched.next_prefill_chunk(mid)
        if c is None:
            break
        chunks.append(c)
        mid.prefill_pos += c[1]
    log += [chunks, sched.chunks_for(mid.prompt_len)]
    late = R("late", [2], 1)
    sched.add_waiting(late)
    log.append([r.id for r in sched.admit()])          # no free slot
    log += [sched.drop_waiting(late), sched.drop_waiting(late)]
    for r in (big, mid):
        sched.evict(r, "length")
    log += [(r.state, r.finish_reason, r.pages) for r in (big, mid)]
    log += [pool.in_use, sched.busy()]
    return log


def test_scheduler_admission_order_equals_jax():
    got = _admission_script("horovod_tpu_torch")
    assert got == _admission_script("horovod_tpu")
    assert got[0] == [] and [x[0] for x in got[1]] == ["big", "small"]
    assert got[4] == [(0, 4), (4, 4), (8, 2)]


def test_scheduler_discriminates_slot_wait_from_page_wait():
    mod, sched, _pool = _sched("horovod_tpu_torch", n_slots=1,
                               pool_pages=4)
    first = mod.GenRequest("first", [1] * 4, 4)
    queued = mod.GenRequest("queued", [1] * 4, 4)
    sched.add_waiting(first)
    sched.add_waiting(queued)
    assert [r.id for r in sched.admit()] == ["first"]
    time.sleep(0.02)
    sched.admit()
    assert queued.slot_wait_s > 0 and queued.page_wait_s == 0.0
    mod, sched2, _pool2 = _sched("horovod_tpu_torch", n_slots=2,
                                 pool_pages=1)
    big = mod.GenRequest("big", [1] * 4, 4)
    sched2.add_waiting(big)
    assert sched2.admit() == []
    time.sleep(0.02)
    sched2.admit()
    assert big.page_wait_s > 0.015 and big.slot_wait_s < 0.001


# -- the engine ---------------------------------------------------------------
def test_engine_rejects_what_cannot_fit_a_slot():
    eng = _port_engine()
    cap = eng.max_request_tokens
    assert cap >= 8
    with pytest.raises(ValueError):            # prompt+max_new too big
        eng.submit("big", [1] * cap, max_new=1)
    with pytest.raises(ValueError):
        eng.submit("empty", [], max_new=4)
    with pytest.raises(ValueError):
        eng.submit("zero", [1, 2], max_new=0)
    with pytest.raises(ValueError):            # outside the vocabulary
        eng.submit("oov", [1, 64], max_new=1)
    req = eng.submit("edge", [1] * (cap - 1), max_new=1)
    _run_to_done(eng, [req])
    assert len(req.tokens) == 1


def test_engine_max_new_one_finishes_at_prefill():
    """TTFT happens at prefill end: the last chunk's logits ARE the first
    token, so max_new=1 never enters the decode batch — and the
    prefill-emitted token still lands in gen_tokens_total."""
    from horovod_tpu_torch.metrics.registry import default_registry
    eng = _port_engine()
    req = eng.submit("one", [3, 1, 4, 1, 5], max_new=1)
    ctr = default_registry().get("hvd_serving_gen_tokens_total")
    tok_before = ctr.value if ctr is not None else 0.0
    _run_to_done(eng, [req])
    assert req.finish_reason == "length" and len(req.tokens) == 1
    assert eng.decode_steps_total == 0
    ctr = default_registry().get("hvd_serving_gen_tokens_total")
    assert ctr is not None and ctr.value == tok_before + 1.0
    assert eng.captures == {"gen_decode_step": 0, "gen_prefill_chunk": 0}


def _staggered(engine, reqset, prefix, run_to_done):
    reqs = [engine.submit(f"{prefix}{i}", p, m)
            for i, (p, m) in enumerate(reqset[:2])]
    for _ in range(3):
        engine.step_once()                     # first two are mid-decode
    reqs += [engine.submit(f"{prefix}{i}", p, m)
             for i, (p, m) in enumerate(reqset[2:], start=2)]
    run_to_done(engine, reqs)
    return reqs


def test_token_parity_continuous_vs_jax_engine_and_oracle():
    """THE contract: the port's staggered continuous run emits tokens
    bit-identical to the JAX engine's same run, to a one-at-a-time
    sequential run of the port's engine, and to the JAX dense oracle."""
    from horovod_tpu.models.transformer import reference_greedy_decode
    from horovod_tpu.serving.generate import GenerateEngine as JaxEngine
    from horovod_tpu.serving.generate import demo_gen_setup as jax_setup
    from horovod_tpu.serving.generate.scheduler import DONE as JDONE
    jp, jcfg = jax_setup()
    reqset = _reqset(np.random.RandomState(7), 6)

    def jax_done(engine, reqs):
        n = 0
        while any(r.state != JDONE for r in reqs):
            engine.step_once()
            n += 1
            assert n < 50_000

    port = _staggered(_port_engine(), reqset, "c", _run_to_done)
    jeng = JaxEngine(jp, jcfg, n_slots=4, page_bytes=4096, prefill_chunk=8)
    jax = _staggered(jeng, reqset, "j", jax_done)
    seq_eng = _port_engine()
    for i, ((prompt, max_new), preq, jreq) in enumerate(
            zip(reqset, port, jax)):
        assert preq.tokens == jreq.tokens, f"request {i}: port != JAX"
        assert (preq.finish_reason, preq.prefill_chunks,
                preq.decode_steps) == (jreq.finish_reason,
                                       jreq.prefill_chunks,
                                       jreq.decode_steps)
        sreq = seq_eng.submit(f"s{i}", prompt, max_new)
        _run_to_done(seq_eng, [sreq])
        assert sreq.tokens == preq.tokens, f"request {i}: sequential"
        if i < 3:
            assert preq.tokens == reference_greedy_decode(
                jp, jcfg, prompt, max_new), f"request {i}: JAX oracle"


def test_continuous_needs_strictly_fewer_decode_steps_than_gang():
    from horovod_tpu_torch.serving.generate import request_level_generate
    reqset = _reqset(np.random.RandomState(11), 12, max_new_hi=10)
    eng = _port_engine()
    reqs = [eng.submit(f"c{i}", p, m) for i, (p, m) in enumerate(reqset)]
    _run_to_done(eng, reqs)
    continuous_steps = eng.decode_steps_total
    base = request_level_generate(eng, reqset)
    gang_steps = eng.decode_steps_total - continuous_steps
    assert continuous_steps < gang_steps, (continuous_steps, gang_steps)
    for creq, breq in zip(reqs, base):
        assert creq.tokens == breq.tokens


def test_engine_deadline_expires_mid_generation():
    from horovod_tpu_torch.serving.batcher import DeadlineError
    eng = _port_engine()
    req = eng.submit("late", [1, 2, 3], max_new=50, deadline_s=0.05)
    eng.step_once()                            # admit + prefill
    time.sleep(0.1)
    eng.step_once()                            # sweep fires
    assert req.finish_reason == "deadline"
    with pytest.raises(DeadlineError):
        req.pending.wait(timeout=1.0)
    assert eng.scheduler.occupied() == 0 and eng.pool.in_use == 0


def test_engine_drain_refuses_new_and_finishes_admitted():
    from horovod_tpu_torch.serving.batcher import DrainingError
    eng = _port_engine()
    req = eng.submit("inflight", [5, 6], max_new=3)
    eng.step_once()
    eng.drain()
    with pytest.raises(DrainingError):
        eng.submit("refused", [1], max_new=1)
    assert not eng.drained()
    _run_to_done(eng, [req])
    assert req.finish_reason == "length" and eng.drained()


def test_generate_metrics_register_all_documented_names():
    from horovod_tpu_torch.metrics.registry import default_registry
    eng = _port_engine()
    req = eng.submit("m0", [1] * 10, max_new=3)
    _run_to_done(eng, [req])
    reg = default_registry()
    for name in ("hvd_serving_prefill_seconds_total",
                 "hvd_serving_prefill_chunks_total",
                 "hvd_serving_decode_seconds_total",
                 "hvd_serving_decode_steps_total",
                 "hvd_serving_gen_tokens_total",
                 "hvd_serving_slot_occupancy",
                 "hvd_serving_gen_waiting",
                 "hvd_serving_kv_pages_in_use",
                 "hvd_serving_kv_pages_total",
                 "hvd_serving_kv_page_bytes",
                 "hvd_serving_ttft_seconds",
                 "hvd_serving_itl_seconds"):
        assert reg.get(name) is not None, f"{name} never registered"
    finished = reg.get("hvd_serving_gen_finished_total",
                       labels={"reason": "length"})
    assert finished is not None and finished.value >= 1


SWAP_PROMPT = [9, 8, 7, 6]


def _swap_during_a_live_sequence(new, version):
    """Run a demo engine, hold its loop inside request ``live``'s second
    token, ask for a swap to ``new`` and submit request ``late`` while
    the swap waits. Returns both results."""
    import threading
    eng = _port_engine(n_slots=2)
    reached, go = threading.Event(), threading.Event()
    emitted = []

    def gate(token):
        emitted.append(token)
        if len(emitted) == 2:
            reached.set()
            go.wait(10)

    eng.start()
    try:
        live = eng.submit("live", SWAP_PROMPT, 20, on_token=gate)
        assert reached.wait(10)
        swapper = threading.Thread(target=eng.load_params,
                                   args=(new, version), daemon=True)
        swapper.start()
        deadline = time.monotonic() + 10
        while eng._swap is None:
            assert time.monotonic() < deadline, "the swap was never asked"
            time.sleep(0.001)
        late = eng.submit("late", SWAP_PROMPT, 6)
        go.set()
        results = (live.pending.wait(timeout=10),
                   late.pending.wait(timeout=10))
        swapper.join(10)
        assert not swapper.is_alive() and eng.weight_version == version
    finally:
        go.set()
        eng.stop()
    return results


def test_generate_stages_cover_swap_pause():
    """A hot weight swap while a sequence is live: a request that waits
    behind it charges the wait to the ``swap_pause`` stage; the live
    sequence is never paused."""
    from horovod_tpu_torch.serving.generate import demo_gen_setup
    live, late = _swap_during_a_live_sequence(
        demo_gen_setup(seed=3, device="cpu")[0], 7)
    assert late["stages"]["swap_pause"] > 0
    assert live["stages"]["swap_pause"] == 0
    for stages in (live["stages"], late["stages"]):
        assert stages["prefill"] > 0 and stages["decode"] > 0
        assert set(stages) == {"slot_wait", "page_wait", "prefill",
                               "decode", "swap_pause"}


def test_load_params_waits_for_live_sequences():
    """A sequence live when a swap is asked finishes on the weights it
    started with and names their version; admission holds until it
    leaves, and the next request decodes with the new weights."""
    from horovod_tpu_torch.models import reference_greedy_decode
    from horovod_tpu_torch.serving.generate import demo_gen_setup
    old, cfg = demo_gen_setup(device="cpu")
    new, _ = demo_gen_setup(seed=3, device="cpu")
    live, late = _swap_during_a_live_sequence(new, 7)
    assert live["weight_version"] == 0 and late["weight_version"] == 7
    assert live["tokens"] == reference_greedy_decode(old, cfg,
                                                     SWAP_PROMPT, 20)
    assert late["tokens"] == reference_greedy_decode(new, cfg,
                                                     SWAP_PROMPT, 6)
    assert late["tokens"] != live["tokens"][:6]


def test_load_params_swaps_weights_at_a_step_boundary():
    """The engine's hot swap: new weights copied into its own tensors
    (the caller's stay untouched); the next request decodes as the
    oracle on the new weights."""
    from horovod_tpu_torch.models import reference_greedy_decode
    from horovod_tpu_torch.serving.generate import demo_gen_setup
    eng = _port_engine()
    old, cfg = demo_gen_setup(device="cpu")
    new, _ = demo_gen_setup(seed=3, device="cpu")
    prompt = [9, 8, 7, 6]
    a = eng.submit("a", prompt, 6)
    _run_to_done(eng, [a])
    assert a.tokens == reference_greedy_decode(old, cfg, prompt, 6)
    eng.load_params(new, 3)
    b = eng.submit("b", prompt, 6)
    _run_to_done(eng, [b])
    want = reference_greedy_decode(new, cfg, prompt, 6)
    assert b.tokens == want and want != a.tokens
    assert (a.weight_version, b.weight_version) == (0, 3)
    assert not torch.equal(eng.params["embed"], old["embed"])
    with pytest.raises(ValueError):
        eng.load_params(demo_gen_setup(d_model=16, device="cpu")[0])
    # stepped by hand, a live sequence has no loop to finish it
    eng.submit("c", prompt, 6)
    eng.step_once()
    with pytest.raises(RuntimeError):
        eng.load_params(old)
