"""The port's serving plane against the JAX package's, on the CPU.

The batteries of ``tests/test_serving.py``, ``tests/test_generate.py``
(replica and router cases) and ``tests/test_serving_ledger.py`` run
against ``horovod_tpu_torch.serving`` at their expectations: the dynamic
batcher, the hardened HTTP server, the replica (infer and generate
roundtrips, idempotent duplicates, concurrent duplicates joining one
decode, the 404 in infer mode, readiness, drain), the hot swap from the
port's store and from a commit the JAX store wrote, the fallback naming
the restored step, the router (retry, hedge, client error, admission
shed, the generate audit and its trace spans, the books closing), drain
plus swap with zero failures, the fleet killing and healing a replica
process, the local front, the request ledger and the serving detectors.
The chaos and autopilot cases of those files wait for the port's chaos
plane and autopilot.

Two cases are the port's own: the registry's ``hvd_serving_*`` names,
labels, help and buckets equal the JAX package's under the same calls,
and the JAX generate replica's hot swap (ROADMAP queue 3 item 10) is
pinned — its ``/generate`` reports the restored step but decodes with
the weights its engine was built with — beside the port's, which decodes
with the restored weights. Every server binds an ephemeral port itself.
"""

import json
import os
import signal
import socket
import threading
import time

import numpy as np
import pytest


@pytest.fixture(autouse=True)
def _clean():
    from horovod_tpu import chaos

    from horovod_tpu_torch.metrics import anomaly
    from horovod_tpu_torch.serving import ledger
    chaos.uninstall()
    ledger.reset()
    anomaly.reset()
    yield
    chaos.uninstall()
    ledger.reset()
    anomaly.reset()


def _post(port, doc, path="/infer", timeout=30.0):
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(doc).encode(),
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _spans(trace_id):
    """The port's trace spans of one trace, from its flight ring."""
    from horovod_tpu_torch.diagnostics.flight_recorder import recorder
    return [e for e in recorder().events()
            if e.get("kind") == "trace_span" and e.get("trace") == trace_id]


def _dead_port():
    """A port nothing listens on (bound and closed here: connecting to
    it is refused, which is the point)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture
def replica():
    from horovod_tpu_torch.serving import ReplicaServer
    r = ReplicaServer(dim=4, replica_id="t0", device="cpu").start()
    yield r
    r.stop()


@pytest.fixture
def gen_replica():
    from horovod_tpu_torch.serving import ReplicaServer
    r = ReplicaServer(replica_id="g0", mode="generate", device="cpu").start()
    yield r
    r.stop()


def _demo_ref(prompt, max_new, seed=0):
    from horovod_tpu_torch.models import reference_greedy_decode
    from horovod_tpu_torch.serving.generate import demo_gen_setup
    params, cfg = demo_gen_setup(seed=seed, device="cpu")
    return reference_greedy_decode(params, cfg, prompt, max_new)


# -- batcher ------------------------------------------------------------------
def test_batcher_forms_full_batch():
    from horovod_tpu_torch.serving.batcher import DynamicBatcher
    b = DynamicBatcher(max_batch_size=4, max_wait_s=5.0, max_queue=16)
    reqs = [b.submit(f"r{i}", i) for i in range(4)]
    batch = b.next_batch(timeout_s=1.0)
    assert [r.id for r in batch] == ["r0", "r1", "r2", "r3"]
    for r in batch:
        r.set_result(r.payload * 10)
    b.batch_done()
    assert reqs[2].wait(timeout=1.0) == 20


def test_batcher_max_wait_bounds_latency():
    from horovod_tpu_torch.serving.batcher import DynamicBatcher
    b = DynamicBatcher(max_batch_size=64, max_wait_s=0.05, max_queue=16)
    t0 = time.monotonic()
    b.submit("solo", 1)
    batch = b.next_batch(timeout_s=1.0)
    assert len(batch) == 1 and time.monotonic() - t0 < 0.5


def test_batcher_sheds_explicitly_on_full_queue():
    from horovod_tpu_torch.serving.batcher import (DynamicBatcher,
                                                   SheddedError)
    b = DynamicBatcher(max_batch_size=4, max_queue=2)
    b.submit("a", 1)
    b.submit("b", 2)
    with pytest.raises(SheddedError):
        b.submit("c", 3)


def test_batcher_expired_deadline_fails_at_formation():
    from horovod_tpu_torch.serving.batcher import (DeadlineError,
                                                   DynamicBatcher)
    b = DynamicBatcher(max_batch_size=4, max_wait_s=0.01, max_queue=16)
    doomed = b.submit("late", 1, deadline_s=0.01)
    live = b.submit("fine", 2, deadline_s=30.0)
    time.sleep(0.05)
    batch = b.next_batch(timeout_s=1.0)
    assert [r.id for r in batch] == ["fine"]
    with pytest.raises(DeadlineError):
        doomed.wait(timeout=0.1)
    live.set_result(None)
    b.batch_done()


def test_batcher_drain_refuses_new_and_flushes_admitted():
    from horovod_tpu_torch.serving.batcher import (DrainingError,
                                                   DynamicBatcher)
    b = DynamicBatcher(max_batch_size=4, max_wait_s=0.01, max_queue=16)
    r1 = b.submit("pre", 1)
    b.drain()
    with pytest.raises(DrainingError):
        b.submit("post", 2)
    assert not b.drained()
    batch = b.next_batch(timeout_s=1.0)
    assert [r.id for r in batch] == ["pre"]
    r1.set_result(None)
    b.batch_done()
    assert b.drained() and b.wait_drained(timeout_s=1.0)


# -- hardened HTTP server -----------------------------------------------------
def test_http_bounded_pool_rejects_busy_and_times_out_wedged():
    """At most ``max_handlers`` requests at once; the overflow connection
    gets an immediate 503 (counted), a wedged client times out and frees
    its slot."""
    from http.server import BaseHTTPRequestHandler

    from horovod_tpu_torch.metrics.registry import default_registry
    from horovod_tpu_torch.runner.http_kv import ThreadedHTTPServer

    class H(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def do_GET(self):
            self.send_response(404)
            self.end_headers()

    srv = ThreadedHTTPServer(("127.0.0.1", 0), H, max_handlers=2,
                             handler_timeout_s=1.0)
    assert srv.allow_reuse_address
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]
    busy = default_registry().get("hvd_http_busy_rejected_total")
    before = busy.value if busy is not None else 0.0
    try:
        wedged = []
        for _ in range(2):
            c = socket.create_connection(("127.0.0.1", port))
            c.sendall(b"GET /a/b HTTP/1.1\r\n")
            wedged.append(c)
        time.sleep(0.2)
        c3 = socket.create_connection(("127.0.0.1", port))
        c3.sendall(b"GET /a/b HTTP/1.0\r\n\r\n")
        assert b"503" in c3.recv(1000)
        c3.close()
        time.sleep(1.3)
        c4 = socket.create_connection(("127.0.0.1", port))
        c4.sendall(b"GET /a/b HTTP/1.0\r\n\r\n")
        assert b"404" in c4.recv(1000)
        c4.close()
        for c in wedged:
            c.close()
    finally:
        srv.shutdown()
        srv.server_close()
    assert default_registry().get(
        "hvd_http_busy_rejected_total").value == before + 1.0


# -- replica ------------------------------------------------------------------
def test_replica_infer_roundtrip(replica):
    code, resp = _post(replica.port, {"id": "q1", "x": [4.0, 0, 0, 0]})
    assert code == 200 and resp["version"] == 0
    assert np.allclose(resp["y"], [1.0] * 4)
    code, resp = _post(replica.port, {"id": "q2", "x": [1.0, 2.0]})
    assert code == 400 and "shape" in resp["error"]


def test_replica_idempotent_duplicate_returns_same_answer(replica):
    from horovod_tpu_torch.metrics.registry import default_registry
    _, a = _post(replica.port, {"id": "dup", "x": [1.0, 0, 0, 0]})
    _, b = _post(replica.port, {"id": "dup", "x": [9.0, 9, 9, 9]})
    assert a["y"] == b["y"]
    assert default_registry().get("hvd_serving_duplicate_hits_total")


def test_replica_readiness_gates_on_queue_and_drain(monkeypatch):
    from horovod_tpu_torch.serving import ReplicaServer
    monkeypatch.setenv("HVD_TPU_SERVING_READY_QUEUE", "-1")
    r = ReplicaServer(dim=4, replica_id="t1", device="cpu").start()
    try:
        assert r.ready_doc()["ready"] is False
        assert _get(r.port, "/readyz")[0] == 503
    finally:
        r.stop()
    monkeypatch.delenv("HVD_TPU_SERVING_READY_QUEUE")
    r2 = ReplicaServer(dim=4, replica_id="t2", device="cpu").start()
    try:
        assert r2.ready_doc()["ready"] is True
        assert _get(r2.port, "/healthz")[0] == 200
        r2.drain(source="test")
        assert r2.ready_doc()["ready"] is False
        assert r2.ready_doc()["draining"] is True
        assert r2.wait_drained(5.0)
        code, resp = _post(r2.port, {"id": "late", "x": [1, 1, 1, 1]})
        assert code == 503 and "draining" in resp["error"]
    finally:
        r2.stop()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_replica_hot_swap_from_durable_store(tmp_path, writer):
    """A fresh commit (written by the port's store or the JAX one) swaps
    in while the old weights keep serving: zero failed requests, and
    responses name the version that computed them."""
    from horovod_tpu_torch.serving import ReplicaServer
    from horovod_tpu_torch.serving.replica import demo_params
    if writer == "jax":
        from horovod_tpu.checkpoint import ShardedCheckpointer
    else:
        from horovod_tpu_torch.checkpoint import ShardedCheckpointer
    store = ShardedCheckpointer(str(tmp_path), rank=0, world_size=1)
    store.save(1, {"params": demo_params(4, scale=1.0)}, wait=True)
    r = ReplicaServer(dim=4, store_dir=str(tmp_path), replica_id="swap",
                      swap_poll_s=0.05, device="cpu").start()
    try:
        code, resp = _post(r.port, {"id": "v1", "x": [4.0, 0, 0, 0]})
        assert code == 200 and resp["version"] == 1
        assert abs(resp["y"][0] - 1.0) < 1e-5
        store.save(2, {"params": demo_params(4, scale=3.0)}, wait=True)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            code, resp = _post(r.port, {"id": f"v2-{time.monotonic_ns()}",
                                        "x": [4.0, 0, 0, 0]})
            assert code == 200
            if resp["version"] == 2:
                break
            time.sleep(0.05)
        assert resp["version"] == 2 and abs(resp["y"][0] - 3.0) < 1e-5
    finally:
        r.stop()
        store.close()


def _corrupt(path):
    b = bytearray(open(path, "rb").read())
    b[len(b) // 2] ^= 0xFF
    open(path, "wb").write(bytes(b))


def test_replica_swap_fallback_names_the_restored_version(tmp_path):
    from horovod_tpu_torch.checkpoint import ShardedCheckpointer
    from horovod_tpu_torch.serving import ReplicaServer
    from horovod_tpu_torch.serving.replica import demo_params
    store = ShardedCheckpointer(str(tmp_path), rank=0, world_size=1)
    store.save(1, {"params": demo_params(4, scale=1.0)}, wait=True)
    store.save(2, {"params": demo_params(4, scale=2.0)}, wait=True)
    _corrupt(str(tmp_path / "step_2" / "shard_0.npz"))
    r = ReplicaServer(dim=4, store_dir=str(tmp_path), replica_id="fb",
                      swap_poll_s=0.05, device="cpu").start()
    try:
        code, resp = _post(r.port, {"id": "fb1", "x": [4.0, 0, 0, 0]})
        assert code == 200 and resp["version"] == 1
        assert abs(resp["y"][0] - 1.0) < 1e-5
        time.sleep(0.3)
        assert r._version == 1
        store.save(3, {"params": demo_params(4, scale=3.0)}, wait=True)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and r._version != 3:
            time.sleep(0.05)
        code, resp = _post(r.port, {"id": "fb3", "x": [4.0, 0, 0, 0]})
        assert resp["version"] == 3 and abs(resp["y"][0] - 3.0) < 1e-5
    finally:
        r.stop()
        store.close()


def test_replica_generate_roundtrip_and_duplicate_replay(gen_replica):
    code, resp = _post(gen_replica.port,
                       {"id": "g1", "prompt": [1, 2, 3], "max_new": 4},
                       path="/generate")
    assert code == 200, resp
    assert resp["tokens_emitted"] == 4 and len(resp["tokens"]) == 4
    assert resp["tokens"] == _demo_ref([1, 2, 3], 4)
    assert resp["finish_reason"] == "length" and resp["prompt_tokens"] == 3
    code2, resp2 = _post(gen_replica.port,
                         {"id": "g1", "prompt": [9, 9], "max_new": 2},
                         path="/generate")
    assert code2 == 200 and resp2["tokens"] == resp["tokens"]
    cap = gen_replica.engine.max_request_tokens
    code3, resp3 = _post(gen_replica.port,
                         {"id": "g2", "prompt": [1] * cap, "max_new": 8},
                         path="/generate")
    assert code3 == 400 and "capacity" in resp3["error"]


def test_replica_concurrent_duplicates_join_one_decode(gen_replica):
    results = []
    lock = threading.Lock()

    def fire():
        code, resp = _post(gen_replica.port,
                           {"id": "dup", "prompt": [4, 2], "max_new": 6},
                           path="/generate")
        with lock:
            results.append((code, resp))

    threads = [threading.Thread(target=fire) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    assert len(results) == 3
    assert all(code == 200 for code, _ in results)
    assert len({tuple(resp["tokens"]) for _c, resp in results}) == 1
    assert {resp["decode_steps"] for _c, resp in results} == {5}
    assert all(resp["tokens_emitted"] == 6 for _c, resp in results)


def test_duplicate_answered_after_its_cache_check_is_not_decoded_again(
        gen_replica, monkeypatch):
    """A duplicate whose cache check ran before the first copy answered,
    and whose in-flight check runs after that copy left ``_pending``,
    replays the cached response; it never decodes the id a second time
    (the JAX replica's window, ROADMAP queue 3 item 18)."""
    first = gen_replica.handle_generate({"id": "w1", "prompt": [1, 2, 3],
                                         "max_new": 3})
    assert first[0] == 200
    monkeypatch.setattr(gen_replica, "_cached_response", lambda rid: None)

    def no_second_decode(*a, **k):
        raise AssertionError("an answered id was submitted again")
    monkeypatch.setattr(gen_replica.engine, "submit", no_second_decode)
    assert gen_replica.handle_generate({"id": "w1", "prompt": [1, 2, 3],
                                        "max_new": 3}) == first


def test_generate_replica_under_thread_stress_keeps_its_books(gen_replica):
    """More client threads than cores, duplicates of every id, a short
    switch interval: every copy of an id gets the one oracle stream,
    each id decodes once (the engine's emitted-token counter), and every
    page returns to the pool."""
    import sys

    from horovod_tpu_torch.metrics.registry import default_registry
    ids = [(f"st{i}", [1 + i % 7, 2, 3 + i % 5], 3 + i % 4)
           for i in range(12)]
    refs = {rid: _demo_ref(p, m) for rid, p, m in ids}
    ctr = default_registry().get("hvd_serving_gen_tokens_total")
    before = ctr.value if ctr is not None else 0.0
    results, lock = [], threading.Lock()

    def client(k):
        for rid, p, m in ids[k % 3::3]:
            code, resp = _post(gen_replica.port, {"id": rid, "prompt": p,
                                                  "max_new": m},
                               path="/generate")
            with lock:
                results.append((rid, code, resp.get("tokens")))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(max(8, 2 * (os.cpu_count() or 1)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == len(threads) * 4
    assert all(code == 200 and toks == refs[rid]
               for rid, code, toks in results)
    tokens = default_registry().get("hvd_serving_gen_tokens_total").value
    assert tokens - before == sum(m for _r, _p, m in ids)
    deadline = time.monotonic() + 10
    while gen_replica.engine.pool.in_use and time.monotonic() < deadline:
        time.sleep(0.01)
    assert gen_replica.engine.pool.in_use == 0


def test_infer_mode_replica_404s_generate(replica):
    code, resp = _post(replica.port, {"id": "x", "prompt": [1],
                                      "max_new": 1}, path="/generate")
    assert code == 404 and "mode=infer" in resp["error"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_generate_replica_serves_and_swaps_the_store_weights(tmp_path,
                                                             writer):
    """Generate mode restores the store's commit into its engine and
    hands the engine each newer commit: the tokens are the oracle's on
    the weights the version names (JAX or port writer)."""
    from horovod_tpu_torch.models import from_jax_params, init_params
    from horovod_tpu_torch.serving import ReplicaServer
    from horovod_tpu_torch.serving.generate import demo_gen_setup
    _, cfg = demo_gen_setup(device="cpu")
    w3 = init_params(np.random.RandomState(3), cfg)
    w5 = init_params(np.random.RandomState(5), cfg)
    if writer == "jax":
        from horovod_tpu.checkpoint import ShardedCheckpointer
        doc = {"params": w3}
    else:
        from horovod_tpu_torch.checkpoint import ShardedCheckpointer
        doc = {"params": from_jax_params(w3)}
    store = ShardedCheckpointer(str(tmp_path), rank=0, world_size=1)
    store.save(1, doc, wait=True)
    r = ReplicaServer(replica_id="gs", mode="generate", device="cpu",
                      store_dir=str(tmp_path), swap_poll_s=0.05).start()
    prompt = [5, 9, 2, 7]
    try:
        code, resp = _post(r.port, {"id": "s1", "prompt": prompt,
                                    "max_new": 6}, path="/generate")
        assert code == 200 and resp["version"] == 1
        assert resp["tokens"] == _demo_ref(prompt, 6, seed=3)
        store.save(2, {"params": w5}, wait=True)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and r._version != 2:
            time.sleep(0.05)
        code, resp = _post(r.port, {"id": "s2", "prompt": prompt,
                                    "max_new": 6}, path="/generate")
        assert code == 200 and resp["version"] == 2
        assert resp["tokens"] == _demo_ref(prompt, 6, seed=5)
        assert _demo_ref(prompt, 6, seed=5) != _demo_ref(prompt, 6, seed=3)
    finally:
        r.stop()
        store.close()


def test_generate_replica_swap_waits_for_live_sequences(tmp_path):
    """A commit that lands while a sequence decodes: the live request
    finishes on the weights it started with and its response names their
    version; a request that arrives during the swap decodes with the new
    weights and names theirs."""
    from horovod_tpu_torch.checkpoint import ShardedCheckpointer
    from horovod_tpu_torch.models import from_jax_params, init_params
    from horovod_tpu_torch.serving import ReplicaServer
    from horovod_tpu_torch.serving.generate import demo_gen_setup
    _, cfg = demo_gen_setup(device="cpu")
    w3, w5 = (from_jax_params(init_params(np.random.RandomState(s), cfg))
              for s in (3, 5))
    store = ShardedCheckpointer(str(tmp_path), rank=0, world_size=1)
    store.save(1, {"params": w3}, wait=True)
    r = ReplicaServer(replica_id="gl", mode="generate", device="cpu",
                      store_dir=str(tmp_path), swap_poll_s=0.05).start()
    reached, go = threading.Event(), threading.Event()
    emit = r.engine._emit

    def gated(req, token):
        # the engine loop stops inside the live request's second token
        emit(req, token)
        if req.id == "live" and len(req.tokens) == 2:
            reached.set()
            go.wait(10)

    r.engine._emit = gated
    prompt, out = [5, 9, 2, 7], {}

    def send(rid, max_new):
        out[rid] = _post(r.port, {"id": rid, "prompt": prompt,
                                  "max_new": max_new}, path="/generate")

    threads = []
    try:
        threads.append(threading.Thread(target=send, args=("live", 20)))
        threads[-1].start()
        assert reached.wait(10)
        store.save(2, {"params": w5}, wait=True)
        deadline = time.monotonic() + 10
        while r.engine._swap is None:
            assert time.monotonic() < deadline, "the swap was never asked"
            time.sleep(0.005)
        threads.append(threading.Thread(target=send, args=("late", 6)))
        threads[-1].start()
        while "late" not in r._pending:
            assert time.monotonic() < deadline, "late was never admitted"
            time.sleep(0.005)
        go.set()
        for t in threads:
            t.join(30)
    finally:
        go.set()
        r.stop()
        store.close()
    (code_l, live), (code_n, late) = out["live"], out["late"]
    assert code_l == code_n == 200
    assert live["version"] == 1
    assert live["tokens"] == _demo_ref(prompt, 20, seed=3)
    assert late["version"] == 2
    assert late["tokens"] == _demo_ref(prompt, 6, seed=5)
    assert late["stages"]["swap_pause"] > 0 and r._version == 2


def test_jax_generate_replica_decodes_with_its_build_weights(tmp_path):
    """ROADMAP queue 3 item 10, the JAX side: a JAX generate replica over
    a store reports the restored step as its version, but its engine was
    flattened once from ``demo_gen_setup()`` and is never handed the
    store's weights — at load or at a swap."""
    from horovod_tpu.checkpoint import ShardedCheckpointer
    from horovod_tpu.models.transformer import (init_params,
                                                reference_greedy_decode)
    from horovod_tpu.serving import ReplicaServer
    from horovod_tpu.serving.generate import demo_gen_setup
    built, cfg = demo_gen_setup()
    w3 = init_params(np.random.RandomState(3), cfg)
    w5 = init_params(np.random.RandomState(5), cfg)
    prompt = [5, 9, 2, 7]
    want_built = reference_greedy_decode(built, cfg, prompt, 6)
    assert reference_greedy_decode(w3, cfg, prompt, 6) != want_built
    store = ShardedCheckpointer(str(tmp_path), rank=0, world_size=1)
    store.save(1, {"params": w3}, wait=True)
    r = ReplicaServer(replica_id="jg", mode="generate",
                      store_dir=str(tmp_path), swap_poll_s=0.05).start()
    try:
        code, resp = _post(r.port, {"id": "j1", "prompt": prompt,
                                    "max_new": 6}, path="/generate")
        assert code == 200 and resp["version"] == 1
        assert resp["tokens"] == want_built
        store.save(2, {"params": w5}, wait=True)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and r._version != 2:
            time.sleep(0.05)
        code, resp = _post(r.port, {"id": "j2", "prompt": prompt,
                                    "max_new": 6}, path="/generate")
        assert code == 200 and resp["version"] == 2
        assert resp["tokens"] == want_built
    finally:
        r.stop()
        store.close()


# -- router -------------------------------------------------------------------
class _StubServer:
    """Minimal /infer stub with a configurable delay (the slow-replica
    stand-in for hedge tests)."""

    def __init__(self, delay_s=0.0, name="stub"):
        from http.server import BaseHTTPRequestHandler

        from horovod_tpu_torch.runner.http_kv import ThreadedHTTPServer
        stub = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                doc = json.loads(self.rfile.read(n))
                time.sleep(stub.delay_s)
                body = json.dumps(
                    {"id": doc["id"], "y": [0.0], "version": 0,
                     "replica": stub.name}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.delay_s = delay_s
        self.name = name
        self.httpd = ThreadedHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    @property
    def port(self):
        return self.httpd.server_address[1]

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_router_retries_past_dead_replica(replica):
    from horovod_tpu_torch.serving import Router
    router = Router([("127.0.0.1", _dead_port()),
                     ("127.0.0.1", replica.port)], hedge_ms=0)
    doc = router.submit([1.0, 0, 0, 0], req_id="retry-1")
    assert doc["replica"] == "t0"
    acct = router.accounting()
    assert acct["outcomes"].get("retried", 0) >= 1
    assert acct["accepted"] == acct["answered_ok"] == 1
    assert not acct["unanswered"] and not acct["answered_twice"]
    router.close()


def test_router_rereads_the_view_when_its_pool_is_exhausted(replica):
    """A request whose pool held only a replica that died re-reads the
    endpoint view once every member has failed, and is answered by the
    replica the view holds now (the JAX router would spend its attempts
    on the dead one and fail the request)."""
    from horovod_tpu_torch.serving import Router
    dead = ("127.0.0.1", _dead_port())
    views = iter([[dead]])

    def view():
        return next(views, [dead, ("127.0.0.1", replica.port)])

    router = Router(view, hedge_ms=0, max_attempts=4)
    try:
        doc = router.submit([4.0, 0, 0, 0], req_id="reread-1")
    finally:
        router.close()
    assert doc["replica"] == "t0" and abs(doc["y"][0] - 1.0) < 1e-5
    acct = router.accounting()
    assert acct["outcomes"].get("retried", 0) >= 1
    assert acct["accepted"] == acct["answered_ok"] == 1


def test_router_hedges_slow_replica(replica):
    from horovod_tpu_torch.serving import Router
    slow = _StubServer(delay_s=2.0, name="slow")
    try:
        router = Router([("127.0.0.1", slow.port),
                         ("127.0.0.1", replica.port)], hedge_ms=100)
        t0 = time.monotonic()
        doc = router.submit([1.0, 0, 0, 0], req_id="hedge-1")
        assert doc["replica"] == "t0" and time.monotonic() - t0 < 1.5
        assert router.accounting()["outcomes"].get("hedged", 0) >= 1
        router.close()
    finally:
        slow.stop()


def test_router_client_error_is_terminal_not_retried(replica):
    from horovod_tpu_torch.serving import Router
    from horovod_tpu_torch.serving.router import RequestRejected
    router = Router([("127.0.0.1", replica.port)], hedge_ms=0)
    with pytest.raises(RequestRejected) as ei:
        router.submit([1.0, 2.0], req_id="badwidth")
    assert ei.value.code == 400
    acct = router.accounting()
    assert acct["outcomes"].get("rejected") == 1
    assert acct["outcomes"].get("retried", 0) == 0
    assert not acct["unanswered"]
    router.close()


def test_router_admission_shed_is_explicit():
    from horovod_tpu_torch.serving import Router
    from horovod_tpu_torch.serving.batcher import SheddedError
    slow = _StubServer(delay_s=1.0)
    try:
        router = Router([("127.0.0.1", slow.port)], max_inflight=1,
                        hedge_ms=0)
        results = []
        t = threading.Thread(target=lambda: results.append(
            router.submit([1.0], req_id="occupant")), daemon=True)
        t.start()
        time.sleep(0.2)
        with pytest.raises(SheddedError):
            router.submit([2.0], req_id="shed-me")
        t.join(timeout=10)
        assert results
        acct = router.accounting()
        assert acct["outcomes"].get("shed") == 1
        entries = [e for e in router.log.entries if e["outcome"] == "shed"]
        assert entries and entries[0]["where"] == "admission"
        router.close()
    finally:
        slow.stop()


def test_router_generate_exactly_once_audit_and_trace_spans(gen_replica):
    from horovod_tpu_torch.serving.router import Router
    router = Router([("127.0.0.1", gen_replica.port)], max_inflight=8)
    try:
        resp = router.submit_generate([7, 7, 7], max_new=5,
                                      req_id="traced-1")
    finally:
        router.close()
    assert resp["tokens_emitted"] == 5
    assert resp["tokens"] == _demo_ref([7, 7, 7], 5)
    ok = [e for e in router.log.entries if e["outcome"] == "ok"]
    assert len(ok) == 1 and ok[0]["tokens_emitted"] == 5
    acct = router.log.accounting()
    assert acct["unanswered"] == [] and acct["answered_twice"] == []
    trace = ok[0]["trace"]
    assert trace and resp.get("trace") == trace
    spans = _spans(trace)
    names = [s["name"] for s in spans]
    for expected in ("request", "dispatch", "serve", "gen_admit",
                     "gen_prefill", "gen_finish"):
        assert expected in names, (expected, names)
    assert names.count("gen_decode_step") == 4  # token 1 is prefill's
    finish = [s for s in spans if s["name"] == "gen_finish"][0]
    assert finish["tokens_emitted"] == 5


def test_ready_endpoints_keeps_only_ready_replicas(replica, monkeypatch):
    from horovod_tpu_torch.serving import ReplicaServer, ready_endpoints
    monkeypatch.setenv("HVD_TPU_SERVING_READY_QUEUE", "-1")
    busy = ReplicaServer(dim=4, replica_id="busy", device="cpu").start()
    try:
        eps = [("127.0.0.1", replica.port), ("127.0.0.1", busy.port),
               ("127.0.0.1", _dead_port())]
        assert ready_endpoints(eps) == [("127.0.0.1", replica.port)]
    finally:
        busy.stop()


def test_request_log_rotates_and_reads_back(tmp_path):
    from horovod_tpu_torch.serving.router import RequestLog, read_request_log
    path = str(tmp_path / "req.jsonl")
    log = RequestLog(path, max_bytes=300)
    for i in range(12):
        log.note(f"r{i}", "accepted", seq=i)
        log.note(f"r{i}", "ok", seq=i, version=1)
    log.close()
    assert os.path.exists(path + ".1")
    back = read_request_log(path)
    ids = [d["id"] for d in back]
    assert ids == sorted(ids, key=lambda x: int(x[1:])) and ids[-1] == "r11"
    with open(path, "a") as f:
        f.write('{"torn": ')                     # a crash mid-append
    assert read_request_log(path) == back
    acct = log.accounting()
    assert acct["accepted"] == acct["answered_ok"] == 12
    assert acct["by_version"] == {1: 12}


def test_books_close_through_router_and_replica(replica):
    from horovod_tpu_torch.serving import Router, ledger
    router = Router([("127.0.0.1", replica.port)], hedge_ms=0)
    try:
        docs = [router.submit([float(i), 0, 0, 0], req_id=f"books-{i}")
                for i in range(12)]
        win = router.window.maybe_roll(force=True)
    finally:
        router.close()
    total = unattr = 0.0
    for doc in docs:
        stages = doc["stages"]
        assert "unattributed" in stages
        assert stages.get("forward", 0) > 0
        assert stages.get("dispatch", 0) > 0
        assert set(stages) <= set(ledger.STAGES)
        assert all(v >= 0 for v in stages.values())
        total += sum(stages.values())
        unattr += stages["unattributed"]
    assert total > 0 and unattr / total < 0.10, (unattr, total)
    assert win["requests"] == 12 and win["unattributed_frac"] < 0.10
    assert win["dominant_stage"] in ledger.STAGES[:-1]
    assert sum(win["stage_shares"].values()) == pytest.approx(1.0, abs=0.01)
    worst = ledger.default_ring().worst(1)
    assert worst and worst[0].get("trace")
    spans = _spans(worst[0]["trace"])
    names = [s["name"] for s in spans]
    assert "request" in names and "serve" in names
    req_span = [s for s in spans if s["name"] == "request"][0]
    assert any(k.startswith("stage_") for k in req_span)


def _closed_loop(submit, clients, stop, errors, out):
    def client(i):
        n = 0
        while not stop.is_set():
            try:
                out.append(submit(i, n))
            except Exception as e:
                errors.append(repr(e))
            n += 1

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(clients)]
    for t in threads:
        t.start()
    return threads


def test_drain_plus_hot_swap_zero_failures(tmp_path):
    """One replica drains while a fresh commit hot-swaps on both: every
    accepted request is answered exactly once, none fails, the new
    version serves, and the drained replica reports DRAINED."""
    from horovod_tpu_torch.checkpoint import ShardedCheckpointer
    from horovod_tpu_torch.serving import ReplicaServer, Router
    from horovod_tpu_torch.serving.replica import demo_params
    store = ShardedCheckpointer(str(tmp_path), rank=0, world_size=1)
    store.save(1, {"params": demo_params(4, scale=1.0)}, wait=True)
    reps = [ReplicaServer(dim=4, store_dir=str(tmp_path), replica_id=f"d{i}",
                          swap_poll_s=0.05, device="cpu").start()
            for i in range(2)]
    router = Router([("127.0.0.1", r.port) for r in reps], hedge_ms=200,
                    max_attempts=8)
    stop, errors, out = threading.Event(), [], []
    threads = _closed_loop(
        lambda i, n: router.submit([4.0, 0, 0, 0], req_id=f"c{i}-{n}"),
        3, stop, errors, out)
    try:
        time.sleep(0.3)
        store.save(2, {"params": demo_params(4, scale=3.0)}, wait=True)
        code, _ = _post(reps[0].port, {}, path="/drain")
        assert code == 200
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            if reps[0].drained() and any(d["version"] == 2 for d in out):
                break
            time.sleep(0.05)
        time.sleep(0.2)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=15)
        router.close()
        for r in reps:
            r.stop()
        store.close()
    acct = router.accounting()
    assert not errors, errors[:3]
    assert reps[0].drained() and reps[0].health_doc()["drained"]
    assert acct["accepted"] == acct["answered_ok"] == len(out) > 0
    assert not acct["unanswered"] and not acct["answered_twice"]
    assert acct["outcomes"].get("failed", 0) == 0
    assert any(d["version"] == 2 and abs(d["y"][0] - 3.0) < 1e-5
               for d in out)
    for d in out:
        assert abs(d["y"][0] - {1: 1.0, 2: 3.0}[d["version"]]) < 1e-5


def test_fleet_kills_and_heals_generate_replicas():
    """Two generate-mode replica PROCESSES on the CPU behind a router
    under closed-loop load: SIGKILL one — zero failed requests (the
    router retries in-flight requests on the survivor), every token
    stream equals the oracle's, the exit is classified FAILURE, and the
    fleet heals back to two; then drain the other — a DRAINED exit, healed
    again; ``scale_out`` raises the target. Bounded: the fleet is stopped
    in every outcome, and every wait has a deadline."""
    from horovod_tpu_torch.serving import ReplicaFleet, Router
    prompts = [[1, 2, 3], [9, 8], [4, 4, 4, 4, 4], [7]]
    refs = {i: _demo_ref(p, 12) for i, p in enumerate(prompts)}
    fleet = ReplicaFleet(size=2, mode="generate", device="cpu",
                         poll_s=0.1)
    router = None
    try:
        fleet.start(ready_timeout_s=90)
        router = Router(fleet.endpoints, max_attempts=8)
        stop, errors, out = threading.Event(), [], []
        threads = _closed_loop(
            lambda i, n: (i, router.submit_generate(
                prompts[i], max_new=12, req_id=f"f{i}-{n}")),
            4, stop, errors, out)
        time.sleep(1.0)
        victim = fleet._replicas[1]
        os.kill(victim.proc.pid, signal.SIGKILL)
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            if fleet.live_count() == 2 and any(
                    e["outcome"] == "failure" for e in fleet.exits):
                break
            time.sleep(0.1)
        assert fleet.live_count() == 2, "fleet did not heal"
        # an admin drain of slot 0 under the same load: exit 0, a planned
        # DRAINED exit (never failure evidence), respawned
        assert fleet.drain(0)
        while time.monotonic() < deadline:
            if fleet.live_count() == 2 and any(
                    e["outcome"] == "drained" for e in fleet.exits):
                break
            time.sleep(0.1)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        acct = router.accounting()
        assert fleet.scale_out(1) == 3 and fleet.target == 3
    finally:
        if router is not None:
            router.close()
        fleet.stop()
    assert not errors, errors[:3]
    assert acct["accepted"] == acct["answered_ok"] == len(out) > 0
    assert not acct["unanswered"] and not acct["answered_twice"]
    assert acct["outcomes"].get("failed", 0) == 0
    for i, doc in out:
        assert doc["tokens"] == refs[i]
    kills = [e for e in fleet.exits if e["outcome"] == "failure"]
    assert len(kills) == 1 and kills[0]["rc"] == -9
    drained = [e for e in fleet.exits if e["outcome"] == "drained"]
    assert len(drained) == 1 and drained[0]["rc"] == 0
    assert drained[0]["slot"] == 0 and "DRAINED" in drained[0]["tail"]


def test_local_front_routes_infer_and_generate(gen_replica):
    """The ``python -m horovod_tpu_torch.serving`` front: /generate and
    /infer through the router, /readyz from the fleet view, /metrics the
    registry's Prometheus text."""
    from horovod_tpu_torch.runner.http_kv import ThreadedHTTPServer
    from horovod_tpu_torch.serving import Router
    from horovod_tpu_torch.serving.__main__ import _FrontHandler

    class _Fleet:
        target = 1

        @staticmethod
        def live_count():
            return 1

    front = ThreadedHTTPServer(("127.0.0.1", 0), _FrontHandler)
    front.router = Router([("127.0.0.1", gen_replica.port)], hedge_ms=0)
    front.fleet = _Fleet()
    threading.Thread(target=front.serve_forever, daemon=True).start()
    port = front.server_address[1]
    try:
        code, resp = _post(port, {"id": "fr1", "prompt": [3, 1],
                                  "max_new": 3}, path="/generate")
        assert code == 200 and resp["tokens"] == _demo_ref([3, 1], 3)
        code, resp = _post(port, {"id": "fr2", "x": [0.0] * 16})
        assert code == 200 and len(resp["y"]) == 16
        code, resp = _post(port, {"id": "fr3", "x": [1.0]})
        assert code == 400
        assert _post(port, {}, path="/nope")[0] == 404
        assert _get(port, "/readyz")[0] == 200
        code, body = _get(port, "/metrics")
        assert code == 200 and b"hvd_serving_accepted_total" in body
    finally:
        front.shutdown()
        front.server_close()
        front.router.close()


# -- metric names against JAX -------------------------------------------------
def _drive_metrics(metrics, ledger, monkeypatch, reg):
    monkeypatch.setattr(metrics, "default_registry", lambda: reg)
    monkeypatch.setattr(ledger, "default_registry", lambda: reg)
    monkeypatch.setenv("HVD_TPU_ANOMALY", "0")
    m = metrics
    m.inc_accepted(), m.inc_completed(), m.inc_failed()
    for where in ("admission", "queue", "deadline", "draining", "chaos"):
        m.inc_shed(where)
    m.inc_hedged(), m.inc_retried(), m.inc_swap(), m.set_weight_version(3)
    for reason in ("chase", "pin", "rollback"):
        m.inc_weight_swap(reason)
    m.set_rollout_state("canary"), m.set_rollout_canary_pct(10)
    m.inc_rollout_verdict("promote"), m.inc_rollout_transition("promoted")
    m.set_queue_depth(2), m.set_inflight(1), m.set_draining(True)
    m.observe_batch(3, top=8), m.observe_latency(0.02)
    m.set_fleet_gauges(2, 2)
    for outcome in ("drained", "failure"):
        m.inc_replica_exit(outcome)
    m.inc_respawn(), m.observe_prefill(0.01), m.count_gen_tokens(3)
    m.observe_decode(0.002, 4), m.set_slot_occupancy(3, 4)
    m.set_gen_waiting(1), m.set_kv_pool(5, 64, 65536)
    m.observe_ttft(0.03), m.observe_itl(0.001)
    for reason in ("length", "deadline", "error", "drain"):
        m.inc_gen_finished(reason)
    w = m.LatencyWindow(window_s=3600.0)
    w.observe(0.5, stages={"queue": 0.2, "decode": 0.2}, ttft_s=0.05)
    w.maybe_roll(force=True)
    return {k: (v["type"], v["help"], v.get("bounds"))
            for k, v in reg.snapshot().items()}


def test_serving_metric_names_labels_and_buckets_equal_jax(monkeypatch,
                                                           tmp_path):
    from horovod_tpu.metrics.registry import Registry as JaxRegistry
    from horovod_tpu.serving import ledger as jledger
    from horovod_tpu.serving import metrics as jmetrics

    from horovod_tpu_torch.metrics.registry import Registry
    from horovod_tpu_torch.serving import ledger, metrics
    monkeypatch.setenv("HVD_TPU_OBS_DIR", str(tmp_path))
    got = _drive_metrics(metrics, ledger, monkeypatch, Registry())
    want = _drive_metrics(jmetrics, jledger, monkeypatch, JaxRegistry())
    assert got == want
    assert len([k for k in got if k.startswith("hvd_serving_")]) > 40
    assert metrics.GEN_LATENCY_BUCKETS == jmetrics.GEN_LATENCY_BUCKETS
    assert metrics.LATENCY_BUCKETS == jmetrics.LATENCY_BUCKETS
    assert ledger.STAGES == jledger.STAGES


def test_every_serving_metric_name_is_a_jax_one():
    """Names registered inline (replica, router, fleet) included."""
    import re
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pat = re.compile(r'"(hvd_(?:serving|http)_[a-z_]*[a-z])"')

    def names(pkg):
        out = set()
        for root, _, files in os.walk(os.path.join(repo, pkg, "serving")):
            for f in files:
                if f.endswith(".py") and "rollout" not in root:
                    out |= set(pat.findall(open(os.path.join(root,
                                                             f)).read()))
        return out

    port, jax = names("horovod_tpu_torch"), names("horovod_tpu")
    assert port and port <= jax, port - jax
    assert jax - port <= {"hvd_serving_rollout_status"}, jax - port


# -- the ledger battery -------------------------------------------------------
def test_quantile_nearest_rank_semantics_pinned():
    from horovod_tpu.serving.ledger import quantile as jax_quantile

    from horovod_tpu_torch.serving.ledger import quantile
    from horovod_tpu_torch.serving.metrics import percentile
    assert percentile is quantile
    assert quantile([], 0.99) == 0.0
    assert quantile([5.0], 0.5) == 5.0
    vals = [float(i) for i in range(1, 101)]
    assert [quantile(vals, q) for q in (0.0, 0.5, 0.99, 1.0)] == \
        [1.0, 51.0, 99.0, 100.0]
    assert quantile([1.0, 9.0], 0.99) == 9.0
    rng = np.random.RandomState(0)
    for n in (1, 2, 7, 100):
        xs = sorted(rng.rand(n).tolist())
        for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
            assert quantile(xs, q) == jax_quantile(xs, q)


def test_close_books_names_the_residual():
    from horovod_tpu_torch.serving.ledger import (RESIDUAL, close_books,
                                                  dominant_stage,
                                                  residual_fraction)
    out = close_books(1.0, {"queue": 0.3, "forward": 0.5, "x": -0.2})
    assert out[RESIDUAL] == pytest.approx(0.2) and out["x"] == 0.0
    assert residual_fraction(1.0, {"queue": 0.3, "forward": 0.5}) == \
        pytest.approx(0.2)
    assert residual_fraction(0.0, {}) == 0.0
    assert dominant_stage(out) == "forward"
    assert dominant_stage({RESIDUAL: 1.0}) is None
    over = close_books(0.5, {"queue": 0.7})
    assert over[RESIDUAL] == 0.0
    # a caller-supplied residual is recomputed, not trusted
    assert close_books(1.0, {"forward": 0.9, RESIDUAL: 9.0})[RESIDUAL] == \
        pytest.approx(0.1)
    assert dominant_stage({}) is None


def test_stage_catalog_is_closed_ordered_and_the_jax_one():
    from horovod_tpu.serving import ledger as jledger

    from horovod_tpu_torch.serving import ledger
    assert ledger.STAGES[-1] == ledger.RESIDUAL
    assert set(ledger.STAGES) == (set(ledger.ROUTER_STAGES)
                                  | set(ledger.REPLICA_STAGES)
                                  | set(ledger.GENERATE_STAGES)
                                  | {ledger.RESIDUAL})
    assert len(set(ledger.STAGES)) == len(ledger.STAGES)
    assert (ledger.ROUTER_STAGES, ledger.REPLICA_STAGES,
            ledger.GENERATE_STAGES, ledger.STAGE_BUCKETS) == \
        (jledger.ROUTER_STAGES, jledger.REPLICA_STAGES,
         jledger.GENERATE_STAGES, jledger.STAGE_BUCKETS)


def test_exemplar_ring_is_bounded_oldest_evicted():
    from horovod_tpu_torch.serving.ledger import ExemplarRing
    ring = ExemplarRing(capacity=3)
    for i in range(5):
        ring.add({"e2e_s": float(i), "req_id": f"r{i}"})
    assert len(ring) == 3
    assert [e["req_id"] for e in ring.snapshot()] == ["r2", "r3", "r4"]
    assert [e["req_id"] for e in ring.worst(2)] == ["r4", "r3"]
    ring.clear()
    assert len(ring) == 0


def test_window_books_sums_shares_ttft_and_worst():
    from horovod_tpu_torch.serving.ledger import WindowBooks
    b = WindowBooks(exemplars_per_window=2)
    b.add(1.0, {"queue": 0.3, "forward": 0.6}, trace="fast", req_id="a",
          ttft_s=0.01)
    b.add(3.0, {"queue": 2.4, "forward": 0.3}, trace="slow", req_id="b",
          version=7, ttft_s=0.09)
    b.add(0.5, {"forward": 0.5}, trace="tiny", req_id="c", ttft_s=0.01)
    doc, worst = b.close()
    assert doc["stages"]["queue"] == pytest.approx(2.7)
    assert doc["stages"]["forward"] == pytest.approx(1.4)
    assert doc["unattributed_s"] == pytest.approx(0.4)
    assert doc["unattributed_frac"] == pytest.approx(0.4 / 4.5, abs=1e-3)
    assert sum(doc["stage_shares"].values()) == pytest.approx(1.0,
                                                              abs=1e-3)
    assert doc["dominant_stage"] == "queue"
    assert doc["ttft_p50_s"] == pytest.approx(0.01)
    assert doc["ttft_p99_s"] == pytest.approx(0.09)
    assert [e["req_id"] for e in worst] == ["b", "a"]
    assert worst[0]["trace"] == "slow" and worst[0]["version"] == 7
    assert worst[0]["dominant_stage"] == "queue"
    assert doc["worst_trace"] == "slow"
    doc2, worst2 = b.close()
    assert doc2["stages"] == {} and doc2["stage_shares"] == {}
    assert doc2["unattributed_frac"] == 0.0
    assert doc2["dominant_stage"] is None and worst2 == []


def test_stage_share_gauges_zero_on_idle_roll():
    from horovod_tpu_torch.metrics.registry import default_registry
    from horovod_tpu_torch.serving import ledger
    from horovod_tpu_torch.serving.metrics import LatencyWindow
    w = LatencyWindow(window_s=3600.0)
    w.observe(1.0, stages={"queue": 0.7, "forward": 0.29})
    doc = w.maybe_roll(force=True)
    assert doc["requests"] == 1 and doc["dominant_stage"] == "queue"
    reg = default_registry()
    g = reg.get("hvd_serving_stage_share", labels={"stage": "queue"})
    assert g is not None and g.value == pytest.approx(0.7, abs=1e-3)
    idle = w.maybe_roll(force=True)
    assert idle["requests"] == 0
    for stage in ledger.STAGES:
        g = reg.get("hvd_serving_stage_share", labels={"stage": stage})
        assert g is not None and g.value == 0.0, stage


def test_burn_rate_one_finding_per_episode_and_rearm(monkeypatch):
    monkeypatch.setenv("HVD_TPU_ANOMALY", "0")
    from horovod_tpu_torch.serving.ledger import BurnRateSlo
    slo = BurnRateSlo(slo_p99_s=0.01, budget=0.01, fast_windows=2,
                      slow_windows=4, threshold=10.0)
    assert slo.enabled and slo.is_bad(0.02) and not slo.is_bad(0.005)
    bad, good = (10, 10), (10, 0)
    assert slo.observe_window(*bad) is None
    f = slo.observe_window(*bad)
    assert f is not None and f["burn_fast"] == pytest.approx(100.0)
    assert slo.observe_window(*bad) is None
    assert slo.observe_window(*good) is None and slo.active
    assert slo.observe_window(*good) is None and not slo.active
    assert slo.observe_window(*bad) is not None
    assert slo.observe_window(*good) is None


def test_burn_rate_finding_names_the_dominant_stage(monkeypatch):
    from horovod_tpu_torch.metrics import anomaly
    from horovod_tpu_torch.serving.ledger import BurnRateSlo
    slo = BurnRateSlo(slo_p99_s=0.01, budget=0.01, fast_windows=1,
                      slow_windows=2, threshold=2.0)
    doc = {"p99_s": 0.5, "qps": 10.0, "dominant_stage": "page_wait",
           "stage_shares": {"page_wait": 0.8, "decode": 0.2},
           "worst_trace": "t-9"}
    f = slo.observe_window(10, 5, doc)
    assert f["dominant_stage"] == "page_wait"
    assert f["dominant_share"] == pytest.approx(0.8)
    assert f["worst_trace"] == "t-9"
    # the finding reached the port's anomaly engine
    assert [x["kind"] for x in anomaly.recent_findings()] == ["slo_breach"]
    off = BurnRateSlo(slo_p99_s=0.0)
    assert not off.enabled and off.observe_window(10, 10) is None


def test_batch_size_buckets_widen_with_slot_count(monkeypatch):
    from horovod_tpu_torch.serving.metrics import batch_size_buckets
    b = batch_size_buckets(top=512)
    assert b[-1] >= 512 and b[0] == 1
    assert all(b[i + 1] == 2 * b[i] for i in range(len(b) - 1))
    assert batch_size_buckets(top=8)[-1] >= 128
    monkeypatch.setenv("HVD_TPU_GEN_SLOTS", "300")
    assert batch_size_buckets()[-1] >= 300


def _mk_engine(monkeypatch, **env):
    from horovod_tpu_torch.metrics.anomaly import AnomalyEngine
    for k, v in env.items():
        monkeypatch.setenv(f"HVD_TPU_{k}", str(v))
    return AnomalyEngine()


def test_ttft_drift_detector_flags_sustained_drift(monkeypatch):
    eng = _mk_engine(monkeypatch, ANOMALY_WARMUP=2, ANOMALY_CONSECUTIVE=1)
    base = {"requests": 5, "ttft_p50_s": 0.01}
    for _ in range(4):
        assert eng.observe_serving(dict(base)) == []
    out = eng.observe_serving({"requests": 5, "ttft_p50_s": 0.08,
                               "worst_trace": "t-slow"})
    assert len(out) == 1 and out[0]["kind"] == "ttft_drift"
    assert out[0]["worst_trace"] == "t-slow"
    assert eng.observe_serving({"requests": 0}) == []


def test_queue_growth_detector_streak_and_idle_reset(monkeypatch):
    eng = _mk_engine(monkeypatch, SERVING_STAGE_WINDOWS=2)
    hot = {"requests": 10,
           "stage_shares": {"queue": 0.4, "batch_wait": 0.3}}
    assert eng.observe_serving(dict(hot)) == []
    out = eng.observe_serving(dict(hot))
    assert len(out) == 1 and out[0]["kind"] == "queue_growth"
    assert out[0]["dominant_stage"] == "queue"
    assert eng.observe_serving(dict(hot)) == []
    assert eng.observe_serving({"requests": 0}) == []
    assert eng.observe_serving(dict(hot)) == []
    assert len(eng.observe_serving(dict(hot))) == 1


def test_kv_thrash_detector_names_page_wait_through_the_window(monkeypatch):
    """Windows whose books are page-wait-bound flag ``kv_thrash`` after
    the streak, through ``LatencyWindow`` → ``observe_serving_window``;
    the same traffic without the page wait flags nothing."""
    from horovod_tpu_torch.metrics import anomaly
    from horovod_tpu_torch.serving.metrics import LatencyWindow
    monkeypatch.setenv("HVD_TPU_SERVING_STAGE_WINDOWS", "2")

    def run(page_wait):
        anomaly.reset()
        w = LatencyWindow(window_s=3600.0)
        for _ in range(2):
            for _ in range(3):
                stages = {"page_wait": page_wait, "prefill": 0.01,
                          "decode": 0.02}
                w.observe(sum(stages.values()), stages=stages)
            w.maybe_roll(force=True)
        return [f for f in anomaly.recent_findings()
                if f["kind"] in ("kv_thrash", "queue_growth",
                                 "ttft_drift")]

    found = run(0.05)
    assert len(found) == 1 and found[0]["kind"] == "kv_thrash"
    assert found[0]["dominant_stage"] == "page_wait"
    assert found[0]["stage_share"] > 0.25
    assert run(0.0) == []
