"""Autopsy bundles: one directory that answers "which rank is stuck in
what".

A copy of ``horovod_tpu/diagnostics/autopsy.py``. Written by the hang
watchdog (:mod:`horovod_tpu_torch.diagnostics.watchdog`) or on demand
(:func:`write_autopsy`). Every rank contributes its own evidence with
rank-suffixed filenames (so a shared filesystem accumulates the whole
picture even if cross-rank fetching fails):

* ``stacks_rank<r>.txt`` — ``faulthandler`` dump of every thread;
* ``flight_rank<r>.json`` — the flight-recorder ring;
* ``engine_rank<r>.json`` — the engine document: ``rank`` and ``ts``
  only until the port has the eager collective core, whose counters,
  stragglers and pending-tensor state the JAX package adds here;
* ``metrics_rank<r>.json`` — the full metrics snapshot;
* ``exemplars_rank<r>.json`` — the serving ledger's tail exemplars, when
  there are some;
* ``merged_trace.json`` — the per-rank timeline shards merged into one
  Perfetto trace (when shard tracing is on).

Rank 0 additionally scrapes every peer's ``/debug/stacks``,
``/debug/flight`` and ``/debug/engine`` endpoints (served by the metrics
exporter, ``HVD_TPU_METRICS_PORT``) into ``peer_rank<r>_*`` files. Each
rank writes ``summary_rank<r>.json``; its ``suspects`` name the tensors
the coordinator still waits on (empty without the eager core).

All of it is best-effort: a hung process must never hang HARDER because
its autopsy failed.
"""

from __future__ import annotations

import faulthandler
import json
import os
import random
import time
from typing import Any, Dict, List, Optional
from urllib.request import urlopen

from horovod_tpu_torch.common.logging import get_logger
from horovod_tpu_torch.common.safe_metrics import safe_inc as _metric
from horovod_tpu_torch.diagnostics.flight_recorder import recorder

_FETCH_TIMEOUT_S = 5.0
_FETCH_ATTEMPTS = 3


def default_autopsy_dir() -> str:
    from horovod_tpu_torch.common.config import env_str
    return env_str("AUTOPSY_DIR") or os.path.join(os.getcwd(),
                                                  "hvd_autopsy")


def _state():
    try:
        from horovod_tpu_torch.common.basics import _state as st
        return st if st.initialized else None
    except Exception:
        return None


def _my_rank() -> int:
    st = _state()
    if st is not None:
        return st.rank
    from horovod_tpu_torch.diagnostics.flight_recorder import \
        _best_effort_rank
    return _best_effort_rank()


def _write(path: str, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)


def _write_json(path: str, doc: Any) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, default=str)


def stacks_text() -> str:
    """All-thread stacks via faulthandler (works mid-hang: it walks
    frames without taking the GIL hostage beyond the dump)."""
    import tempfile
    # faulthandler needs a real fd, not a StringIO
    with tempfile.TemporaryFile(mode="w+") as f:
        faulthandler.dump_traceback(file=f, all_threads=True)
        f.seek(0)
        return f.read()


def engine_doc() -> Dict[str, Any]:
    """This rank's engine document. The JAX package adds the live
    backend's ``counters``, ``stragglers`` and ``engine_state`` where the
    backend has them; the port's process group has none of the three
    until its eager collective core exists, so the document is ``rank``
    and ``ts``, as the JAX package's is on a backend without them."""
    return {"rank": _my_rank(), "ts": time.time()}


def metrics_doc() -> Dict[str, Any]:
    try:
        from horovod_tpu_torch.common.basics import metrics_snapshot
        return metrics_snapshot()
    except Exception:
        from horovod_tpu_torch.metrics.registry import default_registry
        return {"registry": default_registry().snapshot()}


def suspects_from_engine(engine: Dict[str, Any]) -> List[dict]:
    """Pending tensors → who is being waited on (the autopsy headline)."""
    out = []
    for dom in (engine.get("engine_state") or {}).get("domains", []):
        for p in dom.get("pending", []):
            out.append({"tensor": p.get("name"),
                        "waited_s": p.get("waited_s"),
                        "missing_ranks": p.get("missing_ranks", []),
                        "ready_ranks": p.get("ready_ranks", []),
                        "domain": dom.get("id")})
    out.sort(key=lambda p: -(p.get("waited_s") or 0.0))
    return out


def peer_debug_ports() -> Dict[int, tuple]:
    """rank → (host, port) for every OTHER rank's exporter.

    Port is ``HVD_TPU_METRICS_PORT + local_rank`` (exporter contract).
    Hosts: same-host ranks are ``127.0.0.1``; multi-host layouts need
    ``HVD_TPU_PEER_HOSTS`` (comma-separated host per rank) since worker
    processes don't learn peer hostnames from the launcher.
    """
    st = _state()
    if st is None or st.config is None:
        return {}
    base = getattr(st.config, "metrics_port", 0)
    if not base or base <= 0:
        return {}
    from horovod_tpu_torch.metrics.exporter import peer_endpoint
    hosts_env = os.environ.get("HVD_TPU_PEER_HOSTS", "")
    hosts = [h.strip() for h in hosts_env.split(",")] if hosts_env else []
    out = {}
    for r in range(st.size):
        if r == st.rank:
            continue
        # single-host launches need no map (local_rank == global rank);
        # multi-host without PEER_HOSTS is skipped, not guessed
        if not hosts and st.cross_size > 1:
            continue
        out[r] = peer_endpoint(r, base, hosts)
    return out


def _fetch(url: str) -> Optional[bytes]:
    """Peer evidence fetch with backoff: a single transient connection
    reset must not silently lose a rank's stacks/flight dump from the
    bundle (the peer's exporter is a small threaded server that resets
    connections under accept bursts — exactly what a multi-rank autopsy
    causes).

    The JAX package goes through its ``common/retry.retry_call`` with the
    same policy: up to ``_FETCH_ATTEMPTS`` tries, a jittered backoff from
    0.2 s doubling to at most 1 s, all within twice the fetch timeout,
    counted under ``hvd_retry_{attempts,exhausted}_total`` with site
    ``autopsy.peer_fetch``. An HTTP status (404/500: version skew,
    endpoint disabled) will not heal with patience — and autopsy time is
    precious — so it is not retried."""
    from urllib.error import HTTPError
    from urllib.request import Request

    from horovod_tpu_torch import tracing
    site = "autopsy.peer_fetch"
    headers = {}
    ctx = tracing.current()
    if ctx is not None:
        headers[tracing.TRACEPARENT] = ctx.traceparent
    start = time.monotonic()
    for attempt in range(_FETCH_ATTEMPTS):
        try:
            return urlopen(Request(url, headers=headers),
                           timeout=_FETCH_TIMEOUT_S).read()
        except HTTPError as e:
            err = e
            break
        except OSError as e:
            err = e
            _metric("hvd_retry_attempts_total",
                    "transient errors absorbed by retry_call, per site",
                    site=site)
            delay = min(1.0, 0.2 * 2.0 ** attempt)
            delay *= 1.0 + 0.25 * (2.0 * random.random() - 1.0)
            spent = time.monotonic() - start + delay > 2.0 * _FETCH_TIMEOUT_S
            if attempt == _FETCH_ATTEMPTS - 1 or spent:
                _metric("hvd_retry_exhausted_total",
                        "retry_call gave up (attempts or deadline "
                        "spent), per site", site=site)
                break
            time.sleep(delay)
        except Exception as e:
            err = e
            break
    get_logger().warning("autopsy: fetch %s failed: %r", url, err)
    return None


def _collect_peers(bundle: str) -> tuple:
    """Returns ``(fetched, unreachable)`` rank lists; a peer is
    unreachable when none of its /debug endpoints answered even with
    retries — recorded in the summary so a bundle missing a rank's
    evidence says so explicitly instead of looking complete."""
    from horovod_tpu_torch import tracing
    root = tracing.new_trace("autopsy")
    fetched, unreachable = [], []
    for r, (host, port) in sorted(peer_debug_ports().items()):
        base = f"http://{host}:{port}/debug"
        got_any = False
        # one child span per peer: which rank's evidence was slow (or
        # missing) is part of the autopsy's own story
        ctx = tracing.child(root, "autopsy")
        t0 = time.time()
        with tracing.activate(ctx):
            for kind, suffix in (("stacks", "txt"), ("flight", "json"),
                                 ("engine", "json")):
                body = _fetch(f"{base}/{kind}")
                if body is None:
                    continue
                got_any = True
                with open(os.path.join(
                        bundle,
                        f"peer_rank{r}_{kind}.{suffix}"), "wb") as f:
                    f.write(body)
        tracing.record_span("autopsy", "peer_fetch", ctx, start=t0,
                            dur_s=time.time() - t0, peer=r,
                            reached=got_any)
        (fetched if got_any else unreachable).append(r)
    return fetched, unreachable


def _merge_shards_into(bundle: str) -> Optional[str]:
    """Merge whatever timeline shards this host can see (shared-FS best
    case: all of them) into the bundle."""
    from horovod_tpu_torch.common.config import get_config
    from horovod_tpu_torch.common.timeline import shard_paths_for
    from horovod_tpu_torch.diagnostics.merge import merge_shards
    cfg = get_config()
    if not cfg.timeline:
        return None
    st = _state()
    if st is not None and st.timeline is not None:
        st.timeline.flush()  # a live shard is mid-array on disk
    paths = [p for p in shard_paths_for(cfg.timeline)
             if os.path.exists(p)]
    # rank 0's whole-run timeline, if any (a FILE base only — a
    # directory base holds shards already picked up above)
    if os.path.isfile(cfg.timeline):
        paths.append(cfg.timeline)
    if not paths:
        return None
    out = os.path.join(bundle, "merged_trace.json")
    merge_shards(paths, out)
    return out


def write_autopsy(out_dir: Optional[str] = None, reason: str = "",
                  fetch_peers: Optional[bool] = None) -> str:
    """Write this rank's autopsy evidence into ``out_dir`` (default
    ``HVD_TPU_AUTOPSY_DIR`` / ``./hvd_autopsy``); returns the bundle
    directory.  Every step is individually best-effort."""
    rank = _my_rank()
    bundle = out_dir or default_autopsy_dir()
    os.makedirs(bundle, exist_ok=True)
    get_logger().error("writing autopsy bundle to %s (%s)", bundle,
                       reason or "on demand")

    def step(fn):
        try:
            return fn()
        except Exception as e:
            get_logger().warning("autopsy step failed: %r", e)
            return None

    step(lambda: _write(os.path.join(bundle, f"stacks_rank{rank}.txt"),
                        stacks_text()))
    step(lambda: recorder().dump_to(
        os.path.join(bundle, f"flight_rank{rank}.json")))
    engine = step(engine_doc) or {}
    step(lambda: _write_json(
        os.path.join(bundle, f"engine_rank{rank}.json"), engine))
    step(lambda: _write_json(
        os.path.join(bundle, f"metrics_rank{rank}.json"), metrics_doc()))
    step(lambda: _merge_shards_into(bundle))

    if fetch_peers is None:
        fetch_peers = rank == 0
    fetched: List[int] = []
    unreachable: List[int] = []
    if fetch_peers:
        fetched, unreachable = step(
            lambda: _collect_peers(bundle)) or ([], [])
        if unreachable:
            get_logger().warning(
                "autopsy: peers %s unreachable after retries; their "
                "evidence is missing from this bundle", unreachable)

    suspects = suspects_from_engine(engine)

    def _profiles():
        # a capture window that never completed (the job degraded,
        # started its trace, then hung/died) is closed NOW so the trace
        # bytes are on disk, then every capture record — path, trigger,
        # size — is embedded: the bundle ships its own "why" evidence
        from horovod_tpu_torch import profiling
        profiling.finalize_open_capture(reason=f"autopsy: {reason}")
        return profiling.recent_captures()

    profiles = step(_profiles) or []

    def _anomalies():
        # "was it degrading before it died?" — the anomaly engine's
        # findings (step-time drift, throughput regression, persistent
        # straggler, exposed-comm growth) land in the summary so a hang
        # autopsy also reports the degradation history before the stall
        from horovod_tpu_torch.metrics.anomaly import recent_findings
        return recent_findings()

    anomalies = step(_anomalies) or []

    def _goodput():
        # the final ledger snapshot: where the job's wall-clock went
        # before it died, with the open window flushed so the last
        # partial window's evidence is in the books too
        from horovod_tpu_torch.metrics import goodput
        return goodput.snapshot(flush_open=True)

    goodput_snap = step(_goodput)

    def _exemplars():
        # the serving ledger's tail exemplars: the worst requests per
        # latency window, each with its trace id and full stage
        # breakdown — a serving-plane death ships WHERE its slowest
        # requests spent their time
        from horovod_tpu_torch.serving.ledger import exemplars
        return exemplars()

    exemplar_docs = step(_exemplars) or []
    if exemplar_docs:
        step(lambda: _write_json(
            os.path.join(bundle, f"exemplars_rank{rank}.json"),
            {"exemplars": exemplar_docs}))
    step(lambda: _write_json(
        os.path.join(bundle, f"summary_rank{rank}.json"), {
        "reason": reason,
        "rank": rank,
        "written_at": time.time(),
        "suspects": suspects,
        "anomalies": anomalies,
        # the autopilot's decision trail and the elastic driver's outage
        # state: the JAX package's sections, empty as there when those
        # planes are absent (the port has neither yet)
        "actions": [],
        "profiles": profiles,
        "goodput": goodput_snap,
        "driver_outage": None,
        "exemplars": len(exemplar_docs),
        "peers_fetched": fetched,
        "peers_unreachable": unreachable,
    }))
    if profiles:
        get_logger().error(
            "autopsy: %d device-trace capture(s) available; last: %s",
            len(profiles), profiles[-1].get("path"))
    if anomalies:
        last = anomalies[-1]
        get_logger().error(
            "autopsy: %d anomaly finding(s) preceded this bundle; last: "
            "%s at step %s", len(anomalies), last.get("kind"),
            last.get("step"))
    if suspects:
        top = suspects[0]
        get_logger().error(
            "autopsy: tensor %r has waited %.1fs on ranks %s",
            top["tensor"], top.get("waited_s") or 0.0,
            top.get("missing_ranks"))
    return bundle
