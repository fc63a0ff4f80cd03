"""Tree-aggregated fleet metrics: one scrape for the whole job.

A copy of ``horovod_tpu/metrics/fleet.py``. The workers form a **fan-in
tree**: every rank periodically pushes its mergeable registry snapshot
(merged with whatever its children last pushed) to its parent over the
exporter's HTTP plane (``POST /metrics/push``), so data flows rank →
parent → ... → rank 0, each node handling at most ``arity`` children and
one upstream push per interval — O(arity) per node, O(log_arity W) hops
end to end.  Rank 0 serves the merged result on ``GET /metrics/fleet``
with per-rank breakdown gauges (min/max/mean windowed step time, the
currently-charged straggler rank, how many ranks are reporting), so a
dashboard scrapes ONE endpoint regardless of world size.

Topology: parent(r) = (r-1) // arity; children(r) = r*arity+1 ...
r*arity+arity (a complete ``arity``-ary tree over ranks — computed
locally from (rank, size), no negotiation).  Addressing reuses the
exporter contract (base port + local rank; ``HVD_TPU_PEER_HOSTS`` for
multi-host, exactly like the autopsy's peer fetch).

The aggregator is built by ``init`` and torn down by ``shutdown``, so a
re-init re-wires the tree from the new (rank, size); pushed documents
carry the sender's (size, generation) and a receiver rejects documents
from a different world.  A dead parent degrades gracefully: the child
keeps its subtree and retries every interval (logged once per outage,
not per tick), and rank 0's ``ranks_reporting`` gauge makes the gap
visible; entries older than ``3 × push interval`` go stale and drop out
of the merge rather than serving dead data.

Knobs: ``HVD_TPU_FLEET_PUSH_SECONDS`` (default 2),
``HVD_TPU_FLEET_ARITY`` (default 4), ``HVD_TPU_FLEET=0`` disables.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.request
from typing import Dict, List, Optional, Tuple

from horovod_tpu_torch.common.logging import get_logger
from horovod_tpu_torch.metrics.registry import (Registry, default_registry,
                                          render_prometheus)

DEFAULT_PUSH_SECONDS = 2.0
DEFAULT_ARITY = 4
_PUSH_TIMEOUT_S = 5.0


def push_interval_s() -> float:
    from horovod_tpu_torch.common.config import env_float
    return max(0.05, env_float("FLEET_PUSH_SECONDS", DEFAULT_PUSH_SECONDS))


def tree_arity() -> int:
    from horovod_tpu_torch.common.config import env_int
    return max(1, env_int("FLEET_ARITY", DEFAULT_ARITY))


def fleet_enabled() -> bool:
    from horovod_tpu_torch.common.config import env_bool
    return env_bool("FLEET", True)


def parent_of(rank: int, arity: int) -> Optional[int]:
    return None if rank <= 0 else (rank - 1) // arity


def children_of(rank: int, size: int, arity: int) -> List[int]:
    first = rank * arity + 1
    return [c for c in range(first, min(first + arity, size))]


def tree_depth(size: int, arity: int) -> int:
    """Hops from the deepest rank to rank 0 (0 for a 1-rank world)."""
    d, r = 0, size - 1
    while r > 0:
        r = (r - 1) // arity
        d += 1
    return d


def rank_endpoint(rank: int, base_port: int) -> Tuple[str, int]:
    """(host, exporter port) for ``rank`` — the SAME helper the autopsy
    peer fetch uses (:func:`horovod_tpu_torch.metrics.exporter.peer_endpoint`),
    fed from ``HVD_TPU_PEER_HOSTS``; one implementation of the
    exporter addressing contract, not a fork of it."""
    from horovod_tpu_torch.metrics.exporter import peer_endpoint
    hosts_env = os.environ.get("HVD_TPU_PEER_HOSTS", "")
    hosts = [h.strip() for h in hosts_env.split(",")] if hosts_env else None
    return peer_endpoint(rank, base_port, hosts)


class FleetAggregator:
    """One node of the fan-in tree.

    Args:
      rank/size: this worker's identity in the current world.
      base_port: exporter base port (push target = parent's exporter).
      registry: local registry contributing this rank's snapshot.
      generation: world generation stamped into pushed docs (elastic
        re-mesh bumps it; mismatched docs are rejected).
      push_interval/arity: override the env knobs (tests).

    The JAX aggregator also runs the exporter's collectors before each
    local snapshot; the port has none until the eager core's
    ``EngineCollector`` (ROADMAP queue 1 item 8).
    """

    def __init__(self, rank: int, size: int, base_port: int,
                 registry: Optional[Registry] = None,
                 generation: int = 0,
                 push_interval: Optional[float] = None,
                 arity: Optional[int] = None,
                 cross_size: int = 1) -> None:
        self.rank = int(rank)
        self.size = int(size)
        self.base_port = int(base_port)
        self.generation = int(generation)
        self.arity = arity or tree_arity()
        self.interval = push_interval or push_interval_s()
        self.stale_after = 3.0 * self.interval
        self._reg = registry or default_registry()
        self.parent = parent_of(self.rank, self.arity)
        self.children = children_of(self.rank, self.size, self.arity)
        # multi-host without a rank->host map: upstream addresses
        # cannot be derived — refuse to guess loopback (the autopsy
        # peer map makes the same call); local aggregation + the
        # subtree endpoint keep working, only the upstream push is off
        self.routable = self.parent is None or cross_size <= 1 \
            or bool(os.environ.get("HVD_TPU_PEER_HOSTS", ""))
        if not self.routable:
            get_logger().warning(
                "fleet: multi-host layout (cross_size=%d) without "
                "HVD_TPU_PEER_HOSTS — upstream pushes disabled for "
                "rank %d (set the rank->host map to enable the tree)",
                cross_size, self.rank)
        self._lock = threading.Lock()
        # child rank -> (doc, monotonic arrival time)
        self._child_docs: Dict[int, Tuple[dict, float]] = {}
        # windowed per-rank step time: previous (sum, count) of the
        # local step-time histogram, delta'd per PUSH (scrapes read the
        # window without consuming it), + the last closed window's mean
        # so an idle rank stays in the breakdown instead of vanishing
        self._prev_hist: Optional[Tuple[float, int]] = None
        self._last_win: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._push_failures = 0
        self.pushes_sent = 0
        self.pushes_received = 0
        self.rejected = 0

    # -- local contribution --------------------------------------------------
    def _local_per_rank(self, snap: dict, consume: bool) -> dict:
        """This rank's breakdown entry: cumulative steps plus the step
        time averaged over THIS push window (delta of the histogram's
        sum/count since the previous push) — 'recent', not
        since-forever, so a developing straggler shows immediately.

        ``consume=False`` (scrapes) reads the in-progress window
        WITHOUT closing it: a dashboard polling /metrics/fleet faster
        than the push cadence must not starve the data the next
        upstream push (and the straggler detector) reports.  A window
        with no new steps carries the last closed window's mean — an
        idle-but-alive rank stays in the min/max/mean breakdown."""
        entry: Dict[str, object] = {"ts": round(time.time(), 3)}
        h = snap.get("hvd_step_time_seconds")
        if h and h.get("type") == "histogram":
            s, c = float(h["sum"]), int(h["count"])
            entry["steps"] = c
            if c > 0:
                entry["mean_step_time"] = round(s / c, 6)
            with self._lock:
                # first push: the window is everything so far — a
                # straggler shows from the tree's very first aggregation
                prev = self._prev_hist or (0.0, 0)
                if c > prev[1]:
                    win = round((s - prev[0]) / (c - prev[1]), 6)
                else:
                    win = self._last_win
                if consume:
                    self._prev_hist = (s, c)
                    self._last_win = win
            if win is not None:
                entry["win_step_time"] = win
        try:
            # goodput ledger (docs/OBSERVABILITY.md "Goodput ledger"):
            # last closed window's productive fraction + dominating
            # loss category ride the breakdown entry, so rank 0 can
            # name the fleet's worst offender without extra traffic
            from horovod_tpu_torch.metrics import goodput
            gp = goodput.fleet_summary()
            if gp is not None:
                entry["goodput"] = gp
        except Exception:
            pass
        return entry

    # -- tree plumbing -------------------------------------------------------
    def ingest(self, doc: dict) -> bool:
        """A child's pushed subtree document (exporter ``/metrics/push``
        handler calls this).  Returns False (and counts a rejection)
        for documents from another world or an unknown child."""
        try:
            child = int(doc["from_rank"])
        except (KeyError, TypeError, ValueError):
            self.rejected += 1
            return False
        if int(doc.get("size", -1)) != self.size or \
                int(doc.get("generation", -1)) != self.generation or \
                child not in self.children:
            self.rejected += 1
            get_logger().debug(
                "fleet: rejected push from rank %s (size %s gen %s; "
                "we are size %d gen %d, children %s)", child,
                doc.get("size"), doc.get("generation"), self.size,
                self.generation, self.children)
            return False
        with self._lock:
            self._child_docs[child] = (doc, time.monotonic())
            self.pushes_received += 1
        return True

    def subtree_doc(self, consume_window: bool = True) -> dict:
        """Merge this rank's snapshot with every FRESH child subtree —
        the document pushed upstream, and what ``/metrics/fleet``
        renders on rank 0 (scrapes pass ``consume_window=False`` so
        they observe without advancing the push window)."""
        snap = self._reg.snapshot()
        per_rank = {str(self.rank): self._local_per_rank(
            snap, consume=consume_window)}
        covers = [self.rank]
        snaps = [snap]
        now = time.monotonic()
        with self._lock:
            items = list(self._child_docs.items())
        stale = []
        for child, (doc, ts) in items:
            if now - ts > self.stale_after:
                stale.append(child)
                continue
            snaps.append(doc.get("snapshot") or {})
            per_rank.update(doc.get("per_rank") or {})
            covers.extend(doc.get("covers") or [])
        try:
            merged = Registry.merge(snaps)
        except ValueError as e:
            # a mid-rollout worker with different histogram bounds must
            # not take the whole fleet view down — serve local + note it
            get_logger().warning("fleet: snapshot merge failed (%r); "
                                 "serving local-only view", e)
            merged = snap
            covers = [self.rank]
            per_rank = {str(self.rank): per_rank[str(self.rank)]}
        return {"from_rank": self.rank, "size": self.size,
                "generation": self.generation,
                "covers": sorted(set(covers)), "stale": sorted(stale),
                "per_rank": per_rank, "snapshot": merged,
                "ts": round(time.time(), 3)}

    def _push_upstream(self, doc: dict) -> None:
        host, port = rank_endpoint(self.parent, self.base_port)
        url = f"http://{host}:{port}/metrics/push"
        body = json.dumps(doc, default=str).encode()
        req = urllib.request.Request(
            url, data=body, method="POST",
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=_PUSH_TIMEOUT_S).read()
        except Exception as e:
            self._push_failures += 1
            if self._push_failures in (1, 10) or \
                    self._push_failures % 100 == 0:
                # once per outage start (and sparsely after), not per
                # tick — a dead parent at a 2s cadence must not flood
                get_logger().warning(
                    "fleet: push to parent rank %s (%s) failed %d time(s)"
                    ": %r", self.parent, url, self._push_failures, e)
            return
        if self._push_failures:
            get_logger().info("fleet: push to parent rank %s recovered "
                              "after %d failure(s)", self.parent,
                              self._push_failures)
        self._push_failures = 0
        self.pushes_sent += 1

    # -- rank-0 view ---------------------------------------------------------
    def fleet_snapshot(self) -> dict:
        """The merged fleet snapshot plus derived breakdown gauges —
        what ``/metrics/fleet`` renders.  Read-only with respect to the
        push window: scraping must never change what gets pushed."""
        doc = self.subtree_doc(consume_window=False)
        merged = dict(doc["snapshot"])
        covers = doc["covers"]

        def g(name, value, help, labels=None, agg="last"):
            key = name
            if labels:
                items = sorted(labels.items())
                key += "{" + ",".join(f'{k}="{v}"' for k, v in items) + "}"
            merged[key] = {"type": "gauge", "help": help, "agg": agg,
                           "value": float(value)}

        g("hvd_fleet_size", self.size, "world size of the fleet view")
        g("hvd_fleet_ranks_reporting", len(covers),
          "ranks contributing fresh samples to this fleet view")
        g("hvd_fleet_tree_depth",
          tree_depth(self.size, self.arity),
          "fan-in tree depth (hops from deepest rank to rank 0)")
        g("hvd_fleet_generation", self.generation,
          "world generation this tree was wired for")
        win = {int(r): e["win_step_time"]
               for r, e in doc["per_rank"].items()
               if isinstance(e, dict)
               and isinstance(e.get("win_step_time"), (int, float))}
        for r, e in sorted(doc["per_rank"].items(), key=lambda kv: kv[0]):
            if isinstance(e, dict) and "win_step_time" in e:
                g("hvd_fleet_rank_step_time_seconds", e["win_step_time"],
                  "windowed mean step time of this rank",
                  labels={"rank": str(r)})
        if win:
            vals = list(win.values())
            g("hvd_fleet_step_time_min", min(vals),
              "fastest rank's windowed mean step time")
            g("hvd_fleet_step_time_max", max(vals),
              "slowest rank's windowed mean step time")
            g("hvd_fleet_step_time_mean", sum(vals) / len(vals),
              "fleet mean windowed step time")
            g("hvd_fleet_straggler_rank", max(win, key=lambda r: win[r]),
              "rank with the slowest windowed mean step time")
        gp = {int(r): e["goodput"]["fraction"]
              for r, e in doc["per_rank"].items()
              if isinstance(e, dict) and isinstance(e.get("goodput"), dict)
              and isinstance(e["goodput"].get("fraction"), (int, float))}
        for r in sorted(gp):
            g("hvd_fleet_rank_goodput_fraction", gp[r],
              "last goodput window's productive fraction of this rank",
              labels={"rank": str(r)})
        if gp:
            worst = min(gp, key=lambda r: gp[r])
            g("hvd_fleet_goodput_min", gp[worst],
              "worst rank's productive goodput fraction")
            g("hvd_fleet_goodput_worst_rank", worst,
              "rank with the lowest productive goodput fraction")
        return {"doc": doc, "snapshot": merged}

    def render_fleet(self) -> str:
        return render_prometheus(self.fleet_snapshot()["snapshot"])

    # -- lifecycle -----------------------------------------------------------
    def _tick(self) -> None:
        doc = self.subtree_doc()
        if self.parent is not None:
            if not self.routable:
                return  # multi-host without PEER_HOSTS: warned at init
            self._push_upstream(doc)
        else:
            # rank 0: feed the persistent-straggler detector and record
            # a fleet point into the time-series history
            try:
                from horovod_tpu_torch.metrics import anomaly
                eng = anomaly.default_engine()
                if eng is not None:
                    eng.observe_fleet(doc["per_rank"])
            except Exception:
                pass

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self._tick()
            except Exception as e:  # the tree must outlive a bad tick
                get_logger().debug("fleet tick failed: %r", e)

    def start(self) -> "FleetAggregator":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="hvd-tpu-fleet", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    def flush(self) -> None:
        """Push/aggregate NOW (tests and pre-scrape freshness)."""
        self._tick()
