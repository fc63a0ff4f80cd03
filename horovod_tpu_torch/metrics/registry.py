"""Dependency-free metrics primitives: Counter / Gauge / Histogram + Registry.

A copy of ``horovod_tpu/metrics/registry.py``: instruments record locally
with a lock per instrument, ``snapshot()`` produces a plain-dict,
**mergeable** view (sum counters/histograms across workers; gauges merge by
their declared aggregation), and ``render_prometheus()`` serializes a
snapshot in Prometheus text exposition format v0.0.4. Names, label keys,
``agg=`` merge rules and the rendered text are the JAX package's, byte for
byte, so one scraper reads either package.

Stdlib-only by design: the training hot path must not grow a pip
dependency for the sake of counters.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Default histogram buckets: fixed log-scale (powers of 2) from 1 ms to
# ~524 s — wide enough for step times from a pallas microbenchmark to a
# pathological straggler stall, cheap enough to merge across a pod.
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(
    1e-3 * 2.0 ** i for i in range(20))


def _label_key(labels: Optional[Dict[str, str]]) -> str:
    """Canonical label suffix, '' when unlabeled: ``{a="1",b="x"}``."""
    if not labels:
        return ""
    items = sorted((str(k), str(v)) for k, v in labels.items())
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in items)
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None) -> None:
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._lock = threading.Lock()

    def snapshot(self) -> dict:
        raise NotImplementedError


class Counter(_Instrument):
    """Monotonically increasing count (merge = sum)."""

    kind = "counter"

    def __init__(self, name, help="", labels=None):
        super().__init__(name, help, labels)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> dict:
        return {"type": self.kind, "help": self.help, "value": self.value}


class Gauge(_Instrument):
    """Point-in-time value. ``agg`` declares how cross-worker merges
    combine samples: ``last`` (default), ``sum`` (e.g. throughput),
    ``max``, ``min`` (e.g. OOM margin: the tightest rank is THE
    number), or ``mean``."""

    kind = "gauge"

    def __init__(self, name, help="", labels=None,
                 agg: Optional[str] = None):
        super().__init__(name, help, labels)
        agg = agg or "last"
        if agg not in ("last", "sum", "max", "min", "mean"):
            raise ValueError(f"unknown gauge agg {agg!r}")
        self.agg = agg
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> dict:
        return {"type": self.kind, "help": self.help, "value": self.value,
                "agg": self.agg}


class Histogram(_Instrument):
    """Cumulative-bucket histogram over fixed (log-scale by default)
    bounds. Snapshots carry per-bucket counts + sum + count and merge by
    elementwise addition — bounds are part of the identity, so merging
    snapshots with different bounds is an error."""

    kind = "histogram"

    def __init__(self, name, help="", labels=None,
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help, labels)
        bs = tuple(sorted(buckets)) if buckets else DEFAULT_BUCKETS
        if any(b <= 0 or not math.isfinite(b) for b in bs):
            raise ValueError("bucket bounds must be finite and positive")
        self._bounds: Tuple[float, ...] = bs
        self._counts = [0] * (len(bs) + 1)  # last slot = +Inf overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        i = bisect.bisect_left(self._bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot(self) -> dict:
        with self._lock:
            return {"type": self.kind, "help": self.help,
                    "bounds": list(self._bounds),
                    "counts": list(self._counts),
                    "sum": self._sum, "count": self._count}


class Registry:
    """Get-or-create instrument registry with mergeable snapshots.

    Keys are ``name`` + canonical label set; re-requesting an existing
    instrument returns the same object, requesting it with a different
    type raises (mirrors prometheus_client semantics without the dep).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}

    def _get_or_create(self, cls, name, help, labels, **kwargs):
        key = name + _label_key(labels)
        with self._lock:
            inst = self._instruments.get(key)
            if inst is not None:
                if not isinstance(inst, cls):
                    raise ValueError(
                        f"metric {key!r} already registered as "
                        f"{inst.kind}, requested {cls.kind}")
                # explicitly requested options must match the existing
                # instrument — silently handing back different semantics
                # (a "sum" caller getting a "last" gauge) corrupts merges
                agg = kwargs.get("agg")
                if agg is not None and inst.agg != agg:
                    raise ValueError(
                        f"metric {key!r} already registered with "
                        f"agg={inst.agg!r}, requested {agg!r}")
                buckets = kwargs.get("buckets")
                if buckets is not None and \
                        tuple(sorted(buckets)) != inst._bounds:
                    raise ValueError(
                        f"metric {key!r} already registered with "
                        f"different bucket bounds")
                return inst
            inst = cls(name, help=help, labels=labels, **kwargs)
            self._instruments[key] = inst
            return inst

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None,
              agg: Optional[str] = None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels, agg=agg)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def get(self, name: str,
            labels: Optional[Dict[str, str]] = None) -> Optional[_Instrument]:
        """Fetch an existing instrument, or None — never creates (the
        get-or-create constructors would register a zero-valued
        instrument as a side effect of merely *asking*)."""
        with self._lock:
            return self._instruments.get(name + _label_key(labels))

    def unregister(self, name: str,
                   labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._instruments.pop(name + _label_key(labels), None)

    def drop_prefix(self, prefix: str) -> int:
        """Unregister every instrument whose key starts with ``prefix``;
        returns the count.  Used on (re-)init to drop gauges mirroring a
        DEAD engine's state (``hvd_engine_*``, ``hvd_straggler_*``) so a
        re-meshed world's scrape never serves the previous generation's
        last values as if they were live."""
        with self._lock:
            keys = [k for k in self._instruments if k.startswith(prefix)]
            for k in keys:
                del self._instruments[k]
            return len(keys)

    def clear(self) -> None:
        with self._lock:
            self._instruments.clear()

    def snapshot(self) -> Dict[str, dict]:
        """Plain-dict view: ``{key: {type, help, ...values}}``. Keys embed
        the label set (``name{rank="1"}``); values are merge-ready."""
        with self._lock:
            items = list(self._instruments.items())
        return {key: inst.snapshot() for key, inst in items}

    @staticmethod
    def merge(snapshots: Iterable[Dict[str, dict]]) -> Dict[str, dict]:
        """Combine per-worker snapshots: counters and histograms add,
        gauges combine per their ``agg`` declaration."""
        out: Dict[str, dict] = {}
        means: Dict[str, List[float]] = {}
        for snap in snapshots:
            for key, s in snap.items():
                if key not in out:
                    out[key] = {k: (list(v) if isinstance(v, list) else v)
                                for k, v in s.items()}
                    if s["type"] == "gauge" and s.get("agg") == "mean":
                        means[key] = [s["value"]]
                    continue
                t = out[key]
                if t["type"] != s["type"]:
                    raise ValueError(f"type mismatch merging {key!r}")
                if s["type"] == "counter":
                    t["value"] += s["value"]
                elif s["type"] == "histogram":
                    if t["bounds"] != s["bounds"]:
                        raise ValueError(
                            f"bucket bounds mismatch merging {key!r}")
                    t["counts"] = [a + b for a, b in
                                   zip(t["counts"], s["counts"])]
                    t["sum"] += s["sum"]
                    t["count"] += s["count"]
                else:  # gauge
                    agg = s.get("agg", "last")
                    if agg == "sum":
                        t["value"] += s["value"]
                    elif agg == "max":
                        t["value"] = max(t["value"], s["value"])
                    elif agg == "min":
                        t["value"] = min(t["value"], s["value"])
                    elif agg == "mean":
                        means.setdefault(key, [t["value"]]).append(
                            s["value"])
                    else:  # last
                        t["value"] = s["value"]
        for key, vals in means.items():
            out[key]["value"] = sum(vals) / len(vals)
        return out


def render_prometheus(snapshot: Dict[str, dict]) -> str:
    """Serialize a snapshot as Prometheus text format v0.0.4."""
    # group by bare metric name so HELP/TYPE are emitted once per family
    families: Dict[str, List[Tuple[str, dict]]] = {}
    for key in sorted(snapshot):
        name = key.split("{", 1)[0]
        families.setdefault(name, []).append((key, snapshot[key]))
    lines: List[str] = []
    for name, series in families.items():
        first = series[0][1]
        if first.get("help"):
            lines.append(f"# HELP {name} {first['help']}")
        lines.append(f"# TYPE {name} {first['type']}")
        for key, s in series:
            label_part = key[len(name):]  # "" or '{a="b"}'
            if s["type"] == "histogram":
                inner = label_part[1:-1] if label_part else ""
                cum = 0
                for bound, c in zip(s["bounds"], s["counts"]):
                    cum += c
                    le = _fmt(bound)
                    sep = "," if inner else ""
                    lines.append(
                        f'{name}_bucket{{{inner}{sep}le="{le}"}} {cum}')
                cum += s["counts"][-1]
                sep = "," if inner else ""
                lines.append(
                    f'{name}_bucket{{{inner}{sep}le="+Inf"}} {cum}')
                lines.append(f"{name}_sum{label_part} {_fmt(s['sum'])}")
                lines.append(f"{name}_count{label_part} {s['count']}")
            else:
                lines.append(f"{name}{label_part} {_fmt(s['value'])}")
    return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


_DEFAULT = Registry()


def default_registry() -> Registry:
    """The process-wide registry (``metrics_snapshot()["registry"]``)."""
    return _DEFAULT
