"""The unified causal reader: one query across every evidence plane.

A copy of ``horovod_tpu/tracing/reader.py``. Two CLI verbs
(``python -m horovod_tpu_torch.diagnostics ...``):

* ``timeline`` — merge flight dumps + per-rank timeline shards + the
  serving request log + the ``actions_rank<r>.jsonl`` decisions + the
  re-mesh history into ONE skew-corrected Perfetto/chrome trace,
  reusing the shard merger's clock machinery
  (:mod:`horovod_tpu_torch.diagnostics.merge`): each plane becomes a
  track, flight ``trace_span`` records become complete (``X``) spans,
  stamped events become instants, and every flight dump's recorded
  ``wall_offset_s`` maps its events onto the coordinator's clock so
  cross-rank evidence lines up instead of drifting by clock skew.
* ``trace <id>`` — the causal tree of one trace id: every span and
  stamped event carrying the id, joined by span/parent into a tree
  with per-hop latency attribution (each hop's duration, its share of
  the parent, the slow hop flagged).

Record sources understood (all optional — the reader works with
whatever planes exist):

* flight dumps (``hvd_flight_rank<r>.json`` / autopsy
  ``flight_rank<r>.json``): ``trace_span`` events are spans; any other
  event stamped ``trace``/``span`` is a point node;
* serving request logs (JSONL, rotated ``.1`` read first);
* the OBS store (``HVD_TPU_OBS_DIR``): ``actions_rank<r>.jsonl``
  decisions and re-mesh history points stamped with a trace (files a
  JAX job wrote read alike).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

SPAN_KIND = "trace_span"

#: flight-event fields that are span plumbing, not display attributes
_SPAN_FIELDS = ("ts", "seq", "kind", "plane", "name", "start", "dur_s",
                "trace", "span", "parent")


# -- loading ------------------------------------------------------------------
def load_flight_dump(path: str) -> Optional[dict]:
    """One flight dump document, or None when unreadable (one dead
    rank's garbled file must not cost the others' evidence)."""
    try:
        with open(path) as f:
            doc = json.load(f)
        if isinstance(doc, dict) and isinstance(doc.get("events"), list):
            return doc
    except (OSError, ValueError):
        pass
    return None


def find_flight_dumps(directory: str) -> List[str]:
    """Flight dumps under ``directory`` (crash hooks, autopsies and the
    acceptance tests all write ``*flight*rank*.json``)."""
    out = [p for p in glob.glob(os.path.join(directory, "*.json"))
           if "flight" in os.path.basename(p).lower()
           and "rank" in os.path.basename(p).lower()]
    return sorted(out)


def read_jsonl(path: str) -> List[dict]:
    """Torn-tail-tolerant JSONL reader, rotated generation first."""
    out: List[dict] = []
    for p in (path + ".1", path):
        try:
            with open(p) as f:
                for line in f:
                    try:
                        doc = json.loads(line)
                    except ValueError:
                        continue  # torn tail line
                    if isinstance(doc, dict):
                        out.append(doc)
        except OSError:
            continue
    return out


def _obs_files(obs_dir: str, basename: str) -> List[str]:
    try:
        return sorted(
            os.path.join(obs_dir, n) for n in os.listdir(obs_dir)
            if n.startswith(basename + "_rank") and n.endswith(".jsonl"))
    except OSError:
        return []


# -- trace collection ---------------------------------------------------------
def spans_from_events(events: Sequence[dict], offset_s: float = 0.0,
                      source: Optional[str] = None,
                      trace_id: Optional[str] = None
                      ) -> Tuple[List[dict], List[dict]]:
    """Split flight events into ``(spans, points)`` — ``trace_span``
    records vs other trace-stamped events — with wall times mapped onto
    the coordinator's clock (``- offset_s``).  ``trace_id`` filters."""
    spans: List[dict] = []
    points: List[dict] = []
    for ev in events:
        if not isinstance(ev, dict) or not ev.get("trace"):
            continue
        if trace_id is not None and ev["trace"] != trace_id:
            continue
        if ev.get("kind") == SPAN_KIND:
            spans.append({
                "trace": ev["trace"], "span": ev.get("span"),
                "parent": ev.get("parent"),
                "plane": ev.get("plane", "?"),
                "name": ev.get("name", "?"),
                "start": float(ev.get("start", ev.get("ts", 0.0)))
                - offset_s,
                "dur_s": float(ev.get("dur_s") or 0.0),
                "source": source,
                "attrs": {k: v for k, v in ev.items()
                          if k not in _SPAN_FIELDS},
            })
        else:
            points.append({
                "trace": ev["trace"], "span": ev.get("span"),
                "parent": ev.get("parent"),
                "kind": ev.get("kind", "?"),
                "ts": float(ev.get("ts", 0.0)) - offset_s,
                "source": source,
                "attrs": {k: v for k, v in ev.items()
                          if k not in ("ts", "seq", "kind", "trace",
                                       "span", "parent")},
            })
    return spans, points


def _jsonl_points(docs: Sequence[dict], source: str,
                  trace_id: Optional[str], kind_key: str) -> List[dict]:
    out = []
    for d in docs:
        if not d.get("trace"):
            continue
        if trace_id is not None and d["trace"] != trace_id:
            continue
        out.append({
            "trace": d["trace"], "span": d.get("span"),
            "parent": d.get("parent"),
            "kind": str(d.get(kind_key, source)),
            "ts": float(d.get("ts", 0.0)),
            "source": source,
            "attrs": {k: v for k, v in d.items()
                      if k not in ("ts", "trace", "span", "parent",
                                   "traceparent")},
        })
    return out


def collect(flight_paths: Sequence[str] = (),
            obs_dir: Optional[str] = None,
            reqlog_paths: Sequence[str] = (),
            trace_id: Optional[str] = None) -> Dict[str, List[dict]]:
    """Gather ``{"spans": [...], "points": [...]}`` across the planes,
    skew-corrected, optionally filtered to one trace id."""
    spans: List[dict] = []
    points: List[dict] = []
    for path in flight_paths:
        doc = load_flight_dump(path)
        if doc is None:
            continue
        off = float(doc.get("wall_offset_s") or 0.0)
        rank = doc.get("rank")
        s, p = spans_from_events(doc.get("events", []), offset_s=off,
                                 source=f"flight rank {rank}",
                                 trace_id=trace_id)
        spans += s
        points += p
    for path in reqlog_paths:
        points += _jsonl_points(read_jsonl(path), "reqlog", trace_id,
                                "outcome")
    if obs_dir:
        for path in _obs_files(obs_dir, "actions"):
            points += _jsonl_points(read_jsonl(path), "actions",
                                    trace_id, "outcome")
        for path in _obs_files(obs_dir, "obs"):
            docs = [d for d in read_jsonl(path) if "remesh" in d]
            points += _jsonl_points(docs, "remesh", trace_id, "trigger")
    return {"spans": spans, "points": points}


# -- the causal tree ----------------------------------------------------------
def build_tree(data: Dict[str, List[dict]]) -> List[dict]:
    """Join spans + points into trees by span/parent.  A point whose
    span id already has a span record attaches to it as an event;
    otherwise it becomes a (duration-less) node of its own.  Returns
    the roots (parent absent or unknown), children sorted by start."""
    nodes: Dict[str, dict] = {}
    for s in data["spans"]:
        sid = s.get("span")
        if not sid:
            continue
        node = nodes.setdefault(sid, {"events": [], "children": []})
        node.update(s)
    loose: List[dict] = []
    for p in data["points"]:
        sid = p.get("span")
        if sid and sid in nodes and "name" in nodes[sid]:
            nodes[sid]["events"].append(p)
            continue
        if sid:
            node = nodes.setdefault(sid, {"events": [], "children": []})
            if "name" not in node:
                node.update({
                    "trace": p["trace"], "span": sid,
                    "parent": p.get("parent"),
                    "plane": p.get("source", "?"),
                    "name": p["kind"], "start": p["ts"], "dur_s": None,
                    "source": p.get("source"),
                    "attrs": p.get("attrs", {}),
                })
            else:
                node["events"].append(p)
        else:
            loose.append(p)
    roots: List[dict] = []
    for sid, node in nodes.items():
        parent = node.get("parent")
        if parent and parent in nodes:
            nodes[parent]["children"].append(node)
        else:
            roots.append(node)

    def _sort(n: dict) -> None:
        n["children"].sort(key=lambda c: c.get("start") or 0.0)
        for c in n["children"]:
            _sort(c)

    roots.sort(key=lambda n: n.get("start") or 0.0)
    for r in roots:
        _sort(r)
    if loose:
        roots.append({"trace": loose[0].get("trace"), "span": None,
                      "parent": None, "plane": "?", "name": "(unbound "
                      "events)", "start": loose[0].get("ts"),
                      "dur_s": None, "events": loose, "children": []})
    return roots


def _fmt_dur(dur: Optional[float]) -> str:
    if dur is None:
        return "·"
    return f"{dur * 1e3:.1f}ms" if dur < 1.0 else f"{dur:.3f}s"


def _render_node(node: dict, lines: List[str], prefix: str,
                 is_last: bool, parent_dur: Optional[float],
                 is_slow: bool = False) -> None:
    branch = "" if prefix == "" and is_last and not lines else \
        ("└─ " if is_last else "├─ ")
    attrs = node.get("attrs") or {}
    extra = " ".join(f"{k}={v}" for k, v in sorted(attrs.items())
                     if v is not None and k not in ("source",))
    share = ""
    dur = node.get("dur_s")
    if dur is not None and parent_dur:
        share = f"  [{dur / parent_dur:.0%} of parent]"
    if is_slow:
        share += "  << slow hop"
    src = f"  ({node['source']})" if node.get("source") else ""
    lines.append(f"{prefix}{branch}{node.get('plane', '?')}:"
                 f"{node.get('name', '?')} {_fmt_dur(dur)}"
                 f"{share}{src}" + (f"  {extra}" if extra else ""))
    child_prefix = prefix + ("" if branch == "" else
                             ("   " if is_last else "│  "))
    events = sorted(node.get("events") or [],
                    key=lambda e: e.get("ts") or 0.0)
    for e in events:
        eattrs = " ".join(
            f"{k}={v}" for k, v in sorted((e.get("attrs") or {}).items())
            if v is not None)
        lines.append(f"{child_prefix}• {e['kind']}"
                     f" ({e.get('source', '?')})"
                     + (f"  {eattrs}" if eattrs else ""))
    children = node.get("children") or []
    # the latency attribution: flag the SLOWEST child when it
    # dominates — that hop is where this span's time went
    timed = [c.get("dur_s") or 0.0 for c in children]
    slow_i = timed.index(max(timed)) if timed and max(timed) > 0 \
        else None
    if slow_i is not None and dur and timed[slow_i] < 0.5 * dur:
        slow_i = None  # nothing dominates; no attribution claim
    for i, c in enumerate(children):
        _render_node(c, lines, child_prefix, i == len(children) - 1,
                     dur, is_slow=(i == slow_i))


def render_trace(trace_id: str, data: Dict[str, List[dict]]) -> str:
    """The printable causal tree for one trace id."""
    roots = build_tree(data)
    n_spans = len(data["spans"])
    n_points = len(data["points"])
    planes = sorted({s["plane"] for s in data["spans"]}
                    | {p["source"] for p in data["points"]
                       if p.get("source")})
    lines = [f"trace {trace_id}  ({n_spans} span(s), {n_points} "
             f"event(s), planes: {', '.join(planes) or '-'})"]
    for i, root in enumerate(roots):
        _render_node(root, lines, "", i == len(roots) - 1, None)
    return "\n".join(lines)


# -- the merged timeline ------------------------------------------------------
def _attrs_args(d: dict) -> dict:
    return {k: v for k, v in d.items() if v is not None}


def flight_to_chrome(doc: dict) -> List[dict]:
    """One flight dump → chrome events with ABSOLUTE coordinator-clock
    µs timestamps (``wall_offset_s`` applied): ``trace_span`` records
    become complete (X) spans, everything else instants."""
    off = float(doc.get("wall_offset_s") or 0.0)
    out: List[dict] = []
    for ev in doc.get("events", []):
        if not isinstance(ev, dict):
            continue
        args = _attrs_args({k: v for k, v in ev.items()
                            if k not in ("ts", "seq")})
        if ev.get("kind") == SPAN_KIND:
            start = float(ev.get("start", ev.get("ts", 0.0))) - off
            out.append({
                "ph": "X", "tid": str(ev.get("plane", "trace")),
                "name": f"{ev.get('plane', '?')}:{ev.get('name', '?')}",
                "ts": start * 1e6,
                "dur": max(float(ev.get("dur_s") or 0.0) * 1e6, 1.0),
                "args": args})
        else:
            out.append({
                "ph": "i", "s": "t", "tid": "events",
                "name": str(ev.get("kind", "?")),
                "ts": (float(ev.get("ts", 0.0)) - off) * 1e6,
                "args": args})
    return out


def jsonl_to_chrome(docs: Sequence[dict], kind_key: str) -> List[dict]:
    """Request-log / actions / re-mesh JSONL lines → chrome events.
    ``ok`` request-log lines (which carry ``latency_s``) and re-mesh
    points (``remesh_total_s``) become spans ENDING at their stamp;
    everything else instants."""
    out: List[dict] = []
    for d in docs:
        ts = float(d.get("ts", 0.0))
        args = _attrs_args({k: v for k, v in d.items()
                            if k not in ("ts", "traceparent")})
        dur = d.get("latency_s") if "latency_s" in d \
            else d.get("remesh_total_s")
        if isinstance(dur, (int, float)) and dur > 0:
            out.append({"ph": "X", "tid": "requests",
                        "name": str(d.get(kind_key, "?")),
                        "ts": (ts - float(dur)) * 1e6,
                        "dur": float(dur) * 1e6, "args": args})
        else:
            out.append({"ph": "i", "s": "t", "tid": "events",
                        "name": str(d.get(kind_key, "?")),
                        "ts": ts * 1e6, "args": args})
    return out


def build_timeline(flight_paths: Sequence[str] = (),
                   shard_paths: Sequence[str] = (),
                   reqlog_paths: Sequence[str] = (),
                   obs_dir: Optional[str] = None,
                   out_path: Optional[str] = None) -> Dict[str, Any]:
    """The merged black-box timeline: every plane on one clock.
    Returns (and optionally writes) the chrome trace document."""
    from horovod_tpu_torch.diagnostics.merge import merge_shards
    extra: List[tuple] = []
    for path in flight_paths:
        doc = load_flight_dump(path)
        if doc is None:
            continue
        rank = doc.get("rank")
        extra.append((f"flight rank {rank}", 100 + (rank or 0),
                      flight_to_chrome(doc)))
    for i, path in enumerate(reqlog_paths):
        docs = read_jsonl(path)
        if docs:
            extra.append((f"request log {os.path.basename(path)}",
                          200 + i, jsonl_to_chrome(docs, "outcome")))
    if obs_dir:
        for path in _obs_files(obs_dir, "actions"):
            docs = read_jsonl(path)
            if docs:
                extra.append((f"autopilot {os.path.basename(path)}",
                              300, jsonl_to_chrome(docs, "outcome")))
        for path in _obs_files(obs_dir, "obs"):
            docs = [d for d in read_jsonl(path) if "remesh" in d]
            if docs:
                extra.append((f"re-mesh {os.path.basename(path)}",
                              310, jsonl_to_chrome(docs, "trigger")))
    return merge_shards(shard_paths, out_path, extra_tracks=extra)
