"""Cross-rank timeline merger: N per-rank shards → one Perfetto trace.

A copy of ``horovod_tpu/diagnostics/merge.py``. Each shard is a
chrome-tracing JSON array written by
:class:`horovod_tpu_torch.common.timeline.Timeline` (host shards, any
rank; the JAX package's C++ engine also writes ``core`` shards, which the
merger reads alike).  A shard's
first event is a ``SHARD_META`` instant carrying the rank, the source
(``host``/``core``), a wall-clock anchor (``epoch_us`` = wall time at
the meta event, whose own ``ts`` is the matching shard-relative
timestamp) and the estimated wall offset to the coordinator
(:mod:`horovod_tpu_torch.diagnostics.clock`).

The merger maps every event onto the coordinator's wall clock::

    wall_us(ev) = (epoch_us - wall_offset_us) + (ev.ts - meta.ts)

then rebases to the earliest event and assigns one process track per
shard (``pid`` = rank where known), named ``rank N`` / ``rank N (core)``
via ``process_name`` metadata so Perfetto shows one track per rank with
the same collective's spans (matched by ``args.span``) correlated
across tracks.

Shards from crashed ranks are commonly truncated mid-array; the loader
repairs unterminated JSON instead of dropping the evidence.

CLI: ``python -m horovod_tpu_torch.diagnostics merge -o merged.json
SHARD...`` (or ``--dir DIR`` to glob ``*timeline*rank*.json`` shards).
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Dict, List, Optional, Sequence

SHARD_META = "SHARD_META"


def load_shard(path: str) -> List[dict]:
    """Parse one shard, repairing a truncated (crash-cut) JSON array."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except ValueError:
        repaired = text.rstrip().rstrip(",")
        if not repaired.startswith("["):
            raise
        try:
            doc = json.loads(repaired + "]")
        except ValueError:
            # cut mid-object: drop the partial trailing line
            lines = repaired.splitlines()
            doc = json.loads("\n".join(lines[:-1]).rstrip().rstrip(",")
                             + "]")
    if isinstance(doc, dict):  # tolerate {"traceEvents": [...]}
        doc = doc.get("traceEvents", [])
    # writers close the array with a bare {} sentinel — drop fillers
    return [ev for ev in doc if isinstance(ev, dict) and ev.get("ph")]


def _shard_meta(events: List[dict], path: str) -> Dict[str, Any]:
    for ev in events:
        if ev.get("name") == SHARD_META:
            args = ev.get("args", {}) or {}
            return {
                "rank": args.get("rank"),
                "source": args.get("source", "host"),
                "epoch_us": args.get("epoch_us"),
                "wall_offset_us": args.get("wall_offset_us", 0.0),
                "anchor_ts": ev.get("ts", 0.0),
            }
    m = re.search(r"rank[._-]?(\d+)", os.path.basename(path))
    return {"rank": int(m.group(1)) if m else None, "source": "host",
            "epoch_us": None, "wall_offset_us": 0.0, "anchor_ts": 0.0}


def merge_shards(paths: Sequence[str],
                 out_path: Optional[str] = None,
                 extra_tracks: Optional[Sequence[tuple]] = None
                 ) -> Dict[str, Any]:
    """Fold shards into one chrome trace document (also written to
    ``out_path`` when given).  Returns the document.

    ``extra_tracks`` adds non-shard planes (the unified timeline's
    flight dumps, request logs, action/remesh history — see
    :mod:`horovod_tpu_torch.tracing.reader`): a sequence of ``(label,
    sort_index, events)`` where each event already carries an ABSOLUTE
    wall-clock ``ts`` in µs on the coordinator's clock (the caller
    applied its plane's offset); they are rebased together with the
    shard events so every plane shares one t=0."""
    shards = []
    for i, path in enumerate(sorted(paths)):
        try:
            events = load_shard(path)
        except (OSError, ValueError) as e:
            # one unreadable shard (a rank that died with an empty or
            # garbled file) must not cost the other N-1 ranks' evidence
            from horovod_tpu_torch.common.logging import get_logger
            get_logger().warning("merge: skipping unreadable shard %s "
                                 "(%r)", path, e)
            continue
        meta = _shard_meta(events, path)
        if extra_tracks and meta["epoch_us"] is None:
            # the extras carry absolute wall-clock µs; an anchor-less
            # shard only has shard-relative time, and mixing the two
            # scales would rebase the whole timeline ~epoch apart —
            # drop it loudly rather than render an unusable trace
            # (plain shard-only merges keep the old relative behavior)
            from horovod_tpu_torch.common.logging import get_logger
            get_logger().warning(
                "merge: shard %s has no SHARD_META wall anchor; "
                "skipping it in the multi-plane timeline", path)
            continue
        rank = meta["rank"] if meta["rank"] is not None else i
        shards.append((path, events, meta, rank))

    # one pid per shard; collisions (rank 0 host shard + rank 0 core
    # trace) get distinct pids so their tracks never interleave B/E
    # stacks, but stay adjacent via process_sort_index
    used_pids = set()
    merged: List[dict] = []
    placed = []  # (events_with_pid, meta)
    for path, events, meta, rank in shards:
        pid = rank
        while pid in used_pids:
            pid += 1000
        used_pids.add(pid)
        label = f"rank {rank}" + (
            " (core)" if meta["source"] == "core" else "")
        merged.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": "meta", "args": {"name": label}})
        merged.append({"ph": "M", "name": "process_sort_index",
                       "pid": pid, "tid": "meta",
                       "args": {"sort_index": rank}})
        placed.append((pid, events, meta))

    # the extra planes get their own tracks past the shard pid space
    next_pid = 10_000
    for label, sort_index, events in (extra_tracks or ()):
        pid = next_pid
        next_pid += 1
        merged.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": "meta", "args": {"name": label}})
        merged.append({"ph": "M", "name": "process_sort_index",
                       "pid": pid, "tid": "meta",
                       "args": {"sort_index": sort_index}})
        placed.append((pid, list(events),
                       {"epoch_us": None, "wall_offset_us": 0.0,
                        "anchor_ts": 0.0}))

    # map onto the coordinator's wall clock where anchors exist
    timed = []
    for pid, events, meta in placed:
        for ev in events:
            if ev.get("name") == SHARD_META or ev.get("ph") == "M":
                continue
            ts = float(ev.get("ts", 0.0))
            if meta["epoch_us"] is not None:
                ts = (float(meta["epoch_us"])
                      - float(meta["wall_offset_us"] or 0.0)
                      + (ts - float(meta["anchor_ts"] or 0.0)))
            out = dict(ev)
            out["pid"] = pid
            out["ts"] = ts
            timed.append(out)

    if timed:  # rebase so the trace starts at t=0 (viewers like it)
        t0 = min(ev["ts"] for ev in timed)
        for ev in timed:
            ev["ts"] = ev["ts"] - t0
    timed.sort(key=lambda ev: ev["ts"])
    merged.extend(timed)

    doc = {"traceEvents": merged, "displayTimeUnit": "ms"}
    if out_path:
        # pid-unique tmp: two ranks' watchdogs may merge into the same
        # shared-FS target concurrently; each rename stays atomic
        tmp = f"{out_path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        try:
            os.replace(tmp, out_path)
        except OSError:
            pass
    return doc


def find_shards(directory: str) -> List[str]:
    """Shard files under ``directory`` (the per-rank naming both the
    host timeline and bench use: ``*rank<r>*.json``), excluding
    previously merged outputs."""
    out = []
    for path in glob.glob(os.path.join(directory, "*.json")):
        base = os.path.basename(path)
        if "merged" in base:
            continue
        if re.search(r"rank[._-]?\d+", base):
            out.append(path)
    return sorted(out)


def merge_directory(directory: str,
                    out_path: Optional[str] = None) -> Optional[str]:
    """Merge every shard found in ``directory`` into
    ``out_path`` (default ``<directory>/merged_trace.json``).  Returns
    the output path, or None when no shards exist."""
    paths = find_shards(directory)
    if not paths:
        return None
    out_path = out_path or os.path.join(directory, "merged_trace.json")
    merge_shards(paths, out_path)
    return out_path
