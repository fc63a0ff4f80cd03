"""CLI for the diagnostics subsystem.

A copy of ``horovod_tpu/diagnostics/__main__.py``: the same subcommands,
flags and output.

``python -m horovod_tpu_torch.diagnostics merge [-o OUT] SHARD... | --dir DIR``
    Fold per-rank timeline shards into one Perfetto/chrome trace.

``python -m horovod_tpu_torch.diagnostics flight DUMP.json``
    Summarize a flight-recorder dump (event counts per kind, tail).

``python -m horovod_tpu_torch.diagnostics timeline --dir DIR [--obs-dir D]
[--reqlog PATH]... [-o OUT]``
    The merged black-box timeline (docs/OBSERVABILITY.md "Causal
    tracing"): flight dumps + timeline shards found under ``--dir``,
    plus the serving request log(s), the autopilot actions JSONL and
    the re-mesh history from ``--obs-dir``, folded into ONE
    skew-corrected Perfetto trace.

``python -m horovod_tpu_torch.diagnostics trace ID --dir DIR [--obs-dir D]
[--reqlog PATH]...``
    Print one trace id's causal tree with per-hop latency attribution
    (a trace id prefix is accepted when unambiguous).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _cmd_merge(args: argparse.Namespace) -> int:
    from horovod_tpu_torch.diagnostics.merge import (find_shards, merge_shards)
    paths = list(args.shards)
    if args.dir:
        paths.extend(find_shards(args.dir))
    if not paths:
        print("no shards given (pass shard files or --dir)",
              file=sys.stderr)
        return 2
    out = args.output
    if not out:
        import os
        base = args.dir or os.path.dirname(paths[0]) or "."
        out = os.path.join(base, "merged_trace.json")
    doc = merge_shards(paths, out)
    pids = {ev.get("pid") for ev in doc["traceEvents"]
            if ev.get("ph") != "M"}
    print(f"merged {len(paths)} shard(s), "
          f"{len(doc['traceEvents'])} events, {len(pids)} track(s) "
          f"-> {out}")
    return 0


def _cmd_flight(args: argparse.Namespace) -> int:
    with open(args.dump) as f:
        doc = json.load(f)
    events = doc.get("events", [])
    kinds: dict = {}
    for ev in events:
        kinds[ev.get("kind", "?")] = kinds.get(ev.get("kind", "?"), 0) + 1
    print(f"rank {doc.get('rank')}: {len(events)} events "
          f"({doc.get('dropped', 0)} dropped, capacity "
          f"{doc.get('capacity')})")
    for kind, n in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"  {kind}: {n}")
    for ev in events[-args.tail:]:
        print(" ", json.dumps(ev, default=str))
    return 0


def _plane_paths(args):
    """(flight dumps, shards) under ``--dir``: flight dumps by their
    ``*flight*rank*.json`` naming, everything else rank-named is a
    timeline shard."""
    from horovod_tpu_torch.diagnostics.merge import find_shards
    from horovod_tpu_torch.tracing.reader import find_flight_dumps
    flights, shards = [], []
    for d in args.dir or []:
        flights.extend(find_flight_dumps(d))
        shards.extend(p for p in find_shards(d)
                      if "flight" not in os.path.basename(p).lower())
    flights.extend(args.flight or [])
    return flights, shards


def _cmd_timeline(args: argparse.Namespace) -> int:
    from horovod_tpu_torch.tracing.reader import build_timeline
    flights, shards = _plane_paths(args)
    if not (flights or shards or args.reqlog or args.obs_dir):
        print("no planes given (pass --dir/--flight/--reqlog/--obs-dir)",
              file=sys.stderr)
        return 2
    out = args.output
    if not out:
        base = (args.dir[0] if args.dir else
                (args.obs_dir or "."))
        out = os.path.join(base, "merged_timeline.json")
    doc = build_timeline(flight_paths=flights, shard_paths=shards,
                         reqlog_paths=args.reqlog or [],
                         obs_dir=args.obs_dir, out_path=out)
    tracks = {ev.get("pid") for ev in doc["traceEvents"]
              if ev.get("ph") != "M"}
    print(f"merged timeline: {len(flights)} flight dump(s), "
          f"{len(shards)} shard(s), {len(args.reqlog or [])} request "
          f"log(s), obs={'yes' if args.obs_dir else 'no'} -> "
          f"{len(doc['traceEvents'])} events on {len(tracks)} track(s) "
          f"-> {out}")
    return 0


def _cmd_trace(args: argparse.Namespace) -> int:
    from horovod_tpu_torch.tracing.reader import collect, render_trace
    flights, _shards = _plane_paths(args)
    data = collect(flight_paths=flights, obs_dir=args.obs_dir,
                   reqlog_paths=args.reqlog or [])
    ids = sorted({r["trace"] for r in data["spans"] + data["points"]})
    matches = [t for t in ids if t.startswith(args.trace_id)]
    if not matches:
        print(f"trace {args.trace_id!r} not found "
              f"({len(ids)} trace id(s) in the given planes)",
              file=sys.stderr)
        return 1
    if len(matches) > 1:
        print(f"trace prefix {args.trace_id!r} is ambiguous: "
              f"{', '.join(m[:12] for m in matches)}", file=sys.stderr)
        return 2
    trace_id = matches[0]
    filtered = {
        "spans": [s for s in data["spans"] if s["trace"] == trace_id],
        "points": [p for p in data["points"] if p["trace"] == trace_id],
    }
    print(render_trace(trace_id, filtered))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.diagnostics")
    sub = ap.add_subparsers(dest="cmd", required=True)

    mp = sub.add_parser("merge", help="merge per-rank timeline shards")
    mp.add_argument("shards", nargs="*", help="shard files")
    mp.add_argument("--dir", help="directory to glob shards from")
    mp.add_argument("-o", "--output", help="merged trace path")
    mp.set_defaults(fn=_cmd_merge)

    fp = sub.add_parser("flight", help="summarize a flight dump")
    fp.add_argument("dump")
    fp.add_argument("--tail", type=int, default=10,
                    help="print the last N events")
    fp.set_defaults(fn=_cmd_flight)

    def plane_args(p):
        p.add_argument("--dir", action="append",
                       help="directory holding flight dumps and/or "
                            "timeline shards (repeatable)")
        p.add_argument("--flight", action="append",
                       help="explicit flight dump path (repeatable)")
        p.add_argument("--reqlog", action="append",
                       help="serving request log JSONL (repeatable; "
                            "the rotated .1 generation is read too)")
        p.add_argument("--obs-dir",
                       help="HVD_TPU_OBS_DIR (actions JSONL + re-mesh "
                            "history)")

    tp = sub.add_parser("timeline",
                        help="merge every evidence plane into one "
                             "skew-corrected Perfetto trace")
    plane_args(tp)
    tp.add_argument("-o", "--output", help="merged trace path")
    tp.set_defaults(fn=_cmd_timeline)

    cp = sub.add_parser("trace",
                        help="print one trace id's causal tree with "
                             "per-hop latency attribution")
    cp.add_argument("trace_id", help="trace id (prefix ok)")
    plane_args(cp)
    cp.set_defaults(fn=_cmd_trace)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
