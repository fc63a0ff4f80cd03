"""Fleet observability CLI: ``python -m horovod_tpu_torch.metrics <cmd>``.

A copy of ``horovod_tpu/metrics/__main__.py``: the same subcommands,
flags and text.

* ``top`` — live, curses-free fleet dashboard: polls one endpoint
  (rank 0's ``/metrics/fleet`` by default, falling back to plain
  ``/metrics``) and renders the headline numbers plus the per-rank
  step-time breakdown as plain text, redrawn in place with ANSI
  escapes (``--once`` / ``--iterations`` for scripting).
* ``history`` — tabular dump of the persisted step time-series
  (``HVD_TPU_OBS_DIR`` JSONL, docs/OBSERVABILITY.md "Step time-series
  history"); plot-free by design — pipe into your tool of choice.
  ``--remesh`` renders the re-mesh phase table, ``--actions`` the
  autopilot decision audit trail ("my job re-meshed itself — why?"
  starts here, docs/TROUBLESHOOTING.md).

Both are stdlib-only, like everything else in the metrics plane.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request
from typing import Dict, Optional

from horovod_tpu_torch.metrics.timeseries import read_series


def _fetch(url: str, timeout: float = 5.0) -> str:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode()


def parse_prometheus(text: str) -> Dict[str, float]:
    """Minimal text-format v0.0.4 parser: {series_key: value}."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            key, val = line.rsplit(" ", 1)
            out[key] = float(val)
        except ValueError:
            continue
    return out


def _labeled(series: Dict[str, float], name: str) -> Dict[str, float]:
    """{label-suffix: value} for every series of ``name{...}``."""
    out = {}
    for key, v in series.items():
        if key.startswith(name + "{") and key.endswith("}"):
            out[key[len(name) + 1:-1]] = v
    return out


def _fmt_seconds(v: Optional[float]) -> str:
    if v is None:
        return "-"
    return f"{v * 1e3:.1f}ms" if v < 1.0 else f"{v:.2f}s"


def _fmt_bytes(v: Optional[float]) -> str:
    if v is None:
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(v) < 1024:
            return f"{v:.1f}{unit}" if unit != "B" else f"{int(v)}B"
        v /= 1024
    return f"{v:.1f}TiB"


def render_top(series: Dict[str, float], source: str) -> str:
    """One dashboard frame from a parsed scrape (pure: unit-testable)."""
    lines = [f"hvd-tpu fleet view  [{source}]  "
             f"{time.strftime('%H:%M:%S')}"]
    size = series.get("hvd_fleet_size")
    reporting = series.get("hvd_fleet_ranks_reporting")
    if size is not None:
        gap = "" if reporting == size else "  << RANKS MISSING"
        lines.append(f"ranks reporting : {int(reporting or 0)}/{int(size)}"
                     f" (tree depth {int(series.get('hvd_fleet_tree_depth', 0))},"
                     f" generation {int(series.get('hvd_fleet_generation', 0))})"
                     + gap)
    steps = series.get("hvd_steps_total")
    if steps is not None:
        lines.append(f"steps total     : {int(steps)}")
    tsum = series.get("hvd_step_time_seconds_sum")
    tcnt = series.get("hvd_step_time_seconds_count")
    if tcnt:
        lines.append(f"step time mean  : {_fmt_seconds(tsum / tcnt)} "
                     f"(over {int(tcnt)} samples)")
    mn, mx = series.get("hvd_fleet_step_time_min"), \
        series.get("hvd_fleet_step_time_max")
    if mn is not None and mx is not None:
        lines.append(
            f"step time window: min {_fmt_seconds(mn)}  "
            f"mean {_fmt_seconds(series.get('hvd_fleet_step_time_mean'))}  "
            f"max {_fmt_seconds(mx)}")
    straggler = series.get("hvd_fleet_straggler_rank")
    if straggler is not None:
        lines.append(f"straggler rank  : {int(straggler)}")
    # HBM view (docs/OBSERVABILITY.md "Compile & memory observability"):
    # in-use/peak merge max over ranks, the OOM margin merges MIN — the
    # tightest rank is the number that matters
    in_use = series.get("hvd_hbm_bytes_in_use")
    if in_use is not None:
        margin = series.get("hvd_hbm_oom_margin_bytes")
        lines.append(
            f"hbm             : {_fmt_bytes(in_use)} in use, "
            f"peak {_fmt_bytes(series.get('hvd_hbm_peak_bytes'))} / "
            f"limit {_fmt_bytes(series.get('hvd_hbm_limit_bytes'))}"
            + (f"  (OOM margin {_fmt_bytes(margin)})"
               if margin is not None else ""))
    # compile view: total backend compiles + tracing-cache misses +
    # compile seconds (histogram _sum summed across function labels)
    compiles = series.get("hvd_compile_total")
    if compiles is not None:
        misses = series.get("hvd_compile_cache_miss_total")
        secs = sum(v for k, v in series.items()
                   if k.startswith("hvd_compile_seconds_sum"))
        detail = [f"{_fmt_seconds(secs)} total"]
        if misses is not None:
            detail.insert(0, f"{int(misses)} cache misses")
        lines.append(f"compiles        : {int(compiles)} "
                     f"({', '.join(detail)})")
    remeshes = series.get("hvd_remesh_total")
    if remeshes:
        rsecs = sum(v for k, v in series.items()
                    if k.startswith("hvd_remesh_seconds_sum"))
        lines.append(f"re-meshes       : {int(remeshes)} "
                     f"({_fmt_seconds(rsecs)} total recovery)")
    # control-plane HA (docs/ELASTIC.md "Driver failover & takeover"):
    # worst-rank outage age, takeover count, journal footprint
    outage_age = series.get("hvd_driver_outage_seconds")
    takeovers = series.get("hvd_driver_takeovers_total")
    jbytes = series.get("hvd_driver_journal_bytes")
    if outage_age or takeovers or jbytes:
        line = (f"DRIVER          : outage "
                f"{_fmt_seconds(outage_age or 0.0)}  "
                f"takeovers {int(takeovers or 0)}")
        if jbytes is not None:
            line += (f"  journal {_fmt_bytes(jbytes)} "
                     f"({int(series.get('hvd_driver_journal_records', 0))}"
                     f" records)")
        if outage_age:
            line += "  << DRIVER UNREACHABLE"
        lines.append(line)
    # goodput ledger (docs/OBSERVABILITY.md "Goodput ledger"): the
    # fleet-summed per-category seconds as fractions of accounted wall
    # time, plus the worst rank's productive fraction
    goodput = _labeled(series, "hvd_goodput_seconds_total")
    if goodput:
        total = sum(goodput.values())
        cats = {k.split('=')[1].strip(chr(34)): v
                for k, v in goodput.items()}
        productive = cats.get("compute", 0.0) / total if total else 0.0
        loss = sorted(((c, v / total) for c, v in cats.items()
                       if c != "compute" and total and v > 0),
                      key=lambda cv: -cv[1])
        detail = ", ".join(f"{c} {f:.1%}" for c, f in loss[:4])
        line = (f"GOODPUT         : {productive:.1%} productive"
                + (f"  ({detail})" if detail else ""))
        worst_rank = series.get("hvd_fleet_goodput_worst_rank")
        worst = series.get("hvd_fleet_goodput_min")
        if worst_rank is not None and worst is not None:
            line += f"  worst rank {int(worst_rank)} @ {worst:.1%}"
        lines.append(line)
    # serving view (docs/SERVING.md): the windowed SLO signal plus the
    # robustness counters — sheds are EXPLICIT 429s, hedges/retries are
    # requests that survived a slow or dead replica
    qps = series.get("hvd_serving_qps")
    accepted = series.get("hvd_serving_accepted_total")
    if qps is not None or accepted is not None:
        shed = sum(v for k, v in series.items()
                   if k.startswith("hvd_serving_shed_total"))
        lines.append(
            f"SERVING         : {qps or 0.0:,.1f} qps  "
            f"queue {int(series.get('hvd_serving_queue_depth', 0))}  "
            f"p50 {_fmt_seconds(series.get('hvd_serving_p50_seconds'))}  "
            f"p99 {_fmt_seconds(series.get('hvd_serving_p99_seconds'))}  "
            f"shed {int(shed)}  "
            f"hedged {int(series.get('hvd_serving_hedged_total', 0))}  "
            f"retried {int(series.get('hvd_serving_retried_total', 0))}")
        replicas = series.get("hvd_serving_replicas_live")
        if replicas is not None:
            target = series.get("hvd_serving_replicas_target", replicas)
            gap = "" if replicas >= target else "  << FLEET BELOW TARGET"
            lines.append(
                f"replicas        : {int(replicas)}/{int(target)} ready"
                f" (weights v{int(series.get('hvd_serving_weight_version', 0))},"
                f" {int(series.get('hvd_serving_swaps_total', 0))} swaps,"
                f" {int(series.get('hvd_serving_replica_respawns_total', 0))}"
                f" respawns)" + gap)
    for key, value in sorted(series.items()):
        if key.endswith("_per_second") and "{" not in key:
            lines.append(f"{key[4:]:<16}: {value:,.1f}")
    anomalies = _labeled(series, "hvd_anomaly_total")
    if anomalies:
        kinds = ", ".join(f"{k.split('=')[1].strip(chr(34))}×{int(v)}"
                          for k, v in sorted(anomalies.items()))
        lines.append(f"ANOMALIES       : {kinds}")
    # autopilot decisions (docs/OBSERVABILITY.md "Autopilot"): the
    # per-policy/outcome counters plus the mode, one line — the full
    # audit trail is `history --actions`
    decisions = _labeled(series, "hvd_autopilot_decisions_total")
    mode_v = series.get("hvd_autopilot_mode")
    if decisions or mode_v is not None:
        mode_name = {0: "off", 1: "observe", 2: "act"}.get(
            int(mode_v) if mode_v is not None else 1, "?")
        cells = []
        for labels, v in sorted(decisions.items()):
            parts = dict(p.split("=", 1) for p in labels.split(","))
            cells.append(
                f"{parts.get('policy', '?').strip(chr(34))} "
                f"{parts.get('outcome', '?').strip(chr(34))}×{int(v)}")
        lines.append(f"AUTOPILOT [{mode_name}]: "
                     + (", ".join(cells) if cells else "no decisions"))
    per_rank = _labeled(series, "hvd_fleet_rank_step_time_seconds")
    if per_rank:
        lines.append("per-rank windowed step time:")
        entries = sorted(per_rank.items(),
                         key=lambda kv: int(kv[0].split('"')[1]))
        worst = max(v for _, v in entries)
        for label, v in entries:
            r = label.split('"')[1]
            bar = "#" * max(1, int(30 * v / worst)) if worst > 0 else ""
            lines.append(f"  rank {r:>4}  {_fmt_seconds(v):>9}  {bar}")
    return "\n".join(lines)


def cmd_top(args: argparse.Namespace) -> int:
    url = args.url.rstrip("/")
    endpoints = [url] if url.endswith(("/metrics", "/metrics/fleet")) \
        else [url + "/metrics/fleet", url + "/metrics"]
    iterations = 1 if args.once else args.iterations
    n = 0
    while iterations <= 0 or n < iterations:
        n += 1
        body = source = None
        for ep in endpoints:
            try:
                body, source = _fetch(ep), ep
                break
            except Exception as e:
                err = e
        if body is None:
            print(f"scrape failed: {err!r}", file=sys.stderr)
            return 1
        frame = render_top(parse_prometheus(body), source)
        if n > 1:
            # redraw in place: cursor home + clear-to-end (curses-free)
            sys.stdout.write("\x1b[H\x1b[J")
        elif iterations != 1:
            sys.stdout.write("\x1b[2J\x1b[H")
        print(frame, flush=True)
        if iterations <= 0 or n < iterations:
            time.sleep(args.interval)
    return 0


REMESH_PHASES = ("failure_detect", "drain", "rendezvous", "rebuild",
                 "restore", "first_step")


def render_remesh_table(points) -> str:
    """The re-mesh phase table (docs/OBSERVABILITY.md "Re-mesh
    timeline"): one row per recovery episode found in the persisted
    series, phase seconds in pipeline order."""
    rows = [p for p in points if isinstance(p.get("remesh"), dict)]
    if not rows:
        return ""
    head = (f"{'ts':<19} {'rank':>4} {'trigger':<16} "
            + " ".join(f"{c:>14}" for c in REMESH_PHASES)
            + f" {'total':>10}")
    lines = [head]
    for p in rows:
        phases = p["remesh"]
        ts = time.strftime("%Y-%m-%d %H:%M:%S",
                           time.localtime(p.get("ts", 0)))
        cells = " ".join(
            f"{_fmt_seconds(phases.get(c)):>14}" for c in REMESH_PHASES)
        # an episode that healed across a driver takeover is a
        # control-plane recovery, not a data-plane one — say so
        trig = str(p.get("trigger", "-"))
        if p.get("takeover"):
            trig += "+takeover"
        lines.append(
            f"{ts:<19} {p.get('rank', '-'):>4} "
            f"{trig:<16} {cells} "
            f"{_fmt_seconds(p.get('remesh_total_s')):>10}")
    spanned = sum(1 for p in rows if p.get("takeover"))
    lines.append(f"-- {len(rows)} re-mesh episode(s)"
                 + (f", {spanned} spanning a driver takeover"
                    if spanned else ""))
    return "\n".join(lines)


def render_actions_table(decisions) -> str:
    """The autopilot decision audit table (docs/OBSERVABILITY.md
    "Autopilot"): one row per recorded decision — fired, dry-run, or
    suppressed — with the gate input that mattered."""
    head = (f"{'ts':<19} {'rank':>4} {'policy':<20} {'action':<18} "
            f"{'finding':<22} {'outcome':<10} {'reason/gate'}")
    lines = [head]
    for d in decisions:
        ts = time.strftime("%Y-%m-%d %H:%M:%S",
                           time.localtime(d.get("ts", 0)))
        gate = d.get("gate") or {}
        detail = d.get("reason", "")
        extras = []
        if d.get("target_rank") is not None:
            extras.append(f"target_rank={d['target_rank']}")
        if d.get("key") is not None:
            extras.append(f"key={d['key']}")
        for k in ("remesh_p50_s", "projected_loss_s", "margin_frac",
                  "cooldown_remaining_s", "actions_in_window"):
            if gate.get(k) is not None:
                extras.append(f"{k}={gate[k]}")
        if d.get("trace"):
            # the causal join key: paste it into
            # `python -m horovod_tpu_torch.diagnostics trace <id>`
            extras.append(f"trace={d['trace'][:12]}")
        if extras:
            detail = (detail + " " if detail else "") + " ".join(extras)
        lines.append(
            f"{ts:<19} {str(d.get('rank', '-')):>4} "
            f"{str(d.get('policy', '-')):<20} "
            f"{str(d.get('action', '-')):<18} "
            f"{str(d.get('finding', '-')):<22} "
            f"{str(d.get('outcome', '-')):<10} {detail}")
    lines.append(f"-- {len(decisions)} decision(s)")
    return "\n".join(lines)


def render_serving_table(points) -> str:
    """The per-window serving latency series (docs/SERVING.md): one row
    per closed :class:`~horovod_tpu_torch.serving.metrics.LatencyWindow` —
    the trajectory behind "my p99 spiked" (docs/TROUBLESHOOTING.md).
    Windows observed with the request ledger also say WHERE the window
    went: the dominant stage with its share, and the unattributed
    residual fraction (the books-close check, live)."""
    head = (f"{'ts':<19} {'rank':>4} {'window':>8} {'requests':>9} "
            f"{'qps':>9} {'p50':>10} {'p99':>10} {'shed':>6} "
            f"{'dominant':<16} {'unattr':>7}")
    lines = [head]
    for p in points:
        w = p["serving"]
        ts = time.strftime("%Y-%m-%d %H:%M:%S",
                           time.localtime(p.get("ts", 0)))
        dom = w.get("dominant_stage") or "-"
        share = (w.get("stage_shares") or {}).get(dom)
        if share is not None:
            dom = f"{dom} {share * 100:.0f}%"
        unattr = w.get("unattributed_frac")
        unattr_s = f"{unattr * 100:.1f}%" if unattr is not None else "-"
        lines.append(
            f"{ts:<19} {str(p.get('rank', '-')):>4} "
            f"{w.get('window_s', 0):>7.1f}s {w.get('requests', 0):>9} "
            f"{w.get('qps', 0):>9.1f} "
            f"{_fmt_seconds(w.get('p50_s')):>10} "
            f"{_fmt_seconds(w.get('p99_s')):>10} "
            f"{w.get('shed', 0):>6} "
            f"{dom:<16} {unattr_s:>7}")
    lines.append(f"-- {len(points)} serving window(s)")
    return "\n".join(lines)


GOODPUT_CATEGORIES = ("compute", "exposed_comm", "compile",
                      "remesh_recovery", "checkpoint_stall", "input_wait",
                      "guard_skipped", "idle_other")


def render_goodput_table(points) -> str:
    """The per-window goodput category table (docs/OBSERVABILITY.md
    "Goodput ledger"): one row per closed ledger window, category
    seconds in fixed order plus the window's productive fraction and
    whether its books closed."""
    head = (f"{'ts':<19} {'rank':>4} {'steps':>6} {'wall':>9} "
            + " ".join(f"{c[:10]:>10}" for c in GOODPUT_CATEGORIES)
            + f" {'frac':>6} {'books':>6}")
    lines = [head]
    for p in points:
        w = p["goodput"]
        ts = time.strftime("%Y-%m-%d %H:%M:%S",
                           time.localtime(p.get("ts", 0)))
        cells = " ".join(f"{_fmt_seconds(w.get(c, 0.0)):>10}"
                         for c in GOODPUT_CATEGORIES)
        frac = p.get("goodput_fraction")
        lines.append(
            f"{ts:<19} {str(p.get('rank', '-')):>4} "
            f"{p.get('goodput_steps', '-'):>6} "
            f"{_fmt_seconds(p.get('goodput_wall_s')):>9} {cells} "
            f"{frac if frac is None else format(frac, '.1%'):>6} "
            f"{'ok' if p.get('goodput_closed', True) else 'OPEN!':>6}")
    lines.append(f"-- {len(points)} goodput window(s)")
    return "\n".join(lines)


def cmd_history(args: argparse.Namespace) -> int:
    if getattr(args, "goodput", False):
        points = [p for p in read_series(args.dir, rank=args.rank)
                  if isinstance(p.get("goodput"), dict)]
        if args.last:
            points = points[-args.last:]
        if not points:
            print(f"no goodput windows recorded under {args.dir}",
                  file=sys.stderr)
            return 1
        if args.json:
            for p in points:
                print(json.dumps(p))
            return 0
        print(render_goodput_table(points))
        return 0
    if getattr(args, "serving", False):
        points = [p for p in read_series(args.dir, rank=args.rank)
                  if isinstance(p.get("serving"), dict)]
        if args.last:
            points = points[-args.last:]
        if not points:
            print(f"no serving windows recorded under {args.dir}",
                  file=sys.stderr)
            return 1
        if args.json:
            for p in points:
                print(json.dumps(p))
            return 0
        print(render_serving_table(points))
        return 0
    if getattr(args, "actions", False):
        # the autopilot action log rides its own JSONL files
        # (actions_rank<r>.jsonl) in the same store
        decisions = read_series(args.dir, rank=args.rank,
                                basename="actions")
        if args.last:
            decisions = decisions[-args.last:]
        if not decisions:
            print(f"no autopilot decisions recorded under {args.dir}",
                  file=sys.stderr)
            return 1
        if args.json:
            for d in decisions:
                print(json.dumps(d))
            return 0
        print(render_actions_table(decisions))
        return 0
    points = read_series(args.dir, rank=args.rank)
    if getattr(args, "remesh", False):
        episodes = [p for p in points if isinstance(p.get("remesh"), dict)]
        if args.last:
            episodes = episodes[-args.last:]
        if not episodes:
            print(f"no re-mesh episodes recorded under {args.dir}",
                  file=sys.stderr)
            return 1
        if args.json:
            for p in episodes:
                print(json.dumps(p))
            return 0
        print(render_remesh_table(episodes))
        return 0
    # step points only: free-form episode points have their own view
    points = [p for p in points if "remesh" not in p
              and "serving" not in p and "goodput" not in p]
    if args.last:
        points = points[-args.last:]
    if not points:
        print(f"no series under {args.dir}", file=sys.stderr)
        return 1
    if args.json:
        for p in points:
            print(json.dumps(p))
        return 0
    cols = ["rank", "step", "step_time_s", "units_per_s"]
    print(f"{'ts':<19} " + " ".join(f"{c:>12}" for c in cols))
    for p in points:
        ts = time.strftime("%Y-%m-%d %H:%M:%S",
                           time.localtime(p.get("ts", 0)))
        row = " ".join(
            f"{p[c]:>12}" if c in p else f"{'-':>12}" for c in cols)
        print(f"{ts:<19} {row}")
    print(f"-- {len(points)} point(s)")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m horovod_tpu_torch.metrics",
                                description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("top", help="live fleet dashboard")
    t.add_argument("--url", default="http://127.0.0.1:9090",
                   help="exporter base URL (rank 0); /metrics/fleet is "
                        "tried first, /metrics as fallback")
    t.add_argument("--interval", type=float, default=2.0)
    t.add_argument("--iterations", type=int, default=0,
                   help="frames to render (0 = until interrupted)")
    t.add_argument("--once", action="store_true",
                   help="render one frame and exit")
    t.set_defaults(fn=cmd_top)
    h = sub.add_parser("history", help="dump the persisted time-series")
    h.add_argument("--dir", required=True, help="HVD_TPU_OBS_DIR")
    h.add_argument("--rank", type=int, default=None,
                   help="one rank's series (default: all, time-sorted)")
    h.add_argument("--last", type=int, default=0,
                   help="only the last N points")
    h.add_argument("--json", action="store_true",
                   help="raw JSONL instead of the table")
    h.add_argument("--remesh", action="store_true",
                   help="render the re-mesh phase table instead of the "
                        "step series (one row per recovery episode)")
    h.add_argument("--actions", action="store_true",
                   help="render the autopilot decision audit trail "
                        "(actions_rank<r>.jsonl) instead of the step "
                        "series — one row per fired/dry-run/suppressed "
                        "decision")
    h.add_argument("--serving", action="store_true",
                   help="render the per-window serving latency series "
                        "(qps, p50/p99, shed) instead of the step "
                        "series — one row per closed latency window")
    h.add_argument("--goodput", action="store_true",
                   help="render the per-window goodput category table "
                        "(wall seconds per category, productive "
                        "fraction, books-closed flag) instead of the "
                        "step series — one row per closed ledger window")
    h.set_defaults(fn=cmd_history)
    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except KeyboardInterrupt:
        return 130


if __name__ == "__main__":
    sys.exit(main())
