"""Per-version SLO comparison: the measurement half of a rollout.

The comparator never touches the fleet — it reads the router's request
log (every ``ok`` line carries the weight version that answered, every
``retried`` line carries the version that failed first) and reduces a
window of it to per-version latency/error stats, then renders a
verdict:

* ``"rollback"`` — the candidate degraded p99 beyond the allowed ratio
  of the incumbent's, pushed its error rate over the cap, or (the
  quality probe) diverged from the incumbent on the golden request set
  beyond the allowed max.  Latency windows can't see silently-wrong
  MATH — weights that diverge numerically serve just as fast — which
  is why the golden probe exists.
* ``"promote"`` — both arms observed at least ``min_requests``, and
  the candidate held up.
* ``None`` — not enough evidence yet (either arm under
  ``min_requests``): keep serving, keep measuring.  An under-observed
  canary must never promote OR roll back on noise.

Verdicts are therefore auditable from the request log alone
(docs/SERVING.md "Canary rollout"): replaying the same window through
:func:`version_windows` + :func:`compare` reproduces the decision.

A copy of ``horovod_tpu/serving/rollout/comparator.py``.
"""

from __future__ import annotations

import json
import time
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple

# one quantile implementation serves the whole SLO plane (the
# LatencyWindow, this comparator, and ci/check_bench --serving): a
# verdict replayed through any of them sees the same p99
from horovod_tpu_torch.serving.ledger import dominant_stage, quantile as percentile

Endpoint = Tuple[str, int]


def version_windows(entries: Sequence[dict], versions: Sequence[int]
                    ) -> Dict[int, dict]:
    """Reduce request-log ``entries`` to per-version stats for each of
    ``versions``: ok count, latency p50/p99, the error count
    attributed to the version (``retried`` lines name the version that
    failed via ``after_version``; terminal ``failed`` lines count
    against the version of the last retry target when known), and —
    when the ``ok`` lines carry the request ledger's ``stages`` dict —
    the per-version stage shares plus the dominant stage, so a rollback
    verdict can say WHERE the canary spends its extra latency."""
    wanted = {int(v) for v in versions}
    lat: Dict[int, List[float]] = {v: [] for v in wanted}
    ok: Dict[int, int] = {v: 0 for v in wanted}
    errs: Dict[int, int] = {v: 0 for v in wanted}
    stage_s: Dict[int, Dict[str, float]] = {v: {} for v in wanted}
    for e in entries:
        out = e.get("outcome")
        if out == "ok":
            v = e.get("version")
            if v in wanted:
                ok[v] += 1
                if isinstance(e.get("latency_s"), (int, float)):
                    lat[v].append(float(e["latency_s"]))
                st = e.get("stages")
                if isinstance(st, dict):
                    acc = stage_s[v]
                    for k, dur in st.items():
                        if isinstance(dur, (int, float)):
                            acc[k] = acc.get(k, 0.0) + float(dur)
        elif out == "retried":
            av = e.get("after_version")
            if av in wanted:
                errs[av] += 1
    stats: Dict[int, dict] = {}
    for v in wanted:
        xs = sorted(lat[v])
        n = ok[v] + errs[v]
        stats[v] = {
            "version": v,
            "requests": n,
            "ok": ok[v],
            "errors": errs[v],
            "error_rate": round(errs[v] / n, 6) if n else 0.0,
            # percentile() takes a FRACTION in [0,1] (the SLO plane's
            # convention) — a percent here would clamp to max() and
            # hand the verdict to a single worst-case sample
            "p50_s": round(percentile(xs, 0.50), 6) if xs else None,
            "p99_s": round(percentile(xs, 0.99), 6) if xs else None,
        }
        total_stage = sum(stage_s[v].values())
        if total_stage > 0:
            stats[v]["stage_shares"] = {
                k: round(dur / total_stage, 4)
                for k, dur in sorted(stage_s[v].items())}
            stats[v]["dominant_stage"] = dominant_stage(stage_s[v])
    return stats


def compare(canary: dict, incumbent: dict, *, min_requests: int,
            max_p99_ratio: float, max_error_rate: float,
            golden_divergence: Optional[float] = None,
            golden_max: float = 0.5) -> Tuple[Optional[str], str]:
    """(verdict, reason) from two :func:`version_windows` rows plus an
    optional golden-probe divergence.  The golden probe outranks the
    latency windows — quality damage rolls back even when the canary
    is FAST — and insufficient traffic outranks everything."""
    if canary["requests"] < min_requests \
            or incumbent["requests"] < min_requests:
        return None, (
            f"insufficient traffic (canary {canary['requests']}, "
            f"incumbent {incumbent['requests']}, need {min_requests} "
            "each)")
    if golden_divergence is not None and golden_divergence > golden_max:
        return "rollback", (
            f"golden divergence {golden_divergence:.6g} > "
            f"{golden_max:.6g}")
    if canary["error_rate"] > max_error_rate \
            and canary["error_rate"] > incumbent["error_rate"]:
        return "rollback", (
            f"canary error rate {canary['error_rate']:.4f} > "
            f"{max_error_rate:.4f} (incumbent "
            f"{incumbent['error_rate']:.4f})")
    if canary["p99_s"] is not None and incumbent["p99_s"] is not None \
            and incumbent["p99_s"] > 0 \
            and canary["p99_s"] > max_p99_ratio * incumbent["p99_s"]:
        # the ledger's per-version breakdown names WHERE the canary
        # spends its extra latency — a rollback reason an operator can
        # act on, not just a ratio
        dom = canary.get("dominant_stage")
        where = f" (dominant stage: {dom})" if dom else ""
        return "rollback", (
            f"canary p99 {canary['p99_s']:.6f}s > {max_p99_ratio:g}x "
            f"incumbent p99 {incumbent['p99_s']:.6f}s{where}")
    return "promote", "canary held p99/error-rate vs incumbent"


def load_golden_set(path: str) -> List[dict]:
    """A golden set file is JSON: ``{"requests": [{"x": [...]}, ...]}``
    (or a bare list).  Raises on malformed content — a quality gate
    whose probe set silently failed to load is a gate that never
    fires."""
    with open(path) as f:
        doc = json.load(f)
    reqs = doc.get("requests") if isinstance(doc, dict) else doc
    if not isinstance(reqs, list) or not reqs:
        raise ValueError(f"golden set {path!r}: no requests")
    for i, r in enumerate(reqs):
        if not isinstance(r, dict) or "x" not in r:
            raise ValueError(f"golden set {path!r}: request #{i} has "
                             "no 'x'")
    return reqs


def golden_divergence(canary_ep: Endpoint, incumbent_ep: Endpoint,
                      requests: Sequence[dict],
                      timeout_s: float = 5.0) -> float:
    """Max absolute output divergence between the two versions over the
    fixed golden request set, probed DIRECTLY against one replica of
    each arm (bypassing the router: a probe must not perturb the
    per-version traffic windows it gates).  Probe failures raise — an
    unanswerable golden probe is evidence, not a skip."""
    worst = 0.0
    # probe ids must be FRESH per round: a reused id would hit the
    # replica's idempotency cache and replay an answer computed by an
    # OLDER weight version — masking the very divergence being probed
    nonce = time.monotonic_ns()
    for i, req in enumerate(requests):
        body = {"x": [float(v) for v in req["x"]]}
        ys = []
        for ep in (canary_ep, incumbent_ep):
            data = json.dumps(
                {"id": f"golden-{nonce}-{i}-{ep[1]}", **body}).encode()
            http_req = urllib.request.Request(
                f"http://{ep[0]}:{ep[1]}/infer", data=data,
                method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(http_req,
                                        timeout=timeout_s) as r:
                ys.append(json.loads(r.read())["y"])
        a, b = ys
        if len(a) != len(b):
            return float("inf")
        for va, vb in zip(a, b):
            worst = max(worst, abs(float(va) - float(vb)))
    return worst
