"""Roofline MFU attribution: decompose ``1 − MFU`` over the goodput
ledger's categories. A copy of ``horovod_tpu/profiling/attribution.py``.

The identity.  With ``f_c`` the wall-share of ledger category ``c``
(``Σ_c f_c = 1`` — the ledger's closed-books invariant) and ``R`` the
compute-window roofline efficiency

    R = flops / (compute_seconds × peak_flops)
      = MFU / f_compute,

model-FLOPs utilization splits exactly:

    1 − MFU = Σ_{c ≠ compute} f_c  +  (1 − R) · f_compute.

The first term is time the device was not doing model math at all —
each addend is one ledger category (exposed_comm → overlap, compile →
kernel builds, input_wait → the data loop, ...).  The second term —
reported as ``kernel_inefficiency`` — is the compute window itself
running below the roofline: only a device trace
(:mod:`horovod_tpu_torch.profiling.manager`) can break it down further,
which is why the ``goodput_regression`` detector arms exactly that
capture.

Where MFU is unknowable (the CPU, a card missing from the peak table) the
wall shares still stand on their own; ``mfu`` and
``kernel_inefficiency`` come back ``None`` — absence of a roofline
must not read as a perfect one.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from horovod_tpu_torch.metrics.goodput import CATEGORIES


def attribute(goodput: Optional[Dict[str, Any]],
              mfu: Optional[float] = None,
              flops_per_step: Optional[float] = None,
              peak_flops: Optional[float] = None) -> Optional[Dict[str, Any]]:
    """Join a ledger account (``goodput.snapshot()`` or one closed
    window record — anything carrying ``wall_s`` + ``seconds``) with a
    measured MFU into the ``1 − MFU`` decomposition.

    ``mfu`` wins when given; otherwise it is derived from
    ``flops_per_step × steps / (wall × peak_flops)`` when all three are
    known.  Returns None when the ledger account itself is absent.
    """
    if not goodput:
        return None
    wall = float(goodput.get("wall_s") or 0.0)
    secs = goodput.get("seconds") or {}
    if wall <= 0.0 or not secs:
        return None
    shares = {c: float(secs.get(c, 0.0)) / wall for c in CATEGORIES}
    steps = goodput.get("steps")
    if steps is None:
        lw = goodput.get("last_window") or {}
        steps = lw.get("steps")
    if mfu is None and flops_per_step and peak_flops and steps:
        mfu = float(flops_per_step) * float(steps) / (wall * peak_flops)
    out: Dict[str, Any] = {
        "mfu": round(float(mfu), 4) if mfu is not None else None,
        "wall_s": round(wall, 4),
        "shares": {c: round(v, 4) for c, v in shares.items()},
        "one_minus_mfu": None,
        "kernel_inefficiency": None,
        "non_compute_share": round(1.0 - shares["compute"], 4),
        "dominating": _dominating(shares),
    }
    if mfu is not None:
        mfu = float(mfu)
        # (1 − R)·f_compute = f_compute − MFU exactly; a tiny negative
        # (measured MFU above the attributed compute share — clock skew
        # between the FLOPs window and the ledger window) clamps to 0
        # rather than crediting phantom efficiency
        out["one_minus_mfu"] = round(1.0 - mfu, 4)
        out["kernel_inefficiency"] = round(
            max(0.0, shares["compute"] - mfu), 4)
    return out


def _dominating(shares: Dict[str, float]) -> Optional[str]:
    loss = {c: v for c, v in shares.items() if c != "compute"}
    if not loss:
        return None
    return max(loss, key=loss.get)


def render_lines(att: Optional[Dict[str, Any]]) -> str:
    """One human-readable block (a run's summary)."""
    if not att:
        return "mfu attribution: (no ledger data)"
    lines = []
    mfu = att.get("mfu")
    head = f"mfu={mfu:.3f}" if mfu is not None else "mfu=n/a"
    lines.append(f"mfu attribution ({head}, wall {att['wall_s']:.1f}s):")
    for c in CATEGORIES:
        lines.append(f"  {c:<17} {att['shares'].get(c, 0.0):7.2%}")
    ki = att.get("kernel_inefficiency")
    if ki is not None:
        lines.append(f"  {'kernel_inefficiency':<17} {ki:7.2%}")
    return "\n".join(lines)
