"""The comparison that decides ``correct``.

A training cell's program and its plain reference each report, for the
first steps of the run (the same weights, the same batches):

* ``losses``: each step's loss;
* ``grad``: each leaf's norm of the first step's gradient as the optimizer
  got it (worked out from the optimizer's state after one step);
* ``change``: each leaf's norm of its change over the checked steps
  (parameters, and running statistics where the model keeps them).

The numbers compared (each against its limit in ``limits/<cell>.json``):

* ``loss_gap``: the largest ``|loss − reference| / |reference|`` over the
  steps;
* ``grad_gap``: by the worst leaf, the gap between the two norms over the
  reference's norm of that leaf or of the median leaf, whichever is larger;
* ``change_gap``: the same of the change, over the leaves the reference's
  first gradient moves: a parameter whose reference gradient is under
  ``QUIET`` of the median leaf's moves under Adam by round-off alone and
  is left out (running statistics are always counted);
* ``grad_gap_matrices`` and ``change_gap_matrices``: the same over the
  leaves of two or more dimensions (the kernels of products and
  convolutions, the embeddings): steady from seed to seed where the
  one-dimensional leaves amplify rounding (the batch norms' scales and
  biases of a network at its initialization);
* ``change_gap_stats``: the same of the change over the running
  statistics alone (a batch norm's running means and variances, the
  leaves the reference changes without a gradient), where the model keeps
  them: a step that stops updating them moves no parameter the wrong way;
* ``grad_error``: the norm over every leaf of the program's first gradient
  minus the reference's, in the gradient's own units: the rounding a
  precision leaves, which a cancelled gradient (a batch whose
  next-sentence labels balance) does not make larger;
* ``window_nonfinite``: losses of the measured window that are not finite;
* ``replicas_differ`` (several ranks): ranks whose parameters, after the
  checked steps or at the end, are not bit-identical to rank 0's.

A missing or non-finite number fails.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

QUIET = 1e-3


def _gaps(prog: Dict[str, float], ref: Dict[str, float],
          names: List[str]) -> List[float]:
    """Each leaf's gap of norms over the reference's norm of that leaf or
    of the median leaf, whichever is larger."""
    if not names:
        return [math.inf]
    med = statistics.median(ref[n] for n in names)
    out = []
    for n in names:
        den = max(ref[n], med)
        gap = abs(prog.get(n, 0.0) - ref[n])
        out.append(gap / den if den > 0 else (0.0 if gap == 0 else math.inf))
    return out


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The gaps of a program's readings from the reference's."""
    loss_gap = max(abs(p - r) / abs(r) if r else math.inf
                   for p, r in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss_gap = math.inf
    grads = list(ref["grad"])
    gmed = statistics.median(ref["grad"].values())
    moved = [n for n in ref["change"]
             if n not in ref["grad"] or ref["grad"][n] >= QUIET * gmed]
    g = _gaps(prog["grad"], ref["grad"], grads)
    c = _gaps(prog["change"], ref["change"], moved)
    mats = set(ref["matrices"])
    out = {"loss_gap": loss_gap,
           "grad_gap": max(g),
           "grad_gap_matrices": max(x for n, x in zip(grads, g) if n in mats),
           "change_gap": max(c),
           "change_gap_matrices": max(
               x for n, x in zip(moved, c) if n in mats)}
    stats = [n for n in ref["change"] if n not in ref["grad"]]
    if stats:
        out["change_gap_stats"] = max(_gaps(prog["change"], ref["change"],
                                            stats))
    if "diff" in prog:
        out["grad_error"] = math.sqrt(
            sum(v * v for v in prog["diff"]["grad"].values()))
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, dict]]:
    """``(correct, checks)``: every limit met; ``checks`` holds each
    number beside its limit."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks
