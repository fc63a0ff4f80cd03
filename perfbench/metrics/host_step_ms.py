"""The host's cost to enqueue one step: the wall time of the step call
started on an idle card, without a synchronize after it (median of the
steps timed). Where a step launches more than the launch queue holds, the
card's back-pressure is part of it."""

import statistics


def read(rec):
    ms = rec["host_step_ms"]
    return statistics.median(ms) if ms else None
