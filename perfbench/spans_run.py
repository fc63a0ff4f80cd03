"""A traced run of one cell with the program's own spans read too:

    python3 perfbench/spans_run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace 1

``run.py``'s run, every rank's included, with ``spans.capture`` in place
of ``trace.capture`` (the same two traced spans, after host steps timed
without and with the program's span recorder). Its last line is
``run.py``'s result with one more key, ``program``: ``spans.report``'s
readings of every rank's record (``metrics``: ``spans.METRICS``), the
cross-rank collective waits and clock check, the recorder's cost on the
host and where the host waited on the card.
"""

import sys
from pathlib import Path

HERE = Path(__file__).resolve()
sys.path.insert(0, str(HERE.parent.parent))

from perfbench import harness, run, spans, trace  # noqa: E402

_summarize = harness.summarize


def _summarize_with_spans(cell, records, t_start, traced, kind):
    out = _summarize(cell, records, t_start, traced, kind)
    if traced:
        checks = out.pop("checks")
        out["program"] = spans.report(records)
        out["checks"] = checks
    return out


trace.capture = spans.capture
harness.summarize = _summarize_with_spans
run.__file__ = str(HERE)     # the launcher starts each rank through here

if __name__ == "__main__":
    sys.exit(run.main())
