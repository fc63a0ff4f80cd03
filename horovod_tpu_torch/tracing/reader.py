"""Readers of the tracing planes' on-disk records.

Only :func:`read_jsonl` is ported so far, a copy of
``horovod_tpu/tracing/reader.py:67`` (the serving router's request log
reads through it). The flight-dump, span and timeline readers arrive
with the second observability slice (ROADMAP queue 1 item 5).
"""

from __future__ import annotations

import json
from typing import List


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
