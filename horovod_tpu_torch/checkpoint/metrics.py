"""Checkpoint observability on the process-wide metrics registry.

A copy of ``horovod_tpu/checkpoint/metrics.py``: the same metric names on
the port's default registry, so ``hvd.metrics_snapshot()`` picks them up
with no extra wiring:

* ``hvd_checkpoint_save_bytes_total`` — payload bytes THIS rank
  serialized (its shards only, not the global state),
* ``hvd_checkpoint_restore_bytes_total`` — bytes read reassembling
  global arrays at restore,
* ``hvd_checkpoint_save_seconds`` / ``hvd_checkpoint_restore_seconds``
  — histograms; save time is the background write (the wait for the
  device→host copies, serialize + fsync + rank-0 commit wait), NOT the
  inline part of the snapshot,
* ``hvd_checkpoint_inflight`` — async saves queued or being written,
* ``hvd_checkpoint_last_step`` — last step this rank committed or
  restored (gauge, merged as ``max``),
* ``hvd_checkpoint_failures_total`` — saves/commits that errored,
* ``hvd_checkpoint_restore_fallback_total`` — restores that skipped a
  corrupt newest checkpoint for the next-older committed step
  (``ShardedCheckpointer.restore_latest``).

Instruments register on first use so workers that never checkpoint
export nothing. They are looked up on each use (get-or-create), not
cached: a registry cleared between runs gets them anew.
"""

from __future__ import annotations

from typing import Tuple

from horovod_tpu_torch.metrics.registry import default_registry


def _instruments() -> Tuple:
    reg = default_registry()
    return (
        reg.counter("hvd_checkpoint_save_bytes_total",
                    help="checkpoint shard bytes written by this rank"),
        reg.counter("hvd_checkpoint_restore_bytes_total",
                    help="checkpoint bytes read at restore"),
        reg.histogram("hvd_checkpoint_save_seconds",
                      help="background shard write + commit wall time"),
        reg.histogram("hvd_checkpoint_restore_seconds",
                      help="restore wall time (read + reassemble)"),
        reg.gauge("hvd_checkpoint_inflight",
                  help="async checkpoint saves not yet on disk",
                  agg="max"),
        reg.gauge("hvd_checkpoint_last_step",
                  help="last checkpoint step committed or restored",
                  agg="max"),
        reg.counter("hvd_checkpoint_failures_total",
                    help="checkpoint saves that failed to commit"),
        reg.counter("hvd_checkpoint_restore_fallback_total",
                    help="restores that skipped a corrupt newest "
                         "checkpoint for an older committed step"),
    )


def record_save(nbytes: int, seconds: float, step: int) -> None:
    save_b, _, save_s, _, _, last = _instruments()[:6]
    save_b.inc(nbytes)
    save_s.observe(seconds)
    last.set(step)


def record_restore(nbytes: int, seconds: float, step: int) -> None:
    _, rest_b, _, rest_s, _, last = _instruments()[:6]
    rest_b.inc(nbytes)
    rest_s.observe(seconds)
    last.set(step)


def record_failure() -> None:
    _instruments()[6].inc()


def record_restore_fallback() -> None:
    _instruments()[7].inc()


def set_inflight(n: int) -> None:
    _instruments()[4].set(n)
