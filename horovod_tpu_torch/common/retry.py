"""Unified transient-error retry: jittered exponential backoff under a
total-deadline budget, with per-call-site metrics.

Before this module every network-ish call site hand-rolled its own shield
(``runner/http_kv.py`` had a fixed 4-attempt loop with no jitter and no
cap on total wall time; ``diagnostics/autopsy.py`` peer fetches were
single-attempt; ``runner/tpu_discovery.py`` probed once), so behavior
under the exact faults the chaos harness injects (docs/CHAOS.md) differed
per call site.  One policy engine gives every adopter:

* **exponential backoff with jitter** — synchronized retries from a whole
  pod hammering a just-restarted KV server is a thundering herd; jitter
  de-correlates them;
* **a total-deadline budget** — callers state their intent ("this lookup
  is worth ~10s"), and retrying stops when the budget is spent rather
  than after an attempt count whose wall time nobody computed;
* **per-call-site metrics** — ``hvd_retry_attempts_total{site=...}``
  (transient errors absorbed) and ``hvd_retry_exhausted_total{site=...}``
  (gave up), so /metrics shows WHICH plane is flaky before it becomes an
  outage.

Reference analog: none — the reference hand-rolls retries per call site
too (e.g. ``horovod/runner/http/http_client.py``); SURVEY.md flags the
lack of a shared policy.

A copy of ``horovod_tpu/common/retry.py``.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type

from horovod_tpu_torch.common.safe_metrics import safe_inc as _metric

# module-level singleton RNG for jitter; deterministic tests inject their
# own via the rng= parameter
_RNG = random.Random()


def retry_call(fn: Callable,
               site: str,
               retry_on: Tuple[Type[BaseException], ...] = (OSError,),
               give_up_on: Tuple[Type[BaseException], ...] = (),
               attempts: int = 4,
               base_delay_s: float = 0.05,
               backoff: float = 2.0,
               max_delay_s: float = 2.0,
               jitter: float = 0.25,
               deadline_s: Optional[float] = None,
               sleep: Callable[[float], None] = time.sleep,
               rng: Optional[random.Random] = None,
               clock: Callable[[], float] = time.monotonic,
               count_exhausted: bool = True):
    """Call ``fn()``; on a transient error, back off and try again.

    Args:
      fn: zero-arg callable; its return value is returned on success.
      site: stable call-site label for the retry/exhaustion metrics and
        log records (e.g. ``"http_kv"``, ``"autopsy.peer_fetch"``).
      retry_on: exception types considered transient.
      give_up_on: exception types re-raised immediately even when they
        subclass a ``retry_on`` type (e.g. ``urllib.error.HTTPError`` is
        an ``OSError`` but a 404 will not heal with patience).
      attempts: maximum total attempts (first call included).
      base_delay_s / backoff / max_delay_s: delay before retry *i* is
        ``min(max_delay_s, base_delay_s * backoff**i)`` pre-jitter.
      jitter: fractional jitter; each sleep is scaled by a uniform factor
        in ``[1 - jitter, 1 + jitter]``.
      deadline_s: total wall-time budget across attempts AND sleeps; when
        the budget cannot fit the next sleep, retrying stops and the last
        error is raised (counted as exhaustion).  ``None`` = attempts
        alone bound the loop.
      sleep / rng / clock: injectable for tests.
      count_exhausted: when False, exhaustion skips the
        ``hvd_retry_exhausted_total`` tick (the attempts metric and the
        log still land).  For callers whose exhaustion is an EXPECTED
        outcome of a declared condition — a worker polling through a
        driver-takeover window under ``HVD_TPU_DRIVER_OUTAGE_GRACE_S``
        (docs/ELASTIC.md "Driver failover & takeover") — where the alarm
        metric would be a false positive on every planned takeover.

    Raises: the last transient error on exhaustion; non-retryable errors
    immediately.
    """
    if attempts < 1:
        raise ValueError("attempts must be >= 1")
    if attempts == 1:
        # no retry policy in effect — a plain call.  Skipping the
        # metrics/log keeps single-attempt probes (running_on_tpu_vm off
        # TPU) from raising false "retry exhausted" alarms on /metrics.
        return fn()
    r = rng or _RNG
    start = clock()
    for attempt in range(attempts):
        try:
            return fn()
        except give_up_on:
            raise
        except retry_on as e:
            _metric("hvd_retry_attempts_total",
                    "transient errors absorbed by retry_call, per site",
                    site=site)
            last_chance = attempt == attempts - 1
            delay = min(max_delay_s, base_delay_s * backoff ** attempt)
            delay *= 1.0 + jitter * (2.0 * r.random() - 1.0)
            over_budget = (deadline_s is not None and
                           clock() - start + delay > deadline_s)
            if last_chance or over_budget:
                if count_exhausted:
                    _metric("hvd_retry_exhausted_total",
                            "retry_call gave up (attempts or deadline "
                            "spent), per site", site=site)
                _log_exhausted(site, attempt + 1, clock() - start, e)
                raise
            sleep(max(delay, 0.0))
    raise AssertionError("unreachable")  # pragma: no cover


def _log_exhausted(site: str, tried: int, elapsed: float,
                   err: BaseException) -> None:
    try:
        from horovod_tpu_torch.common.logging import get_logger
        get_logger().warning(
            "retry[%s]: giving up after %d attempt(s) over %.2fs: %r",
            site, tried, elapsed, err)
    except Exception:
        pass
