"""Canary weight rollout: autopilot-governed train→serve promotion
(docs/SERVING.md "Canary rollout").

The missing half of the continuous loop: training commits durably
(:mod:`horovod_tpu_torch.checkpoint`), replicas hot-swap from the store
(:mod:`horovod_tpu_torch.serving.replica`) — but an ungoverned swap puts a
poisoned commit on 100% of traffic before anyone measures it.  This
package turns "step N committed" into a governed transition:

* :class:`RolloutController` pins a canary subset of the fleet to the
  candidate version, splits traffic by weight version through the
  router, and reduces per-version request-log windows (plus an
  optional golden-request quality probe) to a ``rollout_verdict``
  finding.
* The autopilot's ``rollout-promote`` / ``rollout-rollback`` policies
  (:func:`horovod_tpu_torch.autopilot.policy.default_policies`) gate on the
  verdict and drive the controller's promote/rollback hooks — canary →
  50% → fleet-wide, or an atomic repin of every canary replica back to
  the incumbent with zero failed requests.
* One trace id covers the whole transition; ``python -m
  horovod_tpu_torch.diagnostics trace <id>`` prints the causal tree.

A copy of ``horovod_tpu/serving/rollout/__init__.py``.
"""

from horovod_tpu_torch.serving.rollout.comparator import (  # noqa: F401
    compare,
    golden_divergence,
    load_golden_set,
    version_windows,
)
from horovod_tpu_torch.serving.rollout.controller import (  # noqa: F401
    RolloutConfig,
    RolloutController,
    read_status,
)

__all__ = [
    "RolloutConfig",
    "RolloutController",
    "compare",
    "golden_divergence",
    "load_golden_set",
    "read_status",
    "version_windows",
]
