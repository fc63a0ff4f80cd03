"""Zero-drop online serving: the trained model meets live traffic.

Mirrors ``horovod_tpu/serving/``: an elastic replica fleet
(process-managed, healed to target size, DRAINED-vs-FAILURE exit
classification), a continuous dynamic batcher feeding the forward step
(bounded queue, max-batch/max-wait knobs, per-request deadlines), a
hedging/retrying router with idempotent request ids (a replica killed
mid-batch costs latency, never a dropped request), zero-downtime hot
weight swap from the durable sharded checkpoint store, explicit 429
load-shedding under backpressure, drain semantics, and per-request
p50/p99 SLO gauges with the request ledger's closed books.

Generative traffic decodes at TOKEN granularity through the
continuous-batching engine (:mod:`horovod_tpu_torch.serving.generate`):
one fixed-shape decode step over a static slot array, captured once in a
CUDA graph on the card, a paged KV-cache pool, the prefill/decode split —
replicas gain a ``generate`` mode and the router a hedging-free
:meth:`Router.submit_generate` path.

The canary rollout controller (:mod:`horovod_tpu_torch.serving.rollout`)
governs a train-to-serve transition under the autopilot; the replica and
the page pool fire the chaos seams ``preemption``, ``serving.request``
and ``serving.kv``.
"""

from horovod_tpu_torch.serving.batcher import (DeadlineError, DrainingError,
                                               DynamicBatcher,
                                               PendingRequest, SheddedError)
from horovod_tpu_torch.serving.fleet import ReplicaFleet
from horovod_tpu_torch.serving.ledger import (STAGES, BurnRateSlo,
                                              ExemplarRing, WindowBooks,
                                              close_books, dominant_stage,
                                              quantile, residual_fraction)
from horovod_tpu_torch.serving.metrics import LatencyWindow
from horovod_tpu_torch.serving.replica import (ReplicaServer, demo_apply,
                                               demo_params)
from horovod_tpu_torch.serving.generate import (GenerateEngine, GenRequest,
                                                KVPagePlan, PagePool,
                                                SlotScheduler,
                                                demo_gen_setup,
                                                plan_kv_pages,
                                                request_level_generate)
from horovod_tpu_torch.serving.router import (RequestFailed, RequestLog,
                                              RequestRejected, Router,
                                              ready_endpoints)
from horovod_tpu_torch.serving.rollout import (RolloutConfig,
                                               RolloutController)

__all__ = [
    "DynamicBatcher", "PendingRequest", "SheddedError", "DrainingError",
    "DeadlineError", "ReplicaServer", "demo_apply", "demo_params",
    "Router", "RequestLog", "RequestFailed", "RequestRejected",
    "ready_endpoints", "ReplicaFleet", "LatencyWindow",
    "GenerateEngine", "GenRequest", "KVPagePlan", "PagePool",
    "SlotScheduler", "demo_gen_setup", "plan_kv_pages",
    "request_level_generate", "RolloutConfig", "RolloutController",
    "STAGES", "BurnRateSlo", "ExemplarRing", "WindowBooks",
    "close_books", "dominant_stage", "quantile", "residual_fraction",
]
