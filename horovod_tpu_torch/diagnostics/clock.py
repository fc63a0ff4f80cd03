"""Wall-clock offset estimation for cross-rank trace alignment.

A copy of ``horovod_tpu/diagnostics/clock.py`` over ``torch.distributed``.
Timeline shards are stamped with each host's own clocks; hosts' wall
clocks can disagree by far more than a collective takes, so merging
shards raw would show rank 3 "responding" before rank 0 asked. Each shard
therefore records an estimated offset to the coordinator's wall clock,
measured on the process group that init just brought up: after a barrier
releases every rank about at once, all ranks sample ``time.time()`` and
all-gather the samples (one float64 each: on the card under NCCL, on the
host under gloo); my offset is the median over a few rounds of
``my_sample - rank0_sample``. The barrier bounds the sampling skew to one
round trip (ms), while real clock skew on unsynchronized hosts is
seconds.

``HVD_TPU_CLOCK_OFFSET_S`` overrides the estimate (tests inject known
skew; operators can pin a value on NTP-disciplined fleets).
"""

from __future__ import annotations

import os
import time
from typing import Tuple

_ROUNDS = 5  # samples whose median is the offset


def wall_monotonic_pair() -> Tuple[float, float]:
    """(wall seconds, monotonic seconds) sampled back-to-back — the
    anchor pair shard metadata embeds so monotonic event timestamps can
    be mapped onto the wall clock."""
    return time.time(), time.monotonic()


def estimate_wall_offset() -> float:
    """Estimated ``my_wall - coordinator_wall`` in seconds over the
    default process group. 0.0 when it cannot be measured: no process
    group, a world of one, or any failure — alignment degrades gracefully
    to raw clocks."""
    forced = os.environ.get("HVD_TPU_CLOCK_OFFSET_S")
    if forced not in (None, ""):
        try:
            return float(forced)
        except ValueError:
            pass
    try:
        import torch.distributed as dist
        if not dist.is_initialized() or dist.get_world_size() <= 1:
            return 0.0
        return _measure()
    except Exception:
        return 0.0


def _measure() -> float:
    import torch
    import torch.distributed as dist
    dev = torch.device("cpu")
    if dist.get_backend() == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    n = dist.get_world_size()
    offsets = []
    for _ in range(_ROUNDS):
        dist.barrier()  # release is ~simultaneous on every rank
        sample = time.time()
        mine = torch.full((1,), sample, dtype=torch.float64, device=dev)
        gathered = torch.empty(n, dtype=torch.float64, device=dev)
        dist.all_gather_into_tensor(gathered, mine)
        offsets.append(sample - float(gathered[0]))
    offsets.sort()
    return offsets[len(offsets) // 2]
