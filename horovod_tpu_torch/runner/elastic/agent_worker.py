"""Worker entry for agent-transport elastic jobs (Spark/Ray): fetch the
pickled training fn from the driver KV, run it, publish this rank's
result (reference analog: ``spark/task/__init__.py`` exec of the pickled
fn in the task process). A copy of
``horovod_tpu/runner/elastic/agent_worker.py``; the host agent starts it
as ``python -m horovod_tpu_torch.runner.elastic.agent_worker``."""

from __future__ import annotations

import os
import sys


def main() -> int:
    from horovod_tpu_torch.common import payload
    from horovod_tpu_torch.runner.elastic.agent import resolve_kv_addr
    from horovod_tpu_torch.runner.http_kv import kv_get, kv_put

    addr, port = os.environ["HVD_AGENT_KV"].rsplit(":", 1)
    addr = resolve_kv_addr(addr)
    blob = kv_get(addr, int(port), "payload", "fn")
    if blob is None:
        print("agent_worker: no payload published", file=sys.stderr)
        return 1
    fn, args, kwargs = payload.loads(blob)
    result = fn(*args, **kwargs)
    # generation-scoped key: a late publish from an aborted generation
    # must never be mistaken for (or overwrite) the completed one's. Both
    # are read after fn: an in-place re-mesh moves them forward
    gen = os.environ.get("HVD_ELASTIC_GENERATION", "0")
    kv_put(addr, int(port), "result",
           f"{gen}.{os.environ['HOROVOD_RANK']}", payload.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
