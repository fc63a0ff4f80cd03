"""Remote task-service entry point: the launcher starts this on each host
(over ssh) before starting workers, then probes routability through it
(reference: the task-service bootstrap in
``horovod/runner/driver/driver_service.py`` /
``common/service/task_service.py``). A copy of
``horovod_tpu/runner/task_server.py``::

    echo <secret hex> | python -m horovod_tpu_torch.runner.task_server --index I

Prints ``HVD_TASK_PORT=<port>`` so the launcher learns the bound port over
the ssh pipe. The shared secret arrives on stdin (the ssh channel), never
on the command line; ``HVD_TPU_SERVICE_SECRET`` (hex) is a local-testing
fallback only.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main() -> None:
    from horovod_tpu_torch.runner.service import TaskService
    p = argparse.ArgumentParser()
    p.add_argument("--index", type=int, required=True)
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--ttl", type=float, default=300.0,
                   help="self-destruct if the driver never shuts us down")
    args = p.parse_args()
    # The secret arrives over STDIN (the ssh channel) so it never appears
    # on a command line or in the remote process table
    secret_hex = os.environ.get("HVD_TPU_SERVICE_SECRET", "")
    if not secret_hex:
        secret_hex = sys.stdin.readline().strip()
    secret = bytes.fromhex(secret_hex)
    svc = TaskService(args.index, secret, port=args.port).start()
    print(f"HVD_TASK_PORT={svc.port}", flush=True)
    deadline = time.monotonic() + args.ttl
    while time.monotonic() < deadline:
        if not svc._thread.is_alive():
            return  # driver called shutdown
        time.sleep(0.2)


if __name__ == "__main__":
    sys.exit(main())
