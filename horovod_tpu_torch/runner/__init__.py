"""Runner: the control plane's processes and their HTTP planes — the
launcher (``python -m horovod_tpu_torch.runner.launch``, ``hvdrun``), host
parsing and slot assignment, process execution, the KV store and its relay
tree, the task services' NIC probe (``service``, ``task_server``), pod
host enumeration (``gpu_discovery``), and the elastic driver with its
agent transport (``runner/elastic/``). Mirrors ``horovod_tpu/runner/``.

Also hosts the interactive API: ``horovod_tpu_torch.runner.run(fn, np=2)``
runs ``fn`` in np local worker processes and returns the per-rank results
(reference: ``horovod.run``, ``runner/__init__.py:92``).
"""

from __future__ import annotations

import os
import sys
import tempfile
from typing import Any, Callable, List, Optional

from horovod_tpu_torch.runner.hosts import HostInfo
from horovod_tpu_torch.runner.exec_run import launch_static

_WORKER_SNIPPET = """
import os, pickle
with open(os.environ["HVD_RUN_FN"], "rb") as f:
    fn, args, kwargs = pickle.load(f)
import horovod_tpu_torch as hvd
hvd.init()
result = fn(*args, **kwargs)
out = os.path.join(os.environ["HVD_RUN_OUT"],
                   f"result_{hvd.rank()}.pkl")
with open(out + ".tmp", "wb") as f:
    pickle.dump(result, f)
os.replace(out + ".tmp", out)
hvd.shutdown()
"""


def run(fn: Callable, args: tuple = (), kwargs: Optional[dict] = None,
        np: int = 1, env: Optional[dict] = None) -> List[Any]:
    """Run ``fn`` under np local workers; returns per-rank results in rank
    order (reference: ``horovod.run`` interactive mode via KV store,
    ``runner/launch.py:594-614`` — here via a tmpdir instead of HTTP).
    ``fn`` travels by :mod:`horovod_tpu_torch.common.payload`."""
    from horovod_tpu_torch.common import payload
    with tempfile.TemporaryDirectory(prefix="hvd_run_") as tmp:
        fn_path = os.path.join(tmp, "fn.pkl")
        with open(fn_path, "wb") as f:
            f.write(payload.dumps((fn, args, kwargs or {})))
        wenv = dict(env if env is not None else os.environ)
        wenv["HVD_RUN_FN"] = fn_path
        wenv["HVD_RUN_OUT"] = tmp
        rc = launch_static([HostInfo("localhost", np)], np,
                           [sys.executable, "-c", _WORKER_SNIPPET],
                           env=wenv)
        if rc != 0:
            raise RuntimeError(f"hvd.run workers failed with exit code {rc}")
        results = []
        for r in range(np):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                results.append(payload.loads(f.read()))
        return results
