"""Starting the core for a launched world.

Mirrors ``horovod_tpu/core/bindings.py``: :func:`core_backend_or_raise`
hands back a :class:`~horovod_tpu_torch.core.core_backend.CoreBackend`,
or raises (a failed build or load never falls back to another engine).

The core's rank 0 listens on its own port, never on the port of the
process group's TCP store: the port's launcher exports one port for the
store (``HVD_TPU_RENDEZVOUS_PORT``, also as ``HVD_TPU_COORD_PORT``), and
two servers on it collide. So rank 0 holds a fresh port (``SO_REUSEADDR``
and not listening, as ``runner.exec_run.reserve_port`` holds one; the
core binds over it with ``SO_REUSEADDR``) and hands it to every rank over
the process group, which every rank already joined; the core's address
is the store's. A new world (an elastic re-mesh) gets a new port this way.

With ``HVD_TPU_TIMELINE`` set the core writes its negotiation timeline to
``<timeline>.core.json`` (``<dir>/timeline.core.json`` for a directory)
on the coordinator: the host timeline keeps the path itself.
"""

from __future__ import annotations

import contextlib
import os
import socket

import torch.distributed as dist


@contextlib.contextmanager
def _env(values: dict):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _publish_port(state):
    """``(addr, port, held socket or None)``: rank 0 holds a free port and
    every rank of the launched world learns it over the process group."""
    held = None
    if state.launched_rank == 0:
        held = socket.socket()
        held.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        held.bind(("0.0.0.0", 0))
    box = [held.getsockname()[1] if held is not None else None]
    dist.broadcast_object_list(box, src=0)
    addr = state.config.rendezvous_addr or "127.0.0.1"
    return addr, int(box[0]), held


def core_backend_or_raise(state):
    """Start the core over the launched world and return the global set's
    backend (a process-set domain when ``init(ranks=...)`` restricted the
    global set)."""
    from horovod_tpu_torch.core.core_backend import CoreBackend, _load_lib
    _load_lib()     # build and load before the rendezvous: a failure raises
    addr, port, held = _publish_port(state)
    env = {"HVD_TPU_COORD_ADDR": addr, "HVD_TPU_COORD_PORT": port,
           "HVD_TPU_RANK": state.launched_rank,
           "HVD_TPU_SIZE": state.launched_size}
    timeline = state.config.timeline
    if timeline:
        env["HVD_TPU_TIMELINE"] = (
            os.path.join(timeline, "timeline.core.json")
            if timeline.endswith(os.sep) or os.path.isdir(timeline)
            else timeline + ".core.json")
    try:
        with _env(env):
            return CoreBackend(world_ranks=state.world_ranks)
    finally:
        if held is not None:
            held.close()


def core_config_dump() -> dict:
    """The env knobs as the C++ core parses them (key=value map)."""
    from horovod_tpu_torch.core.core_backend import _load_lib
    out = {}
    for line in _load_lib().hvd_cfg_dump().decode().strip().splitlines():
        k, _, v = line.partition("=")
        out[k] = v
    return out
