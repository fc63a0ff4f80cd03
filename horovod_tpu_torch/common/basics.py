"""Process identity and lifecycle for the PyTorch port: ``init`` /
``shutdown`` / rank and size queries, and the CUDA device a process drives.

Mirrors ``horovod_tpu/common/basics.py`` (``init``, ``shutdown``, ``rank``,
``size``, ``local_rank``, ``local_size`` and ``_read_identity_from_env``).
The launcher identity is read from the same environment variables:
``HVD_TPU_<NAME>`` first, then ``HOROVOD_<NAME>``.

On a GPU host a process drives one card, ``cuda:<local_rank>``. This port
is single-process so far: a launched world of more than one process is
refused until the data-parallel (NCCL) slice lands.
"""

from __future__ import annotations

import os
import threading

import torch


class NotInitializedError(RuntimeError):
    def __init__(self) -> None:
        super().__init__(
            "horovod_tpu_torch has not been initialized; call init() first.")


class _GlobalState:
    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.initialized = False
        self.rank = 0
        self.size = 1
        self.local_rank = 0
        self.local_size = 1


_state = _GlobalState()


def _read_identity_from_env() -> dict:
    """Launcher-injected identity, under the reference's variable names."""
    def geti(name: str, default: int) -> int:
        v = os.environ.get("HVD_TPU_" + name, os.environ.get("HOROVOD_" + name))
        return int(v) if v not in (None, "") else default

    return dict(
        rank=geti("RANK", 0),
        size=geti("SIZE", 1),
        local_rank=geti("LOCAL_RANK", 0),
        local_size=geti("LOCAL_SIZE", 1),
    )


def init() -> None:
    """Read the launcher identity. A world of more than one process raises
    ``NotImplementedError``: data parallelism over NCCL is the next slice
    of the port."""
    with _state.lock:
        if _state.initialized:
            return
        ident = _read_identity_from_env()
        if ident["size"] > 1:
            raise NotImplementedError(
                f"horovod_tpu_torch runs one process so far (launched world "
                f"size {ident['size']}); multi-process training arrives with "
                f"the data-parallel slice of the port")
        _state.rank = ident["rank"]
        _state.size = ident["size"]
        _state.local_rank = ident["local_rank"]
        _state.local_size = ident["local_size"]
        _state.initialized = True


def shutdown() -> None:
    with _state.lock:
        _state.initialized = False


def is_initialized() -> bool:
    return _state.initialized


def _require_init() -> _GlobalState:
    if not _state.initialized:
        raise NotInitializedError()
    return _state


def rank() -> int:
    return _require_init().rank


def size() -> int:
    return _require_init().size


def local_rank() -> int:
    return _require_init().local_rank


def local_size() -> int:
    return _require_init().local_size


def device() -> torch.device:
    """The card this process drives, ``cuda:<local_rank>``. Raises when no
    CUDA device is present: nothing in the port drifts onto the CPU unless
    the caller asks for it. Works before ``init()``: the binding follows
    from the launch, not from the process group."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    lr = (_state.local_rank if _state.initialized
          else _read_identity_from_env()["local_rank"])
    return torch.device("cuda", lr)


def resolve_device(dev=None) -> torch.device:
    """``None`` means the process's card (:func:`device`); anything else is
    taken as the caller's explicit choice."""
    return device() if dev is None else torch.device(dev)
