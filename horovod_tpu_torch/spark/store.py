"""Storage abstraction for checkpoints / train-data paths.

A copy of ``horovod_tpu/spark/store.py`` (reference:
``horovod/spark/common/store.py:36-530`` — ``Store`` with
``LocalStore``/``HDFSStore``/``DBFSLocalStore`` and fsspec-backed remote
paths, used by the estimators for Parquet data + checkpoints): the same
surface over local paths and (when fsspec is importable) any fsspec URL,
with the same on-disk layout, so either package reads the other's run
directory. :func:`checkpoint_handler` gives the port's
``ShardedCheckpointer`` (the JAX package's on-disk checkpoint format, read
both ways) where the JAX module gives orbax's.
"""

from __future__ import annotations

import os
from typing import Optional


class Store:
    """Base interface (reference: ``Store:36-140``)."""

    def get_train_data_path(self, idx: Optional[str] = None) -> str:
        raise NotImplementedError

    def get_val_data_path(self, idx: Optional[str] = None) -> str:
        raise NotImplementedError

    def get_checkpoint_path(self, run_id: str) -> str:
        raise NotImplementedError

    def get_logs_path(self, run_id: str) -> str:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def read(self, path: str) -> bytes:
        raise NotImplementedError

    def write(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def join(self, path: str, *parts: str) -> str:
        """Path join in the store's own path algebra — estimator code must
        never use ``os.path`` on store paths (they may be object-store
        URLs)."""
        raise NotImplementedError

    def makedirs(self, path: str) -> None:
        """Ensure a directory exists (no-op on keyspace-only backends)."""
        raise NotImplementedError

    def ls(self, path: str) -> list:
        """Entries directly under ``path`` (full store paths, sorted);
        ``[]`` for a missing directory. Used for shard discovery."""
        raise NotImplementedError

    def delete(self, path: str) -> None:
        """Remove a file; silently ignore a missing one. Used to clear
        stale shards when a run_id is reused."""
        raise NotImplementedError

    def read_text(self, path: str) -> str:
        return self.read(path).decode()

    @staticmethod
    def create(prefix_path: str, *args, **kwargs) -> "Store":
        """Reference: ``Store.create`` dispatch by URL scheme."""
        if "://" in prefix_path and not prefix_path.startswith("file://"):
            return FilesystemStore(prefix_path, *args, **kwargs)
        return LocalStore(prefix_path.replace("file://", ""), *args,
                          **kwargs)


class LocalStore(Store):
    """Local-filesystem store (reference: ``LocalStore:143-220``)."""

    def __init__(self, prefix_path: str) -> None:
        self._prefix = prefix_path
        os.makedirs(prefix_path, exist_ok=True)

    def _join(self, *parts: str) -> str:
        p = self.join(self._prefix, *parts)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        return p

    def get_train_data_path(self, idx: Optional[str] = None) -> str:
        return self._join("intermediate_train_data" + (f".{idx}" if idx
                                                       else ""))

    def get_val_data_path(self, idx: Optional[str] = None) -> str:
        return self._join("intermediate_val_data" + (f".{idx}" if idx
                                                     else ""))

    def get_checkpoint_path(self, run_id: str) -> str:
        return self._join("runs", run_id, "checkpoint")

    def get_logs_path(self, run_id: str) -> str:
        return self._join("runs", run_id, "logs")

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def read(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def write(self, path: str, data: bytes) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def join(self, path: str, *parts: str) -> str:
        return os.path.join(path, *parts)

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def ls(self, path: str) -> list:
        if not os.path.isdir(path):
            return []
        return sorted(os.path.join(path, p) for p in os.listdir(path))

    def delete(self, path: str) -> None:
        try:
            os.remove(path)
        except FileNotFoundError:
            pass


class FilesystemStore(Store):
    """fsspec-backed store for s3://, gs://, hdfs:// URLs (reference:
    ``FilesystemStore``/``HDFSStore``; fsspec is the modern superset).

    ``fs`` injects a ready filesystem instance (tests use a
    ``DirFileSystem`` faking a remote scheme; estimator workers receive
    the store by pickle, so the fs must be picklable — fsspec filesystems
    reconstruct from their storage options)."""

    def __init__(self, prefix_path: str, fs=None) -> None:
        try:
            import fsspec
        except ImportError as e:
            raise ImportError(
                f"FilesystemStore({prefix_path!r}) requires fsspec, which "
                "is not installed; use LocalStore or install fsspec.") from e
        if fs is not None:
            self._fs, self._prefix = fs, prefix_path
        else:
            self._fs, self._prefix = fsspec.core.url_to_fs(prefix_path)

    def _join(self, *parts: str) -> str:
        return self.join(self._prefix, *parts)

    def get_train_data_path(self, idx: Optional[str] = None) -> str:
        return self._join("intermediate_train_data" + (f".{idx}" if idx
                                                       else ""))

    def get_val_data_path(self, idx: Optional[str] = None) -> str:
        return self._join("intermediate_val_data" + (f".{idx}" if idx
                                                     else ""))

    def get_checkpoint_path(self, run_id: str) -> str:
        return self._join("runs", run_id, "checkpoint")

    def get_logs_path(self, run_id: str) -> str:
        return self._join("runs", run_id, "logs")

    def exists(self, path: str) -> bool:
        return self._fs.exists(path)

    def read(self, path: str) -> bytes:
        with self._fs.open(path, "rb") as f:
            return f.read()

    def write(self, path: str, data: bytes) -> None:
        with self._fs.open(path, "wb") as f:
            f.write(data)

    def join(self, path: str, *parts: str) -> str:
        return "/".join([path.rstrip("/")] + list(parts))

    def makedirs(self, path: str) -> None:
        try:
            self._fs.makedirs(path, exist_ok=True)
        except NotImplementedError:
            pass  # keyspace-only backend (e.g. s3): directories are implied

    def ls(self, path: str) -> list:
        try:
            return sorted(self._fs.ls(path, detail=False))
        except FileNotFoundError:
            return []

    def delete(self, path: str) -> None:
        try:
            self._fs.rm(path)
        except FileNotFoundError:
            pass


def checkpoint_handler(store: Store, run_id: str):
    """A ``ShardedCheckpointer`` rooted at the store's checkpoint path, and
    that path (the JAX function returns orbax's checkpointer). It writes a
    local directory: a ``LocalStore``'s, or a mounted one."""
    from horovod_tpu_torch.checkpoint import ShardedCheckpointer
    path = store.get_checkpoint_path(run_id)
    return ShardedCheckpointer(path), path
