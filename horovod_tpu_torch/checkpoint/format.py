"""On-disk format of the native sharded checkpoint store.

A copy of ``horovod_tpu/checkpoint/format.py``, the contract both packages
read and write: a checkpoint written by either restores in the other.

::

    <base>/
      step_12/                      # committed checkpoint (atomic rename)
        manifest.json               # rank 0, written LAST inside the tmp dir
        shard_0.npz  shard_0.json   # per-rank payload + {sha256, entries}
        shard_1.npz  shard_1.json
      step_13.tmp/                  # in-flight or abandoned (crash) — never
                                    # read by restore, reclaimed by GC

Phase 1: every rank serializes its shard to ``shard_<r>.npz`` (write →
fsync → rename from ``*.part``) and then publishes ``shard_<r>.json``
(the completion marker, carrying the payload's sha256 and the index
ranges of every entry).  Phase 2: rank 0 waits for all W markers, writes
``manifest.json`` (global shapes/dtypes, shard→rank map, world size,
spec version, per-file sha256), fsyncs, and atomically renames
``step_N.tmp`` → ``step_N``.  A crash at ANY point — including kill -9
of a writer — leaves either a complete committed checkpoint or a tmp
dir that readers ignore and GC reclaims.

Dtypes the ``.npy`` format cannot carry natively (bfloat16, float8_*)
are stored as same-width uint views with the logical dtype recorded in
the manifest. The JAX package reads them back through ``ml_dtypes``; the
port has no ``ml_dtypes`` and works on torch tensors instead
(:func:`tensor_storage`, :func:`to_tensor`): a bf16 tensor is stored as
``t.view(torch.int16)`` seen as ``uint16`` under the name
``"bfloat16"``, and restored by viewing the ``uint16`` bytes as
``torch.bfloat16``, so the stored bytes and the manifest are the JAX
package's for the same values.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

SPEC_VERSION = 1
MANIFEST = "manifest.json"
ATTEMPT = "attempt.json"
TMP_SUFFIX = ".tmp"
_STEP_RE = re.compile(r"^step_(\d+)$")
_TMP_RE = re.compile(r"^step_(\d+)\.tmp$")

# .npy serializes these directly; anything else rides a uint view of the
# same itemsize and is re-viewed on load (bf16 would otherwise come back
# as an opaque void dtype).
_NATIVE_KINDS = frozenset("biufc")
_NATIVE_DTYPES = frozenset(
    np.dtype(t).name for t in (
        np.bool_, np.int8, np.int16, np.int32, np.int64,
        np.uint8, np.uint16, np.uint32, np.uint64,
        np.float16, np.float32, np.float64,
        np.complex64, np.complex128))


class CheckpointError(RuntimeError):
    """A save could not commit or a restore found a broken checkpoint."""


def step_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{int(step)}")


def tmp_dir(base: str, step: int) -> str:
    return step_dir(base, step) + TMP_SUFFIX


def shard_npz(rank: int) -> str:
    return f"shard_{int(rank)}.npz"


def shard_meta(rank: int) -> str:
    return f"shard_{int(rank)}.json"


def list_steps(base: str) -> List[int]:
    """Committed steps (dirs named ``step_N`` that contain a manifest),
    ascending.  Tmp dirs and manifest-less dirs are invisible here by
    construction — they are either in-flight or wreckage."""
    steps = []
    try:
        names = os.listdir(base)
    except OSError:
        return []
    for name in names:
        m = _STEP_RE.match(name)
        if m and os.path.isfile(os.path.join(base, name, MANIFEST)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def list_tmp_steps(base: str) -> List[Tuple[int, str]]:
    """``(step, path)`` of every in-flight/abandoned tmp dir."""
    out = []
    try:
        names = os.listdir(base)
    except OSError:
        return []
    for name in names:
        m = _TMP_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(base, name)))
    return sorted(out)


def list_broken_steps(base: str) -> List[Tuple[int, str]]:
    """``(step, path)`` of ``step_N`` dirs WITHOUT a manifest — can't
    arise from this writer (the rename happens after the manifest) but
    tampering/partial copies produce them; readers ignore them and GC
    reclaims them."""
    out = []
    try:
        names = os.listdir(base)
    except OSError:
        return []
    for name in names:
        m = _STEP_RE.match(name)
        if m and not os.path.isfile(os.path.join(base, name, MANIFEST)):
            out.append((int(m.group(1)), os.path.join(base, name)))
    return sorted(out)


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def fsync_dir(path: str) -> None:
    """Durability of the rename itself (best-effort: not every
    filesystem supports directory fds)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_atomic(path: str, data: bytes) -> None:
    """write → fsync → rename, so ``path`` never holds a torn file."""
    part = path + ".part"
    with open(part, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(part, path)


def shard_bounds(dim: int, world: int) -> List[Tuple[int, int]]:
    """Even contiguous split of axis length ``dim`` over ``world`` ranks
    (some ranks may get an empty range).  Deterministic — both the save
    planner and any reader can recompute it from the manifest's world
    size."""
    w = max(1, int(world))
    return [(r * dim // w, (r + 1) * dim // w) for r in range(w)]


def storage_view(arr: np.ndarray) -> Tuple[np.ndarray, str]:
    """``(storable, logical_dtype_name)`` — exotic dtypes become uint
    views of the same width."""
    dt = arr.dtype
    if dt.kind in _NATIVE_KINDS and dt.name in _NATIVE_DTYPES:
        return arr, dt.name
    store = np.ascontiguousarray(arr).view(
        np.dtype(f"uint{dt.itemsize * 8}"))
    return store, dt.name


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy (or ``ml_dtypes``) name of a torch dtype, as the manifest
    records it: ``torch.bfloat16`` → ``"bfloat16"``."""
    return str(dtype).split(".", 1)[1]


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise CheckpointError(f"dtype {name!r} has no torch counterpart")
    return dt


def tensor_storage(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """``(storable, logical_dtype_name)`` of a host tensor: numpy's own
    dtypes as they are, the others (bfloat16, float8_*) as a uint view of
    the same width, exactly as :func:`storage_view` stores the numpy
    arrays of the JAX package."""
    name = dtype_name(t.dtype)
    t = t.detach().contiguous()
    if name in _NATIVE_DTYPES:
        return t.numpy(), name
    bits = t.element_size() * 8
    ints = t.view(getattr(torch, f"int{bits}") if bits > 8 else torch.uint8)
    return ints.numpy().view(np.dtype(f"uint{bits}")), name


def to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A stored array as a CPU tensor of its logical dtype (the inverse of
    :func:`tensor_storage`; no copy where the dtype is numpy's own)."""
    if dtype_name in _NATIVE_DTYPES or arr.dtype.name == dtype_name:
        return torch.from_numpy(np.ascontiguousarray(arr))
    bits = arr.dtype.itemsize * 8
    ints = arr.view(np.dtype(f"int{bits}") if bits > 8 else np.uint8)
    return torch.from_numpy(np.ascontiguousarray(ints)).view(
        torch_dtype(dtype_name))


def normalize_index(index: Sequence, shape: Sequence[int]) -> List[List[int]]:
    """A shard's position as ``[[start, stop], ...]`` per dim (JSON-safe;
    accepts the slice tuples of ``jax.Array.addressable_shards``)."""
    out = []
    for sl, dim in zip(index, shape):
        start = 0 if sl.start is None else int(sl.start)
        stop = int(dim) if sl.stop is None else int(sl.stop)
        out.append([start, stop])
    return out


def index_slices(index: Sequence[Sequence[int]]) -> Tuple[slice, ...]:
    return tuple(slice(int(s), int(e)) for s, e in index)


def open_attempt(dirpath: str, nonce: str) -> None:
    """Rank 0 claims the tmp dir for ONE save attempt.  Peers write
    their shard markers only after seeing the token and embed its nonce
    — so a marker left by a crashed earlier attempt (different/absent
    nonce) can never satisfy this attempt's commit barrier."""
    os.makedirs(dirpath, exist_ok=True)
    write_atomic(os.path.join(dirpath, ATTEMPT),
                 json.dumps({"nonce": nonce}).encode())
    fsync_dir(dirpath)


def read_attempt(dirpath: str) -> Optional[str]:
    try:
        with open(os.path.join(dirpath, ATTEMPT), "rb") as f:
            doc = json.loads(f.read())
        return doc.get("nonce") or None
    except (OSError, ValueError, AttributeError):
        return None


def write_shard(dirpath: str, rank: int,
                arrays: Dict[str, np.ndarray],
                entries: List[dict],
                attempt: Optional[str] = None) -> str:
    """Phase 1 for one rank: payload npz (atomic), then the completion
    marker ``shard_<rank>.json`` with the payload sha256 + entry index
    map + the attempt nonce.  The marker's existence tells rank 0 this
    rank is done.  Returns the payload's sha256."""
    os.makedirs(dirpath, exist_ok=True)
    npz_path = os.path.join(dirpath, shard_npz(rank))
    part = npz_path + ".part"
    with open(part, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(part, npz_path)
    sha = file_sha256(npz_path)
    meta = {"version": SPEC_VERSION, "rank": int(rank), "sha256": sha,
            "attempt": attempt, "entries": entries}
    write_atomic(os.path.join(dirpath, shard_meta(rank)),
                 json.dumps(meta, sort_keys=True).encode())
    fsync_dir(dirpath)
    return sha


def read_shard_meta(dirpath: str, rank: int) -> Optional[dict]:
    path = os.path.join(dirpath, shard_meta(rank))
    try:
        with open(path, "rb") as f:
            return json.loads(f.read())
    except (OSError, ValueError):
        return None


def commit(base: str, step: int, manifest: dict) -> None:
    """Phase 2: manifest into the tmp dir, then the atomic rename that
    makes the checkpoint exist."""
    tmp = tmp_dir(base, step)
    final = step_dir(base, step)
    write_atomic(os.path.join(tmp, MANIFEST),
                 json.dumps(manifest, sort_keys=True).encode())
    fsync_dir(tmp)
    if os.path.exists(final):
        raise CheckpointError(f"checkpoint step {step} already exists "
                              f"at {final}")
    os.rename(tmp, final)
    fsync_dir(base)


def read_manifest(base: str, step: int) -> dict:
    path = os.path.join(step_dir(base, step), MANIFEST)
    try:
        with open(path, "rb") as f:
            manifest = json.loads(f.read())
    except OSError as e:
        raise CheckpointError(
            f"no committed checkpoint for step {step} under {base}") from e
    except ValueError as e:
        raise CheckpointError(f"corrupt manifest at {path}") from e
    version = manifest.get("version")
    if version != SPEC_VERSION:
        raise CheckpointError(
            f"checkpoint spec version {version!r} at {path} is not "
            f"readable by this build (expects {SPEC_VERSION})")
    return manifest


def remove_tree(path: str) -> None:
    shutil.rmtree(path, ignore_errors=True)


def newest_mtime(path: str) -> float:
    """The most recent mtime inside a dir (the dir itself included) —
    GC's liveness signal for tmp dirs another process may still be
    filling."""
    try:
        newest = os.path.getmtime(path)
    except OSError:
        return 0.0
    try:
        names = os.listdir(path)
    except OSError:
        return newest
    for name in names:
        try:
            newest = max(newest, os.path.getmtime(os.path.join(path, name)))
        except OSError:
            continue
    return newest
