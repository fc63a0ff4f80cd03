"""The native sharded checkpoint store, on torch state.

Mirrors ``horovod_tpu/checkpoint/store.py`` (``ShardedCheckpointer``) with
the same on-disk format (:mod:`~horovod_tpu_torch.checkpoint.format`), so a
commit of either package restores in the other by the leaves' ``parts``
key paths:

* **Sharded** — each rank writes only its shards: rank r writes the r-th
  axis-0 slice of a replicated tensor or array (only that slice crosses
  from the device to the host), and of a
  :class:`~horovod_tpu_torch.checkpoint.state.Shard` (a block of a leaf
  split over a mesh) the owner writes the block, at its index in the
  global shape.
* **Two-phase commit** — shards + per-file sha256 markers first, then a
  rank-0 manifest and an atomic ``step_N.tmp`` → ``step_N`` rename. The
  commit barrier is the filesystem (rank 0 waits for all W markers of
  this attempt's nonce), so no collective runs and a kill -9 anywhere
  leaves the previous checkpoint intact.
* **Async** — the snapshot (the consistent cut) is queued inline: each
  CUDA tensor's slice is copied ``non_blocking`` into pinned host memory
  on the current stream, and an event recorded after the copies; the
  background writer waits on that event before it reads the buffers. An
  optimizer that updates the tensors in place right after ``save`` runs
  after the copies on the same stream, so the cut is the state at the
  call, and the caller is not held while the bytes cross. CPU tensors and
  numpy arrays are copied on the spot.
* **Restore onto the current layout** — restore reassembles each global
  leaf from the manifest's shard map; with ``like``, a tensor leaf gets
  the value on the like leaf's device in the stored dtype, and a
  :class:`Shard` leaf the current layout's block of it. The manifest's
  world size need not match the current one.

The tree is flattened as ``jax.tree_util`` flattens it (dict keys sorted,
sequences by index, ``None`` an empty subtree; :mod:`common.tree
<horovod_tpu_torch.common.tree>`), so each leaf's ``path`` and ``parts``
are the JAX store's. Python scalars are stored inline, anything else that
is not a tensor or an array is pickled. The manifest's ``treedef`` is
``null``: a JAX treedef can be neither made nor read without JAX, and the
JAX store falls back to ``parts`` when it is missing. Without ``like``,
the tree is rebuilt from ``parts`` (dicts and lists; array leaves come
back as CPU tensors).

Replication contract: a leaf that is not a :class:`Shard` must hold the
same value on every rank when ``save`` is called.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import pickle
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from horovod_tpu_torch.checkpoint import format as fmt
from horovod_tpu_torch.checkpoint import metrics as ckpt_metrics
from horovod_tpu_torch.checkpoint.format import CheckpointError
from horovod_tpu_torch.checkpoint.state import Shard
from horovod_tpu_torch.checkpoint.writer import AsyncWriter
from horovod_tpu_torch.common.config import Config
from horovod_tpu_torch.common.logging import get_logger
from horovod_tpu_torch.common.tree import (flatten_with_path, keystr,
                                           map_with_path, path_parts)
from horovod_tpu_torch.diagnostics.flight_recorder import record_event

_INLINE_KINDS = ("bool", "int", "float", "str")


def _default_rank() -> int:
    from horovod_tpu_torch.common.basics import is_initialized, rank
    if is_initialized():
        return rank()
    return int(os.environ.get("HOROVOD_RANK",
                              os.environ.get("HVD_TPU_RANK", "0")))


def _default_world() -> int:
    from horovod_tpu_torch.common.basics import is_initialized, size
    if is_initialized():
        return size()
    return int(os.environ.get("HOROVOD_SIZE",
                              os.environ.get("HVD_TPU_SIZE", "1")))


def _full_index(shape: Tuple[int, ...]) -> List[List[int]]:
    return [[0, int(d)] for d in shape]


def _notify_progress() -> None:
    """A commit or a restore is forward progress: the hang watchdog's
    clock restarts (as the JAX store's ``diagnostics.watchdog.
    notify_progress`` call does)."""
    from horovod_tpu_torch.diagnostics.watchdog import notify_progress
    notify_progress()


class _Plan:
    """One rank's share of one save: manifest leaf records (rank 0 uses
    them), the payload entries and their index map for the shard marker.
    A payload entry is a numpy array, or a host tensor that a copy from
    the card may still be filling until ``events`` have completed."""

    def __init__(self) -> None:
        self.leaves: List[dict] = []
        self.payload: Dict[str, Any] = {}
        self.entries: List[dict] = []
        self.nbytes = 0
        self.devices: set = set()
        self.events: list = []

    def add_entry(self, leaf_idx: int, index: List[List[int]], data) -> None:
        key = f"L{leaf_idx}S{len(self.entries)}"
        self.payload[key] = data
        self.entries.append({"key": key, "leaf": leaf_idx, "index": index})
        self.nbytes += int(data.nbytes) if isinstance(data, np.ndarray) \
            else data.numel() * data.element_size()

    def host_copy(self, t: torch.Tensor) -> torch.Tensor:
        """A host copy of ``t`` that the cut owns: queued into pinned memory
        behind the current stream for a CUDA tensor, made now otherwise."""
        t = t.detach()
        if t.is_cuda:
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            out.copy_(t, non_blocking=True)
            self.devices.add(t.device)
            return out
        if t.device.type != "cpu":
            raise CheckpointError(f"cannot checkpoint a tensor on {t.device}")
        out = torch.empty(t.shape, dtype=t.dtype)
        out.copy_(t)
        return out

    def seal(self) -> None:
        """Record, on each card's current stream, the event after which the
        copies are in host memory."""
        for dev in self.devices:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            self.events.append(ev)

    def arrays(self) -> Dict[str, np.ndarray]:
        """The payload as storable numpy arrays, once the copies are done
        (on the writer's thread)."""
        for ev in self.events:
            ev.synchronize()
        return {k: v if isinstance(v, np.ndarray) else
                fmt.tensor_storage(v)[0] for k, v in self.payload.items()}


def _storage_dtype(value) -> str:
    if isinstance(value, (torch.Tensor, Shard)):
        return fmt.dtype_name(value.dtype)
    dt = value.dtype if hasattr(value, "dtype") else np.asarray(value).dtype
    return fmt.storage_view(np.empty((), dt))[1]


class ShardedCheckpointer:
    """Durable (step → tree) checkpoint store with async saves:
    ``save``/``restore``/``restore_latest``/``latest_step``/``close``, as
    the JAX package's.

    Usage::

        ckpt = ShardedCheckpointer("/ckpt/run1")
        ckpt.save(step, {"model": model_state(model),
                         "optim": optimizer_state(opt, model)})
        ...
        state = ckpt.restore_latest(like=state)   # onto the CURRENT layout

    The knobs ``HVD_TPU_CHECKPOINT_MAX_TO_KEEP`` (3),
    ``HVD_TPU_CHECKPOINT_COMMIT_TIMEOUT_S`` (120) and
    ``HVD_TPU_CHECKPOINT_INFLIGHT`` (2) are read when the store is made
    (:class:`~horovod_tpu_torch.common.config.Config`).
    """

    def __init__(self, directory: str,
                 max_to_keep: Optional[int] = None,
                 max_inflight: Optional[int] = None,
                 commit_timeout_s: Optional[float] = None,
                 rank: Optional[int] = None,
                 world_size: Optional[int] = None) -> None:
        knobs = Config.from_env()
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._max_to_keep = knobs.checkpoint_max_to_keep \
            if max_to_keep is None else int(max_to_keep)
        self._commit_timeout = knobs.checkpoint_commit_timeout_s \
            if commit_timeout_s is None else float(commit_timeout_s)
        self._rank = _default_rank() if rank is None else int(rank)
        self._world = _default_world() if world_size is None else \
            max(1, int(world_size))
        self._lock = threading.Lock()
        self._inflight_steps: set = set()
        inflight = knobs.checkpoint_inflight if max_inflight is None \
            else int(max_inflight)
        self._writer = AsyncWriter(max_inflight=inflight,
                                   on_inflight=ckpt_metrics.set_inflight)
        #: seconds the last ``save`` held its caller (the snapshot queued,
        #: backpressure, a waited commit), and the last restore's
        self.last_stall_s = 0.0
        self.last_restore_s = 0.0

    @property
    def directory(self) -> str:
        return self._dir

    # ------------------------------------------------------------- save

    def save(self, step: int, state: Any, wait: bool = False) -> None:
        """Take the cut of ``state`` NOW and write it in the background;
        ``wait=True`` blocks until this rank's shard is durable — and, on
        rank 0, until the checkpoint is committed."""
        step = int(step)
        with self._lock:
            if step in self._inflight_steps:
                raise CheckpointError(f"step {step} is already being saved")
            if os.path.isdir(fmt.step_dir(self._dir, step)):
                raise CheckpointError(
                    f"step {step} already committed under {self._dir}")
            self._inflight_steps.add(step)
        tmp = fmt.tmp_dir(self._dir, step)
        if self._rank == 0 and os.path.isdir(tmp):
            # a tmp dir for this step means a crashed earlier attempt:
            # its shard markers must NOT satisfy the commit barrier
            fmt.remove_tree(tmp)
        t_inline = time.monotonic()
        try:
            # a free writer slot first, then the cut: a save under
            # backpressure holds no pinned copy while it waits
            self._writer.wait_for_slot()
            plan = self._snapshot(state)
        except BaseException:
            with self._lock:
                self._inflight_steps.discard(step)
            raise
        record_event("ckpt_save", step=step, rank=self._rank)
        job = self._make_job(step, plan, uuid.uuid4().hex)
        try:
            self._writer.submit(job)
        except BaseException:
            with self._lock:
                self._inflight_steps.discard(step)
            raise
        if wait:
            self.wait()
        # goodput ledger: only the slice that BLOCKED the caller counts as
        # checkpoint_stall (the cut queued, backpressure, a waited commit);
        # the background write overlaps training and stays out of it
        self.last_stall_s = time.monotonic() - t_inline
        from horovod_tpu_torch.metrics import goodput
        goodput.note_checkpoint_stall(self.last_stall_s)

    def wait(self) -> None:
        """Drain queued saves; re-raises the first background failure."""
        self._writer.wait()

    def check_error(self) -> None:
        """Re-raise (and clear) a pending background-save failure without
        waiting for in-flight saves."""
        self._writer.check()

    wait_until_finished = wait

    def close(self, wait: bool = True) -> None:
        """``wait=False`` abandons queued saves (in-flight commits are
        nonce-protected; their tmp dirs fall to GC)."""
        self._writer.close(wait=wait)

    def _snapshot(self, state: Any) -> _Plan:
        plan = _Plan()
        for li, (path, value) in enumerate(flatten_with_path(state)):
            rec = {"path": keystr(path), "parts": path_parts(path)}
            # arrays/np scalars FIRST: np.float64 subclasses python float,
            # and the inline branch would strip its dtype
            if isinstance(value, Shard):
                self._plan_shard(plan, li, rec, value)
            elif isinstance(value, (torch.Tensor, np.ndarray, np.generic)):
                self._plan_replicated(plan, li, rec, value)
            elif isinstance(value, bool):
                rec.update(kind="bool", value=value)
            elif isinstance(value, int):
                rec.update(kind="int", value=value)
            elif isinstance(value, float):
                rec.update(kind="float", value=value)
            elif isinstance(value, str):
                rec.update(kind="str", value=value)
            else:
                self._plan_pickle(plan, li, rec, value)
            plan.leaves.append(rec)
        plan.seal()
        return plan

    def _plan_shard(self, plan: _Plan, li: int, rec: dict,
                    value: Shard) -> None:
        """A block of a leaf split over a mesh: its owner writes it, at its
        index in the global shape (the JAX ``replica_id == 0`` shard)."""
        rec.update(kind="array", shape=[int(d) for d in value.global_shape],
                   dtype=_storage_dtype(value), scalar=False)
        if value.owner:
            plan.add_entry(li, [list(map(int, ix)) for ix in value.index],
                           plan.host_copy(value.local))

    def _plan_replicated(self, plan: _Plan, li: int, rec: dict,
                         value: Any) -> None:
        """Replicated tensor or array: rank r owns the r-th contiguous
        axis-0 slice (rank 0 owns 0-d and empty ones whole). The slice is
        taken before the copy to the host, so each rank moves ~1/W of the
        bytes."""
        scalar = isinstance(value, np.generic)
        shape = tuple(int(d) for d in value.shape) \
            if isinstance(value, torch.Tensor) else \
            tuple(int(d) for d in np.shape(value))
        rec.update(kind="array", shape=list(shape),
                   dtype=_storage_dtype(value), scalar=scalar)
        if self._world == 1 or len(shape) == 0 or shape[0] == 0:
            if self._rank == 0:
                plan.add_entry(li, _full_index(shape),
                               self._host(plan, value))
            return
        start, stop = fmt.shard_bounds(shape[0], self._world)[self._rank]
        if stop > start:
            plan.add_entry(li, [[start, stop]] + _full_index(shape[1:]),
                           self._host(plan, value[start:stop]))

    @staticmethod
    def _host(plan: _Plan, value):
        if isinstance(value, torch.Tensor):
            return plan.host_copy(value)
        return fmt.storage_view(np.array(value, copy=True))[0]

    def _plan_pickle(self, plan: _Plan, li: int, rec: dict,
                     value: Any) -> None:
        payload = pickle.dumps(value)
        rec.update(kind="pickle", shape=[len(payload)], dtype="uint8",
                   scalar=False)
        if self._rank == 0:
            plan.add_entry(li, [[0, len(payload)]],
                           np.frombuffer(payload, np.uint8))

    def _make_job(self, step: int, plan: _Plan, nonce: str):
        def job() -> None:
            t0 = time.monotonic()
            tmp = fmt.tmp_dir(self._dir, step)
            try:
                if self._rank == 0:
                    fmt.open_attempt(tmp, nonce)
                else:
                    nonce_seen = self._await_attempt(step, tmp)
                fmt.write_shard(tmp, self._rank, plan.arrays(), plan.entries,
                                attempt=nonce if self._rank == 0
                                else nonce_seen)
                if self._rank == 0:
                    self._commit(step, plan, tmp, nonce)
            except BaseException:
                ckpt_metrics.record_failure()
                raise
            finally:
                with self._lock:
                    self._inflight_steps.discard(step)
            ckpt_metrics.record_save(plan.nbytes, time.monotonic() - t0,
                                     step)
            if self._rank == 0:
                try:
                    self.gc()
                except OSError:
                    pass  # GC is advisory; never fail a commit over it

        return job

    def _await_attempt(self, step: int, tmp: str) -> str:
        """Non-zero ranks write only into an attempt rank 0 has opened —
        the nonce handshake is what makes a crashed generation's leftovers
        inert."""
        deadline = time.monotonic() + self._commit_timeout
        while True:
            nonce = fmt.read_attempt(tmp)
            if nonce is not None:
                return nonce
            if time.monotonic() >= deadline:
                raise CheckpointError(
                    f"rank {self._rank}: no attempt token from rank 0 "
                    f"for step {step} after {self._commit_timeout:.0f}s")
            time.sleep(0.05)

    def _commit(self, step: int, plan: _Plan, tmp: str,
                nonce: str) -> None:
        """Rank 0's phase 2: wait for every rank's shard marker FROM THIS
        ATTEMPT, then manifest + atomic rename. On timeout the tmp dir is
        LEFT IN PLACE — a peer may still be writing; GC reclaims it once
        idle."""
        deadline = time.monotonic() + self._commit_timeout
        metas: Dict[int, dict] = {}
        while True:
            for r in range(self._world):
                if r not in metas:
                    meta = fmt.read_shard_meta(tmp, r)
                    if meta is not None and meta.get("attempt") == nonce:
                        metas[r] = meta
            if len(metas) == self._world:
                break
            if time.monotonic() >= deadline:
                missing = sorted(set(range(self._world)) - set(metas))
                raise CheckpointError(
                    f"commit of step {step} timed out after "
                    f"{self._commit_timeout:.0f}s waiting for shard "
                    f"markers from ranks {missing}; leaving {tmp} for GC")
            time.sleep(0.05)
        leaves = []
        for rec in plan.leaves:
            rec = dict(rec)
            if rec["kind"] not in _INLINE_KINDS:
                rec["shards"] = []
            leaves.append(rec)
        files = {}
        for r, meta in sorted(metas.items()):
            files[fmt.shard_npz(r)] = meta["sha256"]
            for e in meta["entries"]:
                leaves[e["leaf"]]["shards"].append(
                    {"rank": r, "key": e["key"], "index": e["index"]})
        manifest = {"version": fmt.SPEC_VERSION, "step": step,
                    "world_size": self._world, "created": time.time(),
                    "treedef": None, "files": files, "leaves": leaves}
        fmt.commit(self._dir, step, manifest)
        record_event("ckpt_commit", step=step, world=self._world)
        _notify_progress()

    # ---------------------------------------------------------- restore

    def latest_step(self) -> Optional[int]:
        steps = fmt.list_steps(self._dir)
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return fmt.list_steps(self._dir)

    def restore_latest(self, like: Any = None,
                       return_step: bool = False) -> Any:
        """Restore the newest committed step, falling back to the next
        older commit when the newest fails verification (sha256 mismatch,
        missing shard, corrupt manifest), counted loudly
        (``hvd_checkpoint_restore_fallback_total``, an error log and a
        ``ckpt_restore_fallback`` flight event per skipped step).
        ``return_step=True`` returns ``(step, state)``: the step actually
        restored, older than ``latest_step()`` after a fallback."""
        steps = fmt.list_steps(self._dir)
        if not steps:
            self._warn_if_foreign_layout()
            return (None, None) if return_step else None
        for i, step in enumerate(reversed(steps)):
            try:
                state = self.restore(step, like)
                return (step, state) if return_step else state
            except CheckpointError as e:
                if i == len(steps) - 1:
                    raise  # the oldest commit: nothing left to fall to
                older = steps[len(steps) - 2 - i]
                ckpt_metrics.record_restore_fallback()
                get_logger().error(
                    "checkpoint step %d under %s failed verification "
                    "(%s); FALLING BACK to older committed step %d — "
                    "training resumes with the steps in between lost",
                    step, self._dir, e, older)
                record_event("ckpt_restore_fallback", step=step,
                             fallback_step=older, error=str(e)[:200])
        return None  # unreachable; the loop raises or returns

    def _warn_if_foreign_layout(self) -> None:
        """Nothing restorable, but the directory holds plain numeric step
        dirs (another store's layout): say so rather than restart from
        scratch silently."""
        try:
            foreign = [n for n in os.listdir(self._dir)
                       if n.isdigit() and
                       os.path.isdir(os.path.join(self._dir, n))]
        except OSError:
            return
        if foreign:
            get_logger().warning(
                "checkpoint dir %s holds no native checkpoints but has "
                "step dirs %s in another layout: the native store cannot "
                "read them — point the store at a fresh directory",
                self._dir, sorted(foreign)[:4])

    def restore(self, step: int, like: Any = None) -> Any:
        """Reassemble global state from the manifest's shard map. With
        ``like``, each leaf is placed where the like leaf lives (a tensor
        on its device in the stored dtype; a :class:`Shard` as the current
        layout's block of it; ``None`` stays ``None``). Without, the tree
        is rebuilt from the recorded ``parts``, array leaves as CPU
        tensors."""
        t0 = time.monotonic()
        step = int(step)
        manifest = fmt.read_manifest(self._dir, step)
        sdir = fmt.step_dir(self._dir, step)
        cache: Dict[int, Any] = {}
        nbytes = [0]

        def rank_payload(r: int):
            if r not in cache:
                name = fmt.shard_npz(r)
                path = os.path.join(sdir, name)
                try:
                    with open(path, "rb") as f:
                        data = f.read()
                except OSError as e:
                    raise CheckpointError(
                        f"missing shard file {path} for committed step "
                        f"{step}") from e
                expect = manifest.get("files", {}).get(name)
                got = hashlib.sha256(data).hexdigest()
                if expect is not None and got != expect:
                    raise CheckpointError(
                        f"sha256 mismatch for {path}: manifest "
                        f"{expect[:12]}…, file {got[:12]}…")
                nbytes[0] += len(data)
                cache[r] = np.load(io.BytesIO(data), allow_pickle=False)
            return cache[r]

        values = [self._restore_leaf(rec, rank_payload, step)
                  for rec in manifest["leaves"]]
        out = self._rebuild(manifest, values, like, step)
        ckpt_metrics.record_restore(nbytes[0], time.monotonic() - t0, step)
        record_event("ckpt_restore", step=step, bytes=nbytes[0])
        _notify_progress()
        self.last_restore_s = time.monotonic() - t0
        from horovod_tpu_torch.metrics import goodput
        goodput.note_checkpoint_stall(self.last_restore_s)
        return out

    def _restore_leaf(self, rec: dict, rank_payload, step: int) -> Any:
        kind = rec["kind"]
        if kind in _INLINE_KINDS:
            return {"bool": bool, "int": int, "float": float,
                    "str": str}[kind](rec["value"])
        shards = rec.get("shards", [])
        if kind == "pickle":
            if len(shards) != 1:
                raise CheckpointError(
                    f"step {step}: pickled leaf {rec['path']!r} has "
                    f"{len(shards)} shards, expected 1")
            s = shards[0]
            raw = np.asarray(rank_payload(s["rank"])[s["key"]])
            return pickle.loads(raw.tobytes())
        if kind != "array":
            raise CheckpointError(
                f"step {step}: unknown leaf kind {kind!r} for "
                f"{rec['path']!r}")
        shape = tuple(int(d) for d in rec["shape"])
        expect = int(np.prod(shape)) if shape else 1
        out, covered = None, 0
        for s in shards:
            data = fmt.to_tensor(np.asarray(rank_payload(s["rank"])[s["key"]]),
                                 rec["dtype"])
            if shape == () or s["index"] == _full_index(shape):
                out, covered = data.reshape(shape), expect
                continue
            if out is None:
                out = torch.empty(shape, dtype=data.dtype)
            out[fmt.index_slices(s["index"])] = data
            covered += int(np.prod([e - b for b, e in s["index"]]))
        if covered < expect:
            raise CheckpointError(
                f"step {step}: leaf {rec['path']!r} is missing shards "
                f"({covered}/{expect} elements present)")
        if out is None:      # an empty leaf
            out = torch.empty(shape, dtype=fmt.torch_dtype(rec["dtype"]))
        if rec.get("scalar") and rec["dtype"] in fmt._NATIVE_DTYPES:
            return out.numpy()[()]
        return out

    def _rebuild(self, manifest: dict, values: List[Any], like: Any,
                 step: int) -> Any:
        if like is None:
            return _rebuild_from_parts(
                [(rec["parts"], v)
                 for rec, v in zip(manifest["leaves"], values)])
        # match by the serialized parts, as the JAX store does
        by_path = {json.dumps(rec["parts"]): v
                   for rec, v in zip(manifest["leaves"], values)}

        def place(path, like_leaf):
            key = json.dumps(path_parts(path))
            if key not in by_path:
                stored = [r["path"] for r in manifest["leaves"][:8]]
                raise CheckpointError(
                    f"step {step} has no value for {keystr(path)} "
                    f"(checkpoint holds: {stored}…)")
            return _place(by_path[key], like_leaf, keystr(path), step)

        return map_with_path(place, like)

    # --------------------------------------------------------------- gc

    def gc(self, tmp_ttl: Optional[float] = None) -> None:
        """Reclaim old committed steps beyond ``max_to_keep`` and abandoned
        tmp dirs. A tmp dir is abandoned when its step is already
        committed, or when nothing inside it has been touched for
        ``tmp_ttl`` seconds (default: the commit timeout)."""
        ttl = self._commit_timeout if tmp_ttl is None else float(tmp_ttl)
        steps = fmt.list_steps(self._dir)
        if self._max_to_keep > 0 and len(steps) > self._max_to_keep:
            for s in steps[:-self._max_to_keep]:
                fmt.remove_tree(fmt.step_dir(self._dir, s))
        now = time.time()
        with self._lock:
            inflight = set(self._inflight_steps)
        stale = list(fmt.list_tmp_steps(self._dir)) + \
            list(fmt.list_broken_steps(self._dir))
        for step, path in stale:
            if step in inflight:
                continue
            committed = os.path.isfile(os.path.join(
                fmt.step_dir(self._dir, step), fmt.MANIFEST))
            if committed or now - fmt.newest_mtime(path) >= ttl:
                fmt.remove_tree(path)
                get_logger().info("checkpoint gc: removed abandoned %s",
                                  path)


def _place(value: Any, like_leaf: Any, where: str, step: int) -> Any:
    """Put a restored leaf where ``like``'s leaf says it lives: a
    :class:`Shard` gets its block, on its device; a tensor the whole value
    on its device; a numpy array a numpy array; anything else the value as
    restored. The stored dtype is kept."""
    if isinstance(value, np.generic) and \
            isinstance(like_leaf, (torch.Tensor, Shard)):
        value = torch.from_numpy(np.asarray(value))
    if not isinstance(value, torch.Tensor):
        return value
    if isinstance(like_leaf, Shard):
        if tuple(value.shape) != tuple(like_leaf.global_shape):
            raise CheckpointError(
                f"step {step}: {where} is stored as {tuple(value.shape)}; "
                f"the current layout's leaf is {like_leaf.global_shape}")
        block = value[fmt.index_slices(like_leaf.index)]
        return block.to(like_leaf.local.device).contiguous()
    if isinstance(like_leaf, torch.Tensor):
        return value.to(like_leaf.device)
    if isinstance(like_leaf, (np.ndarray, np.generic)) and \
            fmt.dtype_name(value.dtype) in fmt._NATIVE_DTYPES:
        return value.numpy()
    return value


def _rebuild_from_parts(records: List[Tuple[List[dict], Any]]) -> Any:
    """``like``-less fallback: rebuild nesting from the recorded key
    paths. Dicts/attrs become dicts, sequences become lists."""
    if len(records) == 1 and not records[0][0]:
        return records[0][1]
    groups: Dict[Any, List[Tuple[List[dict], Any]]] = {}
    seq = True
    for parts, v in records:
        head, rest = parts[0], parts[1:]
        if "i" not in head:
            seq = False
        key = head.get("k", head.get("a", head.get("i")))
        groups.setdefault(key, []).append((rest, v))
    children = {k: _rebuild_from_parts(g) for k, g in groups.items()}
    if seq and all(isinstance(k, int) for k in children):
        size = max(children) + 1
        return [children.get(i) for i in range(size)]
    return children
