"""Control-plane journal: the elastic driver's write-ahead log.

The driver (:mod:`horovod_tpu_torch.runner.elastic.driver`) holds the job's
entire control state in one process's memory — generation counters, the
signed world doc, blocklist/drain evidence, handled-notice dedupe.  This
module makes that state crash-durable so "driver restart is not a job
restart" (docs/ELASTIC.md "Driver failover & takeover"): every
state-changing decision is appended here, fsync'd, **before** the
corresponding KV publish.  That ordering is the whole safety argument —
the journal is always at least as new as anything the fleet has seen, so
replay can complete an interrupted publish but can never resurrect a
world the fleet already moved past.

Format: one JSON object per line, with ``"t"`` (the record type) as the
FIRST key so even a torn tail's prefix reveals what was being written.
A torn tail (partial last line — the write raced the crash) is normally
dropped; the one exception is a torn ``world_publish``: we cannot know
whether the fleet saw that world, so :meth:`ReplayState.check_takeover`
refuses takeover and points the operator at the backstop generation
restart instead.

Rotation is atomic à la the OBS/reqlog readers: the compacted journal is
written to a sibling ``.new`` file, fsync'd, then ``os.replace``d over
the live path — a reader (or a crash) sees either the old file or the
new one, never a mix, and the newest generation's records survive the
compaction verbatim.

Replay is a pure fold (:func:`replay`): record order in, state dict out,
no I/O, no clocks.  Every fold step uses set/last-wins semantics so
replaying a journal twice yields the same state as once, and an unknown
record type is skipped LOUDLY (warning + counter) — a newer driver's
journal must degrade, not explode, under an older one's replay.

A copy of ``horovod_tpu/runner/elastic/journal.py``: the same record
format, so either package's driver can replay the other's journal.
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from horovod_tpu_torch.common.config import env_int, env_str
from horovod_tpu_torch.common.logging import get_logger

JOURNAL_NAME = "driver_journal.jsonl"

#: record types this reader understands (order matters nowhere; the set
#: exists so replay can tell "unknown" from "known" explicitly)
RECORD_TYPES = frozenset({
    "job_open",        # identity: secret, kv port, ckpt dir, np bounds
    "world_publish",   # full signed doc + the post-publish gen runtime
    "spawn",           # worker process started: (gen, rank) -> host/pid
    "exit",            # worker exit classified: (gen, rank) -> state
    "blocklist",       # host blocklisted, with evidence + wall stamp
    "drain",           # host drained (slots, cooldown, wall stamp)
    "undrain",         # drain lifted early
    "token",           # drain-notice/action token handled (dedupe)
    "notify",          # worker listener registration observed: rank -> addr
    "reset",           # registry reset budget: absolute count
    "takeover",        # a takeover driver adopted this journal
    "clean_exit",      # the driver returned normally (rc) — not a crash
})


def journal_dir() -> Optional[str]:
    """``HVD_TPU_DRIVER_JOURNAL_DIR``: where the driver journals; unset
    (the default) disables journaling and takeover entirely."""
    return env_str("DRIVER_JOURNAL_DIR") or None


def journal_max_bytes() -> int:
    """``HVD_TPU_DRIVER_JOURNAL_MAX_BYTES`` (default 4 MiB): compaction
    threshold, checked at world-publish boundaries."""
    return env_int("DRIVER_JOURNAL_MAX_BYTES", 4 * 1024 * 1024)


class TakeoverRefused(RuntimeError):
    """The journal cannot prove what the fleet saw; takeover would risk
    publishing a stale world.  The safe exit is the existing backstop:
    restart the generation (workers re-rendezvous from the last elastic
    checkpoint — docs/ELASTIC.md "Generation-restart backstop")."""


def _dumps(rtype: str, fields: Dict[str, Any]) -> str:
    # "t" first, by construction: dicts preserve insertion order and
    # json.dumps emits in that order unless sort_keys is set
    rec = {"t": rtype}
    rec.update(fields)
    return json.dumps(rec, default=_json_default)


def _json_default(o):
    if isinstance(o, (set, frozenset)):
        return sorted(o)
    if isinstance(o, bytes):
        return o.hex()
    return str(o)


def _key(k) -> list:
    """(gen, rank) tuples JSON-ify as lists; keep them that way on the
    wire and convert back at fold time."""
    return list(k)


def _untuple(k) -> tuple:
    return tuple(k)


def _metrics_update(path: str, records: int) -> None:
    try:
        from horovod_tpu_torch.metrics.registry import default_registry
        reg = default_registry()
        try:
            size = os.path.getsize(path)
        except OSError:
            size = 0
        reg.gauge("hvd_driver_journal_bytes",
                  help="size of the driver control-plane journal").set(
                      size)
        reg.gauge("hvd_driver_journal_records",
                  help="records appended to the driver journal this "
                       "incarnation").set(records)
    except Exception:
        pass


class DriverJournal:
    """Append-only, fsync'd writer.  One instance per driver
    incarnation; a takeover driver opens the SAME path in append mode
    and keeps writing — the journal spans incarnations by design."""

    def __init__(self, directory: str, name: str = JOURNAL_NAME) -> None:
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, name)
        self._lock = threading.Lock()
        self._records = 0
        self._fh: Optional[io.TextIOWrapper] = open(
            self.path, "a", encoding="utf-8")

    # -- writing ---------------------------------------------------------
    def append(self, rtype: str, **fields) -> None:
        """Durably append one record: write, flush, fsync.  Raises on
        I/O failure — a driver that cannot journal must not keep making
        decisions it cannot replay."""
        line = _dumps(rtype, fields)
        with self._lock:
            fh = self._fh
            if fh is None:
                raise RuntimeError("journal is closed")
            fh.write(line + "\n")
            fh.flush()
            os.fsync(fh.fileno())
            self._records += 1
        _metrics_update(self.path, self._records)

    def maybe_compact(self, max_bytes: Optional[int] = None) -> bool:
        """At a world-publish boundary: if the file outgrew the
        threshold, rewrite it as the minimal record set that replays to
        the same state (atomic ``.new`` + ``os.replace``).  Returns
        whether a compaction happened."""
        limit = journal_max_bytes() if max_bytes is None else max_bytes
        with self._lock:
            try:
                if os.path.getsize(self.path) <= limit:
                    return False
            except OSError:
                return False
            records, torn = read_journal(self.path)
            state = replay(records, torn)
            new_path = self.path + ".new"
            with open(new_path, "w", encoding="utf-8") as out:
                for rec in state.canonical_records():
                    out.write(json.dumps(rec, default=_json_default)
                              + "\n")
                out.flush()
                os.fsync(out.fileno())
            # close-then-replace: the live handle must not keep
            # appending to the orphaned inode
            if self._fh is not None:
                self._fh.close()
            os.replace(new_path, self.path)
            self._fh = open(self.path, "a", encoding="utf-8")
        get_logger().info("driver journal compacted (%s)", self.path)
        _metrics_update(self.path, self._records)
        return True

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.flush()
                    os.fsync(self._fh.fileno())
                except OSError:
                    pass
                self._fh.close()
                self._fh = None


# -- reading -----------------------------------------------------------------
def read_journal(path: str) -> Tuple[List[dict], Optional[str]]:
    """Parse the journal into ``(records, torn_tail)``.

    ``torn_tail`` is the raw prefix of a partial last line (no trailing
    newline — the append raced a crash), or None when the file ends
    cleanly.  A complete mid-file line that fails to parse is skipped
    loudly: corruption, not a torn write, and dropping one record is
    recoverable where refusing the whole journal is not."""
    log = get_logger()
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except FileNotFoundError:
        return [], None
    torn: Optional[str] = None
    chunks = raw.split(b"\n")
    if chunks and chunks[-1] != b"":
        torn = chunks[-1].decode("utf-8", errors="replace")
        chunks = chunks[:-1]
    records: List[dict] = []
    for i, chunk in enumerate(chunks):
        if not chunk:
            continue
        try:
            rec = json.loads(chunk)
            if not isinstance(rec, dict) or "t" not in rec:
                raise ValueError("not a journal record")
        except ValueError as e:
            log.warning("driver journal %s line %d unreadable (%r); "
                        "skipping", path, i + 1, e)
            continue
        records.append(rec)
    if torn is not None:
        log.warning("driver journal %s has a torn tail (%d bytes, "
                    "prefix %r)", path, len(torn), torn[:48])
    return records, torn


def torn_tail_type(torn: Optional[str]) -> Optional[str]:
    """Best-effort record type of a torn tail, from the type-first key
    ordering the writer guarantees."""
    if not torn:
        return None
    for rtype in RECORD_TYPES:
        if torn.startswith('{"t": "%s"' % rtype) or \
                torn.startswith('{"t":"%s"' % rtype):
            return rtype
    return None


class ReplayState:
    """The fold result: everything a takeover driver needs to become
    the driver.  Pure data — restoring it into live objects is the
    driver's job (:meth:`ElasticDriver.takeover_from_journal`)."""

    def __init__(self) -> None:
        self.meta: Dict[str, Any] = {}        # last job_open
        self.world: Optional[dict] = None     # last world_publish
        self.live: Dict[tuple, dict] = {}     # (gen, rank) -> spawn rec
        self.exits: Dict[tuple, dict] = {}    # (gen, rank) -> exit rec
        self.blocklist: Dict[str, dict] = {}  # host -> evidence rec
        self.drains: Dict[str, dict] = {}     # host -> drain rec
        self.tokens: set = set()              # (scope, key, raw)
        self.notify: Dict[str, dict] = {}     # rank -> notify rec
        self.reset_count = 0
        self.takeovers: set = set()           # (pid, ts) markers
        self.clean_exit: Optional[int] = None
        self.unknown = 0
        self.torn_tail: Optional[str] = None

    # -- the fold --------------------------------------------------------
    def fold(self, rec: dict) -> None:
        t = rec.get("t")
        if t == "job_open":
            self.meta = dict(rec)
            # a new job_open supersedes everything before it: same
            # journal path reused for a fresh job
            self.world = None
            self.live.clear()
            self.exits.clear()
            self.blocklist.clear()
            self.drains.clear()
            self.tokens.clear()
            self.notify.clear()
            self.reset_count = 0
            self.clean_exit = None
        elif t == "world_publish":
            self.world = dict(rec)
            # listener registrations are per numbering window: the
            # driver clears the ``notify`` scope at every publish and
            # workers re-register at their first commit in the new
            # world, so replay forgets them the same way
            self.notify.clear()
            self.clean_exit = None
        elif t == "spawn":
            key = _untuple(rec["key"])
            self.live[key] = dict(rec)
            self.exits.pop(key, None)
        elif t == "exit":
            key = _untuple(rec["key"])
            self.exits[key] = dict(rec)
            self.live.pop(key, None)
        elif t == "blocklist":
            self.blocklist[rec["host"]] = dict(rec)
        elif t == "drain":
            self.drains[rec["host"]] = dict(rec)
        elif t == "undrain":
            self.drains.pop(rec.get("host"), None)
        elif t == "token":
            self.tokens.add((rec["scope"], rec["key"],
                             rec.get("raw", "")))
        elif t == "notify":
            self.notify[str(rec["rank"])] = dict(rec)
        elif t == "reset":
            self.reset_count = int(rec.get("count", 0))
        elif t == "takeover":
            self.takeovers.add((rec.get("pid"), rec.get("ts")))
        elif t == "clean_exit":
            self.clean_exit = int(rec.get("rc", 0))
        else:
            self.unknown += 1
            get_logger().warning(
                "driver journal: unknown record type %r skipped "
                "(fields: %s) — written by a newer driver?", t,
                sorted(rec.keys()))
            try:
                from horovod_tpu_torch.metrics.registry import \
                    default_registry
                default_registry().counter(
                    "hvd_driver_journal_unknown_total",
                    help="journal records skipped on replay because "
                         "their type is unknown").inc()
            except Exception:
                pass

    # -- queries ---------------------------------------------------------
    @property
    def world_gen(self) -> int:
        return int((self.world or {}).get("world_gen", 0))

    @property
    def numbering_gen(self) -> int:
        return int((self.world or {}).get("numbering_gen", 0))

    def live_workers(self) -> Dict[tuple, dict]:
        """Spawned-but-not-exited workers of the LAST published world's
        numbering window — the set the takeover driver must adopt."""
        lo, hi = self.numbering_gen, self.world_gen
        return {k: v for k, v in self.live.items()
                if lo <= k[0] <= hi}

    def check_takeover(self) -> None:
        """Raise :class:`TakeoverRefused` when replay cannot produce a
        world the fleet provably saw."""
        tail_type = torn_tail_type(self.torn_tail)
        if tail_type == "world_publish":
            raise TakeoverRefused(
                "journal ends in a half-written world_publish: the KV "
                "publish may or may not have reached the fleet, so a "
                "replayed world could be one generation stale. Refusing "
                "takeover — restart the job and let the generation-"
                "restart backstop re-rendezvous workers from the last "
                "elastic checkpoint (docs/ELASTIC.md).")
        if self.world is None:
            raise TakeoverRefused(
                "journal holds no committed world_publish record: "
                "nothing to take over. Start the job normally (the "
                "generation-restart backstop applies if workers are "
                "still running).")
        if self.clean_exit is not None:
            raise TakeoverRefused(
                "journal ends in clean_exit rc=%d: the previous driver "
                "finished on purpose; there is nothing to take over."
                % self.clean_exit)

    def canonical_records(self) -> List[dict]:
        """Minimal record list that folds back to this state — the
        compaction payload.  The newest world's records are re-emitted
        verbatim so the live generation's history survives rotation."""
        out: List[dict] = []
        if self.meta:
            out.append(self.meta)
        for host in sorted(self.blocklist):
            out.append(self.blocklist[host])
        for host in sorted(self.drains):
            out.append(self.drains[host])
        for scope, key, raw in sorted(self.tokens):
            out.append({"t": "token", "scope": scope, "key": key,
                        "raw": raw})
        out.append({"t": "reset", "count": self.reset_count})
        for pid, ts in sorted(self.takeovers,
                              key=lambda p: (p[1] or 0, p[0] or 0)):
            out.append({"t": "takeover", "pid": pid, "ts": ts})
        if self.world is not None:
            out.append(self.world)
        # after the world record: fold() forgets registrations at every
        # world_publish, so emitting them first would lose them
        for rank in sorted(self.notify):
            out.append(self.notify[rank])
        for key in sorted(self.exits):
            rec = self.exits[key]
            if self.world is not None and \
                    key[0] < self.numbering_gen:
                continue  # pre-window history: replay would ignore it
            out.append(rec)
        for key in sorted(self.live):
            out.append(self.live[key])
        if self.clean_exit is not None:
            out.append({"t": "clean_exit", "rc": self.clean_exit})
        return out


def replay(records: List[dict],
           torn: Optional[str] = None) -> ReplayState:
    """Pure fold: records in, :class:`ReplayState` out.  Feeding the
    same journal twice (or the concatenation of a journal with itself)
    yields the same state — every fold step is last-wins or set-add."""
    state = ReplayState()
    for rec in records:
        state.fold(rec)
    state.torn_tail = torn
    try:
        from horovod_tpu_torch.metrics.registry import default_registry
        default_registry().counter(
            "hvd_driver_journal_replayed_total",
            help="journal records folded during takeover replay").inc(
                len(records))
    except Exception:
        pass
    return state


def load(path: str) -> ReplayState:
    """read + replay in one step (what ``--takeover`` calls)."""
    records, torn = read_journal(path)
    return replay(records, torn)


def now_wall() -> float:
    """Wall time for journal stamps.  Monotonic stamps are meaningless
    across processes, so records carry wall time and restore re-ages:
    ``remaining = cooldown - (now_wall - stamp_wall)``."""
    return time.time()
