"""The generative decode engine: ONE fixed-shape decode step over a static
slot array, fed by continuous token-level batching.

Mirrors ``horovod_tpu/serving/generate/engine.py``. The request-level
serving loop (replica.py) answers a whole request per forward;
autoregressive decode breaks that granularity — sequences finish at
different times, and a request-level batch strands device time on every
early finisher. This engine decodes at TOKEN granularity:

* a static array of ``HVD_TPU_GEN_SLOTS`` decode slots; the step
  (:func:`~horovod_tpu_torch.models.transformer.decode_step_paged`)
  always runs over all of them, with an active mask — membership churn is
  host bookkeeping between steps and NEVER changes a shape;
* K/V history lives in the paged pool (:mod:`.pages`): admission
  allocates a request's WORST-CASE pages up front, eviction returns them
  the same step boundary the sequence leaves;
* prompts prefill in fixed ``HVD_TPU_PREFILL_CHUNK``-token chunks, one
  chunk per engine iteration per sequence, interleaved with live decode
  steps — a long prompt never stalls the decode batch;
* the admission edge is the SAME bounded
  :class:`~horovod_tpu_torch.serving.batcher.DynamicBatcher` contract as
  request-level serving (explicit 429 sheds, drain semantics), run with
  ``max_wait_s=0`` — the slot scheduler IS the batching.

The JAX engine jits its two step functions, and its one-compile contract
says each compiles once under any churn. Here the contract is one CUDA
graph capture per step function: on the card, ``gen_decode_step`` and
``gen_prefill_chunk`` are each captured once (at their first call, after
one warm-up run on a side stream) over static device buffers — the
weights, the K/V pools, and one int64 input buffer per function (page
table, lengths, last tokens and active mask; or the page row, the chunk's
tokens, ``pos0`` and ``valid``). A step writes its host mirrors (numpy
views of a pinned staging buffer) with one host-to-device copy, replays
the graph, and reads the next tokens back once: the one readback the
host scheduler needs, as the JAX engine's ``np.asarray(nxt)``. Each
capture is recorded through
:func:`horovod_tpu_torch.profiling.compile_watch.note_capture` under the
JAX function names. A capture that fails raises; nothing falls back to
eager mode on the card. On the CPU the same functions run eagerly.

A hot weight swap (:meth:`GenerateEngine.load_params`) never changes the
weights under a live sequence: slot admission holds while any slot is
live, the copy runs at the step boundary the last one leaves, and every
result names the weight version its tokens were decoded with.

Every request's path is traced (submit→admit→prefill→each decode
step→finish) and metered per phase (``hvd_serving_prefill/decode_
seconds_total``, slot occupancy, page pool, TTFT/ITL).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.common.config import env_int
from horovod_tpu_torch.serving import metrics as smetrics
from horovod_tpu_torch.serving.batcher import DeadlineError, DynamicBatcher
from horovod_tpu_torch.serving.generate.pages import PagePool, plan_kv_pages
from horovod_tpu_torch.serving.generate.scheduler import (DECODE, DONE,
                                                          PREFILL,
                                                          GenRequest,
                                                          SlotScheduler)


class _Step:
    """One step function over a static int64 input buffer: eager on the
    CPU; on the card captured in a CUDA graph at its first call and
    replayed after. ``host`` is the staging buffer the engine writes
    (pinned on the card), ``body(dev_in)`` the step, returning the next
    token(s) as a device tensor."""

    def __init__(self, name: str, body: Callable, n: int,
                 device: torch.device) -> None:
        self.name = name
        self.body = body
        self.device = device
        self.cuda = device.type == "cuda"
        self.host = torch.zeros(n, dtype=torch.int64, pin_memory=self.cuda)
        self.dev_in = torch.zeros(n, dtype=torch.int64, device=device) \
            if self.cuda else self.host
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._out: Optional[torch.Tensor] = None
        self._out_host: Optional[torch.Tensor] = None
        self.captures = 0

    def _capture(self) -> None:
        from horovod_tpu_torch.profiling import compile_watch
        t0 = time.perf_counter()
        # warm-up on a side stream (cuBLAS handles and workspaces are made
        # lazily, which a capture must not do). It runs the step on the
        # real inputs: a step rewrites the K/V it reads its history from
        # with the same values, so running it again in the replay is
        # harmless.
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.body(self.dev_in)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread_local: other threads of a serving process (HTTP handlers,
        # the weight swapper, a second engine) may use the card meanwhile
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = self.body(self.dev_in)
        self.graph, self._out = graph, out
        self._out_host = torch.empty(out.shape, dtype=out.dtype,
                                     pin_memory=True)
        self.captures += 1
        compile_watch.note_capture(self.name, time.perf_counter() - t0)

    def __call__(self, eager: bool = False) -> np.ndarray:
        """Run the step on the inputs in ``host``; the next token(s) as a
        numpy array. ``eager=True`` runs the same function without the
        graph (the card check of replay against eager)."""
        if not self.cuda:
            return self.body(self.dev_in).numpy()
        self.dev_in.copy_(self.host, non_blocking=True)
        if eager:
            return self.body(self.dev_in).cpu().numpy()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        self._out_host.copy_(self._out, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return self._out_host.numpy()


class _Swap:
    """A weight swap handed to the engine loop: (engine tensor, new
    weights) pairs, the version they carry, and the event set once the
    copy is done."""

    def __init__(self, pairs: list, version: int) -> None:
        self.pairs = pairs
        self.version = version
        self.done = threading.Event()


def _device_params(params: Any, device: torch.device) -> dict:
    """The engine's own fp32 copy of the flattened weights on ``device``:
    static storage that a CUDA graph reads and a hot swap overwrites in
    place."""
    from horovod_tpu_torch.models.transformer import flatten_decode_params
    flat = flatten_decode_params(params)

    def own(t):
        return t.to(device=device, dtype=torch.float32,
                    copy=True).contiguous()

    return {"embed": own(flat["embed"]), "ln_f": own(flat["ln_f"]),
            "layers": {k: own(v) for k, v in flat["layers"].items()}}


class GenerateEngine:
    """Continuous-batching decode engine over one model's weights.

    ``params``: a :class:`~horovod_tpu_torch.models.Transformer`, its
    ``state_dict`` or a JAX-layout parameter tree (numpy or torch);
    ``device=None`` runs on this process's card and raises when there is
    none — pass ``device="cpu"`` to run on the CPU.

    Thread model: :meth:`submit` runs on any thread (handler threads — it
    only touches the bounded admission queue); ALL slot/page/buffer
    mutation happens in :meth:`step_once`, called either by the background
    loop (:meth:`start`) or directly by tests and bench drivers for
    deterministic single-threaded stepping. :meth:`load_params` swaps the
    weights in place once no sequence is live.
    """

    def __init__(self, params: Any, cfg,
                 n_slots: Optional[int] = None,
                 page_bytes: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 device=None) -> None:
        from horovod_tpu_torch.models.transformer import kv_cache_spec
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.cfg = cfg
        self.n_slots = int(n_slots or env_int("GEN_SLOTS", 4))
        self.prefill_chunk = int(prefill_chunk
                                 or env_int("PREFILL_CHUNK", 16))
        n_layers, kv_width, kv_dtype = kv_cache_spec(cfg)
        self.plan = plan_kv_pages(n_layers, kv_width, kv_dtype,
                                  self.n_slots, cfg.max_seq, page_bytes)
        self.pool = PagePool(self.plan)
        self.scheduler = SlotScheduler(self.n_slots, self.pool,
                                       self.prefill_chunk, cfg.max_seq)
        # max_wait_s=0: the window must close instantly — the slot
        # scheduler is the batching, the queue is only admission control
        self.batcher = DynamicBatcher(max_batch_size=self.n_slots,
                                      max_wait_s=0.0)
        self.params = _device_params(params, self.device)
        # the version of the weights in ``params`` (the replica names it
        # through load_params); each request takes it at admission
        self.weight_version = 0
        shape = (n_layers, self.plan.total_pages + 1,
                 self.plan.page_tokens, kv_width)
        self._k_pages = torch.zeros(shape, dtype=kv_dtype,
                                    device=self.device)
        self._v_pages = torch.zeros(shape, dtype=kv_dtype,
                                    device=self.device)
        S, P, C = self.n_slots, self.plan.pages_per_slot, self.prefill_chunk
        self._decode_fn = _Step("gen_decode_step", self._decode_body,
                                S * P + 3 * S, self.device)
        self._prefill_fn = _Step("gen_prefill_chunk", self._prefill_body,
                                 P + C + 2, self.device)
        # host mirrors of the decode step's per-slot inputs: numpy views
        # of its staging buffer, so writing them stages the next step;
        # rows of the page table default to the scratch page id
        h = self._decode_fn.host.numpy()
        self._page_table = h[:S * P].reshape(S, P)
        self._lengths = h[S * P:S * P + S]
        self._last_token = h[S * P + S:S * P + 2 * S]
        self._active = h[S * P + 2 * S:]
        self._page_table[:] = self.plan.total_pages
        self.decode_steps_total = 0
        self.prefill_chunks_total = 0
        # one step at a time
        self._step_lock = threading.Lock()
        # a weight swap waiting for the live sequences to leave (set by
        # load_params, applied by step_once); one swap at a time
        self._swap: Optional[_Swap] = None
        self._swap_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- the two step functions ---------------------------------------------
    def _decode_body(self, buf: torch.Tensor) -> torch.Tensor:
        from horovod_tpu_torch.models.transformer import decode_step_paged
        S, P = self.n_slots, self.plan.pages_per_slot
        nxt, _, _ = decode_step_paged(
            self.params, self._k_pages, self._v_pages,
            buf[:S * P].view(S, P), buf[S * P:S * P + S],
            buf[S * P + S:S * P + 2 * S], buf[S * P + 2 * S:] != 0,
            self.cfg)
        return nxt

    def _prefill_body(self, buf: torch.Tensor) -> torch.Tensor:
        from horovod_tpu_torch.models.transformer import prefill_chunk_paged
        P, C = self.plan.pages_per_slot, self.prefill_chunk
        nxt, _, _ = prefill_chunk_paged(
            self.params, self._k_pages, self._v_pages, buf[:P],
            buf[P:P + C], buf[P + C], buf[P + C + 1], self.cfg)
        return nxt

    def decode_step_now(self, eager: bool = False) -> np.ndarray:
        """Run the decode step once on the current slot state and return
        the next token of every slot, without advancing any sequence (the
        K/V of the position it writes is rewritten with the same values by
        the real step). ``eager=True`` runs it without the CUDA graph: the
        card check of replay against eager."""
        with self._step_lock:
            return self._decode_fn(eager=eager).copy()

    @property
    def captures(self) -> dict:
        """CUDA graph captures of each step function (0 on the CPU)."""
        return {"gen_decode_step": self._decode_fn.captures,
                "gen_prefill_chunk": self._prefill_fn.captures}

    # -- weights ------------------------------------------------------------
    def load_params(self, params: Any, version: int = 0) -> None:
        """Copy new weights (same model) into the engine's static weight
        tensors and name them ``version``; the captured graphs stay valid.

        A sequence finishes with the weights it started with: while any
        slot is live, admission into slots holds (the wait lands on the
        waiting requests' ``swap_pause`` stage) and the copy runs at the
        step boundary the last live sequence leaves. Blocks until the
        copy is done. An engine stepped by hand (no :meth:`start`) must
        have no live sequence."""
        new = _device_params(params, torch.device("cpu"))
        pairs = [(self.params["embed"], new["embed"]),
                 (self.params["ln_f"], new["ln_f"])] + \
            [(self.params["layers"][k], v) for k, v in new["layers"].items()]
        for dst, src in pairs:
            if dst.shape != src.shape:
                raise ValueError(f"new weights {tuple(src.shape)} do not "
                                 f"fit the engine's {tuple(dst.shape)}")
        swap = _Swap(pairs, int(version))
        with self._swap_lock:
            if self._thread is None or not self._thread.is_alive():
                with self._step_lock:
                    if self.scheduler.occupied():
                        raise RuntimeError("live sequences and no engine "
                                           "loop to finish them")
                    self._apply_swap(swap)
                return
            self._swap = swap
            while not swap.done.wait(0.1):
                if not self._thread.is_alive():
                    self._swap = None
                    raise RuntimeError("the engine loop stopped before the "
                                       "weight swap")

    def _apply_swap(self, swap: "_Swap") -> None:
        for dst, src in swap.pairs:
            dst.copy_(src)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.weight_version = swap.version
        self._swap = None
        swap.done.set()

    # -- limits -------------------------------------------------------------
    @property
    def max_request_tokens(self) -> int:
        """Hard per-request bound: prompt + max_new must fit one slot's
        page table AND the model context."""
        return min(self.cfg.max_seq, self.plan.slot_tokens)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "GenerateEngine":
        self._thread = threading.Thread(target=self._run,
                                        name="hvd-gen-engine",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _run(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._stop.is_set():
            self.step_once(idle_wait_s=0.05)

    # -- intake -------------------------------------------------------------
    def submit(self, req_id: str, prompt, max_new: int,
               deadline_s: Optional[float] = None, trace=None,
               on_token=None) -> GenRequest:
        """Admit one generation request (any thread).  Raises
        :class:`~horovod_tpu_torch.serving.batcher.SheddedError` /
        :class:`~horovod_tpu_torch.serving.batcher.DrainingError` exactly
        like request-level admission, and :class:`ValueError` when the
        worst case cannot fit a slot.  The caller blocks on
        ``req.pending.wait()`` for the terminal result."""
        req = GenRequest(req_id, prompt, int(max_new), trace=trace,
                         on_token=on_token)
        if req.max_new < 1:
            raise ValueError(f"request {req_id}: max_new must be >= 1")
        if req.prompt_len < 1:
            raise ValueError(f"request {req_id}: empty prompt")
        if req.worst_case_tokens > self.max_request_tokens:
            raise ValueError(
                f"request {req_id}: prompt+max_new "
                f"({req.worst_case_tokens}) exceeds the per-slot "
                f"capacity ({self.max_request_tokens})")
        if int(req.prompt.min()) < 0 or \
                int(req.prompt.max()) >= self.cfg.vocab_size:
            raise ValueError(f"request {req_id}: a prompt token is outside "
                             f"the vocabulary [0, {self.cfg.vocab_size})")
        req.pending = self.batcher.submit(req_id, req,
                                          deadline_s=deadline_s)
        return req

    def generate(self, prompt, max_new: int, req_id: str = "local",
                 deadline_s: Optional[float] = None) -> dict:
        """Blocking convenience wrapper (the engine loop must be
        running, or another thread stepping)."""
        req = self.submit(req_id, prompt, max_new, deadline_s=deadline_s)
        wait_s = (req.pending.deadline - time.monotonic()) + 1.0
        return req.pending.wait(timeout=max(wait_s, 0.1))

    # -- drain --------------------------------------------------------------
    def drain(self) -> None:
        self.batcher.drain()

    def drained(self) -> bool:
        """Admission stopped AND every admitted sequence answered."""
        return self.batcher.draining and self.batcher.drained() \
            and not self.scheduler.busy()

    def wait_drained(self, timeout_s: float = 30.0) -> bool:
        end = time.monotonic() + timeout_s
        while not self.drained():
            if time.monotonic() >= end:
                return False
            time.sleep(0.01)
        return True

    # -- the step -----------------------------------------------------------
    def step_once(self, idle_wait_s: float = 0.0) -> bool:
        """One engine iteration: pull admissions, sweep deadlines,
        admit into slots, ONE prefill chunk per prefilling sequence,
        ONE batched decode step, deliver finishes, and apply a pending
        weight swap once no slot is live.  Returns True when any work
        happened."""
        pulled = self._pull_admissions(idle_wait_s)
        with self._step_lock:
            self._sweep_deadlines()
            admitted = self.scheduler.admit(hold=self._swap is not None)
            for req in admitted:
                self._on_admitted(req)
            worked = pulled or bool(admitted)
            worked = self._prefill_tick() or worked
            worked = self._decode_tick() or worked
            swap = self._swap
            if swap is not None and not self.scheduler.occupied():
                self._apply_swap(swap)
                worked = True
        smetrics.set_slot_occupancy(self.scheduler.occupied(),
                                    self.n_slots)
        smetrics.set_gen_waiting(self.scheduler.waiting_count())
        return worked

    def _pull_admissions(self, idle_wait_s: float) -> bool:
        # when slots/queue hold live work the pull must not block; only
        # a fully idle engine waits in next_batch
        timeout = 0.0 if self.scheduler.busy() else float(idle_wait_s)
        batch = self.batcher.next_batch(timeout_s=timeout)
        if not batch:
            return False
        for pending in batch:
            req: GenRequest = pending.payload
            req.pending = pending
            self.scheduler.add_waiting(req)
        # the queue's job ends at hand-off; sequence lifetime is the
        # scheduler's (drain completion = drained() above, which also
        # requires the scheduler to be empty)
        self.batcher.batch_done()
        return True

    def _sweep_deadlines(self) -> None:
        now = time.monotonic()
        for req in list(self.scheduler.slots):
            if req is None or req.pending is None:
                continue
            if req.pending.deadline <= now:
                smetrics.inc_shed("deadline")
                self._finish(req, "deadline", error=DeadlineError(
                    f"request {req.id}: deadline expired mid-generation "
                    f"after {len(req.tokens)} tokens"))

    def _on_admitted(self, req: GenRequest) -> None:
        row = self._page_table[req.slot]
        row[:] = self.plan.total_pages          # scratch-fill the tail
        row[:len(req.pages)] = req.pages
        self._lengths[req.slot] = 0
        self._last_token[req.slot] = 0
        self._active[req.slot] = 0              # active only once decoding
        req.weight_version = self.weight_version
        self._span(req, "gen_admit",
                   dur_s=req.admitted_at - req.submitted_at,
                   slot=req.slot, pages=len(req.pages),
                   queued_s=round(req.admitted_at - req.submitted_at, 6))

    # -- prefill ------------------------------------------------------------
    def _prefill_tick(self) -> bool:
        worked = False
        P, C = self.plan.pages_per_slot, self.prefill_chunk
        buf = self._prefill_fn.host.numpy()
        for req in self.scheduler.prefilling():
            chunk = self.scheduler.next_prefill_chunk(req)
            if chunk is None:     # defensive; PREFILL implies a chunk
                continue
            start, length = chunk
            buf[:P] = self._page_table[req.slot]
            buf[P:P + C] = 0
            buf[P:P + length] = req.prompt[start:start + length]
            buf[P + C] = start
            buf[P + C + 1] = length
            t0 = time.monotonic()
            nxt = int(self._prefill_fn())
            dur = time.monotonic() - t0
            smetrics.observe_prefill(dur)
            self.prefill_chunks_total += 1
            req.prefill_s += dur
            req.prefill_pos += length
            req.prefill_chunks += 1
            self._span(req, "gen_prefill", dur_s=dur,
                       chunk=req.prefill_chunks, chunk_start=start,
                       tokens=length)
            worked = True
            if req.prefill_pos >= req.prompt_len:
                # the last chunk's last valid logits ARE the first
                # emitted token: prefill ends with TTFT, decode
                # continues from it
                req.state = DECODE
                self._lengths[req.slot] = req.prompt_len
                self._last_token[req.slot] = nxt
                self._active[req.slot] = 1
                self._emit(req, nxt)
                smetrics.count_gen_tokens(1)
                smetrics.observe_ttft(
                    req.first_token_at - req.submitted_at)
                if len(req.tokens) >= req.max_new:
                    self._finish(req, "length")
        return worked

    # -- decode -------------------------------------------------------------
    def _decode_tick(self) -> bool:
        decoding = self.scheduler.decoding()
        if not decoding:
            return False
        t0 = time.monotonic()
        nxt = self._decode_fn()
        dur = time.monotonic() - t0
        self.decode_steps_total += 1
        for req in decoding:
            s = req.slot
            tok = int(nxt[s])
            req.decode_steps += 1
            req.decode_s += dur  # each rider experiences the full step
            self._lengths[s] += 1
            self._last_token[s] = tok
            self._emit(req, tok)
            self._span(req, "gen_decode_step", dur_s=dur,
                       step=req.decode_steps, token=tok,
                       batch=len(decoding))
            if len(req.tokens) >= req.max_new:
                self._finish(req, "length")
        smetrics.observe_decode(dur, len(decoding))
        smetrics.observe_batch(len(decoding), top=self.n_slots)
        return True

    # -- delivery -----------------------------------------------------------
    def _emit(self, req: GenRequest, token: int) -> None:
        now = time.monotonic()
        prev = req.last_token_at
        req.emit(token, now)
        if prev:
            smetrics.observe_itl(now - prev)

    def _finish(self, req: GenRequest, reason: str,
                error: Optional[BaseException] = None) -> None:
        s = req.slot
        self.scheduler.evict(req, reason)
        if s is not None:
            self._active[s] = 0
            self._lengths[s] = 0
            self._last_token[s] = 0
            self._page_table[s, :] = self.plan.total_pages
        smetrics.inc_gen_finished(reason)
        now = time.monotonic()
        stages = {k: round(v, 6) for k, v in req.stages().items()}
        self._span(req, "gen_finish",
                   dur_s=now - req.submitted_at, reason=reason,
                   tokens_emitted=len(req.tokens),
                   prefill_chunks=req.prefill_chunks,
                   decode_steps=req.decode_steps,
                   ttft_s=round((req.first_token_at - req.submitted_at)
                                if req.first_token_at else 0.0, 6),
                   **{f"stage_{k}": v for k, v in stages.items()
                      if v > 0})
        if req.pending is None:
            return
        if error is not None:
            req.pending.set_error(error)
            return
        ttft = (req.first_token_at - req.submitted_at) \
            if req.first_token_at else 0.0
        req.pending.set_result({
            "tokens": list(req.tokens),
            "tokens_emitted": len(req.tokens),
            "finish_reason": reason,
            "weight_version": req.weight_version,
            "prompt_tokens": req.prompt_len,
            "prefill_chunks": req.prefill_chunks,
            "decode_steps": req.decode_steps,
            "ttft_s": round(ttft, 6),
            "total_s": round(now - req.submitted_at, 6),
            # the generate-plane slice of the request ledger — the
            # replica handler adds its own stages and the router closes
            # the books
            "stages": stages,
        })

    def _span(self, req: GenRequest, name: str, dur_s: float,
              **attrs) -> None:
        if req.trace is None:
            return
        from horovod_tpu_torch import tracing
        tracing.record_span(
            "serving", name, tracing.child(req.trace, "serving"),
            start=time.time() - max(dur_s, 0.0), dur_s=dur_s,
            request=req.id, **attrs)


# -- request-level baseline ---------------------------------------------------
def request_level_generate(engine: GenerateEngine,
                           requests: Sequence[Tuple[Any, int]]
                           ) -> List[GenRequest]:
    """The request-granular discipline the continuous engine replaces,
    driven through the SAME step functions so the comparison is
    apples-to-apples: admit a full gang of ``n_slots`` requests, decode
    until the gang's LONGEST sequence finishes — early finishers strand
    their slot — and only then admit the next gang.

    The engine must NOT be running its background loop.  Returns the
    finished :class:`GenRequest` objects in submission order; compare
    ``engine.decode_steps_total`` deltas (and wall time) against a
    continuous run of the same request set."""
    if engine._thread is not None and engine._thread.is_alive():
        raise RuntimeError("baseline needs exclusive manual stepping")

    reqs = [GenRequest(f"gang-{i}", prompt, int(max_new))
            for i, (prompt, max_new) in enumerate(requests)]
    for lo in range(0, len(reqs), engine.n_slots):
        gang = reqs[lo:lo + engine.n_slots]
        for r in gang:
            engine.scheduler.add_waiting(r)
        guard = 0
        while any(r.state != DONE for r in gang):
            engine.step_once()
            guard += 1
            if guard > 100_000:
                raise RuntimeError("baseline failed to converge")
    return reqs


# -- models -------------------------------------------------------------------
def demo_gen_setup(vocab: int = 64, d_model: int = 32, n_layers: int = 2,
                   n_heads: int = 2, max_seq: int = 64,
                   seed: int = 0, device=None) -> Tuple[Any, Any]:
    """A deterministic tiny dense transformer — the generate-mode analog
    of :func:`~horovod_tpu_torch.serving.replica.demo_params`. Returns
    ``(state_dict, cfg)``: the JAX ``demo_gen_setup``'s weights (the same
    ``init_params`` draw) as tensors on ``device`` (the card unless
    ``device="cpu"``); fp32 so the token-parity contract is exact."""
    from horovod_tpu_torch.models.transformer import TransformerConfig
    cfg = TransformerConfig(vocab_size=vocab, d_model=d_model,
                            n_heads=n_heads, n_layers=n_layers,
                            d_ff=2 * d_model, max_seq=max_seq,
                            n_experts=0, dtype=torch.float32,
                            param_dtype=torch.float32)
    return _seeded_weights(cfg, seed, device), cfg


def flagship_gen_setup(seed: int = 0, device=None) -> Tuple[Any, Any]:
    """The flagship of ``__graft_entry__._flagship_cfg`` (V 32000, M 512,
    8x64 heads, L 4, F 2048, ``max_seq`` 256) for serving: fp32, as
    ``kv_cache_spec`` fixes the cache, with its seed-``seed``
    ``init_params`` weights on ``device`` (the card unless
    ``device="cpu"``). Returns ``(state_dict, cfg)``."""
    from horovod_tpu_torch.models.transformer import TransformerConfig
    cfg = TransformerConfig(vocab_size=32000, d_model=512, n_heads=8,
                            n_layers=4, d_ff=2048, max_seq=256,
                            dtype=torch.float32, param_dtype=torch.float32)
    return _seeded_weights(cfg, seed, device), cfg


def _seeded_weights(cfg, seed: int, device) -> dict:
    from horovod_tpu_torch.models.transformer import (from_jax_params,
                                                      init_params)
    dev = resolve_device(device)
    sd = from_jax_params(init_params(np.random.RandomState(seed), cfg,
                                     n_stages=1))
    return {k: v.to(dev) for k, v in sd.items()}


__all__ = ["GenerateEngine", "GenRequest", "PREFILL", "DECODE", "DONE",
           "demo_gen_setup", "flagship_gen_setup", "request_level_generate"]
