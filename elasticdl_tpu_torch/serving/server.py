"""The generation server: the port of elasticdl_tpu/serving/server.py's
ServingConfig, scheduler loop, ServingServicer and GenerationServer, on
the port's transport (proto/service.py), with the disaggregated chain
handoff's methods (serving/disagg.py), the serve span, tail forensics
and the /metrics exposition; without the JAX server's runtime-health
plane.

Wiring (one process):

    handler threads ──submit──> RequestQueue ──pop──┐
         ^                                          v
         └──events (tokens/done/error)──── _Scheduler thread
                                              │ engine.insert / step
                                              │ watcher.poll (reload)
                                              │ telemetry
                                              v
                              ContinuousBatchingEngine (the card)

One scheduler thread owns the engine: each iteration runs the jobs
handlers submitted (an explicit reload), swaps in a newer checkpoint
when the watcher has one (hot reload, between steps), evicts expired
sequences, seats queued prompts into free slots (prefill, or the first
part of a chunked prefill), runs pending chunked-prefill tiles under a
per-tick budget, runs ONE batched decode step and pushes the produced
tokens, each event stamped with the checkpoint version of the weights
that made them, to the requests' event queues. Handler threads (the
transport's, or in-process callers) only submit to the admission queue
and wait on their request's events, always with a timeout, so a lost
scheduler surfaces as an error and never as a hang; they never touch
the device (`server_status` reads host-side counters only); a chain
export or import runs on the scheduler thread as a submitted job.

The engine is the dense pool unless `kv_paged` (None resolves from
EDL_KV_PAGED, as in the JAX package, so dense by default); speculative
decode and chunked prefill need the paged pool.

Fault injection: the servicer the transport serves is wrapped at the
master's choke point (common/fault_injection.py, EDL_FAULT_SPEC) with
the serving RPC names, e.g. ``generate:error:3``.

Observability: every admitted request opens a `serve` span on the
process recorder (observability/tracing.py), parented under the caller's
dispatch span when the call carried trace context, with the events
`queued`, `seated` (queue wait, and the ms other prefills held the
scheduler meanwhile), the engine's `prefill` / `prefix_hit` /
`revive_upload`, `first_token`, then `completed` or `expired` /
`rejected`. The forensics switch (`ServingConfig.forensics`, None
resolves from EDL_FORENSICS, on by default) adds three things: trace
ids as exemplars of the latency histograms, the `serve_span_classifier`
that retains slow and failed serve traces, and the attribution of each
terminally slow request to a cause of observability/forensics.py (the
status's `slow_cause_counts`). `metrics_port` (None resolves from
EDL_METRICS_PORT, unset = off) serves the telemetry's and the
profiler's families at `GET /metrics`. A stop exports the recorder to
EDL_TRACE_DIR when that is set.
"""

import contextlib
import os
import threading
import time

from elasticdl_tpu_torch.common.fault_injection import (
    SERVING_RPCS,
    FaultInjector,
    maybe_wrap_servicer,
)
from elasticdl_tpu_torch.observability import forensics
from elasticdl_tpu_torch.observability.metrics import (
    MetricsServer,
    metrics_port_default,
)
from elasticdl_tpu_torch.observability.tracing import recorder
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.serving import disagg
from elasticdl_tpu_torch.serving.admission import (
    AdmissionError,
    RequestQueue,
    ServingRequest,
)
from elasticdl_tpu_torch.serving.engine import (
    ContinuousBatchingEngine,
    PagedContinuousBatchingEngine,
    StepProfiler,
    kv_host_bytes_default,
    kv_paged_default,
    prefill_budget_default,
    prefill_chunk_default,
    profile_default,
    role_default,
)
from elasticdl_tpu_torch.serving.hot_reload import (
    CheckpointWatcher,
    ReloadError,
)
from elasticdl_tpu_torch.serving.telemetry import ServingTelemetry


def forensics_default():
    """EDL_FORENSICS resolves the forensics switch a config leaves
    unset: on unless it is "0"."""
    return os.environ.get("EDL_FORENSICS", "1") != "0"


def serve_span_classifier(span):
    """The tail-retention verdict on a replica's `serve` span: one that
    expired, was rejected or failed is retained, and so is one that
    completed after most of its own deadline (forensics.
    is_terminally_slow); healthy ones are sampled. None for other
    spans."""
    if span.name != "serve":
        return None
    if span.status != "ok":
        return True
    deadline_ms = span.attrs.get("deadline_ms") or 0
    if deadline_ms and span.end is not None:
        e2e_ms = (span.end - span.start) * 1000.0
        if forensics.is_terminally_slow("ok", e2e_ms, deadline_ms):
            return True
    return False


# servers with forensics on in this process: the classifier stays on the
# process recorder while any of them runs
_classifier_users = [0]
_classifier_lock = threading.Lock()


def _hold_classifier(delta):
    with _classifier_lock:
        _classifier_users[0] += delta
        if _classifier_users[0] == 1 and delta > 0:
            recorder().add_classifier(serve_span_classifier)
        elif _classifier_users[0] == 0:
            recorder().remove_classifier(serve_span_classifier)


class ServingConfig(object):
    """num_slots sizes the decode pool; queue_capacity bounds the queued
    backlog; top_k/top_p are server-level sampling filters.

    kv_paged: the block-paged pool (None resolves from EDL_KV_PAGED:
    dense unless set). The paged pool holds kv_num_blocks blocks of
    kv_block_size tokens (0 = the dense-equivalent budget), with prefix
    sharing when kv_shared. draft_k: tokens a speculative tick drafts
    (with a draft model; paged only). prefill_chunk_tokens: chunked
    prefill's tile width (None resolves from EDL_PREFILL_CHUNK_TOKENS, 0
    = monolithic; paged only); prefill_budget_ms: the tile ms a tick may
    spend while decode slots wait (None resolves from
    EDL_PREFILL_BUDGET_MS, default 8; <= 0 unbounded). profile: the step
    profiler (None resolves from EDL_PROFILE). checkpoint_dir: a
    directory of checkpoints the server follows, reload_poll_secs apart
    (0 = explicit reloads only). port: the transport's port when the
    server is started with it (0 = an ephemeral one); max_workers: the
    transport's handlers that may run at once. kv_host_bytes: the paged
    pool's host spill tier in bytes (None resolves from
    EDL_KV_HOST_BYTES; 0 = eviction forgets). role: the phase the
    replica advertises for disaggregated serving, "prefill", "decode" or
    "unified" (None resolves from EDL_SERVING_ROLE, default unified).
    metrics_port: the /metrics exposition's port (None resolves from
    EDL_METRICS_PORT, unset = off; 0 = an ephemeral one). forensics:
    exemplars, serve-span retention and slow-cause attribution (None
    resolves from EDL_FORENSICS, on)."""

    def __init__(self, num_slots=4, queue_capacity=64, top_k=0, top_p=1.0,
                 idle_wait_secs=0.05, handler_poll_secs=0.25,
                 kv_paged=None, kv_block_size=16, kv_num_blocks=0,
                 kv_shared=True, draft_k=0, prefill_chunk_tokens=None,
                 prefill_budget_ms=None, profile=None, checkpoint_dir="",
                 reload_poll_secs=2.0, port=0, max_workers=64,
                 kv_host_bytes=None, role=None, metrics_port=None,
                 forensics=None):
        self.num_slots = int(num_slots)
        self.queue_capacity = int(queue_capacity)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.idle_wait_secs = float(idle_wait_secs)
        self.handler_poll_secs = float(handler_poll_secs)
        self.kv_paged = (kv_paged_default() if kv_paged is None
                         else bool(kv_paged))
        self.kv_block_size = int(kv_block_size)
        self.kv_num_blocks = int(kv_num_blocks)
        self.kv_shared = bool(kv_shared)
        self.draft_k = int(draft_k)
        self.prefill_chunk_tokens = (
            prefill_chunk_default() if prefill_chunk_tokens is None
            else int(prefill_chunk_tokens))
        self.prefill_budget_ms = (
            prefill_budget_default() if prefill_budget_ms is None
            else float(prefill_budget_ms))
        self.profile = profile_default() if profile is None else bool(profile)
        self.checkpoint_dir = checkpoint_dir
        self.reload_poll_secs = float(reload_poll_secs)
        self.port = int(port)
        self.max_workers = int(max_workers)
        self.kv_host_bytes = (kv_host_bytes_default() if kv_host_bytes is None
                              else int(kv_host_bytes))
        self.role = role_default() if role is None else str(role)
        if self.role not in ("prefill", "decode", "unified"):
            raise ValueError("role must be prefill|decode|unified, got %r"
                             % (self.role,))
        self.metrics_port = (metrics_port_default() if metrics_port is None
                             else int(metrics_port))
        self.forensics = (forensics_default() if forensics is None
                          else bool(forensics))


def _admit_request(queue, telemetry, engine, req, deadline_ms):
    """Open `req`'s serve span (under its caller's span when it carries
    trace context, else a fresh trace), stamp the engine's prefill-busy
    clock, and queue it (AdmissionError when refused), counting it as
    the JAX servicer's admission counts it."""
    req.span = recorder().start_span(
        "serve", trace_id=req.trace_id or None,
        parent_span_id=req.parent_span_id, request_id=req.request_id,
        prompt_len=len(req.prompt), max_new_tokens=req.max_new_tokens,
        deadline_ms=int(deadline_ms or 0))
    req.trace_id = req.span.trace_id
    req.prefill_busy_at_queued = getattr(engine, "prefill_busy_ms", 0.0)
    try:
        queue.submit(req)
    except AdmissionError as e:
        expired = e.code == "DEADLINE_EXCEEDED"
        telemetry.count("expired" if expired else "rejected")
        req.trace_event("expired" if expired else "rejected", why=str(e))
        req.finish_span(e.code)
        raise
    req.trace_event("queued", queue_depth=len(queue))
    telemetry.count("admitted")
    return req


class _Scheduler(threading.Thread):
    """The continuous-batching loop. It feeds `telemetry` (a
    ServingTelemetry) at the JAX scheduler's sites. Besides,
    `step_secs` and `ttft_secs` record each decode step's and each
    request's time to first token on the host clock (a step ends in a
    host copy of its tokens, so its time includes the device work),
    `step_ends` the host clock at the end of each step, `step_tokens`
    the tokens each step committed; `prefill_tiles` counts the
    chunked-prefill tiles run."""

    def __init__(self, engine, queue, idle_wait_secs=0.05,
                 clock=time.monotonic, watcher=None, prefill_budget_ms=0.0,
                 telemetry=None, forensics_on=True):
        super().__init__(daemon=True, name="serving-scheduler")
        self.engine = engine
        self.queue = queue
        self.idle_wait_secs = idle_wait_secs
        self.watcher = watcher
        self._clock = clock
        self.telemetry = telemetry or ServingTelemetry(clock=clock)
        # slow-cause attribution at the terminal paths
        self.forensics_on = bool(forensics_on)
        self._stop_requested = threading.Event()
        self._drain = True
        self.crashed = None
        # the drain advertisement (ServerStatus.draining): _stopping for
        # good once stop() is called, _reloading only across a swap, so
        # a reload ending while a stop lands cannot clear it
        self._stopping = threading.Event()
        self._reloading = threading.Event()
        self.step_secs = []
        self.step_batch = []
        self.step_tokens = []
        self.step_ends = []
        self.ttft_secs = []
        self.completed = 0
        self.reloads = 0
        self.reload_secs = []  # host seconds of each swap (set_params)
        self.reload_in_flight = []  # sequences decoding at each swap
        # chunked prefill (paged engine with a tile width): seated jobs
        # advance tile by tile, budgeted per tick while decode waits
        self._chunked = bool(getattr(engine, "prefill_chunk_tokens", 0)
                             and hasattr(engine, "begin_insert"))
        self.prefill_budget_ms = float(prefill_budget_ms)
        self._pending_prefills = []
        self._tile_ms = 0.0  # EWMA of a tile's ms: prices the budget
        self.prefill_tiles = 0
        self._jobs = []
        self._jobs_lock = threading.Lock()

    def is_draining(self):
        return self._stopping.is_set() or self._reloading.is_set()

    def run(self):
        try:
            while not self._stop_requested.is_set():
                self._iterate()
            self._shutdown()
        except BaseException as e:  # noqa: BLE001 - surfaced to callers
            self.crashed = e
            self._abort_all("RESOURCE_EXHAUSTED",
                            "scheduler crashed: %r" % (e,))

    def submit_job(self, fn, timeout=60.0):
        """Run `fn` on the scheduler thread (engine work serializes with
        the decode loop) and return its result or raise its error. A
        dead scheduler or a timeout raises AdmissionError."""
        done = threading.Event()
        cell = {}

        def job():
            try:
                cell["result"] = fn()
            except BaseException as e:  # noqa: BLE001 - re-raised below
                cell["error"] = e
            done.set()

        with self._jobs_lock:
            self._jobs.append(job)
        self.queue.wake()
        deadline = self._clock() + timeout
        while not done.wait(0.05):
            if self.crashed is not None or not self.is_alive():
                raise AdmissionError("RESOURCE_EXHAUSTED",
                                     "serving scheduler is not running")
            if self._clock() > deadline:
                raise AdmissionError("DEADLINE_EXCEEDED",
                                     "scheduler job timed out")
        if "error" in cell:
            raise cell["error"]
        return cell["result"]

    def _run_jobs(self):
        while True:
            with self._jobs_lock:
                if not self._jobs:
                    return
                job = self._jobs.pop(0)
            job()

    def _swap(self, loaded):
        """Swap in `loaded` = (flat, version), draining advertised for
        the swap (only the reload's own flag clears)."""
        self._reloading.set()
        try:
            t0 = time.perf_counter()
            flat, version = loaded
            self.engine.set_params(flat, version)
            self.reload_secs.append(time.perf_counter() - t0)
            self.reload_in_flight.append(self.engine.active_count())
            self.reloads += 1
            self.telemetry.count("reloads")
        finally:
            self._reloading.clear()

    def reload_to(self, version):
        """Explicit checkpoint swap to `version`, older included (a
        rollback); runs on the scheduler thread (through submit_job).
        Raises ReloadError with the old weights still serving when the
        watcher's retry ladder is exhausted. Returns the version now
        serving."""
        if self.watcher is None:
            raise ReloadError("no checkpoint watcher configured")
        loaded = self.watcher.load_version(version)
        if loaded is not None:
            self._swap(loaded)
        return int(self.engine.model_version)

    def _expire(self, req, where, **attrs):
        """`where`: mid-decode, queued or mid-prefill."""
        self.telemetry.count("expired")
        req.trace_event("expired", where=where, **attrs)
        req.finish_span("DEADLINE_EXCEEDED")
        self._count_slow(req)
        req.push(("error", "DEADLINE_EXCEEDED", "deadline expired %s" % (
            "while queued" if where == "queued" else where)))

    def _iterate(self):
        self._run_jobs()
        if self.watcher is not None:
            loaded = self.watcher.poll()
            if loaded is not None:
                self._swap(loaded)
        for req in self.engine.evict_expired(self._clock()):
            self._expire(req, "mid-decode")
        self._fill_slots()
        self._advance_prefills()
        if self.engine.active_count():
            self._step(record=True)
        elif not self._pending_prefills:
            self.queue.wait_for_work(self.idle_wait_secs)

    def _step(self, record):
        """One decode step; `record` feeds the telemetry's step gauges
        (the JAX scheduler's loop does, its drain loop does not)."""
        t0 = self._clock()
        results = self.engine.step()
        t1 = self._clock()
        self.step_secs.append(t1 - t0)
        self.step_ends.append(t1)
        self.step_batch.append(len(results))
        committed = sum(len(r[2]) for r in results)
        self.step_tokens.append(committed)
        for _slot, req, tokens, finished in results:
            req.push(("tokens", list(tokens), req.model_version))
            if finished:
                self._complete(req)
        if record:
            kv = self.engine.kv_stats()
            self.telemetry.record_step(
                len(self.queue), len(results), t1 - t0, committed,
                kv_bytes_in_use=kv["kv_bytes_in_use"],
                kv_blocks_free=kv["kv_blocks_free"],
                kv_host_blocks=kv.get("kv_host_blocks"),
                kv_host_bytes=kv.get("kv_host_bytes"))

    def _advance_prefills(self):
        """Run pending chunked-prefill tiles, round-robin, under the
        per-tick budget. The budget binds only while decode slots wait;
        at least one tile runs a tick, so prefill never starves. A tile
        is priced by an EWMA of measured tile ms. A deadline that
        expires mid-prefill aborts the job."""
        budget = self.prefill_budget_ms
        spent, ran = 0.0, 0
        while self._pending_prefills:
            job = self._pending_prefills[0]
            req = job.request
            if req.expired(self._clock()):
                self._pending_prefills.pop(0)
                self.engine.abort_prefill(job)
                self._expire(req, "mid-prefill", tiles=job.tiles)
                continue
            if (ran and budget > 0.0 and self.engine.active_count()
                    and spent + self._tile_ms > budget):
                break
            t0 = self._clock()
            finished = self.engine.advance_prefill(job)
            dt_ms = (self._clock() - t0) * 1000.0
            # the tile held the scheduler, as an insert does
            self.engine.prefill_busy_ms = (
                getattr(self.engine, "prefill_busy_ms", 0.0) + dt_ms)
            spent += dt_ms
            self._tile_ms = (0.8 * self._tile_ms + 0.2 * dt_ms
                             if self._tile_ms else dt_ms)
            ran += 1
            self.prefill_tiles += 1
            # rotate: concurrent prompts share the budget
            self._pending_prefills.append(self._pending_prefills.pop(0))
            if finished:
                self._pending_prefills.remove(job)
                self._first_token(job.request, job.slot, job.first,
                                  job.finished)

    def _first_token(self, req, slot, first, finished):
        """Prefill completion, monolithic or chunked: TTFT, the first
        token (counted here; steps count the decode loop's), and the
        completion of a one-token request."""
        req.first_token_at = self._clock()
        self.ttft_secs.append(req.first_token_at - req.submitted_at)
        ttft_ms = self.telemetry.record_ttft(req)
        req.trace_event("first_token", slot=slot, ttft_ms=round(ttft_ms, 3))
        self.telemetry.count("tokens_generated")
        req.push(("tokens", [first], req.model_version))
        if finished:
            self._complete(req)

    def _fill_slots(self):
        while self.engine.free_slots():
            req, expired = self.queue.pop_ready(fit=self.engine.can_seat)
            for e in expired:
                self._expire(e, "queued", prefill_blocked_ms=round(
                    self._blocked_ms(e), 3))
            if req is None:
                break
            req.seated_at = self._clock()
            wait_ms = self.telemetry.record_queue_wait(
                req.queue_wait_secs(), trace_id=req.trace_id)
            # the windowed prefix-hit rate's denominator
            self.telemetry.count("prompt_tokens", len(req.prompt))
            req.trace_event("seated", queue_wait_ms=round(wait_ms, 3),
                            prefill_blocked_ms=round(self._blocked_ms(req),
                                                     3))
            t0 = self._clock()
            if self._chunked:
                job = self.engine.begin_insert(req)
            else:
                job = None
                slot, first, finished = self.engine.insert(req)
            # the insert (prefill, suffix tile, draft prefill) held the
            # scheduler
            self.engine.prefill_busy_ms = (
                getattr(self.engine, "prefill_busy_ms", 0.0)
                + (self._clock() - t0) * 1000.0)
            if job is None:
                self._first_token(req, slot, first, finished)
            elif job.done():
                self._first_token(req, job.slot, job.first, job.finished)
            else:
                self._pending_prefills.append(job)

    def _complete(self, req):
        self.completed += 1
        self.telemetry.count("completed")
        self.telemetry.record_e2e((self._clock() - req.submitted_at)
                                  * 1000.0, trace_id=req.trace_id)
        req.trace_event("completed", tokens=len(req.generated))
        req.finish_span("ok")
        self._count_slow(req)
        req.push(("done", req.model_version))

    def _count_slow(self, req):
        """A terminally slow request (a deadline breach, or a completion
        after most of its deadline) counts once under the dominant cause
        forensics.attribute finds in its serve span."""
        if not self.forensics_on:
            return
        span = req.span
        if span is None or span.end is None:
            return
        deadline_ms = ((req.deadline - req.submitted_at) * 1000.0
                       if req.deadline is not None else 0.0)
        e2e_ms = (span.end - span.start) * 1000.0
        if not forensics.is_terminally_slow(span.status, e2e_ms,
                                            deadline_ms):
            return
        verdict = forensics.attribute([span.to_dict()])
        if verdict["dominant_cause"]:
            self.telemetry.count_slow_cause(verdict["dominant_cause"])

    def _blocked_ms(self, req):
        """The ms other requests' prefills held the scheduler while `req`
        waited: the engine's prefill-busy clock now against its stamp at
        admission."""
        stamp = getattr(req, "prefill_busy_at_queued", None)
        if stamp is None:
            return 0.0
        return max(0.0, getattr(self.engine, "prefill_busy_ms", 0.0) - stamp)

    def _shutdown(self):
        """Reject the queued backlog; with drain finish the in-flight
        slots and prefills first, else abort them. Every request
        terminates."""
        for req in self.queue.close():
            self.telemetry.count("rejected")
            req.trace_event("rejected", why="shutdown")
            req.finish_span("RESOURCE_EXHAUSTED")
            req.push(("error", "RESOURCE_EXHAUSTED", "server shutting down"))
        if not self._drain:
            self._abort_all("RESOURCE_EXHAUSTED", "server shutting down")
            return
        while self.engine.active_count() or self._pending_prefills:
            for req in self.engine.evict_expired(self._clock()):
                self._expire(req, "mid-decode")
            self._advance_prefills()
            if self.engine.active_count():
                self._step(record=False)

    def _abort_all(self, code, message):
        self._pending_prefills = []
        for req in self.engine.active_requests():
            req.finish_span(code)
            req.push(("error", code, message))
        for req in self.queue.close():
            req.finish_span(code)
            req.push(("error", code, message))

    def stop(self, drain=True):
        self._drain = drain
        self._stopping.set()  # advertised before admission closes
        self._stop_requested.set()
        self.queue.wake()


class ServingServicer(object):
    """The Serving methods (proto/service.py's table) over `scheduler`'s
    queue, engine and telemetry: generate, generate_stream,
    server_status, reload_checkpoint and the chain handoff's
    export_chain, transfer_chain and abort_transfer. `role` is the phase
    the replica advertises. Called with a context of None (the port's
    transport, or in-process), a failure raises AdmissionError with its
    status name, which the transport answers with that status, as the
    JAX servicer's `context.abort` does over gRPC."""

    def __init__(self, scheduler, handler_poll_secs=0.25, role="unified"):
        self._scheduler = scheduler
        self._queue = scheduler.queue
        self._engine = scheduler.engine
        self._telemetry = scheduler.telemetry
        self._watcher = scheduler.watcher
        self._poll = handler_poll_secs
        self._role = role
        # the transfer ledger: transfer calls executing now (0 after a
        # drain) and aborts closed out here
        self._transfers_inflight = 0
        self._transfer_aborts = 0
        self._transfers_lock = threading.Lock()

    # ------------------------------------------------------------- RPCs

    def generate(self, request, context=None):
        req = self._admit(request, context)
        for _chunk, _version in self._events(req, context):
            pass  # unary: req.generated holds the tokens
        return pb.GenerateResponse(tokens=req.prompt + req.generated,
                                   model_version=req.model_version)

    def generate_stream(self, request, context=None):
        req = self._admit(request, context)

        def stream():
            for chunk, version in self._events(req, context):
                yield pb.TokenChunk(tokens=chunk, done=False,
                                    model_version=version)
            yield pb.TokenChunk(tokens=[], done=True,
                                model_version=req.model_version)

        return stream()

    def _shared_pool(self, context, what):
        """The engine's prefix-shared paged pool, or FAILED_PRECONDITION."""
        kv = getattr(self._engine, "kv", None)
        if kv is None or not kv.allocator.share_prefix:
            self._fail(context, "FAILED_PRECONDITION",
                       "chain %s needs the shared paged pool" % what)
        return kv

    @contextlib.contextmanager
    def _transfer(self):
        with self._transfers_lock:
            self._transfers_inflight += 1
        try:
            yield
        finally:
            with self._transfers_lock:
                self._transfers_inflight -= 1

    def export_chain(self, request, context=None):
        """The handoff's exporter side: the prompt's indexed chain (int8
        rows and scales alike, through the host tier's gather) as the
        TransferChainRequest the decode side imports verbatim, gathered
        on the scheduler thread. Holds no references: the chain stays
        parked refcount-0. NOT_FOUND when no full prompt block is
        indexed."""
        kv = self._shared_pool(context, "export")
        prompt = list(request.prompt)
        with self._transfer():
            chain, dtypes = self._scheduler.submit_job(
                lambda: (kv.export_chain(prompt), kv.leaf_dtypes()))
            if not chain:
                self._fail(context, "NOT_FOUND",
                           "no resident chain for prompt")
            return disagg.chain_to_proto(chain, kv.block_size, dtypes,
                                         request.transfer_id)

    def transfer_chain(self, request, context=None):
        """The handoff's importer side: the payload's blocks land in
        fresh blocks re-keyed into the trie in one batched upload, on the
        scheduler thread; the next generate with the prompt seats by
        prefix hit. The response's blocks / tokens are the chain's
        coverage here (imported plus already resident levels). A layout
        that does not match is ok=False, not an RPC error."""
        kv = self._shared_pool(context, "import")
        with self._transfer():
            try:
                blocks, dtypes = disagg.proto_to_blocks(request, kv)

                def import_and_resolve():
                    kv.import_chain(blocks, leaf_dtypes=dtypes)
                    flat = [t for toks, _ in blocks for t in toks]
                    return len(kv.allocator.match_prefix(flat))

                resolved = self._scheduler.submit_job(import_and_resolve)
            except ValueError as e:
                return pb.TransferChainResponse(
                    transfer_id=request.transfer_id, ok=False, error=str(e))
            return pb.TransferChainResponse(
                transfer_id=request.transfer_id, ok=True, blocks=resolved,
                tokens=resolved * kv.block_size)

    def abort_transfer(self, request, context=None):
        """Close a failed handoff: exports hold no references, so this
        is the failure's record in the ledger."""
        with self._transfers_lock:
            self._transfer_aborts += 1
        return pb.TransferChainResponse(transfer_id=request.transfer_id,
                                        ok=True)

    def reload_checkpoint(self, request, context=None):
        """Swap to exactly request.version, newer or older, on the
        scheduler thread. A version that fails to load is a structured
        ok=False verdict with the old weights serving; only a lost
        scheduler is an RPC error."""
        if self._watcher is None:
            self._fail(context, "FAILED_PRECONDITION",
                       "no checkpoint watcher configured")
        version = int(request.version)
        sched = self._scheduler
        try:
            now_serving = sched.submit_job(lambda: sched.reload_to(version),
                                           timeout=120.0)
        except AdmissionError:
            raise
        except Exception as e:  # noqa: BLE001 - structured verdict
            return pb.ReloadCheckpointResponse(
                ok=False, model_version=int(self._engine.model_version),
                error="%s" % (e,))
        return pb.ReloadCheckpointResponse(
            ok=bool(now_serving == version), model_version=now_serving,
            error="" if now_serving == version else
            "serving version-%d after reload" % now_serving)

    def server_status(self, request, context=None):
        """The replica's status from host-side counters (no device
        sync): the pool's host-tier and chain counters, the role and the
        transfer ledger among them. The health plane is not ported
        (health_state "")."""
        snap = self._telemetry.snapshot()
        engine = self._engine
        kv = engine.kv_stats()
        watcher = self._watcher
        with self._transfers_lock:
            transfer_aborts = self._transfer_aborts
            transfers_inflight = self._transfers_inflight
        return pb.ServerStatusResponse(
            queue_depth=len(self._queue),
            active_slots=engine.active_count(),
            num_slots=engine.num_slots,
            model_version=engine.model_version,
            admitted=snap["admitted"],
            rejected=snap["rejected"],
            expired=snap["expired"],
            completed=snap["completed"],
            tokens_generated=snap["tokens_generated"],
            reloads=snap["reloads"],
            uptime_secs=snap["uptime_secs"],
            max_active_slots=snap["max_active_slots"],
            kv_paged=kv["kv_paged"],
            kv_shared=kv["kv_shared"],
            kv_cache_dtype=kv["kv_cache_dtype"],
            kv_block_size=kv["kv_block_size"],
            kv_blocks_total=kv["kv_blocks_total"],
            kv_blocks_free=kv["kv_blocks_free"],
            kv_blocks_cached=kv["kv_blocks_cached"],
            kv_blocks_shared=kv["kv_blocks_shared"],
            kv_bytes_total=kv["kv_bytes_total"],
            kv_bytes_in_use=kv["kv_bytes_in_use"],
            kv_bytes_in_use_peak=snap["kv_bytes_in_use_peak"],
            kv_bytes_per_token=snap["kv_bytes_per_token"],
            prefix_hit_tokens=kv["prefix_hit_tokens"],
            cow_copies=kv["cow_copies"],
            kv_host_blocks=kv.get("kv_host_blocks", 0),
            kv_host_bytes=kv.get("kv_host_bytes", 0),
            revive_uploads=kv.get("revive_uploads", 0),
            prefill_tokens_revived=kv.get("prefill_tokens_revived", 0),
            host_drops=kv.get("host_drops", 0),
            draft_k=engine.draft_k,
            draft_proposed=engine.draft_proposed,
            draft_accepted=engine.draft_accepted,
            draining=self._scheduler.is_draining(),
            queue_wait_ms=snap["queue_wait_ms"],
            prefix_hit_rate_window=snap["prefix_hit_rate_window"],
            ttft_p50_ms=snap["ttft_p50_ms"],
            ttft_p90_ms=snap["ttft_p90_ms"],
            ttft_p99_ms=snap["ttft_p99_ms"],
            queue_wait_p50_ms=snap["queue_wait_p50_ms"],
            queue_wait_p90_ms=snap["queue_wait_p90_ms"],
            queue_wait_p99_ms=snap["queue_wait_p99_ms"],
            ttft_hist=snap["ttft_hist"],
            queue_wait_hist=snap["queue_wait_hist"],
            slow_cause_counts=snap["slow_cause_counts"],
            role=self._role,
            chain_exports=kv.get("chain_exports", 0),
            chain_imports=kv.get("chain_imports", 0),
            chain_import_tokens=kv.get("chain_import_tokens", 0),
            transfer_aborts=transfer_aborts,
            transfers_inflight=transfers_inflight,
            reload_failed=bool(watcher.reload_failed) if watcher else False,
            reload_error=watcher.last_error if watcher else "",
        )

    # --------------------------------------------------------- internals

    def _admit(self, proto_req, context):
        req = ServingRequest(
            prompt=list(proto_req.prompt),
            max_new_tokens=proto_req.max_new_tokens,
            temperature=proto_req.temperature,
            seed=proto_req.seed,
            deadline_ms=proto_req.deadline_ms,
            trace_id=proto_req.trace_id,
            parent_span_id=proto_req.parent_span_id,
            prefill_only=proto_req.prefill_only,
        )
        try:
            return _admit_request(self._queue, self._telemetry, self._engine,
                                  req, proto_req.deadline_ms)
        except AdmissionError as e:
            self._fail(context, e.code, str(e))

    def _events(self, req, context):
        """Yield (token chunk, version) until done; end with a clean
        status on error, expiry or a lost scheduler. The timed wait is
        the backstop: a scheduler that vanishes without a terminal event
        is noticed within one poll."""
        while True:
            ev = req.next_event(timeout=self._poll)
            if ev is None:
                if req.expired(time.monotonic()):
                    self._fail(context, "DEADLINE_EXCEEDED",
                               "deadline expired")
                if not self._scheduler.is_alive():
                    self._fail(context, "RESOURCE_EXHAUSTED",
                               "serving scheduler is not running")
                continue
            if ev[0] == "tokens":
                yield ev[1], ev[2]
            elif ev[0] == "done":
                return
            else:  # ("error", code, message)
                self._fail(context, ev[1], ev[2])

    def _fail(self, context, code_name, message):
        """Raise the failure as AdmissionError(code_name): the port's
        transport answers it with that status (there is no gRPC
        context to abort)."""
        del context
        raise AdmissionError(code_name, message)


class GenerationServer(object):
    """Owns the engine, the admission queue, the telemetry, the
    checkpoint watcher, the scheduler thread and, when started with it,
    the transport, for `model` (the port's TransformerLM, on the device
    it serves from; `model_version` the checkpoint version its weights
    came from). `draft`: a TransformerLM proposing config.draft_k
    tokens a tick (paged pool only; the model itself may be its own
    draft). `raw_servicer` is the ServingServicer, `servicer` the same
    wrapped by EDL_FAULT_SPEC's injector for the transport.
    `generate` / `generate_stream` / `submit` / `events` are the
    in-process entry points; `reload_checkpoint` the explicit swap.
    `metrics` is the MetricsServer while one runs (config.metrics_port)."""

    def __init__(self, model, config=None, model_version=0, draft=None):
        self.config = config or ServingConfig()
        cfg = self.config
        if cfg.kv_paged:
            self.engine = PagedContinuousBatchingEngine(
                model, cfg.num_slots, top_k=cfg.top_k, top_p=cfg.top_p,
                block_size=cfg.kv_block_size, num_blocks=cfg.kv_num_blocks,
                share_prefix=cfg.kv_shared, draft=draft,
                draft_k=cfg.draft_k,
                prefill_chunk_tokens=cfg.prefill_chunk_tokens,
                host_bytes=cfg.kv_host_bytes)
        else:
            if draft is not None and cfg.draft_k:
                raise ValueError(
                    "speculative decode needs the paged pool (kv_paged="
                    "True)")
            self.engine = ContinuousBatchingEngine(
                model, cfg.num_slots, top_k=cfg.top_k, top_p=cfg.top_p)
        self.engine.model_version = int(model_version)
        self.telemetry = ServingTelemetry(exemplars=cfg.forensics)
        self.engine.telemetry = self.telemetry
        if cfg.profile:
            self.engine.profiler = StepProfiler()
        injector = FaultInjector.from_env()
        self.watcher = None
        if cfg.checkpoint_dir:
            self.watcher = CheckpointWatcher(
                cfg.checkpoint_dir, model, poll_secs=cfg.reload_poll_secs,
                start_version=int(model_version), injector=injector)
        self.queue = RequestQueue(
            cfg.queue_capacity, self.engine.seq_len,
            max_cached_tokens=self.engine.max_cached_tokens(),
        )
        self.scheduler = _Scheduler(
            self.engine, self.queue, idle_wait_secs=cfg.idle_wait_secs,
            watcher=self.watcher, prefill_budget_ms=cfg.prefill_budget_ms,
            telemetry=self.telemetry, forensics_on=cfg.forensics)
        self.raw_servicer = ServingServicer(
            self.scheduler, handler_poll_secs=cfg.handler_poll_secs,
            role=cfg.role)
        self.servicer = maybe_wrap_servicer(self.raw_servicer, injector,
                                            rpcs=SERVING_RPCS)
        self._server = None
        self.port = None
        self.metrics = None
        self._classifier_held = False

    @property
    def model_version(self):
        return self.engine.model_version

    def _metrics_families(self):
        """One scrape: the telemetry's families and, with the step
        profiler, its phase histogram (on the metrics thread; each
        collector locks itself)."""
        fams = self.telemetry.prometheus()
        if self.engine.profiler is not None:
            fams.extend(self.engine.profiler.prometheus())
        return fams

    def start(self, transport=False):
        """Start the scheduler and, with config.metrics_port, the
        /metrics server (its port in `self.metrics.port`); with
        `transport`, also serve the Serving methods on config.port (0:
        an ephemeral port, in `self.port`) with config.max_workers
        handlers."""
        if self.config.forensics and not self._classifier_held:
            _hold_classifier(1)
            self._classifier_held = True
        self.scheduler.start()
        if self.config.metrics_port is not None:
            self.metrics = MetricsServer(self._metrics_families,
                                         port=self.config.metrics_port)
        if transport:
            from elasticdl_tpu_torch.proto.service import (
                add_serving_servicer_to_server,
                build_server,
            )

            server = build_server(max_workers=self.config.max_workers)
            add_serving_servicer_to_server(self.servicer, server)
            self.port = server.add_insecure_port(
                "[::]:%d" % self.config.port)
            server.start()
            self._server = server
        return self

    def stop(self, drain=True, grace=5.0, timeout=60.0):
        """Stop admission, drain (or abort) in-flight work, join the
        scheduler (at most `timeout` s), then stop the transport, whose
        calls in flight get `grace` s to finish, and the /metrics server;
        export the span recorder when EDL_TRACE_DIR is set. Safe to call
        twice."""
        self.scheduler.stop(drain=drain)
        if self.scheduler.is_alive():
            self.scheduler.join(timeout=timeout)
        if self._server is not None:
            self._server.stop(grace)
            self._server = None
        if self.metrics is not None:
            self.metrics.close()
            self.metrics = None
        self.telemetry.close()
        if self._classifier_held:
            _hold_classifier(-1)
            self._classifier_held = False
        recorder().flush()

    def reload_checkpoint(self, version, timeout=120.0):
        """Swap to checkpoint `version` (newer or older) between decode
        steps, as the reload RPC does; returns the version now serving,
        raises ReloadError with the old weights serving when it cannot
        be loaded."""
        return self.scheduler.submit_job(
            lambda: self.scheduler.reload_to(version), timeout=timeout)

    def status(self):
        """The replica's status as a dict: the checkpoint version it
        serves and its reloads, queue and slot occupancy, requests still
        prefilling, completed requests, the speculative counters, the
        KV pool's stats (the layout `kv_paged`, the format under
        `kv_cache_dtype`: "" or "int8"; blocks; bytes summed per leaf at
        its dtype; the paged pool's host-tier and chain counters), the
        advertised `role` and, with the step profiler, its phases under
        `profile`. `raw_servicer.server_status` answers the
        ServerStatusResponse."""
        engine, watcher = self.engine, self.watcher
        prefilling = getattr(engine, "prefilling_count", lambda: 0)
        extra = {}
        if engine.profiler is not None:
            extra["profile"] = engine.profiler.snapshot()
        return dict(
            model_version=engine.model_version,
            reloads=self.scheduler.reloads,
            reload_failed=bool(watcher and watcher.reload_failed),
            last_reload_error=watcher.last_error if watcher else "",
            queue_depth=len(self.queue),
            active_slots=engine.active_count(),
            prefilling=prefilling(),
            num_slots=engine.num_slots,
            completed=self.scheduler.completed,
            draft_k=engine.draft_k,
            draft_proposed=engine.draft_proposed,
            draft_accepted=engine.draft_accepted,
            role=self.config.role,
            **engine.kv_stats(), **extra)

    def submit(self, prompt, max_new_tokens, temperature=0.0, seed=0,
               deadline_ms=0, prefill_only=False):
        """Admit one request (raises AdmissionError) and return it; its
        serve span is the root of a fresh trace."""
        req = ServingRequest(prompt, max_new_tokens, temperature=temperature,
                             seed=seed, deadline_ms=deadline_ms,
                             prefill_only=prefill_only)
        return _admit_request(self.queue, self.telemetry, self.engine, req,
                              deadline_ms)

    def generate_stream(self, prompt, max_new_tokens, temperature=0.0,
                        seed=0, deadline_ms=0):
        """Yield lists of new tokens as the scheduler produces them;
        raises AdmissionError on rejection, expiry or scheduler loss."""
        req = self.submit(prompt, max_new_tokens, temperature, seed,
                          deadline_ms)
        return self.events(req)

    def generate(self, prompt, max_new_tokens, temperature=0.0, seed=0,
                 deadline_ms=0):
        """Prompt + generated tokens, like the servicer's response."""
        req = self.submit(prompt, max_new_tokens, temperature, seed,
                          deadline_ms)
        for _chunk in self.events(req):
            pass
        return req.prompt + req.generated

    def events(self, req):
        """Yield the token chunks of admitted request `req` until it
        completes; raises AdmissionError on its terminal error."""
        for chunk, _version in self.raw_servicer._events(req, None):
            yield chunk
