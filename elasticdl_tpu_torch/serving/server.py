"""In-process generation server: the port of elasticdl_tpu/serving/
server.py's ServingConfig, scheduler loop and GenerationServer, without
its gRPC transport, telemetry, forensics or health plane.

One scheduler thread owns the engine: each iteration swaps in a newer
checkpoint when the watcher has one (hot reload, between steps), evicts
expired sequences, seats queued prompts into free slots (prefill, or
the first part of a chunked prefill), runs pending chunked-prefill
tiles under a per-tick budget, runs ONE batched decode step and pushes
the produced tokens to the requests' event queues. Caller threads only
submit to the admission queue and wait on their request's events,
always with a timeout, so a lost scheduler surfaces as an error and
never as a hang.

The engine is the dense pool unless `kv_paged` (None resolves from
EDL_KV_PAGED, as in the JAX package, so dense by default); speculative
decode and chunked prefill need the paged pool.
"""

import threading
import time

from elasticdl_tpu_torch.serving.admission import (
    AdmissionError,
    RequestQueue,
    ServingRequest,
)
from elasticdl_tpu_torch.serving.engine import (
    ContinuousBatchingEngine,
    PagedContinuousBatchingEngine,
    StepProfiler,
    kv_paged_default,
    prefill_budget_default,
    prefill_chunk_default,
    profile_default,
)
from elasticdl_tpu_torch.serving.hot_reload import (
    CheckpointWatcher,
    ReloadError,
)


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
    (0 = explicit reloads only)."""

    def __init__(self, num_slots=4, queue_capacity=64, top_k=0, top_p=1.0,
                 idle_wait_secs=0.05, handler_poll_secs=0.25,
                 kv_paged=None, kv_block_size=16, kv_num_blocks=0,
                 kv_shared=True, draft_k=0, prefill_chunk_tokens=None,
                 prefill_budget_ms=None, profile=None, checkpoint_dir="",
                 reload_poll_secs=2.0):
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


class _Scheduler(threading.Thread):
    """The continuous-batching loop. `step_secs` and `ttft_secs` record
    each decode step's and each request's time to first token on the
    host clock (a step ends in a host copy of its tokens, so its time
    includes the device work), `step_ends` the host clock at the end of
    each step, `step_tokens` the tokens each step committed;
    `prefill_tiles` counts the chunked-prefill tiles run."""

    def __init__(self, engine, queue, idle_wait_secs=0.05,
                 clock=time.monotonic, watcher=None, prefill_budget_ms=0.0):
        super().__init__(daemon=True, name="serving-scheduler")
        self.engine = engine
        self.queue = queue
        self.idle_wait_secs = idle_wait_secs
        self.watcher = watcher
        self._clock = clock
        self._stop_requested = threading.Event()
        self._drain = True
        self.crashed = None
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
        t0 = time.perf_counter()
        flat, version = loaded
        self.engine.set_params(flat, version)
        self.reload_secs.append(time.perf_counter() - t0)
        self.reload_in_flight.append(self.engine.active_count())
        self.reloads += 1

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

    def _iterate(self):
        self._run_jobs()
        if self.watcher is not None:
            loaded = self.watcher.poll()
            if loaded is not None:
                self._swap(loaded)
        for req in self.engine.evict_expired(self._clock()):
            req.push(("error", "DEADLINE_EXCEEDED",
                      "deadline expired mid-decode"))
        self._fill_slots()
        self._advance_prefills()
        if self.engine.active_count():
            self._step()
        elif not self._pending_prefills:
            self.queue.wait_for_work(self.idle_wait_secs)

    def _step(self):
        t0 = self._clock()
        results = self.engine.step()
        t1 = self._clock()
        self.step_secs.append(t1 - t0)
        self.step_ends.append(t1)
        self.step_batch.append(len(results))
        self.step_tokens.append(sum(len(r[2]) for r in results))
        for _slot, req, tokens, finished in results:
            req.push(("tokens", list(tokens)))
            if finished:
                self._complete(req)

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
                req.push(("error", "DEADLINE_EXCEEDED",
                          "deadline expired mid-prefill"))
                continue
            if (ran and budget > 0.0 and self.engine.active_count()
                    and spent + self._tile_ms > budget):
                break
            t0 = self._clock()
            finished = self.engine.advance_prefill(job)
            dt_ms = (self._clock() - t0) * 1000.0
            spent += dt_ms
            self._tile_ms = (0.8 * self._tile_ms + 0.2 * dt_ms
                             if self._tile_ms else dt_ms)
            ran += 1
            self.prefill_tiles += 1
            # rotate: concurrent prompts share the budget
            self._pending_prefills.append(self._pending_prefills.pop(0))
            if finished:
                self._pending_prefills.remove(job)
                self._first_token(job.request, job.first, job.finished)

    def _first_token(self, req, first, finished):
        req.first_token_at = self._clock()
        self.ttft_secs.append(req.first_token_at - req.submitted_at)
        req.push(("tokens", [first]))
        if finished:
            self._complete(req)

    def _fill_slots(self):
        while self.engine.free_slots():
            req, expired = self.queue.pop_ready(fit=self.engine.can_seat)
            for e in expired:
                e.push(("error", "DEADLINE_EXCEEDED",
                        "deadline expired while queued"))
            if req is None:
                break
            req.seated_at = self._clock()
            if self._chunked:
                job = self.engine.begin_insert(req)
                if job.done():
                    self._first_token(req, job.first, job.finished)
                else:
                    self._pending_prefills.append(job)
                continue
            _slot, first, finished = self.engine.insert(req)
            self._first_token(req, first, finished)

    def _complete(self, req):
        self.completed += 1
        req.push(("done",))

    def _shutdown(self):
        """Reject the queued backlog; with drain finish the in-flight
        slots and prefills first, else abort them. Every request
        terminates."""
        for req in self.queue.close():
            req.push(("error", "RESOURCE_EXHAUSTED", "server shutting down"))
        if not self._drain:
            self._abort_all("RESOURCE_EXHAUSTED", "server shutting down")
            return
        while self.engine.active_count() or self._pending_prefills:
            for req in self.engine.evict_expired(self._clock()):
                req.push(("error", "DEADLINE_EXCEEDED",
                          "deadline expired mid-decode"))
            self._advance_prefills()
            if self.engine.active_count():
                self._step()

    def _abort_all(self, code, message):
        self._pending_prefills = []
        for req in self.engine.active_requests():
            req.push(("error", code, message))
        for req in self.queue.close():
            req.push(("error", code, message))

    def stop(self, drain=True):
        self._drain = drain
        self._stop_requested.set()
        self.queue.wake()


class GenerationServer(object):
    """Owns the engine, the admission queue, the checkpoint watcher and
    the scheduler thread for `model` (the port's TransformerLM, on the
    device it serves from; `model_version` the checkpoint version its
    weights came from). `draft`: a TransformerLM proposing
    config.draft_k tokens a tick (paged pool only; the model itself may
    be its own draft). `generate` / `generate_stream` are the
    in-process entry points; `reload_checkpoint` the explicit swap."""

    def __init__(self, model, config=None, model_version=0, draft=None):
        self.config = config or ServingConfig()
        cfg = self.config
        if cfg.kv_paged:
            self.engine = PagedContinuousBatchingEngine(
                model, cfg.num_slots, top_k=cfg.top_k, top_p=cfg.top_p,
                block_size=cfg.kv_block_size, num_blocks=cfg.kv_num_blocks,
                share_prefix=cfg.kv_shared, draft=draft,
                draft_k=cfg.draft_k,
                prefill_chunk_tokens=cfg.prefill_chunk_tokens)
        else:
            if draft is not None and cfg.draft_k:
                raise ValueError(
                    "speculative decode needs the paged pool (kv_paged="
                    "True)")
            self.engine = ContinuousBatchingEngine(
                model, cfg.num_slots, top_k=cfg.top_k, top_p=cfg.top_p)
        self.engine.model_version = int(model_version)
        if cfg.profile:
            self.engine.profiler = StepProfiler()
        self.watcher = None
        if cfg.checkpoint_dir:
            self.watcher = CheckpointWatcher(
                cfg.checkpoint_dir, model, poll_secs=cfg.reload_poll_secs,
                start_version=int(model_version))
        self.queue = RequestQueue(
            cfg.queue_capacity, self.engine.seq_len,
            max_cached_tokens=self.engine.max_cached_tokens(),
        )
        self.scheduler = _Scheduler(
            self.engine, self.queue, idle_wait_secs=cfg.idle_wait_secs,
            watcher=self.watcher, prefill_budget_ms=cfg.prefill_budget_ms)

    @property
    def model_version(self):
        return self.engine.model_version

    def start(self):
        self.scheduler.start()
        return self

    def stop(self, drain=True, timeout=60.0):
        """Stop admission, drain (or abort) in-flight work, join the
        scheduler. Safe to call twice."""
        self.scheduler.stop(drain=drain)
        if self.scheduler.is_alive():
            self.scheduler.join(timeout=timeout)

    def reload_checkpoint(self, version, timeout=120.0):
        """Swap to checkpoint `version` (newer or older) between decode
        steps, as the JAX servicer's reload RPC does; returns the
        version now serving, raises ReloadError with the old weights
        serving when it cannot be loaded."""
        return self.scheduler.submit_job(
            lambda: self.scheduler.reload_to(version), timeout=timeout)

    def status(self):
        """The replica's status, as the JAX servicer's ServerStatus
        reports it: the checkpoint version it serves and its reloads,
        queue and slot occupancy, requests still prefilling, completed
        requests, the speculative counters, the KV pool's stats (the
        layout `kv_paged`, the format under `kv_cache_dtype`: "" or
        "int8"; blocks; bytes summed per leaf at its dtype) and, with
        the step profiler, its phases under `profile`."""
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
            **engine.kv_stats(), **extra)

    def submit(self, prompt, max_new_tokens, temperature=0.0, seed=0,
               deadline_ms=0):
        """Admit one request (raises AdmissionError) and return it."""
        req = ServingRequest(prompt, max_new_tokens, temperature=temperature,
                             seed=seed, deadline_ms=deadline_ms)
        self.queue.submit(req)
        return req

    def generate_stream(self, prompt, max_new_tokens, temperature=0.0,
                        seed=0, deadline_ms=0):
        """Yield lists of new tokens as the scheduler produces them;
        raises AdmissionError on rejection, expiry or scheduler loss."""
        req = self.submit(prompt, max_new_tokens, temperature, seed,
                          deadline_ms)
        return self.events(req)

    def generate(self, prompt, max_new_tokens, temperature=0.0, seed=0,
                 deadline_ms=0):
        """Prompt + generated tokens, like the JAX servicer's response."""
        req = self.submit(prompt, max_new_tokens, temperature, seed,
                          deadline_ms)
        for _chunk in self.events(req):
            pass
        return req.prompt + req.generated

    def events(self, req):
        """Yield the token chunks of admitted request `req` until it
        completes; raises AdmissionError on its terminal error."""
        poll = self.config.handler_poll_secs
        while True:
            ev = req.next_event(timeout=poll)
            if ev is None:
                if req.expired(time.monotonic()):
                    raise AdmissionError("DEADLINE_EXCEEDED",
                                         "deadline expired")
                if not self.scheduler.is_alive():
                    raise AdmissionError("RESOURCE_EXHAUSTED",
                                         "serving scheduler is not running")
                continue
            if ev[0] == "tokens":
                yield ev[1]
            elif ev[0] == "done":
                return
            else:
                raise AdmissionError(ev[1], ev[2])
