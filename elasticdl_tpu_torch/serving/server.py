"""In-process generation server: the port of elasticdl_tpu/serving/
server.py's ServingConfig, scheduler loop and GenerationServer, without
its gRPC transport, telemetry, forensics, health plane or hot reload.

One scheduler thread owns the engine: each iteration evicts expired
sequences, seats queued prompts into free slots (prefill), runs ONE
batched decode step and pushes the produced tokens to the requests'
event queues. Caller threads only submit to the admission queue and
wait on their request's events, always with a timeout, so a lost
scheduler surfaces as an error and never as a hang.
"""

import threading
import time

from elasticdl_tpu_torch.serving.admission import (
    AdmissionError,
    RequestQueue,
    ServingRequest,
)
from elasticdl_tpu_torch.serving.engine import PagedContinuousBatchingEngine


class ServingConfig(object):
    """num_slots sizes the decode pool; queue_capacity bounds the queued
    backlog; top_k/top_p are server-level sampling filters. The KV pool
    holds kv_num_blocks blocks of kv_block_size tokens (0 = the
    dense-equivalent budget for num_slots), with prefix sharing when
    kv_shared."""

    def __init__(self, num_slots=4, queue_capacity=64, top_k=0, top_p=1.0,
                 idle_wait_secs=0.05, handler_poll_secs=0.25,
                 kv_block_size=16, kv_num_blocks=0, kv_shared=True):
        self.num_slots = int(num_slots)
        self.queue_capacity = int(queue_capacity)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.idle_wait_secs = float(idle_wait_secs)
        self.handler_poll_secs = float(handler_poll_secs)
        self.kv_block_size = int(kv_block_size)
        self.kv_num_blocks = int(kv_num_blocks)
        self.kv_shared = bool(kv_shared)


class _Scheduler(threading.Thread):
    """The continuous-batching loop. `step_secs` and `ttft_secs` record
    each decode step's and each request's time to first token on the
    host clock (a step ends in a host copy of its tokens, so its time
    includes the device work)."""

    def __init__(self, engine, queue, idle_wait_secs=0.05,
                 clock=time.monotonic):
        super().__init__(daemon=True, name="serving-scheduler")
        self.engine = engine
        self.queue = queue
        self.idle_wait_secs = idle_wait_secs
        self._clock = clock
        self._stop_requested = threading.Event()
        self._drain = True
        self.crashed = None
        self.step_secs = []
        self.step_batch = []
        self.ttft_secs = []
        self.completed = 0

    def run(self):
        try:
            while not self._stop_requested.is_set():
                self._iterate()
            self._shutdown()
        except BaseException as e:  # noqa: BLE001 - surfaced to callers
            self.crashed = e
            self._abort_all("RESOURCE_EXHAUSTED",
                            "scheduler crashed: %r" % (e,))

    def _iterate(self):
        for req in self.engine.evict_expired(self._clock()):
            req.push(("error", "DEADLINE_EXCEEDED",
                      "deadline expired mid-decode"))
        self._fill_slots()
        if self.engine.active_count():
            self._step()
        else:
            self.queue.wait_for_work(self.idle_wait_secs)

    def _step(self):
        t0 = self._clock()
        results = self.engine.step()
        self.step_secs.append(self._clock() - t0)
        self.step_batch.append(len(results))
        for _slot, req, tokens, finished in results:
            req.push(("tokens", list(tokens)))
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
            _slot, first, finished = self.engine.insert(req)
            req.first_token_at = self._clock()
            self.ttft_secs.append(req.first_token_at - req.submitted_at)
            req.push(("tokens", [first]))
            if finished:
                self._complete(req)

    def _complete(self, req):
        self.completed += 1
        req.push(("done",))

    def _shutdown(self):
        """Reject the queued backlog; with drain finish the in-flight
        slots first, else abort them. Every request terminates."""
        for req in self.queue.close():
            req.push(("error", "RESOURCE_EXHAUSTED", "server shutting down"))
        if not self._drain:
            self._abort_all("RESOURCE_EXHAUSTED", "server shutting down")
            return
        while self.engine.active_count():
            for req in self.engine.evict_expired(self._clock()):
                req.push(("error", "DEADLINE_EXCEEDED",
                          "deadline expired mid-decode"))
            if self.engine.active_count():
                self._step()

    def _abort_all(self, code, message):
        for req in self.engine.active_requests():
            req.push(("error", code, message))
        for req in self.queue.close():
            req.push(("error", code, message))

    def stop(self, drain=True):
        self._drain = drain
        self._stop_requested.set()
        self.queue.wake()


class GenerationServer(object):
    """Owns the engine, the admission queue and the scheduler thread for
    `model` (the port's TransformerLM, on the device it serves from;
    `model_version` the checkpoint version its weights came from).
    `generate` / `generate_stream` are the in-process entry points."""

    def __init__(self, model, config=None, model_version=0):
        self.config = config or ServingConfig()
        self.model_version = int(model_version)
        cfg = self.config
        self.engine = PagedContinuousBatchingEngine(
            model, cfg.num_slots, top_k=cfg.top_k, top_p=cfg.top_p,
            block_size=cfg.kv_block_size, num_blocks=cfg.kv_num_blocks,
            share_prefix=cfg.kv_shared,
        )
        self.queue = RequestQueue(
            cfg.queue_capacity, self.engine.seq_len,
            max_cached_tokens=self.engine.max_cached_tokens(),
        )
        self.scheduler = _Scheduler(self.engine, self.queue,
                                    idle_wait_secs=cfg.idle_wait_secs)

    def start(self):
        self.scheduler.start()
        return self

    def stop(self, drain=True, timeout=60.0):
        """Stop admission, drain (or abort) in-flight work, join the
        scheduler. Safe to call twice."""
        self.scheduler.stop(drain=drain)
        if self.scheduler.is_alive():
            self.scheduler.join(timeout=timeout)

    def status(self):
        """The replica's status, as the JAX servicer's ServerStatus
        reports it: the checkpoint version it serves, queue and slot
        occupancy, completed requests and the
        KV pool's stats (the arenas' format under `kv_cache_dtype`: ""
        or "int8"; blocks; bytes summed per leaf at its dtype)."""
        return dict(
            model_version=self.model_version,
            queue_depth=len(self.queue),
            active_slots=self.engine.active_count(),
            num_slots=self.engine.num_slots,
            completed=self.scheduler.completed,
            **self.engine.kv_stats(),
        )

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
