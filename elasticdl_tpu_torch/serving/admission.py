"""Request admission: the bounded queue in front of the decode pool.
The port's copy of elasticdl_tpu/serving/admission.py.

* full queue        -> reject now with RESOURCE_EXHAUSTED (backpressure)
* invalid request   -> INVALID_ARGUMENT (the prompt and output budget
                       cannot fit the model's cache; never queued)
* expired deadline  -> DEADLINE_EXCEEDED, queued or decoding

Thread-safe: caller threads submit; the single scheduler thread pops.
Completion plumbing rides on each request's event queue.
"""

import collections
import threading
import time


class AdmissionError(Exception):
    """Rejected at (or after) admission. `code` is the status name:
    RESOURCE_EXHAUSTED, INVALID_ARGUMENT or DEADLINE_EXCEEDED."""

    def __init__(self, code, message):
        super().__init__(message)
        self.code = code


class ServingRequest(object):
    """One in-flight generation request. Events flow through `events`:
        ("tokens", [ids], version)  new tokens and the checkpoint
                                    version of the weights that made
                                    them
        ("done", version)           completed
        ("error", code, message)    terminal failure

    `span` (observability/tracing.py) is the request's serve span: the
    servicer opens it at admission, parented under the caller's dispatch
    span when the call carried trace context, and the scheduler and
    engine annotate the lifecycle through `trace_event`; both are no-ops
    while `span` is None (requests built directly)."""

    _ids = iter(range(1, 2 ** 62))
    _ids_lock = threading.Lock()

    def __init__(self, prompt, max_new_tokens, temperature=0.0, seed=0,
                 deadline_ms=0, clock=time.monotonic, trace_id="",
                 parent_span_id="", prefill_only=False):
        with ServingRequest._ids_lock:
            self.request_id = next(ServingRequest._ids)
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        # disaggregated cache warming (serving/disagg.py): seat, run the
        # prompt's prefill, register the chain, release
        self.prefill_only = bool(prefill_only)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.submitted_at = clock()
        self.deadline = (
            self.submitted_at + deadline_ms / 1000.0
            if deadline_ms and deadline_ms > 0 else None
        )
        self.events = collections.deque()
        self._event_cv = threading.Condition()
        # trace context (empty: an untraced caller; the servicer mints)
        self.trace_id = trace_id or ""
        self.parent_span_id = parent_span_id or ""
        self.span = None
        # scheduler-side state
        self.generated = []
        self.first_token_at = None
        self.seated_at = None
        # the checkpoint version whose weights produced the latest token
        # (-1 until the first one)
        self.model_version = -1

    def trace_event(self, name, **attrs):
        if self.span is not None:
            self.span.event(name, **attrs)

    def finish_span(self, status="ok"):
        if self.span is not None:
            self.span.finish(status)

    def expired(self, now):
        return self.deadline is not None and now > self.deadline

    def queue_wait_secs(self):
        """Seconds queued before seating (None until seated)."""
        if self.seated_at is None:
            return None
        return self.seated_at - self.submitted_at

    def push(self, event):
        with self._event_cv:
            self.events.append(event)
            self._event_cv.notify_all()

    def next_event(self, timeout=None):
        """Block for the next event; None on timeout (the caller
        re-checks its deadline and the scheduler's liveness)."""
        with self._event_cv:
            if not self.events:
                self._event_cv.wait(timeout)
            if not self.events:
                return None
            return self.events.popleft()


class RequestQueue(object):
    """Bounded FIFO with deadline-aware pop. `max_cached_tokens` is the
    paged pool's never-fits bound: a request whose cache rows exceed the
    whole block budget is invalid at submit; one that fits the pool but
    not the blocks free right now stays queued (`fit` on pop_ready)."""

    def __init__(self, capacity, seq_len, clock=time.monotonic,
                 max_cached_tokens=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1, got %d" % capacity)
        self.capacity = int(capacity)
        self.seq_len = int(seq_len)
        self.max_cached_tokens = (
            int(max_cached_tokens) if max_cached_tokens else None
        )
        self._clock = clock
        self._q = collections.deque()
        self._cv = threading.Condition()
        self._closed = False

    def __len__(self):
        with self._cv:
            return len(self._q)

    def submit(self, request):
        """Admit or raise AdmissionError; never blocks."""
        self.validate(request)
        with self._cv:
            if self._closed:
                raise AdmissionError(
                    "RESOURCE_EXHAUSTED", "server is shutting down"
                )
            if len(self._q) >= self.capacity:
                raise AdmissionError(
                    "RESOURCE_EXHAUSTED",
                    "request queue full (%d queued)" % len(self._q),
                )
            self._q.append(request)
            self._cv.notify_all()

    def validate(self, request):
        p = len(request.prompt)
        if p < 1:
            raise AdmissionError("INVALID_ARGUMENT", "empty prompt")
        if request.max_new_tokens < 1:
            raise AdmissionError(
                "INVALID_ARGUMENT",
                "max_new_tokens must be >= 1, got %d"
                % request.max_new_tokens,
            )
        if p + request.max_new_tokens > self.seq_len:
            raise AdmissionError(
                "INVALID_ARGUMENT",
                "prompt %d + max_new_tokens %d exceeds the model's "
                "seq_len %d" % (p, request.max_new_tokens, self.seq_len),
            )
        cached = p + request.max_new_tokens - 1
        caches = request.max_new_tokens > 1 or request.prefill_only
        if (self.max_cached_tokens is not None and caches
                and cached > self.max_cached_tokens):
            raise AdmissionError(
                "INVALID_ARGUMENT",
                "request needs %d KV rows > the pool's total budget of "
                "%d tokens" % (cached, self.max_cached_tokens),
            )
        if request.expired(self._clock()):
            raise AdmissionError(
                "DEADLINE_EXCEEDED", "deadline expired before admission"
            )

    def pop_ready(self, fit=None):
        """Next admissible request, expiring stale ones on the way out.
        Returns (request or None, expired list). A head-of-line request
        that `fit` refuses stays at the head (FIFO, no starvation)."""
        expired = []
        now = self._clock()
        with self._cv:
            while self._q:
                req = self._q[0]
                if req.expired(now):
                    self._q.popleft()
                    expired.append(req)
                    continue
                if fit is not None and not fit(req):
                    return None, expired
                self._q.popleft()
                return req, expired
        return None, expired

    def wait_for_work(self, timeout):
        """Scheduler idle wait: returns once a request is queued or the
        timeout lapses."""
        with self._cv:
            if not self._q:
                self._cv.wait(timeout)
            return bool(self._q)

    def wake(self):
        with self._cv:
            self._cv.notify_all()

    def close(self):
        """Stop admitting; return the queued backlog for the caller to
        fail cleanly."""
        with self._cv:
            self._closed = True
            backlog = list(self._q)
            self._q.clear()
            self._cv.notify_all()
        return backlog
