"""Request-scoped tracing: spans, the ring-buffer recorder with
tail-based retention, and the Chrome-trace export. The port of
elasticdl_tpu/observability/tracing.py (pure Python, the same span
documents).

Three ids, all hex strings: ``trace_id`` one per request, minted where
the request first enters the system (the router, or a direct client);
``span_id`` one per span; ``parent_span_id`` the causal edge. Crossing
a process boundary copies ``(trace_id, span_id)`` into the RPC's trace
fields, and the receiver starts its span with ``parent_span_id = <the
sender's span_id>``. A hedge or a re-dispatch makes SIBLING spans under
the same parent, so one tree per request survives retries.

Standard span events: ``queued``, ``seated``, ``prefill``,
``first_token``, ``completed``, ``expired``, ``rejected``,
``redispatched``, ``hedged``, ``hedge_win``, ``breaker_trip``, ``shed``,
``fault_injected``, ``affinity``, ``disagg_handoff``,
``disagg_fallback``.

Recording is always on and bounded: finished spans land in a
lock-guarded ring (drop-oldest, counted in ``dropped``).

Tail-based retention: classifier hooks (``add_classifier``) judge each
finished span. ``True`` moves the span and every recorded span of its
trace into a separately bounded RETAINED tier (and pins later spans of
that trace there); ``False`` marks a healthy root kept only with
probability ``sample_rate`` (below it the root and its trace leave the
ring, counted in ``sampled_out``); ``None`` falls through to the next
hook and then the plain ring. The router installs a hook that retains
failed, shed, re-dispatched, hedged and over-SLO request roots.

Export happens only when ``EDL_TRACE_DIR`` is set: each process writes
``spans-<service>-<pid>.json`` there (``flush()`` on a clean stop, plus
an atexit backstop armed by ``configure``); ``chrome_trace`` turns
merged span documents into Chrome-trace JSON for Perfetto or
chrome://tracing.

Timestamps are ``time.time()`` so that spans of several processes land
on one timeline.
"""

import atexit
import json
import os
import random
import threading
import time
from collections import deque

TRACE_DIR_ENV = "EDL_TRACE_DIR"

_DEFAULT_CAPACITY = 4096
#: the retained tier's own bound (slow and failed traces)
_DEFAULT_RETAINED_CAPACITY = 2048


def new_trace_id():
    return os.urandom(8).hex()


def new_span_id():
    return os.urandom(8).hex()


class Span(object):
    """One timed operation, made by ``SpanRecorder.start_span``;
    ``finish()`` (or leaving it as a context manager) seals it into the
    recorder. ``event`` / ``set`` are plain appends and updates (atomic
    under the GIL), and ``finish`` is idempotent under the recorder's
    lock, so a span touched by several threads is recorded once."""

    __slots__ = ("name", "trace_id", "span_id", "parent_span_id",
                 "service", "start", "end", "status", "attrs",
                 "events", "_recorder")

    def __init__(self, recorder, name, trace_id, parent_span_id, attrs,
                 start):
        self._recorder = recorder
        self.name = name
        self.trace_id = trace_id
        self.span_id = new_span_id()
        self.parent_span_id = parent_span_id or ""
        self.service = recorder.service
        self.start = start
        self.end = None
        self.status = None
        self.attrs = dict(attrs)
        self.events = []

    def event(self, name, **attrs):
        """A timestamped point annotation inside the span."""
        self.events.append((self._recorder.clock(), name, attrs))
        return self

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def finish(self, status="ok"):
        """Seal the span (the first finish wins)."""
        self._recorder._finish(self, status)
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, _tb):
        self.finish("ok" if exc_type is None else "error")
        return False

    def to_dict(self):
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "service": self.service,
            "start": self.start,
            "end": self.end,
            "status": self.status,
            "attrs": self.attrs,
            "events": [{"ts": ts, "name": name, "attrs": attrs}
                       for ts, name, attrs in list(self.events)],
        }


class SpanRecorder(object):
    """A process's bounded store of FINISHED spans: `capacity` spans,
    drop-oldest with a monotone ``dropped`` counter, plus the retained
    tier. All mutation under one lock; spans are built outside it."""

    def __init__(self, service="proc", capacity=_DEFAULT_CAPACITY,
                 clock=time.time,
                 retained_capacity=_DEFAULT_RETAINED_CAPACITY,
                 sample_rate=1.0, seed=None):
        self.service = service
        self.capacity = int(capacity)
        self.clock = clock
        self.dropped = 0
        self._lock = threading.Lock()
        self._spans = deque()
        self.retained_capacity = int(retained_capacity)
        self.retained_dropped = 0
        self.sampled_out = 0
        self.sample_rate = float(sample_rate)
        self._retained = deque()
        self._retained_traces = set()
        self._classifiers = []
        self._rand = random.Random(seed)

    def add_classifier(self, fn):
        """Register a verdict hook `fn(span) -> True | False | None`
        (see the module docstring). Hooks run under the recorder lock
        at finish time; idempotent per function object."""
        with self._lock:
            if fn not in self._classifiers:
                self._classifiers.append(fn)
        return fn

    def remove_classifier(self, fn):
        """Unregister a hook (no-op if absent)."""
        with self._lock:
            self._classifiers = [f for f in self._classifiers if f != fn]

    def clear_classifiers(self):
        with self._lock:
            self._classifiers = []

    def start_span(self, name, trace_id=None, parent_span_id="", **attrs):
        """A new span; mints a trace when `trace_id` is falsy."""
        return Span(self, name, trace_id or new_trace_id(),
                    parent_span_id, attrs, self.clock())

    def _verdict_locked(self, span):
        """The first non-None verdict; a hook that raises abstains."""
        for fn in self._classifiers:
            try:
                verdict = fn(span)
            except Exception:  # noqa: BLE001 - hooks must not crash us
                verdict = None
            if verdict is not None:
                return bool(verdict)
        return None

    def _retain_locked(self, span):
        """Move `span` and every recorded span of its trace into the
        retained tier, pinning the trace; the tier is bounded
        drop-oldest with its own counter."""
        self._retained_traces.add(span.trace_id)
        moved = [s for s in self._spans if s.trace_id == span.trace_id]
        if moved:
            self._spans = deque(s for s in self._spans
                                if s.trace_id != span.trace_id)
        self._retained.extend(moved)
        self._retained.append(span)
        while len(self._retained) > self.retained_capacity:
            victim = self._retained.popleft()
            self.retained_dropped += 1
            if not any(s.trace_id == victim.trace_id
                       for s in self._retained):
                self._retained_traces.discard(victim.trace_id)

    def _finish(self, span, status):
        with self._lock:
            if span.end is not None:
                return
            span.end = self.clock()
            span.status = status
            if span.trace_id in self._retained_traces:
                self._retain_locked(span)
                return
            verdict = self._verdict_locked(span)
            if verdict is True:
                self._retain_locked(span)
                return
            if verdict is False and self._rand.random() >= self.sample_rate:
                before = len(self._spans)
                self._spans = deque(s for s in self._spans
                                    if s.trace_id != span.trace_id)
                self.sampled_out += 1 + (before - len(self._spans))
                return
            self._spans.append(span)
            while len(self._spans) > self.capacity:
                self._spans.popleft()
                self.dropped += 1

    def __len__(self):
        with self._lock:
            return len(self._retained) + len(self._spans)

    def snapshot(self):
        """Every recorded span, the retained tier first."""
        with self._lock:
            return list(self._retained) + list(self._spans)

    def clear(self):
        with self._lock:
            self._spans.clear()
            self._retained.clear()
            self._retained_traces.clear()
            self.dropped = 0
            self.retained_dropped = 0
            self.sampled_out = 0

    def export(self):
        """The per-process span document."""
        with self._lock:
            spans = list(self._retained) + list(self._spans)
            retained = len(self._retained)
            dropped = self.dropped
            retained_dropped = self.retained_dropped
            sampled_out = self.sampled_out
        return {
            "service": self.service,
            "pid": os.getpid(),
            "dropped": dropped,
            "retained": retained,
            "retained_dropped": retained_dropped,
            "sampled_out": sampled_out,
            "spans": [s.to_dict() for s in spans],
        }

    def write(self, path):
        """Atomic JSON write (a temporary file, then a rename)."""
        tmp = "%s.tmp.%d" % (path, os.getpid())
        with open(tmp, "w") as f:
            json.dump(self.export(), f)
        os.replace(tmp, path)
        return path

    def flush(self, trace_dir=None):
        """Write this process's spans into the trace directory
        (EDL_TRACE_DIR unless given); None when none is configured."""
        trace_dir = trace_dir or os.environ.get(TRACE_DIR_ENV, "")
        if not trace_dir:
            return None
        os.makedirs(trace_dir, exist_ok=True)
        safe = "".join(c if c.isalnum() or c in "-_." else "-"
                       for c in self.service)
        return self.write(os.path.join(
            trace_dir, "spans-%s-%d.json" % (safe, os.getpid())))


# ------------------------------------------------- process-global recorder

_RECORDER = SpanRecorder()
_ATEXIT_ARMED = False


def recorder():
    """The process-global recorder every subsystem records into."""
    return _RECORDER


def configure(service=None, capacity=None):
    """Name this process's recorder (e.g. ``router:50050``) and arm the
    atexit flush; safe to call repeatedly."""
    global _ATEXIT_ARMED
    if service:
        _RECORDER.service = service
    if capacity:
        _RECORDER.capacity = int(capacity)
    if not _ATEXIT_ARMED:
        _ATEXIT_ARMED = True
        atexit.register(lambda: _RECORDER.flush())
    return _RECORDER


# ------------------------------------------------------ chrome conversion


def group_by_trace(span_dicts):
    """{trace_id: [span dicts]}."""
    by_trace = {}
    for s in span_dicts:
        by_trace.setdefault(s["trace_id"], []).append(s)
    return by_trace


def trace_roots(span_dicts):
    """Spans with no parent in the set (a parent that was never
    exported leaves its children as roots)."""
    ids = {s["span_id"] for s in span_dicts}
    return [s for s in span_dicts
            if not s["parent_span_id"] or s["parent_span_id"] not in ids]


def children_of(span_dicts, parent_span_id):
    return [s for s in span_dicts if s["parent_span_id"] == parent_span_id]


def chrome_trace(span_dicts):
    """Merged span dicts as Chrome-trace JSON (the JSON Array Format):
    one process per service, one thread per trace within it; each slice
    carries its ids, attrs and status in ``args``; span events become
    instant events on the same row."""
    services = sorted({s["service"] for s in span_dicts})
    pid_of = {svc: i + 1 for i, svc in enumerate(services)}
    tid_of = {}
    events = []
    for svc, pid in pid_of.items():
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": svc}})
    for s in sorted(span_dicts, key=lambda d: (d["start"], d["name"])):
        pid = pid_of[s["service"]]
        tid = tid_of.setdefault((pid, s["trace_id"]), len(tid_of) + 1)
        end = s["end"] if s["end"] is not None else s["start"]
        args = dict(s["attrs"])
        args.update({"trace_id": s["trace_id"], "span_id": s["span_id"],
                     "parent_span_id": s["parent_span_id"],
                     "status": s["status"]})
        events.append({
            "name": s["name"], "cat": s["service"], "ph": "X",
            "pid": pid, "tid": tid, "ts": s["start"] * 1e6,
            "dur": max(0.0, (end - s["start"])) * 1e6, "args": args,
        })
        for ev in s["events"]:
            events.append({
                "name": ev["name"], "cat": s["service"], "ph": "i",
                "s": "t", "pid": pid, "tid": tid, "ts": ev["ts"] * 1e6,
                "args": dict(ev["attrs"], trace_id=s["trace_id"],
                             span_id=s["span_id"]),
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}
