"""Serving telemetry: the port's copy of `ServingTelemetry` and
`RouterTelemetry` from elasticdl_tpu/serving/telemetry.py, the counters,
gauges and latency histograms behind a replica's ServerStatus and the
router's RouterStatus.

The counter, gauge and slow-cause sets are closed: `count`, `gauge` and
`count_slow_cause` raise on a name not declared, because a typo would
silently fork a fresh counter and under-report the real one. Latencies
(time to first token, queue wait, decode step, end to end; ms) live in
the shared log-linear histograms (observability/histogram.py), so the
status's percentiles are computed as the JAX package computes them.
Every counter, gauge and histogram also feeds a windowed
`TimeSeriesRing` (observability/metrics.py), from which the windowed
prefix-hit rate is read. With `exemplars` on (the server's forensics
switch), the record sites pass each request's trace id into the TTFT,
queue-wait and end-to-end histograms, so a scraped tail bucket names a
real trace, and the ring differences those exemplars too.
`prometheus()` returns the exposition families the JAX package's
`prometheus()` returns, by the same names, help strings and series.

The snapshot derives `kv_bytes_per_token` = sum over decode steps of
kv_bytes_in_use / tokens_generated: the average KV bytes resident per
generated token.

Thread-safety: the scheduler thread records steps and latencies,
handler threads bump admission counters and read snapshots, the metrics
thread renders, all under one lock. Nothing here touches the device.

Not ported: the TensorBoard event writer (`log_dir` raises; ROADMAP
Queue 1 item 6).
"""

import threading
import time

from elasticdl_tpu_torch.observability.forensics import CAUSES
from elasticdl_tpu_torch.observability.histogram import LogLinearHistogram
from elasticdl_tpu_torch.observability.metrics import (
    TimeSeriesRing,
    counter_family,
    gauge_family,
    hist_family,
    labeled_counter_family,
)

_ITEM6 = "ROADMAP Queue 1 item 6, the TensorBoard writers"


class ServingTelemetry(object):
    #: the closed counter set. prefix_hit_tokens counts prompt tokens
    #: seated by shared-prefix incref, prompt_tokens every prompt token
    #: seated (the hit rate's denominator), cow_copies the copy-on-write
    #: faults, draft_proposed / draft_accepted the speculative proposals;
    #: revive_uploads / prefill_tokens_revived / host_drops the paged
    #: pool's host tier (forwarded by the engine by delta, with the
    #: kv_host_blocks / kv_host_bytes gauges fed each step); the health
    #: pair is declared as in the JAX package and stays 0 until that
    #: plane is ported.
    COUNTERS = ("admitted", "rejected", "expired", "completed",
                "tokens_generated", "reloads", "prefix_hit_tokens",
                "prompt_tokens", "cow_copies", "draft_proposed",
                "draft_accepted", "revive_uploads",
                "prefill_tokens_revived", "host_drops",
                "steady_recompiles", "stalls")
    #: the closed gauge set
    GAUGES = ("queue_depth", "active_slots", "step_ms",
              "tokens_per_sec", "ttft_ms", "queue_wait_ms",
              "kv_bytes_in_use", "kv_blocks_free", "kv_host_blocks",
              "kv_host_bytes", "ttft_p99", "e2e_p99",
              "prefix_hit_rate_window", "last_progress_age_ms",
              "memory_unaccounted_bytes")
    #: latency histograms (ms), all on the shared bucket scheme
    HISTOGRAMS = ("ttft_ms", "queue_wait_ms", "step_ms", "e2e_ms")
    #: the closed slow-cause set (observability/forensics.py)
    SLOW_CAUSES = CAUSES
    #: the windowed prefix-hit rate's trailing horizon (secs)
    PREFIX_HIT_HORIZON_SECS = 30.0
    #: the queue-wait EWMA's weight: a load signal tracks the current
    #: regime, not the lifetime mean
    QUEUE_WAIT_ALPHA = 0.3
    #: decode steps a tokens/s window spans
    FLUSH_EVERY = 50
    #: the ring's window (secs) and its bound (windows)
    RING_SECS, RING_WINDOWS = 1.0, 240

    def __init__(self, log_dir=None, clock=time.monotonic, exemplars=True):
        """`exemplars`: trace ids into the latency histograms."""
        if log_dir:
            raise NotImplementedError(
                "the serving telemetry's TensorBoard writer is not ported "
                "yet (%s)" % _ITEM6)
        self._exemplars = bool(exemplars)
        self._clock = clock
        self._lock = threading.Lock()
        self._started = clock()
        self.counters = {name: 0 for name in self.COUNTERS}
        self.gauges = {name: 0.0 for name in self.GAUGES}
        self.slow_causes = {name: 0 for name in self.SLOW_CAUSES}
        self.hists = {name: LogLinearHistogram()
                      for name in self.HISTOGRAMS}
        self.ring = TimeSeriesRing(interval_secs=self.RING_SECS,
                                   capacity=self.RING_WINDOWS, clock=clock)
        self.max_active_slots = 0
        self.kv_bytes_in_use_peak = 0
        self._kv_byte_steps = 0  # sum of kv_bytes_in_use over steps
        self._queue_wait_ewma_ms = 0.0
        self._queue_waits_seen = 0
        self._step = 0
        self._window_tokens = 0
        self._window_t0 = clock()

    def _gauge_locked(self, name, value):
        if name not in self.gauges:
            raise ValueError(
                "unknown serving gauge %r (declared: %s)"
                % (name, ", ".join(self.GAUGES)))
        self.gauges[name] = float(value)

    def gauge(self, name, value):
        with self._lock:
            self._gauge_locked(name, value)

    def _ring_observe_locked(self, roll=True):
        """Feed the ring one cumulative snapshot; slow-cause counts ride
        as `slow_cause.<cause>` counters."""
        counters = dict(self.counters)
        for cause, n in self.slow_causes.items():
            counters["slow_cause.%s" % cause] = n
        self.ring.observe(
            counters=counters, gauges=self.gauges,
            hists={name: h.to_counts() for name, h in self.hists.items()},
            exemplars={name: h.exemplars for name, h in self.hists.items()
                       if h.exemplars},
            roll=roll)

    # ------------------------------------------------------------ events

    def count(self, name, n=1):
        with self._lock:
            if name not in self.counters:
                raise ValueError(
                    "unknown serving counter %r (declared: %s)"
                    % (name, ", ".join(self.COUNTERS)))
            self.counters[name] += n

    def count_slow_cause(self, cause, n=1):
        """One terminally-slow request attributed to `cause`."""
        with self._lock:
            if cause not in self.slow_causes:
                raise ValueError(
                    "unknown slow cause %r (declared: %s)"
                    % (cause, ", ".join(self.SLOW_CAUSES)))
            self.slow_causes[cause] += n

    def reset_latency(self):
        """Drop the latency distributions (histograms, the queue-wait
        EWMA, the ring) and keep the monotone counters: the entry's
        warmup calls this so the first request's kernel build never
        shows in the percentiles."""
        with self._lock:
            for name in self.hists:
                self.hists[name] = LogLinearHistogram()
            self._queue_wait_ewma_ms = 0.0
            self._queue_waits_seen = 0
            self.ring = TimeSeriesRing(interval_secs=self.RING_SECS,
                                       capacity=self.RING_WINDOWS,
                                       clock=self._clock)

    def record_ttft(self, request):
        """Time to first token of one request, at its first token; the
        request's trace id rides in as the bucket's exemplar."""
        ttft_ms = (self._clock() - request.submitted_at) * 1000.0
        trace_id = (getattr(request, "trace_id", "")
                    if self._exemplars else "")
        with self._lock:
            self.hists["ttft_ms"].record(ttft_ms, trace_id=trace_id or None)
            self._gauge_locked("ttft_ms", ttft_ms)
            if self.ring.due():
                self._ring_observe_locked()
        return ttft_ms

    def record_e2e(self, latency_ms, trace_id=None):
        """End-to-end latency of one completed request."""
        with self._lock:
            self.hists["e2e_ms"].record(
                latency_ms, trace_id=trace_id if self._exemplars else None)

    def record_queue_wait(self, wait_secs, trace_id=None):
        """Time one request spent queued before seating: the EWMA and
        the queue-wait histogram."""
        wait_ms = wait_secs * 1000.0
        with self._lock:
            if self._queue_waits_seen == 0:
                self._queue_wait_ewma_ms = wait_ms
            else:
                a = self.QUEUE_WAIT_ALPHA
                self._queue_wait_ewma_ms = (
                    a * wait_ms + (1.0 - a) * self._queue_wait_ewma_ms)
            self._queue_waits_seen += 1
            self.hists["queue_wait_ms"].record(
                wait_ms, trace_id=trace_id if self._exemplars else None)
            self._gauge_locked("queue_wait_ms", self._queue_wait_ewma_ms)
        return wait_ms

    def record_step(self, queue_depth, active_slots, step_secs,
                    tokens_committed, kv_bytes_in_use=None,
                    kv_blocks_free=None, kv_host_blocks=None,
                    kv_host_bytes=None):
        """One decode step's gauges; the tokens/s window closes every
        FLUSH_EVERY steps."""
        with self._lock:
            self._step += 1
            self.max_active_slots = max(self.max_active_slots, active_slots)
            self.counters["tokens_generated"] += tokens_committed
            self._window_tokens += tokens_committed
            self.hists["step_ms"].record(step_secs * 1000.0)
            if kv_bytes_in_use is not None:
                self.kv_bytes_in_use_peak = max(self.kv_bytes_in_use_peak,
                                                kv_bytes_in_use)
                self._kv_byte_steps += kv_bytes_in_use
                self._gauge_locked("kv_bytes_in_use", kv_bytes_in_use)
            if kv_blocks_free is not None:
                self._gauge_locked("kv_blocks_free", kv_blocks_free)
            if kv_host_blocks is not None:
                self._gauge_locked("kv_host_blocks", kv_host_blocks)
            if kv_host_bytes is not None:
                self._gauge_locked("kv_host_bytes", kv_host_bytes)
            self._gauge_locked("queue_depth", queue_depth)
            self._gauge_locked("active_slots", active_slots)
            self._gauge_locked("step_ms", step_secs * 1000.0)
            if self._step % self.FLUSH_EVERY == 0:
                self._flush_window_locked()
            if self.ring.due():
                self._ring_observe_locked()

    def _prefix_hit_rate_locked(self):
        """The share of prompt tokens seated without prefill compute
        over the trailing horizon: closed ring windows plus the open
        partial, read from the live counters."""
        horizon = self.PREFIX_HIT_HORIZON_SECS
        hit = (self.ring.sum_counter("prefix_hit_tokens", horizon)
               + self.counters["prefix_hit_tokens"]
               - self.ring.baseline_counter("prefix_hit_tokens"))
        total = (self.ring.sum_counter("prompt_tokens", horizon)
                 + self.counters["prompt_tokens"]
                 - self.ring.baseline_counter("prompt_tokens"))
        return hit / total if total > 0 else 0.0

    def _flush_window_locked(self):
        """Close the tokens/s window and refresh the headline gauges."""
        now = self._clock()
        window = max(now - self._window_t0, 1e-9)
        self._gauge_locked("tokens_per_sec", self._window_tokens / window)
        self._window_tokens = 0
        self._window_t0 = now
        for hist_name in ("ttft_ms", "e2e_ms"):
            hist = self.hists[hist_name]
            if hist.count:
                self._gauge_locked("%s_p99" % hist_name.replace("_ms", ""),
                                   hist.percentile(99))
        self._gauge_locked("prefix_hit_rate_window",
                           self._prefix_hit_rate_locked())

    # ---------------------------------------------------------- snapshot

    def snapshot(self):
        with self._lock:
            snap = dict(self.counters)
            snap["max_active_slots"] = self.max_active_slots
            snap["uptime_secs"] = self._clock() - self._started
            snap["steps"] = self._step
            snap["kv_bytes_in_use_peak"] = self.kv_bytes_in_use_peak
            snap["kv_bytes_per_token"] = (
                self._kv_byte_steps
                / max(1, self.counters["tokens_generated"]))
            snap["queue_wait_ms"] = self._queue_wait_ewma_ms
            snap["prefix_hit_rate_window"] = self._prefix_hit_rate_locked()
            for prefix in ("ttft", "queue_wait", "e2e", "step"):
                hist = self.hists[prefix + "_ms"]
                for q in (50, 90, 99):
                    snap["%s_p%d_ms" % (prefix, q)] = hist.percentile(q)
            snap["ttft_hist"] = self.hists["ttft_ms"].to_counts()
            snap["queue_wait_hist"] = self.hists["queue_wait_ms"].to_counts()
            snap["slow_cause_counts"] = [self.slow_causes[c]
                                         for c in self.SLOW_CAUSES]
            snap["slow_requests"] = sum(self.slow_causes.values())
            return snap

    def prometheus(self):
        """The exposition families: every counter as
        edl_serving_<name>_total, every gauge as edl_serving_<name>,
        every histogram with its exemplars, the slow-cause counters by
        `cause` label and the ring's dropped windows; taken under the
        lock (the metrics thread calls it)."""
        with self._lock:
            fams = [counter_family("edl_serving_%s_total" % name,
                                   "serving counter %s" % name,
                                   self.counters[name])
                    for name in self.COUNTERS]
            gauges = dict(self.gauges)
            gauges["prefix_hit_rate_window"] = self._prefix_hit_rate_locked()
            fams += [gauge_family("edl_serving_%s" % name,
                                  "serving gauge %s" % name,
                                  [({}, gauges[name])])
                     for name in self.GAUGES]
            for name in self.HISTOGRAMS:
                h = self.hists[name]
                fams.append(hist_family(
                    "edl_serving_%s" % name,
                    "serving latency histogram %s (shared log-linear "
                    "scheme)" % name,
                    [({}, h.to_counts(), h.sum, h.exemplars)]))
            fams.append(labeled_counter_family(
                "edl_serving_slow_cause_total",
                "terminally-slow requests by dominant attributed "
                "cause (observability/forensics.py taxonomy)",
                [({"cause": c}, self.slow_causes[c])
                 for c in self.SLOW_CAUSES]))
            fams.append(gauge_family(
                "edl_serving_ring_windows_dropped",
                "time-series ring windows evicted by the bound",
                [({}, self.ring.dropped)]))
            return fams

    def close(self):
        """Land the final partial window in the ring."""
        with self._lock:
            self._ring_observe_locked(roll=False)
            self.ring.flush()


class RouterTelemetry(object):
    """The routing tier's counters and gauges behind router_status.

    Counters (a closed set: `count` raises on an unknown name): routed
    (accepted dispatches), completed (returned OK), redispatched (re-sent
    after a replica failure), hedges, hedge_wins, shed
    (RESOURCE_EXHAUSTED with no replica in rotation), breaker_trips
    (closed -> open), errors (terminal failures), affinity_hits /
    affinity_misses (requests with a prefix fingerprint that did / did
    not land on their learned replica), disagg_handoffs /
    disagg_fallbacks (prefill -> decode handoffs; a fallback dispatches
    cold, it does not fail). Gauges (closed too): healthy_replicas and
    replicas at the last heartbeat, cell_id and cells.

    The router's end-to-end dispatch latency (accept -> terminal outcome,
    re-dispatches and hedges included) rides the shared log-linear
    histogram behind router_status's e2e_p* fields. Every heartbeat poll
    feeds the ring one cumulative observation: the counters, the e2e
    buckets and the fleet-merged replica histograms the router hands in
    (`fleet_hists`) and the e2e exemplars; the SLO burn-rate engine reads
    that ring, `prometheus()` renders it. `flush_every` is the
    TensorBoard writer's cadence (the writer is not ported: a `log_dir`
    raises)."""

    COUNTERS = ("routed", "completed", "redispatched", "hedges",
                "hedge_wins", "shed", "breaker_trips", "errors",
                "affinity_hits", "affinity_misses",
                "disagg_handoffs", "disagg_fallbacks")
    GAUGES = ("healthy_replicas", "replicas", "cell_id", "cells")

    def __init__(self, log_dir=None, flush_every=20, clock=time.monotonic,
                 ring_secs=2.0, ring_windows=300):
        if log_dir:
            raise NotImplementedError(
                "the router telemetry's TensorBoard writer is not ported "
                "yet (%s)" % _ITEM6)
        del flush_every  # the writer's cadence
        self._clock = clock
        self._lock = threading.Lock()
        self._started = clock()
        self._poll = 0
        self.counters = {name: 0 for name in self.COUNTERS}
        self.gauges = {name: 0.0 for name in self.GAUGES}
        self.hists = {"e2e_ms": LogLinearHistogram()}
        self.ring = TimeSeriesRing(interval_secs=ring_secs,
                                   capacity=ring_windows, clock=clock)

    def _gauge_locked(self, name, value):
        if name not in self.gauges:
            raise ValueError(
                "unknown router gauge %r (declared: %s)"
                % (name, ", ".join(self.GAUGES)))
        self.gauges[name] = float(value)

    def gauge(self, name, value):
        with self._lock:
            self._gauge_locked(name, value)

    def count(self, name, n=1):
        with self._lock:
            if name not in self.counters:
                raise ValueError(
                    "unknown router counter %r (declared: %s)"
                    % (name, ", ".join(self.COUNTERS)))
            self.counters[name] += n

    def record_e2e(self, latency_ms, trace_id=None):
        """The end-to-end latency of one dispatch that reached a
        terminal outcome; `trace_id` becomes the bucket's exemplar."""
        with self._lock:
            self.hists["e2e_ms"].record(latency_ms, trace_id=trace_id)

    def record_poll(self, healthy, replicas, fleet_hists=None):
        """One heartbeat sweep: the rotation gauges and one cumulative
        ring observation (the counters, the e2e buckets and
        `fleet_hists`, e.g. {"fleet_ttft_ms": cumulative buckets})."""
        with self._lock:
            self._poll += 1
            self._gauge_locked("healthy_replicas", healthy)
            self._gauge_locked("replicas", replicas)
            hists = {"e2e_ms": self.hists["e2e_ms"].to_counts()}
            if fleet_hists:
                hists.update(fleet_hists)
            self.ring.observe(
                counters=self.counters, gauges=self.gauges, hists=hists,
                exemplars={"e2e_ms": self.hists["e2e_ms"].exemplars})

    def evaluate_slos(self, engine, now=None):
        """A BurnRateEngine over the ring, under the telemetry lock."""
        with self._lock:
            return engine.evaluate(self.ring, now)

    def snapshot(self):
        with self._lock:
            snap = dict(self.counters)
            snap["uptime_secs"] = self._clock() - self._started
            snap["polls"] = self._poll
            snap["healthy_replicas"] = int(self.gauges["healthy_replicas"])
            snap["replicas"] = int(self.gauges["replicas"])
            for q in (50, 90, 99):
                snap["e2e_p%d_ms" % q] = self.hists["e2e_ms"].percentile(q)
            return snap

    def prometheus(self):
        """The routing tier's families: the counters and gauges, the
        router's e2e histogram with its exemplars, and every
        fleet-merged histogram of the ring's latest observation, so one
        scrape of the router answers fleet TTFT."""
        with self._lock:
            fams = [counter_family("edl_router_%s_total" % name,
                                   "router counter %s" % name,
                                   self.counters[name])
                    for name in self.COUNTERS]
            fams += [gauge_family("edl_router_%s" % name,
                                  "router gauge %s" % name,
                                  [({}, self.gauges[name])])
                     for name in self.GAUGES]
            h = self.hists["e2e_ms"]
            fams.append(hist_family(
                "edl_router_e2e_ms",
                "router end-to-end dispatch latency (shared "
                "log-linear scheme)",
                [({}, h.to_counts(), h.sum, h.exemplars)]))
            for name, counts in sorted(self.ring.latest()["hists"].items()):
                if name == "e2e_ms":
                    continue  # the live histogram above
                fams.append(hist_family(
                    "edl_router_%s" % name,
                    "fleet-merged replica histogram %s (bucket "
                    "addition across the roster)" % name,
                    [({}, counts, None)]))
            fams.append(gauge_family(
                "edl_router_ring_windows_dropped",
                "time-series ring windows evicted by the bound",
                [({}, self.ring.dropped)]))
            return fams

    def close(self):
        """Land the final partial window in the ring."""
        with self._lock:
            self.ring.observe(
                counters=self.counters, gauges=self.gauges,
                hists={"e2e_ms": self.hists["e2e_ms"].to_counts()},
                roll=False)
            self.ring.flush()
