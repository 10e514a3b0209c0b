"""Serving telemetry: the port's copy of `ServingTelemetry` from
elasticdl_tpu/serving/telemetry.py, the counters, gauges and latency
histograms behind a replica's ServerStatus.

The counter, gauge and slow-cause sets are closed: `count`, `gauge` and
`count_slow_cause` raise on a name not declared, because a typo would
silently fork a fresh counter and under-report the real one. Latencies
(time to first token, queue wait, decode step, end to end; ms) live in
the shared log-linear histograms (observability/histogram.py), so the
status's percentiles are computed as the JAX package computes them.
Every counter, gauge and histogram also feeds a windowed
`TimeSeriesRing` (observability/metrics.py), from which the windowed
prefix-hit rate is read.

The snapshot derives `kv_bytes_per_token` = sum over decode steps of
kv_bytes_in_use / tokens_generated: the average KV bytes resident per
generated token.

Thread-safety: the scheduler thread records steps and latencies,
handler threads bump admission counters and read snapshots, all under
one lock. Nothing here touches the device.

Not ported: the TensorBoard event writer (`log_dir`), the Prometheus
exposition, histogram exemplars and RouterTelemetry (ROADMAP Queue 1
items 4 and 6).
"""

import threading
import time

from elasticdl_tpu_torch.observability.forensics import CAUSES
from elasticdl_tpu_torch.observability.histogram import LogLinearHistogram
from elasticdl_tpu_torch.observability.metrics import TimeSeriesRing


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

    def __init__(self, log_dir=None, clock=time.monotonic):
        if log_dir:
            raise NotImplementedError(
                "the serving telemetry's TensorBoard writer is not ported "
                "yet (ROADMAP Queue 1 item 6, the replica's metrics "
                "plane)")
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
        """Time to first token of one request, at its first token."""
        ttft_ms = (self._clock() - request.submitted_at) * 1000.0
        with self._lock:
            self.hists["ttft_ms"].record(ttft_ms)
            self._gauge_locked("ttft_ms", ttft_ms)
            if self.ring.due():
                self._ring_observe_locked()
        return ttft_ms

    def record_e2e(self, latency_ms):
        """End-to-end latency of one completed request."""
        with self._lock:
            self.hists["e2e_ms"].record(latency_ms)

    def record_queue_wait(self, wait_secs):
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
            self.hists["queue_wait_ms"].record(wait_ms)
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

    def close(self):
        """Land the final partial window in the ring."""
        with self._lock:
            self._ring_observe_locked(roll=False)
            self.ring.flush()
