"""The live metrics plane: the port of
elasticdl_tpu/observability/metrics.py, dependency-free.

* `TimeSeriesRing`: a bounded ring of fixed-interval windows over
  CUMULATIVE inputs. Each window holds counter deltas, last-observed
  gauges, histogram bucket deltas (the log-linear scheme's `to_counts()`
  form) and the exemplars new to it, so a trailing horizon answers "what
  happened in the last N seconds": what the SLO burn-rate engine
  (observability/slo.py), the windowed prefix-hit rate and the fleet
  collector read. Windows of several replicas merge by addition
  (`merge_window_deltas`). Overflow drops the oldest window and counts
  it in `dropped`.
* The Prometheus text exposition: `render_prometheus` writes families of
  counters, gauges and histograms in text format 0.0.4 (cumulative
  `_bucket{le=...}` samples at the shared scheme's bounds, `_sum`,
  `_count`, OpenMetrics exemplars on `_bucket` lines), and
  `MetricsServer` serves the page at `GET /metrics` from a stdlib
  `http.server` thread, armed by `--metrics_port` / EDL_METRICS_PORT.

Names: `edl_<service>_<counter>_total` (counter), `edl_<service>_<gauge>`
(gauge), `edl_<service>_<hist>` with `_bucket` / `_sum` / `_count`
(histogram, ms). observability/promparse.py is the independent parser.

The ring takes no lock: its owner's telemetry lock guards it. A
MetricsServer's collect callback runs on the HTTP thread and locks what
it reads.
"""

import math
import os
import threading
import time
from collections import deque

from elasticdl_tpu_torch.observability.histogram import (
    NUM_BUCKETS,
    bucket_bounds,
)


def metrics_port_default():
    """EDL_METRICS_PORT resolves the scrape port a config leaves unset:
    unset or empty is off (None), an integer that port (0 = ephemeral),
    anything else off."""
    text = os.environ.get("EDL_METRICS_PORT", "")
    if text == "":
        return None
    try:
        return int(text)
    except ValueError:
        return None


# ------------------------------------------------------------------ ring


def add_counts(a, b):
    """Elementwise bucket addition of two trimmed count lists — the one
    merge the whole histogram plane uses (router fleet merge, ring
    window merge, the collector's window deltas)."""
    if len(a) < len(b):
        a, b = b, a
    out = list(a)
    for i, c in enumerate(b):
        out[i] += c
    return out


def merge_exemplars(a, b):
    """Merge two exemplar maps ({bucket_index: (trace_id, value,
    unix_ts)}), keeping the max-value sample per bucket — the same
    associative rule LogLinearHistogram uses, so fleet-merged windows
    still name a real trace per tail bucket."""
    out = {int(k): tuple(v) for k, v in a.items()}
    for k, ex in b.items():
        k = int(k)
        ex = tuple(ex)
        cur = out.get(k)
        if cur is None or ex[1] >= cur[1]:
            out[k] = ex
    return out


def _sub_exemplars(cur, base):
    """Exemplars NEW to this window: entries of `cur` absent from (or
    changed since) `base` — the exemplar twin of the bucket-delta
    subtraction, so a window only names traces recorded inside it."""
    out = {}
    for k, ex in cur.items():
        if tuple(base.get(k, ())) != tuple(ex):
            out[k] = tuple(ex)
    return out


def _sub_counts(cur, base):
    """Trimmed `cur - base` bucket deltas (cur is cumulative, so every
    delta is >= 0 for well-formed inputs; negative deltas clamp to 0 —
    a replaced replica's counter reset must not poison a window)."""
    out = []
    for i, c in enumerate(cur):
        b = base[i] if i < len(base) else 0
        out.append(max(0, c - b))
    while out and not out[-1]:
        out.pop()
    return out


def merge_window_deltas(a, b):
    """Merge two window-delta dicts (cross-replica aggregation):
    counter deltas add, histogram bucket deltas add elementwise, gauges
    add (fleet totals). Returns a new dict; inputs untouched."""
    out = {
        "t0": min(a.get("t0", 0.0), b.get("t0", 0.0)),
        "t1": max(a.get("t1", 0.0), b.get("t1", 0.0)),
        "counters": dict(a.get("counters", {})),
        "gauges": dict(a.get("gauges", {})),
        "hists": {k: list(v) for k, v in a.get("hists", {}).items()},
        "exemplars": {k: dict(v)
                      for k, v in a.get("exemplars", {}).items()},
    }
    for name, v in b.get("counters", {}).items():
        out["counters"][name] = out["counters"].get(name, 0) + v
    for name, v in b.get("gauges", {}).items():
        out["gauges"][name] = out["gauges"].get(name, 0) + v
    for name, counts in b.get("hists", {}).items():
        out["hists"][name] = add_counts(
            out["hists"].get(name, []), counts
        )
    for name, exes in b.get("exemplars", {}).items():
        out["exemplars"][name] = merge_exemplars(
            out["exemplars"].get(name, {}), exes
        )
    return out


class TimeSeriesRing(object):
    """Bounded ring of fixed-interval windows over cumulative inputs.

    `observe()` takes CUMULATIVE counter values and CUMULATIVE histogram
    bucket counts (plus last-value gauges); the ring differences them
    at window boundaries, so feeders never maintain deltas themselves
    and the invariant `sum of all window deltas (+ the open partial) ==
    latest cumulative` holds by construction — the property the
    snapshot()/close() window-boundary regression test pins.

    A window closes at the first observation at/past `interval_secs`
    since the window opened; windows carry explicit `t0`/`t1`, so a
    sparse feeder (an idle server) yields WIDER windows rather than
    fabricated empty ones, and horizon queries weigh them by real time.
    `flush()` force-closes the open partial window (shutdown path).
    """

    def __init__(self, interval_secs=1.0, capacity=240,
                 clock=time.monotonic):
        self.interval_secs = float(interval_secs)
        self.capacity = max(1, int(capacity))
        self._clock = clock
        self._windows = deque()
        self.dropped = 0  # closed windows evicted by the bound
        self._t0 = clock()
        self._base = {"counters": {}, "hists": {}, "exemplars": {}}
        self._last = {"counters": {}, "gauges": {}, "hists": {},
                      "exemplars": {}}
        self._seen = False  # any observation since the last close

    def due(self, now=None):
        """Cheap boundary check — feeders on hot paths call this before
        paying for an `observe` snapshot."""
        now = self._clock() if now is None else now
        return now - self._t0 >= self.interval_secs

    def observe(self, counters=None, gauges=None, hists=None,
                exemplars=None, now=None, roll=True):
        """One cumulative observation; closes the open window when the
        interval has elapsed (roll=True). Values are copied — callers
        may hand live dicts/lists. `exemplars` is {hist_name:
        {bucket_index: (trace_id, value, unix_ts)}} — the histogram's
        exemplars_wire() shape — differenced at window boundaries like
        the bucket counts."""
        now = self._clock() if now is None else now
        if counters:
            self._last["counters"].update(counters)
        if gauges:
            self._last["gauges"].update(gauges)
        if hists:
            for name, counts in hists.items():
                self._last["hists"][name] = list(counts)
        if exemplars:
            for name, exes in exemplars.items():
                self._last["exemplars"][name] = {
                    int(k): tuple(v) for k, v in exes.items()
                }
        self._seen = True
        if roll and now - self._t0 >= self.interval_secs:
            self._close(now)

    def rebase(self, now=None):
        """Restart the open window from the CURRENT cumulative state
        without emitting a window: the next close deltas against now,
        not against zero. The fleet collector's first scrape of a
        long-lived process calls this so lifetime totals never
        masquerade as a window's worth of traffic."""
        now = self._clock() if now is None else now
        self._base = {
            "counters": dict(self._last["counters"]),
            "hists": {k: list(v)
                      for k, v in self._last["hists"].items()},
            "exemplars": {k: dict(v)
                          for k, v in self._last["exemplars"].items()},
        }
        self._t0 = now
        self._seen = False

    def flush(self, now=None):
        """Force-close the open partial window (even shorter than the
        interval) so a process stopping mid-window loses nothing."""
        now = self._clock() if now is None else now
        if self._seen:
            self._close(now)

    def _close(self, now):
        base = self._base
        window = {
            "t0": self._t0,
            "t1": now,
            "counters": {
                name: v - base["counters"].get(name, 0)
                for name, v in self._last["counters"].items()
            },
            "gauges": dict(self._last["gauges"]),
            "hists": {
                name: _sub_counts(counts, base["hists"].get(name, []))
                for name, counts in self._last["hists"].items()
            },
            "exemplars": {
                name: _sub_exemplars(
                    exes, base["exemplars"].get(name, {})
                )
                for name, exes in self._last["exemplars"].items()
            },
        }
        self._windows.append(window)
        if len(self._windows) > self.capacity:
            self._windows.popleft()
            self.dropped += 1
        self._base = {
            "counters": dict(self._last["counters"]),
            "hists": {k: list(v)
                      for k, v in self._last["hists"].items()},
            "exemplars": {k: dict(v)
                          for k, v in self._last["exemplars"].items()},
        }
        self._t0 = now
        self._seen = False

    # -------------------------------------------------------- queries

    def windows(self, horizon_secs=None, now=None):
        """Closed windows, oldest first; with a horizon, only windows
        whose END falls inside the trailing horizon."""
        if horizon_secs is None:
            return list(self._windows)
        now = self._clock() if now is None else now
        cutoff = now - float(horizon_secs)
        return [w for w in self._windows if w["t1"] > cutoff]

    def sum_counter(self, name, horizon_secs=None, now=None):
        return sum(
            w["counters"].get(name, 0)
            for w in self.windows(horizon_secs, now)
        )

    def merged_hist_counts(self, name, horizon_secs=None, now=None):
        """Bucket-added histogram deltas over the trailing horizon —
        hand to LogLinearHistogram.from_counts for percentiles, or to
        the SLO engine for threshold counting."""
        out = []
        for w in self.windows(horizon_secs, now):
            counts = w["hists"].get(name)
            if counts:
                out = add_counts(out, counts)
        return out

    def merged_exemplars(self, name, horizon_secs=None, now=None):
        """Max-value-per-bucket exemplar merge over the trailing
        horizon — the traces the SLO engine's bad buckets can be
        joined back to."""
        out = {}
        for w in self.windows(horizon_secs, now):
            exes = w.get("exemplars", {}).get(name)
            if exes:
                out = merge_exemplars(out, exes)
        return out

    def pending_counter(self, name):
        """The open partial window's delta for one counter (live view;
        the window is not closed)."""
        return (self._last["counters"].get(name, 0)
                - self._base["counters"].get(name, 0))

    def baseline_counter(self, name):
        """The cumulative value the open window STARTED from — a
        feeder holding a fresher cumulative than the last observe()
        computes its own live partial as `live - baseline` (the
        telemetry hit-rate does)."""
        return self._base["counters"].get(name, 0)

    def latest(self):
        """Copies of the latest CUMULATIVE observation (counters,
        gauges, hists) — what an exposition renders when it wants
        lifetime values for series the ring is the only holder of
        (e.g. the router's fleet-merged replica histograms)."""
        return {
            "counters": dict(self._last["counters"]),
            "gauges": dict(self._last["gauges"]),
            "hists": {k: list(v)
                      for k, v in self._last["hists"].items()},
            "exemplars": {k: dict(v)
                          for k, v in self._last["exemplars"].items()},
        }


# ------------------------------------------------ Prometheus exposition


def _sanitize(name):
    out = []
    for i, ch in enumerate(name):
        ok = ch.isalnum() or ch in "_:"
        if ok and not (i == 0 and ch.isdigit()):
            out.append(ch)
        else:
            out.append("_")
    return "".join(out)


def _fmt_value(v):
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return "%d" % int(v)
    return repr(v)


def _fmt_labels(labels):
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        val = str(labels[k]).replace("\\", "\\\\")
        val = val.replace('"', '\\"').replace("\n", "\\n")
        parts.append('%s="%s"' % (_sanitize(k), val))
    return "{%s}" % ",".join(parts)


def counter_family(name, help_text, value, labels=None):
    """A counter family with one sample. `name` must already end in
    `_total` (the naming rule the parser enforces)."""
    return (name, "counter", help_text, [("", labels or {}, value)])


def labeled_counter_family(name, help_text, samples):
    """A counter family with several labeled series (e.g. one
    slow-cause counter per `cause` label). `samples` =
    [(labels, value)]; `name` must end in `_total`."""
    return (name, "counter", help_text,
            [("", labels or {}, v) for labels, v in samples])


def gauge_family(name, help_text, samples):
    """`samples` = [(labels, value)] — one family may carry several
    labeled series (e.g. one burn-rate gauge per SLO x window)."""
    return (name, "gauge", help_text,
            [("", labels or {}, v) for labels, v in samples])


def hist_family(name, help_text, series):
    """A histogram family from trimmed log-linear bucket counts.

    `series` = [(labels, counts, sum_ms_or_None)] or
    [(labels, counts, sum_ms_or_None, exemplars)] — counts in the
    shared scheme's wire form, `exemplars` the histogram's
    {bucket_index: (trace_id, value, unix_ts)} map. Renders cumulative
    `_bucket` samples at every NON-EMPTY bucket's upper bound plus the
    mandatory `+Inf`, `_sum` (estimated from bucket midpoints when not
    supplied) and `_count`; a bucket with an exemplar renders it in
    OpenMetrics exemplar syntax after the sample value
    (``... # {trace_id="..."} 12.3 1722800000``). Subsetting the
    bounds is valid Prometheus — cumulative counts stay monotone, and
    the shared scheme makes any two expositions comparable
    bucket-for-bucket."""
    samples = []
    for entry in series:
        labels, counts, sum_ms = entry[0], entry[1], entry[2]
        exemplars = entry[3] if len(entry) > 3 else None
        cum = 0
        est_sum = 0.0
        for i, c in enumerate(counts):
            if i >= NUM_BUCKETS:
                break
            if not c:
                continue
            cum += c
            lo, hi = bucket_bounds(i)
            est_sum += (lo + hi) / 2.0 * c
            lab = dict(labels or {})
            lab["le"] = _fmt_value(hi)
            ex = (exemplars or {}).get(i)
            if ex is not None:
                tid, value, ts = ex
                samples.append(("_bucket", lab, cum,
                                (str(tid), float(value), float(ts))))
            else:
                samples.append(("_bucket", lab, cum))
        lab = dict(labels or {})
        lab["le"] = "+Inf"
        samples.append(("_bucket", lab, cum))
        samples.append(("_sum", dict(labels or {}),
                        est_sum if sum_ms is None else sum_ms))
        samples.append(("_count", dict(labels or {}), cum))
    return (name, "histogram", help_text, samples)


def render_prometheus(families):
    """Prometheus text format 0.0.4 from [(name, type, help, samples)]
    families; samples are [(suffix, labels, value)] or — on histogram
    `_bucket` lines only — [(suffix, labels, value, (trace_id,
    ex_value, ex_unix_ts))], rendered as an OpenMetrics exemplar."""
    lines = []
    for name, mtype, help_text, samples in families:
        base = _sanitize(name)
        lines.append("# HELP %s %s" % (
            base,
            str(help_text).replace("\\", "\\\\").replace("\n", "\\n"),
        ))
        lines.append("# TYPE %s %s" % (base, mtype))
        for sample in samples:
            suffix, labels, value = sample[0], sample[1], sample[2]
            line = "%s%s%s %s" % (
                base, _sanitize(suffix) if suffix else "",
                _fmt_labels(labels), _fmt_value(value),
            )
            if len(sample) > 3 and sample[3] is not None:
                tid, ex_value, ex_ts = sample[3]
                line += " # %s %s %s" % (
                    _fmt_labels({"trace_id": tid}),
                    _fmt_value(ex_value), _fmt_value(ex_ts),
                )
            lines.append(line)
    return "\n".join(lines) + "\n"


class MetricsServer(object):
    """`GET /metrics` over stdlib http.server on a daemon thread.

    `collect` returns the families to render (called per scrape, on
    the HTTP thread — collectors lock themselves). Off by default
    everywhere; entrypoints arm it via --metrics_port /
    EDL_METRICS_PORT. Binds host 0.0.0.0 so a scraper on another host
    reaches it; port 0 = ephemeral (the bound port is `self.port`)."""

    def __init__(self, collect, port=0, host="0.0.0.0"):
        import http.server
        import socketserver

        self._collect = collect
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - http.server API
                if self.path.split("?")[0] != "/metrics":
                    self.send_error(404)
                    return
                try:
                    body = render_prometheus(
                        outer._collect()
                    ).encode("utf-8")
                except Exception as e:  # noqa: BLE001 - scrape = 500
                    self.send_error(500, str(e))
                    return
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8",
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *_args):
                pass  # scrapes must not spam the serving logs

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, int(port)), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="metrics-exposition",
        )
        self._thread.start()

    def close(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
