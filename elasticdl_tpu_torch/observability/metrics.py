"""The windowed time-series ring: the port's copy of `TimeSeriesRing`
from elasticdl_tpu/observability/metrics.py, which the serving and
router telemetry feed, the windowed prefix-hit rate and the SLO
burn-rate engine (observability/slo.py) read, with `add_counts` (the
bucket addition every fleet merge uses) and `metrics_port_default`.

Not ported: the Prometheus exposition, the metrics HTTP server, the
exemplar maps, the ring's partial-window queries and the window merges
of the fleet collector (ROADMAP Queue 1 item 6).
"""

import os
import time
from collections import deque


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


def add_counts(a, b):
    """Elementwise bucket addition of two trimmed count lists."""
    if len(a) < len(b):
        a, b = b, a
    out = list(a)
    for i, c in enumerate(b):
        out[i] += c
    return out


def _sub_counts(cur, base):
    """Trimmed `cur - base` bucket deltas; a negative delta clamps to 0."""
    out = []
    for i, c in enumerate(cur):
        b = base[i] if i < len(base) else 0
        out.append(max(0, c - b))
    while out and not out[-1]:
        out.pop()
    return out


class TimeSeriesRing(object):
    """Bounded ring of fixed-interval windows over cumulative inputs.

    `observe()` takes CUMULATIVE counter values and histogram bucket
    counts (plus last-value gauges); the ring differences them at window
    boundaries, so the sum of all window deltas (and the open partial)
    equals the latest cumulative value.

    A window closes at the first observation at or past `interval_secs`
    since the window opened; windows carry explicit `t0` / `t1`, so a
    sparse feeder yields wider windows, not empty ones, and horizon
    queries weigh them by real time. `flush()` force-closes the open
    partial window.
    """

    def __init__(self, interval_secs=1.0, capacity=240,
                 clock=time.monotonic):
        self.interval_secs = float(interval_secs)
        self.capacity = max(1, int(capacity))
        self._clock = clock
        self._windows = deque()
        self.dropped = 0  # closed windows evicted by the bound
        self._t0 = clock()
        self._base = {"counters": {}, "hists": {}}
        self._last = {"counters": {}, "gauges": {}, "hists": {}}
        self._seen = False  # any observation since the last close

    def due(self, now=None):
        """Cheap boundary check, for feeders on hot paths."""
        now = self._clock() if now is None else now
        return now - self._t0 >= self.interval_secs

    def observe(self, counters=None, gauges=None, hists=None, now=None,
                roll=True):
        """One cumulative observation; closes the open window when the
        interval has elapsed (roll=True). Values are copied."""
        now = self._clock() if now is None else now
        if counters:
            self._last["counters"].update(counters)
        if gauges:
            self._last["gauges"].update(gauges)
        if hists:
            for name, counts in hists.items():
                self._last["hists"][name] = list(counts)
        self._seen = True
        if roll and now - self._t0 >= self.interval_secs:
            self._close(now)

    def flush(self, now=None):
        """Force-close the open partial window."""
        now = self._clock() if now is None else now
        if self._seen:
            self._close(now)

    def _rebase(self):
        self._base = {
            "counters": dict(self._last["counters"]),
            "hists": {k: list(v) for k, v in self._last["hists"].items()},
        }

    def _close(self, now):
        base = self._base
        self._windows.append({
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
        })
        if len(self._windows) > self.capacity:
            self._windows.popleft()
            self.dropped += 1
        self._rebase()
        self._t0 = now
        self._seen = False

    # -------------------------------------------------------- queries

    def windows(self, horizon_secs=None, now=None):
        """Closed windows, oldest first; with a horizon, only those
        whose END falls inside the trailing horizon."""
        if horizon_secs is None:
            return list(self._windows)
        now = self._clock() if now is None else now
        cutoff = now - float(horizon_secs)
        return [w for w in self._windows if w["t1"] > cutoff]

    def sum_counter(self, name, horizon_secs=None, now=None):
        return sum(w["counters"].get(name, 0)
                   for w in self.windows(horizon_secs, now))

    def merged_hist_counts(self, name, horizon_secs=None, now=None):
        """Bucket-added histogram deltas over the trailing horizon, for
        LogLinearHistogram.from_counts or the SLO engine's threshold
        count."""
        out = []
        for w in self.windows(horizon_secs, now):
            counts = w["hists"].get(name)
            if counts:
                out = add_counts(out, counts)
        return out

    def baseline_counter(self, name):
        """The cumulative value the open window started from."""
        return self._base["counters"].get(name, 0)
