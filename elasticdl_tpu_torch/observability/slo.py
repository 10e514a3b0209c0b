"""SLO burn-rate engine over the windowed time-series ring: the port of
elasticdl_tpu/observability/slo.py.

An SLO is a declared objective plus an ERROR BUDGET: "TTFT p99 under
500 ms" means "at most `goal` (e.g. 1%) of requests may exceed 500 ms".
The burn rate of a window is how fast the budget is being spent:

    burn = bad_fraction(window) / goal

burn == 1.0 spends the budget exactly on schedule. Each objective is
evaluated over two trailing horizons of the ring, a FAST window that
reacts to an incident and a SLOW window that filters blips; `alerting`
is true only when both burn above 1.0.

Two objective kinds, both computed from ring window deltas alone:

* **latency**: bad = samples in histogram buckets strictly above the
  threshold's bucket (the bucket containing the threshold counts as
  good, within the log-linear scheme's 3.1% resolution); total = all
  samples in the horizon;
* **availability**: bad = the sum of the declared bad-counter deltas,
  total = the sum of the total-counter deltas (shed + errors over
  routed: the goodput floor).

Burn rates are signals, not actions: the router reports them in
`router_status` (SloObjective blocks).
"""

from elasticdl_tpu_torch.observability.histogram import bucket_index


class SloSpec(object):
    """One declared objective. kind "latency" needs `hist` (the ring
    histogram name) and `threshold_ms`; kind "availability" needs
    `bad_counters` and `total_counters`. `goal` is the allowed bad
    fraction (the error budget), in (0, 1)."""

    KINDS = ("latency", "availability")

    def __init__(self, name, kind, goal, hist=None, threshold_ms=None,
                 bad_counters=(), total_counters=()):
        if kind not in self.KINDS:
            raise ValueError("unknown SLO kind %r" % (kind,))
        if not 0.0 < float(goal) < 1.0:
            raise ValueError("goal must be in (0, 1), got %r" % (goal,))
        if kind == "latency" and (not hist or threshold_ms is None):
            raise ValueError(
                "latency SLO %r needs hist + threshold_ms" % name)
        if kind == "availability" and (
                not bad_counters or not total_counters):
            raise ValueError(
                "availability SLO %r needs bad/total counters" % name)
        self.name = name
        self.kind = kind
        self.goal = float(goal)
        self.hist = hist
        self.threshold_ms = (None if threshold_ms is None
                             else float(threshold_ms))
        self.bad_counters = tuple(bad_counters)
        self.total_counters = tuple(total_counters)


def default_router_slos(ttft_p99_ms, e2e_p99_ms, goodput_goal,
                        latency_goal=0.01):
    """The routing tier's three objectives: fleet TTFT p99, router e2e
    p99, and the goodput floor (shed + terminal errors over routed)."""
    return [
        SloSpec("ttft_p99", "latency", latency_goal,
                hist="fleet_ttft_ms", threshold_ms=ttft_p99_ms),
        SloSpec("e2e_p99", "latency", latency_goal,
                hist="e2e_ms", threshold_ms=e2e_p99_ms),
        SloSpec("goodput", "availability", goodput_goal,
                bad_counters=("shed", "errors"),
                total_counters=("routed",)),
    ]


class BurnRateEngine(object):
    """Evaluates SloSpecs against one TimeSeriesRing. Stateless between
    calls (the ring is the state); `evaluate` returns plain dicts:

        {"name", "kind", "goal", "threshold_ms", "fast_burn",
         "slow_burn", "fast_window_secs", "slow_window_secs",
         "fast_samples", "slow_samples", "alerting"}

    Burns are always finite: an empty horizon spends no budget."""

    def __init__(self, specs, fast_window_secs=30.0,
                 slow_window_secs=120.0):
        self.specs = list(specs)
        self.fast_window_secs = float(fast_window_secs)
        self.slow_window_secs = float(slow_window_secs)

    def _bad_total(self, spec, ring, horizon, now):
        if spec.kind == "latency":
            counts = ring.merged_hist_counts(spec.hist, horizon, now)
            cut = bucket_index(spec.threshold_ms)
            return sum(counts[cut + 1:]), sum(counts)
        bad = sum(ring.sum_counter(c, horizon, now)
                  for c in spec.bad_counters)
        total = sum(ring.sum_counter(c, horizon, now)
                    for c in spec.total_counters)
        return bad, total

    def evaluate(self, ring, now=None):
        reports = []
        for spec in self.specs:
            fb, ft = self._bad_total(spec, ring, self.fast_window_secs, now)
            sb, st = self._bad_total(spec, ring, self.slow_window_secs, now)
            fast = (fb / ft / spec.goal) if ft else 0.0
            slow = (sb / st / spec.goal) if st else 0.0
            reports.append({
                "name": spec.name,
                "kind": spec.kind,
                "goal": spec.goal,
                "threshold_ms": spec.threshold_ms or 0.0,
                "fast_burn": fast,
                "slow_burn": slow,
                "fast_window_secs": self.fast_window_secs,
                "slow_window_secs": self.slow_window_secs,
                "fast_samples": ft,
                "slow_samples": st,
                "alerting": fast > 1.0 and slow > 1.0,
            })
        return reports
