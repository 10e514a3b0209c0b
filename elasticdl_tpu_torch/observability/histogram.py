"""Fixed-bucket log-linear latency histograms: the port's copy of
elasticdl_tpu/observability/histogram.py's bucket scheme and
`LogLinearHistogram`, so a percentile the port reports is computed as
the JAX package computes it.

Values are non-negative floats (the system records milliseconds),
scaled by 1/RESOLUTION to an integer n; the first SUBBUCKETS buckets
are linear, above that each power-of-two range is split into
SUBBUCKETS/2 linear subbuckets, so the relative error is at most
2/SUBBUCKETS (~3.1%) at every magnitude, in NUM_BUCKETS (832) buckets.

Not ported: exemplars and the wire form (`exemplars_wire`,
`from_counts`), which serve the JAX package's metrics plane and router.
No lock: the owner of a histogram locks it.
"""

import math

#: smallest distinguishable value (0.01 => 10 us when recording ms)
RESOLUTION = 0.01
#: linear subbuckets per power-of-two range (a power of two)
SUBBUCKETS = 64
_SUB_BITS = SUBBUCKETS.bit_length() - 1
_HALF = SUBBUCKETS // 2
#: ranges above the linear one (about 2.8 hours in ms)
_DECADES = 24
NUM_BUCKETS = SUBBUCKETS + _DECADES * _HALF


def bucket_index(value):
    """The bucket of a non-negative value, in O(1)."""
    try:
        n = int(value / RESOLUTION)
    except (OverflowError, ValueError):  # inf: the top bucket
        return NUM_BUCKETS - 1
    if n < SUBBUCKETS:
        return n if n >= 0 else 0
    e = n.bit_length() - _SUB_BITS
    if e > _DECADES:
        return NUM_BUCKETS - 1
    m = n >> e
    return SUBBUCKETS + (e - 1) * _HALF + (m - _HALF)


def bucket_bounds(idx):
    """(lower, upper) value bounds of bucket `idx` (upper exclusive)."""
    if idx < SUBBUCKETS:
        return idx * RESOLUTION, (idx + 1) * RESOLUTION
    k = idx - SUBBUCKETS
    e = k // _HALF + 1
    m = _HALF + k % _HALF
    return (m << e) * RESOLUTION, ((m + 1) << e) * RESOLUTION


class LogLinearHistogram(object):
    """Mergeable fixed-bucket histogram with exact count, sum, min and
    max."""

    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self):
        self.counts = [0] * NUM_BUCKETS
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = 0.0

    def record(self, value):
        value = float(value)
        if not 0.0 <= value < math.inf:  # negative, NaN, inf: refused
            return
        self.counts[bucket_index(value)] += 1
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    def merge(self, other):
        """Fold `other` in (elementwise bucket addition)."""
        for i, c in enumerate(other.counts):
            if c:
                self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        if other.count:
            self.min = min(self.min, other.min)
            self.max = max(self.max, other.max)
        return self

    def percentile(self, q):
        """Value at percentile `q` (0..100): the midpoint of the bucket
        where the cumulative count reaches rank ceil(q% * n), clamped
        into [min, max]; 0.0 when empty."""
        if not self.count:
            return 0.0
        rank = max(1, int(math.ceil(q / 100.0 * self.count)))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                lo, hi = bucket_bounds(i)
                return min(max((lo + hi) / 2.0, self.min), self.max)
        return self.max

    def snapshot(self, qs=(50, 90, 99)):
        """{"p50": ..., "p90": ..., "p99": ..., "count": n}."""
        out = {"p%d" % q: self.percentile(q) for q in qs}
        out["count"] = self.count
        return out

    def to_counts(self):
        """Dense counts with trailing zeros trimmed."""
        last = 0
        for i, c in enumerate(self.counts):
            if c:
                last = i + 1
        return self.counts[:last]


def percentiles(values, qs=(50, 90, 99)):
    """Percentiles of `values` through the histogram, rounded to 3
    places; None entries when `values` is empty."""
    if not values:
        return {"p%d" % q: None for q in qs}
    h = LogLinearHistogram()
    for v in values:
        h.record(v)
    return {"p%d" % q: round(h.percentile(q), 3) for q in qs}
