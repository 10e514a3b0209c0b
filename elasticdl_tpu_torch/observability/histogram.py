"""Fixed-bucket log-linear latency histograms: the port's copy of
elasticdl_tpu/observability/histogram.py's bucket scheme and
`LogLinearHistogram`, so a percentile the port reports is computed as
the JAX package computes it.

Values are non-negative floats (the system records milliseconds),
scaled by 1/RESOLUTION to an integer n; the first SUBBUCKETS buckets
are linear, above that each power-of-two range is split into
SUBBUCKETS/2 linear subbuckets, so the relative error is at most
2/SUBBUCKETS (~3.1%) at every magnitude, in NUM_BUCKETS (832) buckets.

`to_counts` / `from_counts` are the wire form: the trimmed bucket counts
a replica's ServerStatus carries and the router merges by addition.

Exemplars: `record(value, trace_id=...)` attaches a per-bucket exemplar
(trace_id, value, unix_ts), at most EXEMPLAR_SLOTS buckets, the highest
buckets winning a slot (the tail is what forensics reads) and the
largest sample winning within a bucket, which keeps the merge
associative. `exemplars_wire` / `from_counts(counts, exemplars)` carry
them beside the counts; the Prometheus renderer writes them in
OpenMetrics exemplar syntax on `_bucket` lines. No lock: the owner of a
histogram locks it.
"""

import math
import time

#: smallest distinguishable value (0.01 => 10 us when recording ms)
RESOLUTION = 0.01
#: linear subbuckets per power-of-two range (a power of two)
SUBBUCKETS = 64
_SUB_BITS = SUBBUCKETS.bit_length() - 1
_HALF = SUBBUCKETS // 2
#: ranges above the linear one (about 2.8 hours in ms)
_DECADES = 24
NUM_BUCKETS = SUBBUCKETS + _DECADES * _HALF
#: the most buckets of one histogram that carry an exemplar
EXEMPLAR_SLOTS = 16


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
    max, and up to EXEMPLAR_SLOTS bucket exemplars."""

    __slots__ = ("counts", "count", "sum", "min", "max", "exemplars")

    def __init__(self):
        self.counts = [0] * NUM_BUCKETS
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = 0.0
        #: bucket index -> (trace_id, value, unix_ts)
        self.exemplars = {}

    def record(self, value, trace_id=None, ts=None):
        value = float(value)
        if not 0.0 <= value < math.inf:  # negative, NaN, inf: refused
            return
        idx = bucket_index(value)
        self.counts[idx] += 1
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        if trace_id:
            self._note_exemplar(idx, str(trace_id), value,
                                time.time() if ts is None else float(ts))

    def _note_exemplar(self, idx, trace_id, value, ts):
        """At most EXEMPLAR_SLOTS exemplar buckets: a higher bucket
        evicts the lowest one, a lower bucket never evicts; within a
        bucket the largest value (the later one on a tie) wins."""
        cur = self.exemplars.get(idx)
        if cur is not None:
            if value >= cur[1]:
                self.exemplars[idx] = (trace_id, value, ts)
            return
        if len(self.exemplars) >= EXEMPLAR_SLOTS:
            low = min(self.exemplars)
            if idx <= low:
                return
            del self.exemplars[low]
        self.exemplars[idx] = (trace_id, value, ts)

    def merge(self, other):
        """Fold `other` in (elementwise bucket addition; exemplars by
        the same slot rule as record)."""
        for i, c in enumerate(other.counts):
            if c:
                self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        if other.count:
            self.min = min(self.min, other.min)
            self.max = max(self.max, other.max)
        for idx, (tid, value, ts) in other.exemplars.items():
            self._note_exemplar(idx, tid, value, ts)
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

    def exemplars_wire(self):
        """{bucket_index: [trace_id, value, unix_ts]}, JSON-safe (a JSON
        round trip's string keys come back through from_counts)."""
        return {idx: [tid, value, ts]
                for idx, (tid, value, ts) in self.exemplars.items()}

    @classmethod
    def from_counts(cls, counts, exemplars=None):
        """Rebuild from wire-form counts and, optionally, an exemplar
        map. min / max / sum degrade to bucket-midpoint estimates
        (within the scheme's relative error), enough for percentiles,
        which need only the counts."""
        h = cls()
        for i, c in enumerate(counts):
            c = int(c)
            if c <= 0 or i >= NUM_BUCKETS:
                continue
            h.counts[i] = c
            h.count += c
            lo, hi = bucket_bounds(i)
            mid = (lo + hi) / 2.0
            h.sum += mid * c
            h.min = min(h.min, mid)
            h.max = max(h.max, mid)
        for idx, (tid, value, ts) in (exemplars or {}).items():
            h._note_exemplar(int(idx), str(tid), float(value), float(ts))
        return h


def percentiles(values, qs=(50, 90, 99)):
    """Percentiles of `values` through the histogram, rounded to 3
    places; None entries when `values` is empty."""
    if not values:
        return {"p%d" % q: None for q in qs}
    h = LogLinearHistogram()
    for v in values:
        h.record(v)
    return {"p%d" % q: round(h.percentile(q), 3) for q in qs}
