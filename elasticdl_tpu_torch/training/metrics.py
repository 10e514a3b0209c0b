"""Evaluation metric aggregation: the port's copy of
elasticdl_tpu/training/metrics.py. Inputs are numpy arrays (the
Trainer's evaluate_batch returns numpy). Two metric kinds:

* per-sample callables `fn(labels, predictions) -> array`, aggregated as
  a running mean over samples;
* stateful metric objects with `update(labels, predictions)` /
  `result()` (`StreamingMetric`, e.g. `AUC`).

`eval_metrics_fn` may return the flat form {metric: fn} or, for
dict-output models, the nested form {output: {metric: fn}}, flattened
into {"output_metric": fn on predictions[output]}.
"""

import numpy as np


class StreamingMetric(object):
    """Base for stateful metrics (subclass with update/result/reset)."""

    def update(self, labels, predictions):
        raise NotImplementedError

    def result(self):
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError


class AUC(StreamingMetric):
    """Binary AUC from a fixed-bin histogram of sigmoid(score), the
    trapezoid over the ROC curve its tails give."""

    def __init__(self, num_thresholds=200):
        self._bins = num_thresholds
        self.reset()

    def reset(self):
        self._pos = np.zeros(self._bins, np.int64)
        self._neg = np.zeros(self._bins, np.int64)

    def update(self, labels, predictions):
        labels = np.asarray(labels).reshape(-1)
        scores = np.asarray(predictions).reshape(-1)
        probs = 1.0 / (1.0 + np.exp(-scores.astype(np.float64)))
        idx = np.clip((probs * self._bins).astype(int), 0, self._bins - 1)
        np.add.at(self._pos, idx[labels > 0], 1)
        np.add.at(self._neg, idx[labels <= 0], 1)

    def result(self):
        pos_c = np.cumsum(self._pos[::-1])
        neg_c = np.cumsum(self._neg[::-1])
        tp = pos_c / max(1, pos_c[-1])
        fp = neg_c / max(1, neg_c[-1])
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(tp, fp))


def flatten_metrics_dict(metrics_dict):
    """{output: {metric: fn}} entries -> {"output_metric": fn'} where fn'
    reads predictions[output] (and labels[output] when labels are a
    dict); flat entries pass through."""
    flat = {}
    for name, fn in metrics_dict.items():
        if isinstance(fn, dict):
            for metric_name, metric_fn in fn.items():
                flat["%s_%s" % (name, metric_name)] = _bind_output(
                    metric_fn, name)
        else:
            flat[name] = fn
    return flat


class _BoundMetric(StreamingMetric):
    def __init__(self, metric, output):
        self._metric, self._output = metric, output

    def update(self, labels, predictions):
        self._metric.update(_pick(labels, self._output),
                            _pick(predictions, self._output))

    def result(self):
        return self._metric.result()

    def reset(self):
        self._metric.reset()


def _bind_output(metric_fn, output_name):
    if isinstance(metric_fn, StreamingMetric):
        return _BoundMetric(metric_fn, output_name)
    return lambda labels, predictions: metric_fn(
        _pick(labels, output_name), _pick(predictions, output_name))


def _pick(x, key):
    if isinstance(x, dict):
        if key not in x:
            raise KeyError(
                "eval_metrics_fn references output %r but the model "
                "produced outputs %r" % (key, sorted(x)))
        return x[key]
    return x


class MetricsAggregator(object):
    def __init__(self, metrics_dict):
        self._metrics = flatten_metrics_dict(metrics_dict)
        self._sums = {k: 0.0 for k in self._metrics}
        self._counts = {k: 0 for k in self._metrics}

    def update(self, labels, predictions, chunk_size=4096):
        """Feed one batch of raw (labels, outputs), in chunks so large
        evaluation batches stay memory-bounded."""
        n = _leading(labels if labels is not None else predictions)
        for lo in range(0, n, chunk_size):
            hi = min(n, lo + chunk_size)
            lab, pred = _slice(labels, lo, hi), _slice(predictions, lo, hi)
            for name, fn in self._metrics.items():
                if isinstance(fn, StreamingMetric):
                    fn.update(lab, pred)
                else:
                    vals = np.asarray(fn(lab, pred), np.float64).reshape(-1)
                    self._sums[name] += float(vals.sum())
                    self._counts[name] += vals.size

    def result(self):
        out = {}
        for name, fn in self._metrics.items():
            if isinstance(fn, StreamingMetric):
                out[name] = fn.result()
            else:
                out[name] = self._sums[name] / max(1, self._counts[name])
        return out


def _leading(x):
    if isinstance(x, dict):
        x = next(iter(x.values()))
    return np.asarray(x).shape[0]


def _slice(x, lo, hi):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: np.asarray(v)[lo:hi] for k, v in x.items()}
    return np.asarray(x)[lo:hi]
