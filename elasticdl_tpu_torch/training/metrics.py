"""Evaluation metric aggregation: the port's copy of
`MetricsAggregator` (elasticdl_tpu/training/metrics.py) for per-sample
metrics, `fn(labels, predictions) -> array`, aggregated as a running mean
over samples. Inputs are numpy arrays (the Trainer's evaluate_batch
returns numpy). Stateful metric objects (AUC) and the nested
{output: {metric: fn}} form are not ported yet.
"""

import numpy as np


class MetricsAggregator(object):
    def __init__(self, metrics_dict):
        for name, fn in metrics_dict.items():
            if not callable(fn) or hasattr(fn, "update"):
                raise NotImplementedError(
                    "metric %r: only per-sample callables are ported" % name)
        self._metrics = dict(metrics_dict)
        self._sums = {k: 0.0 for k in self._metrics}
        self._counts = {k: 0 for k in self._metrics}

    def update(self, labels, predictions, chunk_size=4096):
        """Feed one batch of raw (labels, outputs), in chunks so large
        evaluation batches stay memory-bounded."""
        labels, predictions = np.asarray(labels), np.asarray(predictions)
        for lo in range(0, labels.shape[0], chunk_size):
            lab = labels[lo:lo + chunk_size]
            pred = predictions[lo:lo + chunk_size]
            for name, fn in self._metrics.items():
                vals = np.asarray(fn(lab, pred), np.float64).reshape(-1)
                self._sums[name] += float(vals.sum())
                self._counts[name] += vals.size

    def result(self):
        return {name: self._sums[name] / max(1, self._counts[name])
                for name in self._metrics}
