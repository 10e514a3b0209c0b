"""A minimal host-side dataset pipeline: the port's copy of
elasticdl_tpu/data/dataset.py.

    Dataset.from_generator(gen_fn)
      .map(fn) .shuffle(buffer_size, seed) .batch(n, drop_remainder)
      .prefetch(n)

Batching stacks dict-of-ndarray (or tuple) elements into numpy arrays
with a leading batch axis; the Trainer moves them to its device.
`shuffle` keeps the JAX package's `random.Random(seed)` draws and swap
order, so both packages read records in the same order.
"""

import collections
import queue
import random
import threading

import numpy as np


class Dataset(object):
    def __init__(self, source_fn):
        # source_fn: () -> iterator of elements
        self._source_fn = source_fn

    @staticmethod
    def from_generator(gen_fn):
        return Dataset(gen_fn)

    @staticmethod
    def from_list(items):
        return Dataset(lambda: iter(list(items)))

    def map(self, fn):
        src = self._source_fn

        def gen():
            for x in src():
                yield fn(x)

        return Dataset(gen)

    def shuffle(self, buffer_size, seed=None):
        src = self._source_fn

        def gen():
            rng = random.Random(seed)
            buf = []
            for x in src():
                buf.append(x)
                if len(buf) >= buffer_size:
                    i = rng.randrange(len(buf))
                    buf[i], buf[-1] = buf[-1], buf[i]
                    yield buf.pop()
            rng.shuffle(buf)
            for x in buf:
                yield x

        return Dataset(gen)

    def batch(self, batch_size, drop_remainder=False):
        src = self._source_fn

        def gen():
            buf = []
            for x in src():
                buf.append(x)
                if len(buf) == batch_size:
                    yield _stack(buf)
                    buf = []
            if buf and not drop_remainder:
                yield _stack(buf)

        return Dataset(gen)

    def prefetch(self, buffer_size=1):
        """Produce elements on a background thread, at most `buffer_size`
        ahead of the consumer; an error in the producer re-raises in the
        consumer, and an abandoned iterator stops the thread."""
        src = self._source_fn

        def gen():
            q = queue.Queue(maxsize=max(1, buffer_size))
            sentinel = object()
            stop = threading.Event()
            err = []

            def put(x):
                while not stop.is_set():
                    try:
                        q.put(x, timeout=0.1)
                        return True
                    except queue.Full:
                        continue
                return False

            def producer():
                try:
                    for x in src():
                        if not put(x):
                            return
                except BaseException as e:  # re-raised in the consumer
                    err.append(e)
                finally:
                    put(sentinel)

            t = threading.Thread(target=producer, daemon=True)
            t.start()
            try:
                while True:
                    x = q.get()
                    if x is sentinel:
                        if err:
                            raise err[0]
                        return
                    yield x
            finally:
                stop.set()

        return Dataset(gen)

    def __iter__(self):
        return self._source_fn()


def _stack(elements):
    """Stack homogeneous elements (dicts, tuples or arrays) into one
    batched element with a leading batch axis."""
    first = elements[0]
    if isinstance(first, dict):
        return collections.OrderedDict(
            (k, _stack([e[k] for e in elements])) for k in first
        )
    if isinstance(first, tuple):
        return tuple(
            _stack([e[i] for e in elements]) for i in range(len(first))
        )
    return np.stack([np.asarray(e) for e in elements], axis=0)


def pad_batch(batch, batch_size):
    """Pad the leading axis of every array in `batch` to `batch_size` by
    repeating the last element; returns (padded_batch, true_count). The
    step masks the padded rows through its per-example weights."""

    def pad(x):
        x = np.asarray(x)
        n = x.shape[0]
        if n == batch_size:
            return x
        reps = np.repeat(x[-1:], batch_size - n, axis=0)
        return np.concatenate([x, reps], axis=0)

    def leading(x):
        if isinstance(x, dict):
            x = next(iter(x.values()))
        return np.asarray(x).shape[0]

    def pad_any(x):
        if isinstance(x, dict):
            return {k: pad(v) for k, v in x.items()}
        return pad(x)

    if isinstance(batch, tuple):
        return tuple(pad_any(b) for b in batch), leading(batch[0])
    return pad_any(batch), leading(batch)
