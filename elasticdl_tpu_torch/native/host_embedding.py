"""Host-DRAM embedding store: ctypes bindings over
elasticdl_tpu_torch/csrc/host_embedding.cc, and a numpy store with the
same semantics. The port's copy of elasticdl_tpu/native/host_embedding.py.

This is the host-spill tier of the sparse embedding engine: tables too
large for the card keep their rows here (the role parameter-server pod
memory played in ElasticDL), with lazy deterministic row init and the
sparse optimizer family (SGD, momentum, Adam, Adagrad) applied on the
host.

`HostEmbeddingStore(...)` builds the native library with the host C++
compiler at first use (ops/_build.py, into the git-ignored `_build/`)
and loads it, or raises: there is no silent fallback. The numpy
`_PythonStore` is used only where a caller asks for it
(`force_python=True`, as tests do to hold one store against the
other).
"""

import ctypes
import threading

import numpy as np

from elasticdl_tpu_torch.ops import _build

_LIB = None
_LIB_LOCK = threading.Lock()


def _load():
    """The bound native library, built and loaded on first use."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        lib = _build.load("host_embedding")
        c_i64 = ctypes.c_int64
        c_f32p = ctypes.POINTER(ctypes.c_float)
        c_i64p = ctypes.POINTER(ctypes.c_int64)
        lib.host_embedding_new.restype = ctypes.c_void_p
        lib.host_embedding_new.argtypes = [
            c_i64, ctypes.c_uint64, ctypes.c_float, ctypes.c_float,
        ]
        lib.host_embedding_free.restype = None
        lib.host_embedding_free.argtypes = [ctypes.c_void_p]
        lib.host_embedding_dim.restype = c_i64
        lib.host_embedding_dim.argtypes = [ctypes.c_void_p]
        lib.host_embedding_size.restype = c_i64
        lib.host_embedding_size.argtypes = [ctypes.c_void_p]
        lib.host_embedding_clear.restype = None
        lib.host_embedding_clear.argtypes = [ctypes.c_void_p]
        lib.host_embedding_lookup.restype = None
        lib.host_embedding_lookup.argtypes = [
            ctypes.c_void_p, c_i64p, c_i64, c_f32p,
        ]
        lib.host_embedding_set.restype = None
        lib.host_embedding_set.argtypes = [
            ctypes.c_void_p, c_i64p, c_i64, c_f32p,
        ]
        lib.host_embedding_export.restype = c_i64
        lib.host_embedding_export.argtypes = [
            ctypes.c_void_p, c_i64p, c_f32p, c_i64,
        ]
        lib.host_embedding_sgd.restype = None
        lib.host_embedding_sgd.argtypes = [
            ctypes.c_void_p, c_i64p, c_f32p, c_i64, ctypes.c_float,
        ]
        lib.host_embedding_momentum.restype = None
        lib.host_embedding_momentum.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, c_i64p, c_f32p, c_i64,
            ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ]
        lib.host_embedding_adam.restype = None
        lib.host_embedding_adam.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, c_i64p,
            c_f32p, c_i64, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, c_i64,
        ]
        lib.host_embedding_adagrad.restype = None
        lib.host_embedding_adagrad.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, c_i64p, c_f32p, c_i64,
            ctypes.c_float, ctypes.c_float,
        ]
        _LIB = lib
        return lib


def _as_ids(ids):
    return np.ascontiguousarray(ids, dtype=np.int64).reshape(-1)


def _as_rows(values, dim, n):
    """`values` as a C-contiguous float32 [n, dim] array; raises when it
    does not hold n rows of dim (the native code reads n * dim floats)."""
    out = np.ascontiguousarray(values, dtype=np.float32)
    if out.size != n * dim:
        raise ValueError("expected %d rows of dim %d, got %s values"
                         % (n, dim, out.shape))
    return out.reshape(n, dim)


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class _NativeStore(object):
    """One table's rows in the native store (csrc/host_embedding.cc)."""

    def __init__(self, dim, seed, init_low, init_high):
        self._lib = _load()
        self.dim = int(dim)
        self._handle = self._lib.host_embedding_new(
            self.dim, seed, init_low, init_high)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.host_embedding_free(handle)
            self._handle = None

    def lookup(self, ids):
        ids = _as_ids(ids)
        out = np.empty((len(ids), self.dim), np.float32)
        self._lib.host_embedding_lookup(
            self._handle, _ptr(ids, ctypes.c_int64), len(ids),
            _ptr(out, ctypes.c_float))
        return out

    def set_rows(self, ids, values):
        ids = _as_ids(ids)
        values = _as_rows(values, self.dim, len(ids))
        self._lib.host_embedding_set(
            self._handle, _ptr(ids, ctypes.c_int64), len(ids),
            _ptr(values, ctypes.c_float))

    def __len__(self):
        return int(self._lib.host_embedding_size(self._handle))

    def clear(self):
        self._lib.host_embedding_clear(self._handle)

    def export_rows(self):
        n = len(self)
        ids = np.empty((n,), np.int64)
        values = np.empty((n, self.dim), np.float32)
        written = 0
        if n:
            written = self._lib.host_embedding_export(
                self._handle, _ptr(ids, ctypes.c_int64),
                _ptr(values, ctypes.c_float), n)
        return ids[:written], values[:written]

    def sgd(self, ids, grads, lr):
        ids = _as_ids(ids)
        grads = _as_rows(grads, self.dim, len(ids))
        self._lib.host_embedding_sgd(
            self._handle, _ptr(ids, ctypes.c_int64),
            _ptr(grads, ctypes.c_float), len(ids), lr)

    def momentum(self, vel, ids, grads, lr, mu=0.9, nesterov=False):
        ids = _as_ids(ids)
        grads = _as_rows(grads, self.dim, len(ids))
        self._lib.host_embedding_momentum(
            self._handle, vel._handle, _ptr(ids, ctypes.c_int64),
            _ptr(grads, ctypes.c_float), len(ids), lr, mu,
            1 if nesterov else 0)

    def adam(self, m, v, ids, grads, lr, beta1=0.9, beta2=0.999,
             eps=1e-8, step=1):
        ids = _as_ids(ids)
        grads = _as_rows(grads, self.dim, len(ids))
        self._lib.host_embedding_adam(
            self._handle, m._handle, v._handle, _ptr(ids, ctypes.c_int64),
            _ptr(grads, ctypes.c_float), len(ids), lr, beta1, beta2, eps,
            step)

    def adagrad(self, accum, ids, grads, lr, eps=1e-10):
        ids = _as_ids(ids)
        grads = _as_rows(grads, self.dim, len(ids))
        self._lib.host_embedding_adagrad(
            self._handle, accum._handle, _ptr(ids, ctypes.c_int64),
            _ptr(grads, ctypes.c_float), len(ids), lr, eps)


_MASK64 = (1 << 64) - 1


def _splitmix64_row(seed, row_id, dim, low, high):
    """The C++ store's init_row (splitmix64 over seed ^ id * golden), so
    both stores initialize the same row."""
    state = (seed ^ ((row_id * 0x9E3779B97F4A7C15) & _MASK64)) & _MASK64
    out = np.empty((dim,), np.float32)
    span = np.float32(high) - np.float32(low)
    for i in range(dim):
        state = (state + 0x9E3779B97F4A7C15) & _MASK64
        z = state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        z = z ^ (z >> 31)
        frac = (z >> 11) * (1.0 / 9007199254740992.0)
        out[i] = np.float32(low) + np.float32(frac) * span
    return out


class _PythonStore(object):
    """The native store's semantics in numpy (lazy deterministic init,
    sparse updates), for tests that hold one against the other."""

    def __init__(self, dim, seed, init_low, init_high):
        self.dim = int(dim)
        self._seed = seed
        self._low = init_low
        self._high = init_high
        self._rows = {}
        self._lock = threading.Lock()

    def _get(self, row_id):
        with self._lock:
            row = self._rows.get(row_id)
            if row is None:
                row = self._rows[row_id] = _splitmix64_row(
                    self._seed, row_id, self.dim, self._low, self._high)
        return row

    def lookup(self, ids):
        ids = _as_ids(ids)
        if not len(ids):
            return np.empty((0, self.dim), np.float32)
        return np.stack([self._get(int(i)) for i in ids])

    def set_rows(self, ids, values):
        ids = _as_ids(ids)
        values = _as_rows(values, self.dim, len(ids))
        with self._lock:
            for i, row_id in enumerate(ids):
                self._rows[int(row_id)] = values[i].copy()

    def __len__(self):
        with self._lock:
            return len(self._rows)

    def clear(self):
        with self._lock:
            self._rows.clear()

    def export_rows(self):
        with self._lock:
            rows = dict(self._rows)
        if not rows:
            return (np.empty((0,), np.int64),
                    np.empty((0, self.dim), np.float32))
        ids = np.fromiter(rows, np.int64, len(rows))
        return ids, np.stack([rows[int(i)] for i in ids])

    def sgd(self, ids, grads, lr):
        ids = _as_ids(ids)
        grads = _as_rows(grads, self.dim, len(ids))
        lr = np.float32(lr)
        for i, row_id in enumerate(ids):
            self._get(int(row_id))[:] -= lr * grads[i]

    def momentum(self, vel, ids, grads, lr, mu=0.9, nesterov=False):
        ids = _as_ids(ids)
        grads = _as_rows(grads, self.dim, len(ids))
        lr, mu = np.float32(lr), np.float32(mu)
        for i, row_id in enumerate(ids):
            p = self._get(int(row_id))
            v = vel._get(int(row_id))
            v[:] = mu * v + grads[i]
            p[:] -= lr * ((mu * v + grads[i]) if nesterov else v)

    def adam(self, m, v, ids, grads, lr, beta1=0.9, beta2=0.999,
             eps=1e-8, step=1):
        ids = _as_ids(ids)
        grads = _as_rows(grads, self.dim, len(ids))
        lr32, b1, b2 = np.float32(lr), np.float32(beta1), np.float32(beta2)
        # the C++ store's alpha: float lr promoted to double, then float
        alpha = np.float32(float(lr32) * np.sqrt(1.0 - float(b2) ** step)
                           / (1.0 - float(b1) ** step))
        for i, row_id in enumerate(ids):
            p = self._get(int(row_id))
            mi = m._get(int(row_id))
            vi = v._get(int(row_id))
            mi[:] = b1 * mi + (np.float32(1) - b1) * grads[i]
            vi[:] = b2 * vi + (np.float32(1) - b2) * grads[i] * grads[i]
            p[:] -= alpha * mi / (np.sqrt(vi) + np.float32(eps))

    def adagrad(self, accum, ids, grads, lr, eps=1e-10):
        ids = _as_ids(ids)
        grads = _as_rows(grads, self.dim, len(ids))
        lr = np.float32(lr)
        for i, row_id in enumerate(ids):
            p = self._get(int(row_id))
            a = accum._get(int(row_id))
            a[:] += grads[i] * grads[i]
            p[:] -= lr * grads[i] / (np.sqrt(a) + np.float32(eps))


def HostEmbeddingStore(dim, seed=0, init_low=-0.05, init_high=0.05,
                       force_python=False):
    """A table's host store: the native one (built at first use; raises
    when it cannot be built or loaded), or the numpy one when
    `force_python`. Default init matches ElasticDL's Go table (uniform
    [-0.05, 0.05])."""
    if force_python:
        return _PythonStore(dim, seed, init_low, init_high)
    return _NativeStore(dim, seed, init_low, init_high)
