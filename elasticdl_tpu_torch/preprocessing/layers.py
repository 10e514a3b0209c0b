"""Feature-preprocessing layers of the port: the counterpart of
elasticdl_tpu/preprocessing/layers.py (the reference's 11 layers of
`elasticdl_preprocessing/layers/`).

* The numeric layers (Normalizer, RoundIdentity, LogRound,
  Discretization, ConcatenateWithOffset, and Hashing over ints) take
  numpy arrays or torch tensors and return the same kind: numpy in, the
  JAX package's numpy code; a tensor in, the torch ops the JAX layer's
  `jnp` path runs, on the tensor's device.
* The string layers (Hashing over strings, IndexLookup, ToNumber,
  ToRagged, ToSparse) are host numpy, as in the JAX package: strings
  never reach the card. Use them in `dataset_fn`.
* Padded id matrices stand for TF's sparse and ragged forms: PADDING_ID
  (-1) marks an absent slot; the transforms keep it.
* Hashing is md5 of `str(value)` (the first 8 digest bytes, little
  endian, modulo the bucket count), bit for bit the JAX package's; the
  reference's TF hashes with FarmHash64, so bucket assignments differ
  from TF's. A torch tensor is hashed through its numpy form, so an
  element is stringified as the JAX layer stringifies the same numpy
  element (`str(torch.tensor(3))` would be "tensor(3)").
"""

import hashlib

import numpy as np
import torch

from elasticdl_tpu_torch.embedding.layer import PADDING_ID


def _is_torch(x):
    return isinstance(x, torch.Tensor)


def _host(x):
    """A torch tensor's numpy form (its values, on the host); anything
    else as it is."""
    if _is_torch(x):
        return x.detach().cpu().numpy()
    return x


class _Layer(object):
    """Callable-layer base (keras Layer stand-in)."""

    def __call__(self, inputs):
        return self.call(inputs)


class Normalizer(_Layer):
    """(x - subtractor) / divisor in fp32 (reference normalizer.py)."""

    def __init__(self, subtractor, divisor):
        if divisor == 0:
            raise ValueError("The divisor cannot be 0")
        self.subtractor = subtractor
        self.divisor = divisor

    def call(self, inputs):
        if _is_torch(inputs):
            x = inputs.to(torch.float32)
        else:
            x = np.asarray(inputs, dtype=np.float32)
        return (x - self.subtractor) / self.divisor


def _torch_ids(v):
    """A float tensor's int64 ids with NaN read as 0, as XLA converts NaN
    in the JAX layer's `jnp` path (torch's own cast of NaN differs by
    device)."""
    return torch.where(torch.isnan(v), torch.zeros_like(v), v).to(
        torch.int64)


def _truncate(v, n, default, torch_ids):
    """v where it lies in [0, n), else `default`."""
    bad = (v < 0) | (v >= n)
    if torch_ids:
        return torch.where(bad, torch.full_like(v, default), v)
    return np.where(bad, np.int64(default), v)


class RoundIdentity(_Layer):
    """round(x) (half to even) as an int64 id; out of [0, num_buckets) ->
    default_value (reference round_identity.py `_round_and_truncate`)."""

    def __init__(self, num_buckets, default_value=0):
        self.num_buckets = int(num_buckets)
        self.default_value = int(default_value)

    def call(self, inputs):
        if _is_torch(inputs):
            v = _torch_ids(torch.round(inputs.to(torch.float32)))
        else:
            v = np.round(np.asarray(inputs, dtype=np.float32)).astype(
                np.int64)
        return _truncate(v, self.num_buckets, self.default_value,
                         _is_torch(inputs))


class LogRound(_Layer):
    """round(log_base(x)) (half to even) as an int64 id; out of [0,
    num_bins) -> default_value (reference log_round.py)."""

    def __init__(self, num_bins, base=None, default_value=0):
        self.num_bins = int(num_bins)
        self.base = base
        self.default_value = int(default_value)

    def call(self, inputs):
        if _is_torch(inputs):
            v = torch.log(inputs.to(torch.float32))
            if self.base is not None:
                v = v / torch.log(torch.tensor(self.base, dtype=torch.float32,
                                               device=v.device))
            v = _torch_ids(torch.round(v))
        else:
            v = np.log(np.asarray(inputs, dtype=np.float32))
            if self.base is not None:
                v = v / np.log(np.float32(self.base))
            v = np.round(v).astype(np.int64)
        return _truncate(v, self.num_bins, self.default_value,
                         _is_torch(inputs))


class Discretization(_Layer):
    """Bucketize by boundaries: the id is the count of boundaries <= x, so
    `bins=[0, 1, 2]` gives buckets (-inf, 0) [0, 1) [1, 2) [2, inf)
    (reference discretization.py). numpy: np.digitize(right=False); a
    tensor: torch.bucketize(right=True) over the boundaries in the
    input's dtype, as the JAX layer's searchsorted(side="right") (torch
    reads `right` the other way round)."""

    def __init__(self, bins):
        self.bins = list(bins)

    def num_bins(self):
        return len(self.bins) + 1

    def call(self, inputs):
        if _is_torch(inputs):
            b = torch.as_tensor(self.bins, dtype=inputs.dtype,
                                device=inputs.device)
            return torch.bucketize(inputs, b, right=True).to(torch.int64)
        x = np.asarray(inputs)
        return np.digitize(x, self.bins, right=False).astype(np.int64)


def _hash_one(v, num_bins):
    s = v if isinstance(v, bytes) else str(v).encode("utf-8")
    return int.from_bytes(hashlib.md5(s).digest()[:8], "little") % num_bins


class Hashing(_Layer):
    """value -> md5(str(value)) % num_bins (see the module docstring for
    the divergence from the reference's FarmHash). Ints are stringified
    first, as in the reference; PADDING_ID slots of int inputs pass
    through. A torch int tensor gives an int64 tensor on its device."""

    def __init__(self, num_bins):
        if num_bins is None or num_bins <= 0:
            raise ValueError(
                "`num_bins` cannot be `None` or non-positive values."
            )
        self.num_bins = int(num_bins)

    def call(self, inputs):
        arr = np.asarray(_host(inputs))
        out = np.empty(arr.shape, np.int64)
        flat_in, flat_out = arr.reshape(-1), out.reshape(-1)
        ints = arr.dtype.kind in ("i", "u")
        for i, v in enumerate(flat_in):
            if ints:
                flat_out[i] = (PADDING_ID if v == PADDING_ID
                               else _hash_one(int(v), self.num_bins))
            else:
                flat_out[i] = _hash_one(v, self.num_bins)
        if _is_torch(inputs):
            return torch.from_numpy(out).to(inputs.device)
        return out


class IndexLookup(_Layer):
    """String -> zero-based index by vocabulary (a list, or a file of one
    entry a line); OOV maps to ``hash(v) % num_oov_tokens + len(vocab)``
    (reference index_lookup.py: with the default num_oov_tokens=1 every
    OOV value becomes len(vocab))."""

    def __init__(self, vocabulary=None, num_oov_tokens=1):
        if isinstance(vocabulary, str):
            with open(vocabulary) as f:
                vocabulary = [line.rstrip("\n") for line in f if line.strip()]
        vocabulary = list(vocabulary or [])
        if len(set(vocabulary)) != len(vocabulary):
            raise ValueError(
                "The vocabulary has repeated items: %s"
                % [v for v in set(vocabulary) if vocabulary.count(v) > 1]
            )
        self.vocabulary = vocabulary
        self.num_oov_tokens = int(num_oov_tokens)
        self._table = {self._norm(v): i for i, v in enumerate(vocabulary)}
        self._oov_bins = max(self.num_oov_tokens, 1)

    @staticmethod
    def _norm(v):
        return v.decode("utf-8") if isinstance(v, bytes) else str(v)

    def vocab_size(self):
        return len(self.vocabulary) + self.num_oov_tokens

    def call(self, inputs):
        arr = np.asarray(inputs)
        out = np.empty(arr.shape, np.int64)
        flat_in, flat_out = arr.reshape(-1), out.reshape(-1)
        n = len(self.vocabulary)
        for i, v in enumerate(flat_in):
            key = self._norm(v)
            idx = self._table.get(key)
            if idx is None:
                idx = n
                if self.num_oov_tokens > 1:
                    idx += _hash_one(key, self._oov_bins)
            flat_out[i] = idx
        return out


class ConcatenateWithOffset(_Layer):
    """Add offsets[i] to each id tensor, then concatenate (reference
    concatenate_with_offset.py). PADDING_ID slots stay PADDING_ID, so
    combiner lookups still skip them. numpy arrays or torch tensors, as
    the first input is."""

    def __init__(self, offsets, axis=-1):
        self.offsets = offsets
        self.axis = axis

    def call(self, inputs):
        if not isinstance(inputs, (list, tuple)):
            return inputs
        if self.offsets is not None and len(self.offsets) != len(inputs):
            raise ValueError(
                "The offsets length is not equal to inputs length: "
                "inputs %d, offsets %d" % (len(inputs), len(self.offsets))
            )
        as_torch = _is_torch(inputs[0])
        shifted = []
        for i, t in enumerate(inputs):
            if as_torch:
                t = torch.as_tensor(t, device=inputs[0].device)
            else:
                t = np.asarray(t)
            if self.offsets is not None:
                off = self.offsets[i]
                if as_torch:
                    t = torch.where(t == PADDING_ID, t, t + off)
                else:
                    t = np.where(t == PADDING_ID, t, t + off)
            shifted.append(t)
        if as_torch:
            return torch.cat(shifted, dim=self.axis)
        return np.concatenate(shifted, axis=self.axis)


class ToNumber(_Layer):
    """Parse strings to numbers; unparseable or empty -> default_value
    (reference to_number.py)."""

    def __init__(self, out_type, default_value):
        self.out_type = np.dtype(out_type)
        self.default_value = default_value

    def call(self, inputs):
        arr = np.asarray(inputs)
        if arr.dtype.kind in ("i", "u", "f"):
            return arr.astype(self.out_type)
        out = np.empty(arr.shape, self.out_type)
        flat_in, flat_out = arr.reshape(-1), out.reshape(-1)
        if self.out_type.kind == "f":
            caster = float
        else:
            def caster(s):
                return int(float(s))
        for i, v in enumerate(flat_in):
            s = v.decode("utf-8") if isinstance(v, bytes) else str(v)
            try:
                flat_out[i] = caster(s)
            except (ValueError, TypeError):
                flat_out[i] = self.default_value
        return out


class ToRagged(_Layer):
    """Dense -> ragged, dropping `ignore_value` entries (reference
    to_ragged.py), in the padded form: each row's kept values move left
    and PADDING_ID fills the tail, so a combiner lookup sees the same ids
    a row."""

    def __init__(self, ignore_value=-1):
        self.ignore_value = ignore_value

    def call(self, inputs):
        arr = np.asarray(inputs)
        if arr.ndim == 1:
            arr = arr[:, None]
        out = np.full(arr.shape, PADDING_ID, np.int64)
        for r in range(arr.shape[0]):
            keep = [v for v in arr[r] if not self._ignored(v)]
            out[r, : len(keep)] = [int(v) for v in keep]
        return out

    def _ignored(self, v):
        if isinstance(v, (bytes, str)):
            s = v.decode("utf-8") if isinstance(v, bytes) else v
            return s == str(self.ignore_value) or s == ""
        return v == self.ignore_value


class ToSparse(ToRagged):
    """Dense -> sparse keeping positions (reference to_sparse.py): in the
    padded form an ignored entry becomes PADDING_ID in place."""

    def call(self, inputs):
        arr = np.asarray(inputs)
        if arr.dtype.kind in ("i", "u"):
            return np.where(
                arr == self.ignore_value, np.int64(PADDING_ID), arr
            ).astype(np.int64)
        out = np.empty(arr.shape, np.int64)
        flat_in, flat_out = arr.reshape(-1), out.reshape(-1)
        for i, v in enumerate(flat_in):
            flat_out[i] = PADDING_ID if self._ignored(v) else int(
                float(v.decode() if isinstance(v, bytes) else v)
            )
        return out


def SparseEmbedding(input_dim, output_dim, combiner="sum",
                    embeddings_initializer="uniform", device="cuda",
                    generator=None):
    """Embedding over padded sparse ids with a combiner (reference
    sparse_embedding.py: safe_embedding_lookup_sparse over a
    SparseTensor): the port's Embedding with the combiner, whose lookups
    launch the gather kernel on the card."""
    from elasticdl_tpu_torch.embedding.layer import Embedding

    return Embedding(
        input_dim=input_dim,
        output_dim=output_dim,
        combiner=combiner,
        embeddings_initializer=embeddings_initializer,
        device=device,
        generator=generator,
    )
