"""SQLFlow transform-op metadata and its interpreter: the port's copy of
model_zoo/census_model_sqlflow/transform_ops.py (the reference's
wide_and_deep/transform_ops.py:13-125).

A SQLFlow `COLUMN` clause compiles to a dataflow of named transform ops
(hash / vocabulary lookup / bucketize / concat-with-offset / embedding /
array). The metadata is executed directly:

* `topo_sort` orders any op list by its input and output names;
* `execute_host_ops` / `HostOpExecutor` run the string and id stages
  (HASH / LOOKUP / BUCKETIZE / CONCAT) on the host with the
  preprocessing layers: strings never reach the card;
* the EMBEDDING / ARRAY stages are the model's, which builds its towers
  from the same metadata (census_wide_and_deep.py).
"""

import itertools
from enum import Enum

import numpy as np

from elasticdl_tpu_torch.preprocessing.layers import (
    ConcatenateWithOffset,
    Discretization,
    Hashing,
    IndexLookup,
)


class TransformOpType(Enum):
    HASH = 1
    BUCKETIZE = 2
    LOOKUP = 3
    EMBEDDING = 4
    CONCAT = 5
    ARRAY = 6


class SchemaInfo(object):
    """(column name, numpy dtype) of one source-table column."""

    def __init__(self, name, dtype):
        self.name = name
        self.dtype = dtype


class TransformOp(object):
    def __init__(self, name, input, output):  # noqa: A002 - reference API
        self.name = name
        self.input = input  # one name or a list of names
        self.output = output
        self.op_type = None

    @property
    def inputs(self):
        return self.input if isinstance(self.input, list) else [self.input]


class Hash(TransformOp):
    def __init__(self, name, input, output, hash_bucket_size):  # noqa: A002
        super().__init__(name, input, output)
        self.op_type = TransformOpType.HASH
        self.hash_bucket_size = hash_bucket_size

    @property
    def num_buckets(self):
        return self.hash_bucket_size


class Vocabularize(TransformOp):
    def __init__(self, name, input, output, vocabulary_list=None,  # noqa: A002
                 vocabulary_file=None):
        super().__init__(name, input, output)
        self.op_type = TransformOpType.LOOKUP
        self.vocabulary_list = vocabulary_list
        self.vocabulary_file = vocabulary_file

    @property
    def num_buckets(self):
        # + 1 OOV token (IndexLookup default)
        if self.vocabulary_list is not None:
            return len(self.vocabulary_list) + 1
        with open(self.vocabulary_file) as f:
            return sum(1 for line in f if line.strip()) + 1


class Bucketize(TransformOp):
    def __init__(self, name, input, output, num_buckets=None,  # noqa: A002
                 boundaries=None):
        super().__init__(name, input, output)
        self.op_type = TransformOpType.BUCKETIZE
        self._num_buckets = num_buckets
        self.boundaries = boundaries

    @property
    def num_buckets(self):
        if self._num_buckets is not None:
            return self._num_buckets
        return len(self.boundaries) + 1


class Concat(TransformOp):
    def __init__(self, name, input, output, id_offsets):  # noqa: A002
        super().__init__(name, input, output)
        self.op_type = TransformOpType.CONCAT
        self.id_offsets = id_offsets


class Embedding(TransformOp):
    def __init__(self, name, input, output, input_dim, output_dim):  # noqa: A002
        super().__init__(name, input, output)
        self.op_type = TransformOpType.EMBEDDING
        self.input_dim = input_dim
        self.output_dim = output_dim


class Array(TransformOp):
    """Collect several outputs into one ordered list (the towers)."""

    def __init__(self, name, input, output):  # noqa: A002
        super().__init__(name, input, output)
        self.op_type = TransformOpType.ARRAY


def id_offsets_from_bucket_nums(num_buckets):
    """[8, 7, 6] -> [0, 8, 15]: each member of a Concat group gets its own
    id range (reference _get_id_offsets_from_dependency_bucket_num)."""
    return list(itertools.accumulate([0] + list(num_buckets[:-1])))


def topo_sort(ops, source_names):
    """Order ops so every op runs after its producers (Kahn). The inputs
    available at the start are the source-table columns. Raises on cycles
    or references to names nothing produces."""
    produced = set(source_names)
    remaining = list(ops)
    ordered = []
    while remaining:
        ready = [
            op for op in remaining
            if all(i in produced for i in op.inputs)
        ]
        if not ready:
            missing = {
                i for op in remaining for i in op.inputs
            } - produced - {op.output for op in remaining}
            raise ValueError(
                "transform graph is cyclic or references unknown inputs: "
                "unresolvable ops %s%s"
                % (
                    [op.name for op in remaining],
                    (", undefined inputs %s" % sorted(missing))
                    if missing else "",
                )
            )
        for op in ready:
            ordered.append(op)
            produced.add(op.output)
            remaining.remove(op)
    return ordered


def _host_layer(op):
    if op.op_type == TransformOpType.HASH:
        return Hashing(num_bins=op.hash_bucket_size)
    if op.op_type == TransformOpType.LOOKUP:
        return IndexLookup(
            vocabulary=op.vocabulary_list or op.vocabulary_file
        )
    if op.op_type == TransformOpType.BUCKETIZE:
        if op.boundaries is None:
            raise ValueError(
                "Bucketize %r needs boundaries for host execution" % op.name
            )
        return Discretization(bins=op.boundaries)
    if op.op_type == TransformOpType.CONCAT:
        return ConcatenateWithOffset(op.id_offsets)
    raise ValueError("%r is not a host-stage op" % op)


class HostOpExecutor(object):
    """Compiled form of the host stages: layers (vocab tables, hash
    functions, bucket arrays) are built ONCE here, then reused for every
    example — dataset_fn runs this per record, so per-record layer
    construction (re-reading vocabulary files etc.) is the difference
    between O(1) and O(dataset) setup work."""

    def __init__(self, ops):
        self._ops = [
            (op, _host_layer(op))
            for op in ops
            if op.op_type not in (
                TransformOpType.EMBEDDING, TransformOpType.ARRAY
            )
        ]

    def __call__(self, example):
        """One example dict -> {name: np.ndarray} including the source
        columns; EMBEDDING/ARRAY stages live in the model."""
        values = dict(example)
        for op, layer in self._ops:
            if op.op_type == TransformOpType.CONCAT:
                parts = [
                    np.asarray(values[name]).reshape(-1)
                    for name in op.inputs
                ]
                values[op.output] = layer(parts)
            else:
                value = values[op.input]
                if op.op_type == TransformOpType.BUCKETIZE:
                    value = np.asarray(value, np.float32)
                values[op.output] = np.asarray(layer(value)).reshape(-1)
        return values


def execute_host_ops(ops, example):
    """One-shot convenience over HostOpExecutor (tests); hot paths build
    the executor once instead."""
    return HostOpExecutor(ops)(example)
