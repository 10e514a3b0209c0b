"""The port's feature-preprocessing layers (preprocessing/layers.py),
feature columns (feature_column.py) and the SQLFlow analysis accessors
(analyzer_utils.py): the counterpart of elasticdl_tpu/preprocessing."""

from elasticdl_tpu_torch.preprocessing.layers import (  # noqa: F401
    ConcatenateWithOffset,
    Discretization,
    Hashing,
    IndexLookup,
    LogRound,
    Normalizer,
    RoundIdentity,
    SparseEmbedding,
    ToNumber,
    ToRagged,
    ToSparse,
)
