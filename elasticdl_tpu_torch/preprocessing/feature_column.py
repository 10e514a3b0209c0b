"""Feature-column equivalents of the port: the counterpart of
elasticdl_tpu/preprocessing/feature_column.py.

The reference adds a ``ConcatenatedCategoricalColumn`` to TF's
feature-column system and an ``embedding_column`` backed by the
distributed embedding. Here a column is a callable ``features_dict ->
ids array`` plus metadata, and `embedding_column` pairs one with a
factory of the port's Embedding, whose lookups launch the gather kernel
on the card.
"""

import numpy as np

from elasticdl_tpu_torch.preprocessing.layers import ConcatenateWithOffset


class CategoricalColumn(object):
    """An ids column: its key into the features dict and its bucket
    count."""

    def __init__(self, key, num_buckets, transform=None):
        self.key = key
        self.num_buckets = int(num_buckets)
        self._transform = transform

    def __call__(self, features):
        v = features[self.key]
        return self._transform(v) if self._transform else v


def categorical_column_with_identity(key, num_buckets):
    return CategoricalColumn(key, num_buckets)


def concatenated_categorical_column(categorical_columns):
    """Several categorical columns in ONE id space: each column's ids
    shift past the previous columns' bucket counts (reference
    ConcatenatedCategoricalColumn: offsets = cumulative num_buckets);
    PADDING_ID slots stay PADDING_ID."""
    offsets = np.cumsum(
        [0] + [c.num_buckets for c in categorical_columns[:-1]]
    ).tolist()
    concat = ConcatenateWithOffset(offsets=offsets, axis=-1)
    total = sum(c.num_buckets for c in categorical_columns)

    def column(features):
        parts = []
        for c in categorical_columns:
            ids = np.asarray(c(features))
            if ids.ndim == 1:
                ids = ids[:, None]
            parts.append(ids)
        return concat(parts)

    column.num_buckets = total
    column.keys = [c.key for c in categorical_columns]
    return column


def embedding_column(categorical_column, dimension, combiner="mean",
                     initializer="uniform"):
    """Pair a categorical column with an Embedding spec (reference
    elasticdl/feature_column/feature_column.py embedding_column). Returns
    (column_fn, layer_factory): apply column_fn in dataset_fn, build the
    layer in the model with `layer_factory(device=..., generator=...)`
    (the JAX factory's `name` has no counterpart: a torch module is named
    by the attribute that holds it)."""
    from elasticdl_tpu_torch.embedding.layer import Embedding

    num_buckets = getattr(categorical_column, "num_buckets")

    def layer_factory(device="cuda", generator=None):
        return Embedding(
            input_dim=num_buckets,
            output_dim=dimension,
            combiner=combiner,
            embeddings_initializer=initializer,
            device=device,
            generator=generator,
        )

    return categorical_column, layer_factory
