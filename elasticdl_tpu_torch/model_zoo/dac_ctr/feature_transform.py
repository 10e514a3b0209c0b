"""Criteo feature transform: the port's copy of
model_zoo/dac_ctr/feature_transform.py (the reference's
feature_transform.py transform_feature / transform_group: the 13
numerics standardized by Normalizer; per group, bucket features
discretized and categorical features hashed, their ids offset into the
group's id space).

It runs on the host (strings never reach the card) and gives each
example (a dense vector, {group name: id vector}). A group's id-space
size is a static property of the config (`group_max_ids`), so the
models' tables have fixed shapes."""

import numpy as np

from elasticdl_tpu_torch.model_zoo.dac_ctr.feature_config import (
    BUCKET_FEATURES,
    FEATURE_BOUNDARIES,
    FEATURE_DISTINCT_COUNT,
    FEATURES_AVGS,
    FEATURES_STDDEVS,
    HASH_FEATURES,
    MAX_HASHING_BUCKET_SIZE,
    STANDARDIZED_FEATURES,
)
from elasticdl_tpu_torch.preprocessing.layers import (
    Discretization,
    Hashing,
    Normalizer,
)


def _hash_bins(feature, max_bucket):
    return min(FEATURE_DISTINCT_COUNT[feature], max_bucket)


def group_max_ids(feature_groups, max_bucket=MAX_HASHING_BUCKET_SIZE):
    """{group_name: id-space size} — static, drives embedding table shapes
    (reference transform_group id_offsets[-1])."""
    out = {}
    for i, features in enumerate(feature_groups):
        total = 0
        for f in features:
            if f in BUCKET_FEATURES:
                total += len(FEATURE_BOUNDARIES[f]) + 1
            elif f in HASH_FEATURES:
                total += _hash_bins(f, max_bucket)
        out["group_%d" % i] = total
    return out


def transform_feature(example, feature_groups,
                      max_bucket=MAX_HASHING_BUCKET_SIZE):
    """One example -> (standardized dense [13], {group_name: id vector}).

    Mirrors reference transform_feature: Normalizer over
    STANDARDIZED_FEATURES; per group Discretization/Hashing + id offsets.
    """
    dense = np.asarray(
        [
            Normalizer(FEATURES_AVGS[f], FEATURES_STDDEVS[f])(
                np.float32(example[f])
            )
            for f in STANDARDIZED_FEATURES
        ],
        np.float32,
    )

    id_tensors = {}
    for i, features in enumerate(feature_groups):
        ids, offset = [], 0
        for f in features:
            if f in BUCKET_FEATURES:
                layer = Discretization(bins=FEATURE_BOUNDARIES[f])
                ids.append(
                    int(np.asarray(layer(np.float32(example[f])))) + offset
                )
                offset += len(FEATURE_BOUNDARIES[f]) + 1
            elif f in HASH_FEATURES:
                bins = _hash_bins(f, max_bucket)
                ids.append(int(np.asarray(Hashing(bins)(example[f]))) + offset)
                offset += bins
        id_tensors["group_%d" % i] = np.asarray(ids, np.int64)
    return dense, id_tensors
