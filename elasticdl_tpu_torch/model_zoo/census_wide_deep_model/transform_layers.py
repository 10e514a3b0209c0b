"""The host transform pipeline: the port's copy of
model_zoo/census_wide_deep_model/transform_layers.py (the reference's
keras_process_layer.py CategoryLookup / CategoryHash / NumericBucket and
wide_deep_functional_api.transform / transform_group): each feature maps
to an int id, the ids of a group's features are offset into one id
space, and a group becomes a [batch, n_features] id matrix.

It runs on the host in ``dataset_fn`` (strings never reach the card);
the model's towers take the id matrices."""

import numpy as np

from elasticdl_tpu_torch.model_zoo.census_wide_deep_model.feature_info_util import (  # noqa: E501
    TransformOp,
    get_id_boundaries,
)
from elasticdl_tpu_torch.preprocessing.layers import (
    Discretization,
    Hashing,
    IndexLookup,
)


def get_transform_layer(feature_info):
    """FeatureInfo -> host-side transform callable
    (reference wide_deep_functional_api.get_transform_layer)."""
    if feature_info.op_name == TransformOp.LOOKUP:
        return IndexLookup(vocabulary=list(feature_info.param))
    if feature_info.op_name == TransformOp.HASH:
        return Hashing(num_bins=int(feature_info.param))
    if feature_info.op_name == TransformOp.BUCKETIZE:
        return Discretization(bins=list(feature_info.param))
    raise ValueError("The op %r is not supported" % (feature_info.op_name,))


def transform_group(example, feature_group):
    """Transform one example's features of a group into an offset id vector
    (reference transform_group: per-feature transform + AddIdOffset +
    concatenate)."""
    offsets = get_id_boundaries(feature_group)
    ids = []
    for offset, info in zip(offsets[:-1], feature_group):
        value = example[info.name]
        if info.op_name == TransformOp.BUCKETIZE:
            value = np.asarray(value, np.float32)
        out = np.asarray(get_transform_layer(info)(value)).reshape(-1)
        ids.append(out.astype(np.int64) + offset)
    return np.concatenate(ids)


def transform(example, feature_groups):
    """{group_name: offset id vector} for one example
    (reference wide_deep_functional_api.transform)."""
    return {
        name: transform_group(example, group)
        for name, group in feature_groups.items()
    }
