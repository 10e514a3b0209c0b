"""Feature transform metadata: the port's copy of
model_zoo/census_wide_deep_model/feature_info_util.py (the reference's
feature_info_util.py: the FeatureInfo namedtuple, the TransformOp names
and the id-boundary helper that offsets each feature's ids inside its
group)."""

from collections import namedtuple

FeatureInfo = namedtuple("FeatureInfo", ["name", "op_name", "dtype", "param"])


class TransformOp(object):
    HASH = "HASH"
    LOOKUP = "LOOKUP"
    BUCKETIZE = "BUCKETIZE"


def feature_id_space(feature_info):
    """Number of distinct ids the transform of one feature can produce."""
    if feature_info.op_name == TransformOp.HASH:
        return int(feature_info.param)
    if feature_info.op_name == TransformOp.LOOKUP:
        return len(feature_info.param) + 1  # + default OOV token
    if feature_info.op_name == TransformOp.BUCKETIZE:
        return len(feature_info.param) + 1
    raise ValueError("Unknown op %r" % (feature_info.op_name,))


def get_id_boundaries(feature_group):
    """Cumulative id offsets [0, s1, s1+s2, ...] for the features of a group
    (reference feature_info_util.get_id_boundaries)."""
    bounds = [0]
    for info in feature_group:
        bounds.append(bounds[-1] + feature_id_space(info))
    return bounds
