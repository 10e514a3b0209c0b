"""Census feature transforms: the PyTorch twin of
model_zoo/census_dnn_model/census_feature_columns.py (the reference's
census_feature_columns.py). Numeric columns pass through; each
categorical string column is hashed into 64 buckets on the host
(`transform_categoricals`, in dataset_fn) and embedded at dim 16 in the
model (`CensusFeatureLayer`, the DenseFeatures equivalent)."""

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.model_zoo.flax_layers import Embed
from elasticdl_tpu_torch.preprocessing.layers import Hashing

CATEGORICAL_FEATURE_KEYS = [
    "workclass",
    "education",
    "marital-status",
    "occupation",
    "relationship",
    "race",
    "sex",
    "native-country",
]
NUMERIC_FEATURE_KEYS = [
    "age",
    "capital-gain",
    "capital-loss",
    "hours-per-week",
]
LABEL_KEY = "label"

HASH_BUCKET_SIZE = 64
EMBEDDING_DIM = 16
# the features' width after the layer: the numerics, then every table
FEATURE_WIDTH = (len(NUMERIC_FEATURE_KEYS)
                 + len(CATEGORICAL_FEATURE_KEYS) * EMBEDDING_DIM)


def transform_categoricals(example):
    """Host side: string categorical features -> hashed int ids."""
    out = {}
    for key in CATEGORICAL_FEATURE_KEYS:
        out[key] = np.asarray(
            Hashing(HASH_BUCKET_SIZE)(example[key]), dtype=np.int32
        )
    return out


class CensusFeatureLayer(nn.Module):
    """The in-model half of the feature columns: one 64 x 16 table
    `emb_<key>` a categorical, its rows concatenated after the numeric
    features."""

    def __init__(self, device=None, generator=None):
        super().__init__()
        for key in CATEGORICAL_FEATURE_KEYS:
            self.add_module("emb_%s" % key.replace("-", "_"), Embed(
                HASH_BUCKET_SIZE, EMBEDDING_DIM, device, generator))

    def forward(self, features):
        parts = [features[key].to(torch.float32).reshape(-1, 1)
                 for key in NUMERIC_FEATURE_KEYS]
        for key in CATEGORICAL_FEATURE_KEYS:
            table = getattr(self, "emb_%s" % key.replace("-", "_"))
            parts.append(table(features[key].reshape(-1)))
        return torch.cat(parts, dim=-1)
