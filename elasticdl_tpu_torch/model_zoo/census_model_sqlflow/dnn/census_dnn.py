"""Census DNN in SQLFlow's feature-column style: the PyTorch twin of
model_zoo/census_model_sqlflow/dnn/census_dnn.py (the reference's
census_feature_column.py:34-52 and census_functional.py:27-37): numeric
columns pass through; each categorical column is hashed into 64 buckets
on the host (dataset_fn) and embedded at dim 16 in the model
(`<key>_embedding`); Dense 16 - 16 - 1 with relu and a sigmoid head,
Adam(1e-3), binary cross entropy on the probabilities. Parameter names
are the flax paths (flax_layers.py); weights from seed `seed` on
`device`."""

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.convert import zoo_flax_param_path
from elasticdl_tpu_torch.data.example_codec import decode_example
from elasticdl_tpu_torch.model_zoo.flax_layers import (
    Dense,
    Embed,
    binary_cross_entropy_on_probs,
    flax_generator,
)
from elasticdl_tpu_torch.ops.dispatch import resolve_device
from elasticdl_tpu_torch.preprocessing.layers import Hashing
from elasticdl_tpu_torch.training.optimizers import adam

CATEGORICAL_FEATURE_KEYS = [
    "workclass", "education", "marital-status", "occupation",
    "relationship", "race", "sex", "native-country",
]
NUMERIC_FEATURE_KEYS = [
    "age", "capital-gain", "capital-loss", "hours-per-week",
]
LABEL_KEY = "label"

HASH_BUCKETS = 64
EMBEDDING_DIM = 16


def _table(name):
    return "%s_embedding" % name.replace("-", "_")


class CensusDNN(nn.Module):
    def __init__(self, device="cuda", seed=0):
        super().__init__()
        device = resolve_device(device)
        gen = flax_generator(device, seed)
        for name in CATEGORICAL_FEATURE_KEYS:
            self.add_module(_table(name), Embed(HASH_BUCKETS, EMBEDDING_DIM,
                                                device, gen))
        width = (len(NUMERIC_FEATURE_KEYS)
                 + len(CATEGORICAL_FEATURE_KEYS) * EMBEDDING_DIM)
        for i, (n_in, n_out) in enumerate(((width, 16), (16, 16), (16, 1))):
            self.add_module("Dense_%d" % i, Dense(n_in, n_out, device=device,
                                                  generator=gen))

    def forward(self, features, training=False):
        del training
        parts = [features[name].to(torch.float32).reshape(-1, 1)
                 for name in NUMERIC_FEATURE_KEYS]
        for name in CATEGORICAL_FEATURE_KEYS:
            parts.append(getattr(self, _table(name))(
                features[name].reshape(-1)))
        x = torch.cat(parts, dim=1)
        x = torch.relu(self.Dense_0(x))
        x = torch.relu(self.Dense_1(x))
        return torch.sigmoid(self.Dense_2(x))


def custom_model(device="cuda", seed=0):
    return CensusDNN(device=device, seed=seed)


def loss(labels, predictions):
    labels = torch.as_tensor(labels, device=predictions.device)
    return binary_cross_entropy_on_probs(labels.reshape(-1),
                                         predictions.reshape(-1))


def optimizer(lr=0.001):
    return adam(lr)


flax_param_path = zoo_flax_param_path


def dataset_fn(dataset, mode, _):
    hashers = {
        name: Hashing(num_bins=HASH_BUCKETS)
        for name in CATEGORICAL_FEATURE_KEYS
    }

    def _parse(record):
        ex = decode_example(record)
        features = {
            name: np.asarray(ex[name], np.float32).reshape(())
            for name in NUMERIC_FEATURE_KEYS
        }
        for name in CATEGORICAL_FEATURE_KEYS:
            features[name] = np.asarray(
                hashers[name](ex[name]), np.int64
            ).reshape(())
        if mode == Mode.PREDICTION:
            return features
        return features, ex[LABEL_KEY].astype(np.int32).reshape(())

    return dataset.map(_parse)


def eval_metrics_fn():
    return {
        "accuracy": lambda labels, predictions: (
            (np.asarray(predictions).reshape(-1) > 0.5).astype(np.int32)
            == np.asarray(labels).reshape(-1)
        ).astype(np.float32)
    }
