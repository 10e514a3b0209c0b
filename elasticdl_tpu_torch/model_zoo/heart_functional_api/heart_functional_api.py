"""Heart-disease classifier: the PyTorch twin of
model_zoo/heart_functional_api/heart_functional_api.py (the reference's
heart_functional_api.py:20-100), and the zoo spec around it.

* trestbps / chol / thalach / oldpeak / slope / ca pass through;
* `age` bucketized at [18, 25, ..., 65] and one-hot (11 buckets);
* `thal` (a string) hashed into 100 buckets and embedded at dim 8;
* Dense 16 - 16 - 1 with relu and a sigmoid head, SGD(1e-6), binary
  cross entropy on the probabilities.

The hash and the buckets run on the host in dataset_fn; the one-hot,
the table and the MLP are the model. Parameter names are the flax
paths (flax_layers.py); weights from seed `seed` on `device`.
"""

import numpy as np
import torch
import torch.nn.functional as F
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
from elasticdl_tpu_torch.preprocessing.layers import Discretization, Hashing
from elasticdl_tpu_torch.training.optimizers import sgd

NUMERIC_KEYS = ["trestbps", "chol", "thalach", "oldpeak", "slope", "ca"]
AGE_BOUNDARIES = [18, 25, 30, 35, 40, 45, 50, 55, 60, 65]
THAL_HASH_BUCKETS = 100
THAL_EMBEDDING_DIM = 8


class HeartModel(nn.Module):
    def __init__(self, device="cuda", seed=0):
        super().__init__()
        device = resolve_device(device)
        gen = flax_generator(device, seed)
        width = (len(NUMERIC_KEYS) + len(AGE_BOUNDARIES) + 1
                 + THAL_EMBEDDING_DIM)
        self.thal_embedding = Embed(THAL_HASH_BUCKETS, THAL_EMBEDDING_DIM,
                                    device, gen)
        for i, (n_in, n_out) in enumerate(((width, 16), (16, 16), (16, 1))):
            self.add_module("Dense_%d" % i, Dense(n_in, n_out, device=device,
                                                  generator=gen))

    def forward(self, features, training=False):
        del training
        parts = [features[k].to(torch.float32).reshape(-1, 1)
                 for k in NUMERIC_KEYS]
        parts.append(F.one_hot(features["age_bucket"].long().reshape(-1),
                               len(AGE_BOUNDARIES) + 1).to(torch.float32))
        parts.append(self.thal_embedding(features["thal_id"].reshape(-1)))
        x = torch.cat(parts, dim=-1)
        x = torch.relu(self.Dense_0(x))
        x = torch.relu(self.Dense_1(x))
        return torch.sigmoid(self.Dense_2(x))


def custom_model(device="cuda", seed=0):
    return HeartModel(device=device, seed=seed)


def loss(labels, predictions):
    labels = torch.as_tensor(labels, device=predictions.device)
    return binary_cross_entropy_on_probs(labels.reshape(-1),
                                         predictions.reshape(-1))


def optimizer(lr=1e-6):
    return sgd(lr)


flax_param_path = zoo_flax_param_path


def dataset_fn(dataset, mode, _):
    age_bucketize = Discretization(bins=AGE_BOUNDARIES)
    thal_hash = Hashing(THAL_HASH_BUCKETS)

    def _parse(record):
        ex = decode_example(record)
        features = {
            k: np.asarray(ex[k], dtype=np.float32).reshape(())
            for k in NUMERIC_KEYS
        }
        features["age_bucket"] = np.asarray(
            age_bucketize(np.asarray(ex["age"], np.float32)), np.int32
        ).reshape(())
        features["thal_id"] = np.asarray(
            thal_hash(ex["thal"]), np.int32
        ).reshape(())
        if mode == Mode.PREDICTION:
            return features
        return features, np.asarray(ex["target"], np.int32).reshape(())

    return dataset.map(_parse)


def eval_metrics_fn():
    return {
        "accuracy": lambda labels, predictions: (
            np.round(np.asarray(predictions).reshape(-1)).astype(np.int32)
            == np.asarray(labels).reshape(-1)
        ).astype(np.float32)
    }


def feature_shapes():
    shapes = {k: () for k in NUMERIC_KEYS}
    shapes["age_bucket"] = ()
    shapes["thal_id"] = ()
    return shapes
