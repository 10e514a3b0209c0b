"""Criteo CTR training entry: the PyTorch twin of
model_zoo/dac_ctr/elasticdl_train.py (the reference's elasticdl_train.py,
which hardwires xdeepfm): a spec module whose dataset_fn runs
transform_feature over FEATURE_GROUPS and whose
``custom_model(ctr_model=...)`` selects wide_deep / deepfm / dcn / xdeepfm
through --model_params; ``max_hashing_bucket_size`` caps the hash
spaces (the published 10^6 by default: 5.50 M rows a table width).
Adam(1e-3), sigmoid cross entropy on the logits, MaxStepsStopping at
150000 steps.

Parameter names are the flax paths (flax_layers.py): the CTR model is
the wrapper's `inner`, as in flax. Weights from seed `seed` on
`device`.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.api.callbacks import MaxStepsStopping
from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.convert import zoo_flax_param_path
from elasticdl_tpu_torch.data.example_codec import decode_example
from elasticdl_tpu_torch.model_zoo.dac_ctr.dcn_model import dcn_model
from elasticdl_tpu_torch.model_zoo.dac_ctr.deepfm_model import deepfm_model
from elasticdl_tpu_torch.model_zoo.dac_ctr.feature_config import (
    FEATURE_GROUPS,
    LABEL_KEY,
    MAX_HASHING_BUCKET_SIZE,
)
from elasticdl_tpu_torch.model_zoo.dac_ctr.feature_transform import (
    group_max_ids,
    transform_feature,
)
from elasticdl_tpu_torch.model_zoo.dac_ctr.wide_deep_model import (
    wide_deep_model,
)
from elasticdl_tpu_torch.model_zoo.dac_ctr.xdeepfm_model import (
    xdeepfm_model,
)
from elasticdl_tpu_torch.model_zoo.flax_layers import flax_generator
from elasticdl_tpu_torch.ops.dispatch import resolve_device
from elasticdl_tpu_torch.training.metrics import AUC
from elasticdl_tpu_torch.training.optimizers import adam

_MODELS = {
    "wide_deep": wide_deep_model,
    "deepfm": deepfm_model,
    "dcn": dcn_model,
    "xdeepfm": xdeepfm_model,
}

# module-level so dataset_fn (which has no model handle) matches the
# model's id spaces; custom_model(max_hashing_bucket_size=...) updates it
_max_bucket = [MAX_HASHING_BUCKET_SIZE]


class _CTRWrapper(nn.Module):
    """Adapts the (features dict) call to (dense_tensor, id_tensors)."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, features, training=False):
        dense = features["dense"].to(torch.float32)
        id_tensors = {
            k: v for k, v in features.items() if k.startswith("group_")
        }
        return self.inner(dense, id_tensors, training=training)


def custom_model(ctr_model="xdeepfm",
                 max_hashing_bucket_size=MAX_HASHING_BUCKET_SIZE,
                 device="cuda", seed=0):
    _max_bucket[0] = int(max_hashing_bucket_size)
    max_ids = group_max_ids(FEATURE_GROUPS, _max_bucket[0])
    device = resolve_device(device)
    return _CTRWrapper(_MODELS[ctr_model](
        max_ids, device=device, generator=flax_generator(device, seed)))


def loss(labels, predictions):
    """Mean sigmoid cross entropy on the logits (optax
    sigmoid_binary_cross_entropy)."""
    logits = predictions["logits"].reshape(-1)
    labels = torch.as_tensor(labels, device=logits.device).reshape(-1)
    return F.binary_cross_entropy_with_logits(logits,
                                              labels.to(logits.dtype))


def optimizer(lr=0.001):
    return adam(lr)


def callbacks():
    return [MaxStepsStopping(max_steps=150000)]


flax_param_path = zoo_flax_param_path


def dataset_fn(dataset, mode, _):
    def _parse(record):
        ex = decode_example(record)
        dense, id_tensors = transform_feature(
            ex, FEATURE_GROUPS, _max_bucket[0]
        )
        features = {"dense": dense}
        features.update(id_tensors)
        if mode == Mode.PREDICTION:
            return features
        return features, np.asarray(ex[LABEL_KEY], np.int32).reshape(())

    dataset = dataset.map(_parse)
    if mode == Mode.TRAINING:
        dataset = dataset.shuffle(buffer_size=10000, seed=0)
    return dataset


def eval_metrics_fn():
    return {
        "logits": {
            "accuracy": lambda labels, predictions: (
                (np.asarray(predictions).reshape(-1) > 0.5).astype(np.int32)
                == np.asarray(labels).reshape(-1)
            ).astype(np.float32)
        },
        "probs": {"auc": AUC()},
    }


def feature_shapes():
    shapes = {"dense": (13,)}
    shapes.update({"group_%d" % i: (1,) for i in range(len(FEATURE_GROUPS))})
    return shapes
