"""Census Wide&Deep: the PyTorch twin of
model_zoo/census_wide_deep_model/wide_deep_functional_api.py (the
reference's wide_deep_functional_api.py:164-244), and the zoo spec
around it.

* features become per-group offset id matrices on the host
  (transform_layers.py);
* wide tower: a dim-1 table a group (`wide_<group>_embedding`), summed
  over the group's features;
* deep tower: a dim-8 table a group (`deep_<group>_embedding`), summed,
  then Dense 16, 8, 4 (no activation, as in flax);
* concat(wide, deep) -> sum -> logits [b, 1]; sigmoid -> probs [b];
  sigmoid cross entropy on the logits, Adam(1e-3).

Parameter names are the flax paths (flax_layers.py); weights from seed
`seed` on `device`.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.convert import zoo_flax_param_path
from elasticdl_tpu_torch.data.example_codec import decode_example
from elasticdl_tpu_torch.model_zoo.census_wide_deep_model.feature_config import (  # noqa: E501
    FEATURE_GROUPS,
    LABEL_KEY,
    MODEL_INPUTS,
    get_id_group_dims,
)
from elasticdl_tpu_torch.model_zoo.census_wide_deep_model.transform_layers import (  # noqa: E501
    transform,
)
from elasticdl_tpu_torch.model_zoo.flax_layers import (
    Dense,
    Embed,
    flax_generator,
)
from elasticdl_tpu_torch.ops.dispatch import resolve_device
from elasticdl_tpu_torch.training.metrics import AUC
from elasticdl_tpu_torch.training.optimizers import adam

HIDDEN_UNITS = (16, 8, 4)


class WideDeepTowers(nn.Module):
    """The wide&deep head over per-group id matrices: `wide` and `deep`
    are [(group name, table attribute, id-space size)] in the order the
    towers concatenate; the wide tables are dim 1, the deep ones
    `deep_dim`, and Dense_0.. of HIDDEN_UNITS follow the deep tower."""

    def __init__(self, wide, deep, deep_dim=8, device="cuda", seed=0):
        super().__init__()
        device = resolve_device(device)
        gen = flax_generator(device, seed)
        self._wide = [(g, name) for g, name, _n in wide]
        self._deep = [(g, name) for g, name, _n in deep]
        # flax builds the tables as the forward first calls them: wide
        # then deep; the draws follow that order
        for (_g, name, n), dim in ([(w, 1) for w in wide]
                                   + [(d, deep_dim) for d in deep]):
            self.add_module(name, Embed(n, dim, device, gen))
        width = deep_dim * len(deep)
        for i, units in enumerate(HIDDEN_UNITS):
            self.add_module("Dense_%d" % i, Dense(width, units, device=device,
                                                  generator=gen))
            width = units

    def _tower(self, features, tables):
        return torch.cat([getattr(self, name)(features[g]).sum(dim=1)
                          for g, name in tables], dim=-1)

    def forward(self, features, training=False):
        del training
        wide = self._tower(features, self._wide)
        dnn = self._tower(features, self._deep)
        for i in range(len(HIDDEN_UNITS)):
            dnn = getattr(self, "Dense_%d" % i)(dnn)
        logits = torch.cat([wide, dnn], dim=1).sum(dim=1, keepdim=True)
        return {"logits": logits, "probs": torch.sigmoid(logits).reshape(-1)}


def custom_model(device="cuda", seed=0):
    dims = get_id_group_dims()
    return WideDeepTowers(
        [(g, "wide_%s_embedding" % g, dims[g]) for g in MODEL_INPUTS["wide"]],
        [(g, "deep_%s_embedding" % g, dims[g]) for g in MODEL_INPUTS["deep"]],
        device=device, seed=seed)


def loss(labels, predictions):
    """Mean sigmoid cross entropy on the logits (optax
    sigmoid_binary_cross_entropy)."""
    logits = predictions["logits"].reshape(-1)
    labels = torch.as_tensor(labels, device=logits.device).reshape(-1)
    return F.binary_cross_entropy_with_logits(logits,
                                              labels.to(logits.dtype))


def optimizer(lr=0.001):
    return adam(lr)


flax_param_path = zoo_flax_param_path


def dataset_fn(dataset, mode, _):
    def _parse(record):
        ex = decode_example(record)
        features = {
            name: ids.astype(np.int64)
            for name, ids in transform(ex, FEATURE_GROUPS).items()
        }
        if mode == Mode.PREDICTION:
            return features
        return features, np.asarray(ex[LABEL_KEY], np.int32).reshape(())

    dataset = dataset.map(_parse)
    if mode == Mode.TRAINING:
        dataset = dataset.shuffle(buffer_size=1024, seed=0)
    return dataset


def logits_accuracy(labels, predictions):
    """1 where the logit's sign gives the label, per example."""
    return ((np.asarray(predictions).reshape(-1) > 0.0).astype(np.int32)
            == np.asarray(labels).reshape(-1)).astype(np.float32)


def eval_metrics_fn():
    return {"logits": {"accuracy": logits_accuracy},
            "probs": {"auc": AUC()}}


def feature_shapes():
    return {
        name: (len(group),) for name, group in FEATURE_GROUPS.items()
    }
