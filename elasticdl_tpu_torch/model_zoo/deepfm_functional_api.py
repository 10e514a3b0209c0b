"""DeepFM over frappe-style id lists: the PyTorch twin of
model_zoo/deepfm_functional_api/deepfm_functional_api.py, and the zoo
spec around it. The other two DeepFM models of the zoo
(deepfm_edl_embedding, deepfm_host_embedding) share its math, loss,
data and metrics and differ only in where their two tables live.

    ids [b, L] (id 0 is padding: its embeddings are masked to 0)
    second-order FM term 0.5 * sum_d((sum_l e)^2 - sum_l e^2)
    first-order term: a per-id bias embedding, summed
    deep tower Dense(fc_unit) -> Dense(1) over the flattened embeddings
    (no activation between, as in flax)
    logits = first + second + deep; {"logits": [b], "probs": [b, 1]}

The tables here are plain torch `nn.Embedding`s, as the JAX model's are
flax `nn.Embed`s: no TPU kernel serves them there, so none does here.
Parameter names follow the flax module names (`embedding.weight` is
`embedding/embedding`, `Dense_0.weight` is `Dense_0/kernel` transposed;
convert.deepfm_params_from_flax carries flax weights over). flax names
a module when it is built, and `nn.Dense(1)(nn.Dense(fc_unit)(x))`
builds the outer one first: `Dense_0` is the [fc_unit -> 1] layer and
`Dense_1` the [input_length * dim -> fc_unit] one.

Numerics follow flax: Dense kernels lecun-normal (a normal cut at two
standard deviations, rescaled to variance 1/fan_in), zero biases; nn.Embed
tables normal with variance 1/dim; all drawn from one torch.Generator on
the model's device seeded by `seed`. The loss takes no sample weights,
as the JAX zoo's does, so padded rows of a partial batch enter it.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.api.callbacks import (
    LearningRateScheduler,
    MaxStepsStopping,
)
from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.convert import deepfm_flax_param_path
from elasticdl_tpu_torch.data.example_codec import decode_example
from elasticdl_tpu_torch.ops.dispatch import resolve_device
from elasticdl_tpu_torch.training.metrics import AUC
from elasticdl_tpu_torch.training.optimizers import sgd

INPUT_DIM = 5383  # frappe vocabulary
# stddev of a unit normal cut at +-2, which flax's lecun_normal divides by
_TRUNC_STD = 0.87962566103423978


def dense_tower(module, width, fc_unit, device, gen):
    """Add `Dense_0` (fc_unit -> 1) and `Dense_1` (width -> fc_unit) to
    `module`, flax-initialised from `gen`."""
    for i, (n_in, n_out) in enumerate(((fc_unit, 1), (width, fc_unit))):
        layer = nn.Linear(n_in, n_out, device=device)
        with torch.no_grad():
            std = (1.0 / n_in) ** 0.5 / _TRUNC_STD
            nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=gen)
            layer.bias.zero_()
        module.add_module("Dense_%d" % i, layer)


def deepfm_outputs(module, ids, emb, id_bias):
    """The DeepFM head over looked-up embeddings: `ids` [b, L], `emb`
    [b, L, d], `id_bias` [b, L, 1]; `module` holds Dense_0 and
    Dense_1 (dense_tower)."""
    mask = (ids != 0).to(emb.dtype)[..., None]
    emb = emb * mask
    emb_sum = emb.sum(dim=1)
    second_order = 0.5 * (emb_sum.square()
                          - emb.square().sum(dim=1)).sum(dim=1)
    first_order = (id_bias * mask).sum(dim=(1, 2))
    deep = module.Dense_0(module.Dense_1(emb.reshape(emb.shape[0], -1)))
    logits = first_order + second_order + deep.reshape(-1)
    return {"logits": logits, "probs": torch.sigmoid(logits)[:, None]}


class DeepFMModel(nn.Module):
    def __init__(self, input_dim=INPUT_DIM, embedding_dim=64,
                 input_length=10, fc_unit=64, device="cuda", seed=0):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        for name, dim in (("embedding", embedding_dim), ("id_bias", 1)):
            table = nn.Embedding(input_dim, dim, device=device)
            with torch.no_grad():
                table.weight.normal_(0.0, dim ** -0.5, generator=gen)
            self.add_module(name, table)
        dense_tower(self, input_length * embedding_dim, fc_unit, device, gen)
        self.device = device

    def forward(self, features, training=False):
        """features {"feature": [b, input_length] ids} -> {"logits",
        "probs"}; `training` is accepted for the zoo convention."""
        del training
        ids = torch.as_tensor(features["feature"], device=self.device).long()
        return deepfm_outputs(self, ids, self.embedding(ids),
                              self.id_bias(ids))


def custom_model(input_dim=INPUT_DIM, embedding_dim=64, input_length=10,
                 fc_unit=64, device="cuda", seed=0):
    return DeepFMModel(input_dim=input_dim, embedding_dim=embedding_dim,
                       input_length=input_length, fc_unit=fc_unit,
                       device=device, seed=seed)


def loss(labels, predictions):
    """Mean sigmoid cross entropy on the logits (optax
    sigmoid_binary_cross_entropy)."""
    logits = predictions["logits"].reshape(-1)
    labels = torch.as_tensor(labels, device=logits.device).reshape(-1)
    return F.binary_cross_entropy_with_logits(logits,
                                              labels.to(logits.dtype))


def optimizer(lr=0.1):
    return sgd(lr)


def _schedule(model_version):
    """ElasticDL's absolute schedule (0.1, 0.05, 0.01 by step) as
    multipliers of the base lr 0.1."""
    if model_version < 2000:
        return 1.0
    return 0.5 if model_version < 4000 else 0.1


def callbacks():
    return [LearningRateScheduler(_schedule), MaxStepsStopping(max_steps=200)]


# the spec's parameter-name -> flax-path mapping (checkpoints, exports)
flax_param_path = deepfm_flax_param_path


def dataset_fn(dataset, mode, _):
    """frappe records: a fixed-length id list `feature` and a binary
    label."""

    def _parse(record):
        ex = decode_example(record)
        features = {"feature": ex["feature"].astype(np.int32)}
        if mode == Mode.PREDICTION:
            return features
        return features, ex["label"].astype(np.int32)[0]

    dataset = dataset.map(_parse)
    if mode == Mode.TRAINING:
        dataset = dataset.shuffle(buffer_size=1024, seed=0)
    return dataset


def eval_metrics_fn():
    return {
        "logits": {
            "accuracy": lambda labels, predictions: (
                (np.asarray(predictions).reshape(-1) > 0.0).astype(np.int32)
                == np.asarray(labels).reshape(-1)
            ).astype(np.float32)
        },
        "probs": {"auc": AUC()},
    }


def feature_shapes():
    return {"feature": (10,)}
