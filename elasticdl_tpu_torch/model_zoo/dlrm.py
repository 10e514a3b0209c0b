"""DLRM (Naumov et al. 2019): the PyTorch twin of
model_zoo/dlrm/dlrm.py, and the zoo spec around it (loss, optimizer,
dataset_fn, eval_metrics_fn, feature_shapes).

    dense [b, 13] -> bottom MLP -> [b, d]
    26 categorical ids -> one Embedding each -> [b, 26, d]
    pairwise dot products over the 27 vectors (upper triangle, i < j)
    concat(bottom, interactions) -> top MLP -> logit

Every table is the port's `Embedding` (embedding/layer.py), looked up
together through `lookup_many`: one gather-kernel launch for the 26
tables. A table of at least 2 MiB (every table at the bench width, 1.2M
x 32 fp32 = 154 MB) takes the sparse-row tier, whose updates are one
row-update-kernel launch a step for all the tables. Parameter names
follow the flax module names (`bottom_0` ..., `table_0.embedding_table`
..., `top_0` ...), so `convert.dlrm_params_from_flax` carries flax
weights over.

Numerics follow flax: Dense kernels drawn lecun-normal (a normal cut at
two standard deviations and rescaled to variance 1/fan_in), zero
biases, tables keras-uniform(-0.05, 0.05); all from one torch.Generator
on the model's device seeded by `seed`.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.common.hash_utils import string_to_id
from elasticdl_tpu_torch.convert import dlrm_flax_param_path
from elasticdl_tpu_torch.data.example_codec import decode_example
from elasticdl_tpu_torch.embedding.layer import Embedding, lookup_many
from elasticdl_tpu_torch.ops.dispatch import resolve_device
from elasticdl_tpu_torch.training.metrics import AUC
from elasticdl_tpu_torch.training.optimizers import sgd

NUM_DENSE = 13
NUM_SPARSE = 26
# stddev of a unit normal cut at +-2, which flax's lecun_normal divides by
_TRUNC_STD = 0.87962566103423978


class DLRM(nn.Module):
    def __init__(self, table_size=100_000, num_tables=NUM_SPARSE,
                 embedding_dim=32, bottom_mlp=(64, 32), top_mlp=(64, 1),
                 device="cuda", seed=0):
        super().__init__()
        device = resolve_device(device)
        self.table_size = int(table_size)
        self.num_tables = int(num_tables)
        d = self.embedding_dim = int(embedding_dim)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        self.bottom = self._mlp("bottom", NUM_DENSE,
                                tuple(bottom_mlp) + (d,), device, gen)
        for t in range(self.num_tables):
            self.add_module("table_%d" % t, Embedding(
                self.table_size, d, device=device, generator=gen))
        n = self.num_tables + 1
        iu, ju = np.triu_indices(n, k=1)
        # flat positions of the (i < j) pairs in the [n, n] products, in
        # np.triu_indices order, which fixes the top MLP's input order
        self.register_buffer("pair_index", torch.as_tensor(
            iu * n + ju, dtype=torch.long, device=device), persistent=False)
        self.top = self._mlp("top", d + len(iu), tuple(top_mlp), device, gen)

    def _mlp(self, name, width, sizes, device, gen):
        layers = []
        for i, out in enumerate(sizes):
            layer = nn.Linear(width, out, device=device)
            with torch.no_grad():
                std = (1.0 / width) ** 0.5 / _TRUNC_STD
                nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std,
                                      2 * std, generator=gen)
                layer.bias.zero_()
            self.add_module("%s_%d" % (name, i), layer)
            layers.append(layer)
            width = out
        return layers

    @property
    def device(self):
        return self.pair_index.device

    def tables(self):
        return [getattr(self, "table_%d" % t) for t in range(self.num_tables)]

    @staticmethod
    def _run_mlp(layers, x):
        for i, layer in enumerate(layers):
            x = layer(x)
            if i < len(layers) - 1:
                x = F.relu(x)
        return x

    def forward(self, features, training=False):
        """features {"dense": [b, 13], "sparse": [b, >= num_tables] ids}
        -> {"logits": [b], "probs": [b, 1]}; `training` is accepted for
        the zoo convention (the model has no dropout)."""
        del training
        dense = torch.as_tensor(features["dense"], device=self.device).float()
        # fold hashed ids into this model's table range, as flax does
        ids = torch.as_tensor(features["sparse"], device=self.device)
        ids = (ids.to(torch.int32) % self.table_size).t().contiguous()
        bottom = self._run_mlp(self.bottom, dense)  # [b, d]
        embs = lookup_many(self.tables(), ids[:self.num_tables])
        z = torch.stack([bottom] + embs, dim=1)  # [b, T+1, d]
        inter = torch.bmm(z, z.transpose(1, 2))  # [b, T+1, T+1]
        pairs = inter.reshape(inter.shape[0], -1)[:, self.pair_index]
        logits = self._run_mlp(self.top, torch.cat([bottom, pairs], dim=1))
        logits = logits.reshape(-1)
        return {"logits": logits, "probs": torch.sigmoid(logits)[:, None]}


def custom_model(table_size=100_000, num_tables=NUM_SPARSE, embedding_dim=32,
                 bottom_mlp=(64, 32), top_mlp=(64, 1), device="cuda", seed=0):
    return DLRM(table_size=table_size, num_tables=num_tables,
                embedding_dim=embedding_dim, bottom_mlp=bottom_mlp,
                top_mlp=top_mlp, device=device, seed=seed)


def loss(labels, predictions, sample_weights=None):
    """Sigmoid cross entropy on the logits (optax
    sigmoid_binary_cross_entropy), weighted: sum(ce * w) / max(sum(w),
    1e-9)."""
    logits = predictions["logits"].reshape(-1)
    labels = torch.as_tensor(labels, device=logits.device).reshape(-1)
    ce = F.binary_cross_entropy_with_logits(
        logits, labels.to(logits.dtype), reduction="none")
    if sample_weights is None:
        return ce.mean()
    w = torch.as_tensor(sample_weights, device=logits.device,
                        dtype=ce.dtype).reshape(-1)
    return (ce * w).sum() / w.sum().clamp(min=1e-9)


def optimizer(lr=0.01):
    return sgd(lr)


# the spec's parameter-name -> flax-path mapping (trainable_pattern)
flax_param_path = dlrm_flax_param_path


# Hash modulus for categorical strings -> ids, as the JAX zoo's
HASH_BUCKETS = 100_000


def dataset_fn(dataset, mode, _):
    """Criteo/DAC records (numeric I1..I13, categorical strings
    C1..C26, binary label): dense features log-normalised, categorical
    strings hashed into HASH_BUCKETS ids."""

    def _parse(record):
        ex = decode_example(record)
        dense = np.array([float(ex["I%d" % i]) for i in
                          range(1, NUM_DENSE + 1)], np.float32)
        dense = np.log1p(np.maximum(dense, 0.0))
        sparse = np.array(
            [string_to_id(np.asarray(ex["C%d" % i]).item().decode(),
                          HASH_BUCKETS)
             for i in range(1, NUM_SPARSE + 1)], np.int32)
        features = {"dense": dense, "sparse": sparse}
        if mode == Mode.PREDICTION:
            return features
        return features, np.int32(ex["label"])

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
    return {"dense": (NUM_DENSE,), "sparse": (NUM_SPARSE,)}
