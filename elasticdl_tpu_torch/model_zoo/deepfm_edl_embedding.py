"""DeepFM whose two tables are the framework's Embedding layer: the
PyTorch twin of model_zoo/deepfm_edl_embedding/deepfm_edl_embedding.py.
The math, loss, data and metrics are deepfm_functional_api's.

Both tables are the port's `Embedding` (embedding/layer.py), looked up
through the gather kernel (csrc/embedding_gather.cu). Their tier follows
their size, as in the JAX package: at frappe's 5383 x 64 fp32 (1.4 MB,
under the 2 MiB EMBEDDING_PARTITION_THRESHOLD_BYTES) `edl_embedding`
trains in the masked dense tier; past 2 MiB (a Criteo-scale
`input_dim`) it takes the sparse-row tier, whose updates are the
row-update kernel (csrc/row_update.cu). Parameter names follow flax:
`edl_embedding.embedding_table` is `edl_embedding/embedding_table`.
"""

import torch
from torch import nn

from elasticdl_tpu_torch.embedding.layer import Embedding
from elasticdl_tpu_torch.model_zoo import deepfm_functional_api as base
from elasticdl_tpu_torch.ops.dispatch import resolve_device


class DeepFMEdlModel(nn.Module):
    def __init__(self, input_dim=base.INPUT_DIM, embedding_dim=64,
                 input_length=10, fc_unit=64, device="cuda", seed=0):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        self.edl_embedding = Embedding(input_dim, embedding_dim,
                                       device=device, generator=gen)
        self.edl_id_bias = Embedding(input_dim, 1, device=device,
                                     generator=gen)
        base.dense_tower(self, input_length * embedding_dim, fc_unit,
                         device, gen)
        self.device = device

    def forward(self, features, training=False):
        del training
        ids = torch.as_tensor(features["feature"], device=self.device)
        ids = ids.to(torch.int32)
        return base.deepfm_outputs(self, ids, self.edl_embedding(ids),
                                   self.edl_id_bias(ids))


def custom_model(input_dim=base.INPUT_DIM, embedding_dim=64,
                 input_length=10, fc_unit=64, device="cuda", seed=0):
    return DeepFMEdlModel(input_dim=input_dim, embedding_dim=embedding_dim,
                          input_length=input_length, fc_unit=fc_unit,
                          device=device, seed=seed)


# the zoo spec's entries, deepfm_functional_api's
dataset_fn = base.dataset_fn
eval_metrics_fn = base.eval_metrics_fn
feature_shapes = base.feature_shapes
flax_param_path = base.flax_param_path
loss = base.loss
optimizer = base.optimizer
