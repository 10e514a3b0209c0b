"""DeepFM whose tables live in host DRAM through the host-spill bridge:
the PyTorch twin of model_zoo/deepfm_host_embedding/
deepfm_host_embedding.py, the model a user picks when the tables exceed
the card's memory. The math, loss, data and metrics are
deepfm_functional_api's.

The two tables are declared by `host_embeddings()`: their rows live in
the native host store (csrc/host_embedding.cc), HostEmbeddingManager
pulls each batch's unique rows, the card gathers them through the
gather kernel (`HostEmbedding`), and the engines' native SGD applies
the row gradients. The model's own parameters are the dense tower
(`Dense_0`, `Dense_1`), whose torch SGD steps at the same rate.

flax infers Dense_0's input width from the pulled rows; a torch Linear
needs it up front: input_length x the `edl_embedding` table's dim
(`embedding_dim`, by default the dim `host_embeddings()` declares).
"""

import torch
from torch import nn

from elasticdl_tpu_torch.embedding.host_bridge import HostEmbedding
from elasticdl_tpu_torch.model_zoo import deepfm_functional_api as base
from elasticdl_tpu_torch.ops.dispatch import resolve_device


class DeepFMHostModel(nn.Module):
    def __init__(self, input_length=10, fc_unit=64, embedding_dim=None,
                 device="cuda", seed=0):
        super().__init__()
        device = resolve_device(device)
        if embedding_dim is None:
            embedding_dim = host_embeddings()["edl_embedding"]["dim"]
        gen = torch.Generator(device=device).manual_seed(int(seed))
        self.edl_embedding = HostEmbedding("edl_embedding", device=device)
        self.edl_id_bias = HostEmbedding("edl_id_bias", device=device)
        base.dense_tower(self, input_length * embedding_dim, fc_unit,
                         device, gen)
        self.device = device

    def forward(self, features, training=False):
        """features: the batch's {"feature": [b, L] ids} plus the
        `<table>.rows` / `<table>.idx` the manager prepared."""
        del training
        ids = torch.as_tensor(features["feature"], device=self.device)
        return base.deepfm_outputs(self, ids,
                                   self.edl_embedding(features),
                                   self.edl_id_bias(features))


def custom_model(input_length=10, fc_unit=64, embedding_dim=None,
                 device="cuda", seed=0):
    return DeepFMHostModel(input_length=input_length, fc_unit=fc_unit,
                           embedding_dim=embedding_dim, device=device,
                           seed=seed)


def host_embeddings(embedding_dim=64):
    """Host-DRAM table declarations (embedding/host_bridge
    build_manager_from_spec). The engines' SGD matches optimizer(), so
    dense params and embedding rows step at one rate."""
    return {
        "edl_embedding": dict(ids_feature="feature", dim=embedding_dim,
                              optimizer="sgd", lr=0.1),
        "edl_id_bias": dict(ids_feature="feature", dim=1, optimizer="sgd",
                            lr=0.1),
    }


# the zoo spec's entries, deepfm_functional_api's
dataset_fn = base.dataset_fn
eval_metrics_fn = base.eval_metrics_fn
feature_shapes = base.feature_shapes
flax_param_path = base.flax_param_path
loss = base.loss
optimizer = base.optimizer
