"""MNIST CNN: the PyTorch twin of
model_zoo/mnist_functional_api/mnist_functional_api.py (the reference's
mnist_functional_api.py:21-103), and the zoo spec around it.

Conv 32 - Conv 64 (3 x 3, VALID, relu), BatchNorm (momentum 0.99),
max_pool 2, Dropout 0.25, Dense 10; SGD 0.1; the weighted loss takes
`sample_weights`. Activations run NCHW; the flatten before the Dense
is in flax's NHWC order, so `Dense_0`'s 9216 rows are flax's. Parameter
names are the flax paths (flax_layers.py); weights from seed `seed` on
`device`.
"""

import torch
from torch import nn

from elasticdl_tpu_torch.convert import zoo_flax_param_path
from elasticdl_tpu_torch.model_zoo import image_spec
from elasticdl_tpu_torch.model_zoo.flax_layers import (
    BatchNorm,
    Conv,
    Dense,
    Dropout,
    flatten_nhwc,
    flax_generator,
    max_pool,
    nhwc_to_nchw,
)
from elasticdl_tpu_torch.ops.dispatch import resolve_device
from elasticdl_tpu_torch.training.optimizers import sgd


class MnistModel(nn.Module):
    def __init__(self, device="cuda", seed=0):
        super().__init__()
        device = resolve_device(device)
        gen = flax_generator(device, seed)
        self.Conv_0 = Conv(1, 32, 3, padding="VALID", device=device,
                           generator=gen)
        self.Conv_1 = Conv(32, 64, 3, padding="VALID", device=device,
                           generator=gen)
        self.BatchNorm_0 = BatchNorm(64, momentum=0.99, device=device)
        self.Dropout_0 = Dropout(0.25)
        self.Dense_0 = Dense(12 * 12 * 64, 10, device=device, generator=gen)

    def forward(self, features, training=False):
        x = features["image"].to(torch.float32)
        x = nhwc_to_nchw(x.reshape(x.shape[0], 28, 28, 1))
        x = torch.relu(self.Conv_0(x))
        x = torch.relu(self.Conv_1(x))
        x = self.BatchNorm_0(x, training)
        x = max_pool(x, (2, 2), strides=(2, 2))
        x = self.Dropout_0(x, training)
        return self.Dense_0(flatten_nhwc(x))


def custom_model(device="cuda", seed=0):
    return MnistModel(device=device, seed=seed)


def loss(labels, predictions, sample_weights=None):
    labels = torch.as_tensor(labels, device=predictions.device)
    ce = image_spec.softmax_cross_entropy(predictions, labels)
    if sample_weights is None:
        return ce.mean()
    w = torch.as_tensor(sample_weights, device=ce.device, dtype=ce.dtype)
    return (ce * w).sum() / torch.clamp(w.sum(), min=1.0)


def optimizer(lr=0.1):
    return sgd(lr)


flax_param_path = zoo_flax_param_path
dataset_fn = image_spec.image_dataset_fn()
eval_metrics_fn = image_spec.eval_metrics_fn


def feature_shapes():
    return {"image": (28, 28)}
