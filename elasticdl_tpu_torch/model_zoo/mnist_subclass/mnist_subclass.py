"""MNIST CNN, subclass style: the PyTorch twin of
model_zoo/mnist_subclass/mnist_subclass.py (the reference's
mnist_subclass.py:18-100), and the zoo spec around it.

The mnist_functional_api net under the flax `setup()` attribute names
(`_conv1`, `_conv2`, `_batch_norm` with flax's default epsilon,
`_dense`); SGD 0.01; the loss takes no sample weights, as the JAX
module's.
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


class CustomModel(nn.Module):
    def __init__(self, device="cuda", seed=0):
        super().__init__()
        device = resolve_device(device)
        gen = flax_generator(device, seed)
        self._conv1 = Conv(1, 32, 3, padding="VALID", device=device,
                           generator=gen)
        self._conv2 = Conv(32, 64, 3, padding="VALID", device=device,
                           generator=gen)
        self._batch_norm = BatchNorm(64, momentum=0.99, device=device)
        self._dropout = Dropout(0.25)
        self._dense = Dense(12 * 12 * 64, 10, device=device, generator=gen)

    def forward(self, features, training=False):
        x = features["image"].to(torch.float32)
        x = nhwc_to_nchw(x.reshape(x.shape[0], 28, 28, 1))
        x = torch.relu(self._conv1(x))
        x = torch.relu(self._conv2(x))
        x = self._batch_norm(x, training)
        x = max_pool(x, (2, 2), strides=(2, 2))
        x = self._dropout(x, training)
        return self._dense(flatten_nhwc(x))


def custom_model(device="cuda", seed=0):
    return CustomModel(device=device, seed=seed)


def loss(labels, predictions):
    return image_spec.mean_cross_entropy(labels, predictions)


def optimizer(lr=0.01):
    return sgd(lr)


flax_param_path = zoo_flax_param_path
dataset_fn = image_spec.image_dataset_fn()
eval_metrics_fn = image_spec.eval_metrics_fn


def feature_shapes():
    return {"image": (28, 28)}
