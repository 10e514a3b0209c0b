"""CIFAR-10 CNN, subclass style: the PyTorch twin of
model_zoo/cifar10_subclass/cifar10_subclass.py (the reference's
cifar10_subclass.py:18-200), and the zoo spec around it.

The cifar10_functional_api stack under the flax `setup()` names:
`_block1a` ... `_block3b` (each a conv - BatchNorm - relu with
`Conv_0` and `BatchNorm_0` inside), `_drop1` ... `_drop3`, `_dense`;
SGD 0.1 without a schedule.
"""

import torch
from torch import nn

from elasticdl_tpu_torch.convert import zoo_flax_param_path
from elasticdl_tpu_torch.model_zoo import image_spec
from elasticdl_tpu_torch.model_zoo.cifar10_functional_api.\
    cifar10_functional_api import STAGES
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


class _ConvBNRelu(nn.Module):
    def __init__(self, in_channels, channels, device, generator):
        super().__init__()
        self.Conv_0 = Conv(in_channels, channels, 3, padding="SAME",
                           device=device, generator=generator)
        self.BatchNorm_0 = BatchNorm(channels, momentum=0.9, epsilon=1e-6,
                                     device=device)

    def forward(self, x, training=False):
        return torch.relu(self.BatchNorm_0(self.Conv_0(x), training))


class CustomModel(nn.Module):
    def __init__(self, device="cuda", seed=0):
        super().__init__()
        device = resolve_device(device)
        gen = flax_generator(device, seed)
        c_in = 3
        for stage, (ch, rate) in enumerate(STAGES, start=1):
            for part in "ab":
                self.add_module("_block%d%s" % (stage, part),
                                _ConvBNRelu(c_in, ch, device, gen))
                c_in = ch
            self.add_module("_drop%d" % stage, Dropout(rate))
        self._dense = Dense(4 * 4 * 128, 10, device=device, generator=gen)

    def forward(self, features, training=False):
        x = features["image"].to(torch.float32)
        x = nhwc_to_nchw(x.reshape(x.shape[0], 32, 32, 3))
        for stage in range(1, len(STAGES) + 1):
            x = getattr(self, "_block%da" % stage)(x, training)
            x = getattr(self, "_block%db" % stage)(x, training)
            x = max_pool(x, (2, 2), strides=(2, 2))
            x = getattr(self, "_drop%d" % stage)(x, training)
        return self._dense(flatten_nhwc(x))


def custom_model(device="cuda", seed=0):
    return CustomModel(device=device, seed=seed)


def loss(labels, predictions):
    return image_spec.mean_cross_entropy(labels, predictions)


def optimizer(lr=0.1):
    return sgd(lr)


flax_param_path = zoo_flax_param_path
dataset_fn = image_spec.image_dataset_fn()
eval_metrics_fn = image_spec.eval_metrics_fn


def feature_shapes():
    return {"image": (32, 32, 3)}
