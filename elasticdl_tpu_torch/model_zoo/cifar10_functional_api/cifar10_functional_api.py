"""CIFAR-10 VGG-style CNN: the PyTorch twin of
model_zoo/cifar10_functional_api/cifar10_functional_api.py (the
reference's cifar10_functional_api.py:19-176), and the zoo spec around
it.

Three stages at 32, 64 and 128 channels, each two conv (3 x 3, SAME) -
BatchNorm (momentum 0.9, epsilon 1e-6) - relu pairs, max_pool 2 and
Dropout 0.2 / 0.3 / 0.4; then Dense `output` over the NHWC flatten; SGD
0.1 under the reference's LearningRateScheduler (1, 0.1, 0.01 of it
from update 5000 and 15000). Its PredictionOutputsProcessor logs each
batch of predictions.
"""

import logging

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.api.callbacks import LearningRateScheduler
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
from elasticdl_tpu_torch.worker.prediction_outputs_processor import (
    BasePredictionOutputsProcessor,
)

logger = logging.getLogger(__name__)

STAGES = ((32, 0.2), (64, 0.3), (128, 0.4))  # (channels, dropout rate)


class Cifar10Model(nn.Module):
    def __init__(self, device="cuda", seed=0):
        super().__init__()
        device = resolve_device(device)
        gen = flax_generator(device, seed)
        c_in = 3
        for stage, (ch, rate) in enumerate(STAGES):
            for i in (2 * stage, 2 * stage + 1):
                self.add_module("Conv_%d" % i, Conv(
                    c_in, ch, 3, padding="SAME", device=device,
                    generator=gen))
                self.add_module("BatchNorm_%d" % i, BatchNorm(
                    ch, momentum=0.9, epsilon=1e-6, device=device))
                c_in = ch
            self.add_module("Dropout_%d" % stage, Dropout(rate))
        self.output = Dense(4 * 4 * 128, 10, device=device, generator=gen)

    def forward(self, features, training=False):
        x = features["image"].to(torch.float32)
        x = nhwc_to_nchw(x.reshape(x.shape[0], 32, 32, 3))
        for stage in range(len(STAGES)):
            for i in (2 * stage, 2 * stage + 1):
                x = getattr(self, "Conv_%d" % i)(x)
                x = torch.relu(getattr(self, "BatchNorm_%d" % i)(x, training))
            x = max_pool(x, (2, 2), strides=(2, 2))
            x = getattr(self, "Dropout_%d" % stage)(x, training)
        return self.output(flatten_nhwc(x))


def custom_model(device="cuda", seed=0):
    return Cifar10Model(device=device, seed=seed)


def loss(labels, predictions):
    return image_spec.mean_cross_entropy(labels, predictions)


def optimizer(lr=0.1):
    return sgd(lr)


def lr_multiplier(model_version):
    """The reference's absolute schedule (0.1, 0.01, 0.001 from update
    5000 and 15000) as multipliers of the base lr 0.1."""
    if model_version < 5000:
        return 1.0
    return 0.1 if model_version < 15000 else 0.01


def callbacks():
    return [LearningRateScheduler(lr_multiplier)]


flax_param_path = zoo_flax_param_path
dataset_fn = image_spec.image_dataset_fn()
eval_metrics_fn = image_spec.eval_metrics_fn


def feature_shapes():
    return {"image": (32, 32, 3)}


class PredictionOutputsProcessor(BasePredictionOutputsProcessor):
    """Logs prediction batches (the reference writes them to a
    MaxCompute table when ODPS is configured,
    cifar10_functional_api.py:178-202; the ODPS sink is not ported)."""

    def process(self, predictions, worker_id):
        logger.info("worker %d predictions: %s", worker_id,
                    np.asarray(predictions))
