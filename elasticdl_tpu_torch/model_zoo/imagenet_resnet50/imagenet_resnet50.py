"""ImageNet ResNet-50 zoo entry: the PyTorch twin of
model_zoo/imagenet_resnet50/imagenet_resnet50.py (the reference's
imagenet_resnet50.py: ResNet-50 over 224 x 224 x 3 images, 1000
classes), and the zoo spec around it.

The JAX module casts the image to bfloat16, but its convs hold fp32
parameters, and flax's Conv promotes a bf16 input to them: the pixels
are rounded to bf16 and every layer computes in fp32. The port does the
same. Convs in bf16 or channels-last would be a speed change of their
own. Optimizer: add_decayed_weights(1e-4) then sgd(0.1, momentum=0.9).
"""

import torch
from torch import nn

from elasticdl_tpu_torch.convert import zoo_flax_param_path
from elasticdl_tpu_torch.model_zoo import image_spec
from elasticdl_tpu_torch.model_zoo.flax_layers import flax_generator
from elasticdl_tpu_torch.model_zoo.resnet50_subclass.resnet50_model import (
    L2_WEIGHT_DECAY,
    ResNet50,
)
from elasticdl_tpu_torch.ops.dispatch import resolve_device
from elasticdl_tpu_torch.training.optimizers import sgd


class ImagenetModel(nn.Module):
    def __init__(self, num_classes=1000, device="cuda", seed=0):
        super().__init__()
        device = resolve_device(device)
        self.resnet50 = ResNet50(num_classes, device=device,
                                 generator=flax_generator(device, seed))

    def forward(self, features, training=False):
        x = features["image"].to(torch.bfloat16).to(torch.float32)
        return self.resnet50(x, training).to(torch.float32)


def custom_model(device="cuda", seed=0):
    return ImagenetModel(device=device, seed=seed)


def loss(labels, predictions):
    return image_spec.mean_cross_entropy(labels, predictions)


def optimizer(lr=0.1):
    return sgd(lr, momentum=0.9, weight_decay=L2_WEIGHT_DECAY)


flax_param_path = zoo_flax_param_path
dataset_fn = image_spec.image_dataset_fn(255.0)
eval_metrics_fn = image_spec.eval_metrics_fn


def feature_shapes():
    return {"image": (224, 224, 3)}
