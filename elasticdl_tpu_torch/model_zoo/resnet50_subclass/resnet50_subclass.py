"""ResNet-50 zoo entry: the PyTorch twin of
model_zoo/resnet50_subclass/resnet50_subclass.py (the reference's
resnet50_subclass.py: CustomModel over CIFAR-size images, 10 classes,
momentum SGD), and the zoo spec around it.

The stack sits under `resnet50`; images are divided by 255; the
optimizer is optax.chain(add_decayed_weights(1e-4), sgd(0.02,
momentum=0.9)), torch's SGD with that weight_decay (its checkpoint
leaves `.opt_state[1][0].trace[...]`).
"""

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


class CustomModel(nn.Module):
    def __init__(self, num_classes=10, device="cuda", seed=0):
        super().__init__()
        device = resolve_device(device)
        self.resnet50 = ResNet50(num_classes, device=device,
                                 generator=flax_generator(device, seed))

    def forward(self, features, training=False):
        return self.resnet50(features["image"], training)


def custom_model(device="cuda", seed=0):
    return CustomModel(num_classes=10, device=device, seed=seed)


def loss(labels, predictions):
    return image_spec.mean_cross_entropy(labels, predictions)


def optimizer(lr=0.02):
    return sgd(lr, momentum=0.9, weight_decay=L2_WEIGHT_DECAY)


flax_param_path = zoo_flax_param_path
dataset_fn = image_spec.image_dataset_fn(255.0)
eval_metrics_fn = image_spec.eval_metrics_fn


def feature_shapes():
    return {"image": (32, 32, 3)}
