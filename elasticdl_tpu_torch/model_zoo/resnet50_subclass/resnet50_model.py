"""ResNet-50 building blocks: the PyTorch twin of
model_zoo/resnet50_subclass/resnet50_model.py (the reference's
resnet50_model.py IdentityBlock / ConvBlock, BATCH_NORM_DECAY and
_EPSILON; its L2 weight decay sits in the optimizer, as in the JAX
package).

Blocks take and give NCHW activations; `ResNet50` takes NHWC images,
as the JAX module does. Names are flax's: a block's `Conv_0` ...
`Conv_2` (bias-free) and `BatchNorm_0` ... `BatchNorm_2`, a ConvBlock's
strided shortcut `Conv_3` / `BatchNorm_3` (its stride sits on the first
1 x 1 conv, as in the JAX block); the stack's `conv1` (7 x 7, stride 2,
padding 3), `BatchNorm_0`, a 3 x 3 max_pool of stride 2 and padding 1
(-inf, as flax pads it), `ConvBlock_i` / `IdentityBlock_j` in build
order over the stages [3, 4, 6, 3], a global mean and `fc1000`.
"""

import torch
from torch import nn

from elasticdl_tpu_torch.model_zoo.flax_layers import (
    BatchNorm,
    Conv,
    Dense,
    max_pool,
    nhwc_to_nchw,
)

L2_WEIGHT_DECAY = 1e-4
BATCH_NORM_DECAY = 0.9
BATCH_NORM_EPSILON = 1e-5
# (filters, identity blocks after the ConvBlock, ConvBlock strides)
STAGES = (((64, 64, 256), 2, (1, 1)), ((128, 128, 512), 3, (2, 2)),
          ((256, 256, 1024), 5, (2, 2)), ((512, 512, 2048), 2, (2, 2)))


def _bn(features, device):
    return BatchNorm(features, momentum=BATCH_NORM_DECAY,
                     epsilon=BATCH_NORM_EPSILON, device=device)


class _Block(nn.Module):
    """The three convs both blocks share: 1 x 1 (strided in a
    ConvBlock), k x k SAME, 1 x 1, each with its BatchNorm."""

    def __init__(self, in_channels, kernel_size, filters, strides, device,
                 generator):
        super().__init__()
        f1, f2, f3 = filters
        for i, (c_in, c_out, k, s) in enumerate((
                (in_channels, f1, 1, strides), (f1, f2, kernel_size, 1),
                (f2, f3, 1, 1))):
            self.add_module("Conv_%d" % i, Conv(
                c_in, c_out, k, strides=s, padding="SAME", use_bias=False,
                device=device, generator=generator))
            self.add_module("BatchNorm_%d" % i, _bn(c_out, device))

    def _residual(self, x, training):
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x), training))
        y = torch.relu(self.BatchNorm_1(self.Conv_1(y), training))
        return self.BatchNorm_2(self.Conv_2(y), training)


class IdentityBlock(_Block):
    """3-conv residual block whose shortcut is the identity (in_channels
    must equal filters[2])."""

    def __init__(self, in_channels, kernel_size, filters, device=None,
                 generator=None):
        super().__init__(in_channels, kernel_size, filters, 1, device,
                         generator)

    def forward(self, x, training=False):
        return torch.relu(self._residual(x, training) + x)


class ConvBlock(_Block):
    """3-conv residual block with a strided 1 x 1 conv shortcut."""

    def __init__(self, in_channels, kernel_size, filters, strides=(2, 2),
                 device=None, generator=None):
        super().__init__(in_channels, kernel_size, filters, strides, device,
                         generator)
        # built after the residual path, as flax names it: Conv_3
        self.Conv_3 = Conv(in_channels, filters[2], 1, strides=strides,
                           padding="SAME", use_bias=False, device=device,
                           generator=generator)
        self.BatchNorm_3 = _bn(filters[2], device)

    def forward(self, x, training=False):
        shortcut = self.BatchNorm_3(self.Conv_3(x), training)
        return torch.relu(self._residual(x, training) + shortcut)


class ResNet50(nn.Module):
    """The full ResNet-50 stack over NHWC images of 3 channels."""

    def __init__(self, num_classes=10, device=None, generator=None):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, strides=2, padding=[(3, 3), (3, 3)],
                          use_bias=False, device=device, generator=generator)
        self.BatchNorm_0 = _bn(64, device)
        self.blocks = []
        c_in, n_conv, n_identity = 64, 0, 0
        for filters, identities, strides in STAGES:
            name = "ConvBlock_%d" % n_conv
            self.add_module(name, ConvBlock(c_in, 3, filters, strides,
                                            device, generator))
            self.blocks.append(name)
            n_conv += 1
            c_in = filters[2]
            for _ in range(identities):
                name = "IdentityBlock_%d" % n_identity
                self.add_module(name, IdentityBlock(c_in, 3, filters,
                                                    device, generator))
                self.blocks.append(name)
                n_identity += 1
        self.fc1000 = Dense(c_in, num_classes, device=device,
                            generator=generator)

    def forward(self, x, training=False):
        x = nhwc_to_nchw(x.to(torch.float32))
        x = torch.relu(self.BatchNorm_0(self.conv1(x), training))
        x = max_pool(x, (3, 3), strides=(2, 2), padding=[(1, 1), (1, 1)])
        for name in self.blocks:
            x = getattr(self, name)(x, training)
        return self.fc1000(x.mean(dim=(2, 3)))
