"""Vision Transformer for image classification: the PyTorch twin of
model_zoo/vit/vit.py, and the zoo spec around it.

Patches are cut by a reshape and a transpose in flax's NHWC order
([b, n, p, n, p, c] -> [b, n * n, p * p * c], a row a patch), not by a
conv; then `patch_embed` (Dense), `wpe` over the n * n patches, a
`Dropout` (flax_layers': masks from the step's generator, never
jax.random's), the port's transformer `Block`s with `causal=False`
under the flax names `layer_%d` (kernels A, C and D on the card without
the causal mask; head_dim 64 at ViT-Base), `ln_f`, a mean over the
patches (no CLS token) and the `head`, the logits cast to fp32. The
image is cast to the compute dtype (`dtype`) before the patch
embedding; norms run in fp32 and parameters stay fp32, as in
transformer_lm. The geometry checks keep flax's ValueErrors; under a
mesh with any axis above 1 it raises (its sequence is made inside the
model from image rows, and its mean-pool would need a sum over sp;
ROADMAP Queue 1 item 7). adamw with weight decay 0.05.
"""

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.common.constants import MeshAxis
from elasticdl_tpu_torch.convert import zoo_flax_param_path
from elasticdl_tpu_torch.model_zoo import image_spec
from elasticdl_tpu_torch.model_zoo.flax_layers import (
    Dense,
    Dropout,
    Embed,
    LayerNorm,
    flax_generator,
    init_flax_,
)
from elasticdl_tpu_torch.model_zoo.transformer_lm import (
    _linear,
    check_attn_impl,
    encoder_blocks,
    refuse_mesh,
    resolve_dtype,
)
from elasticdl_tpu_torch.ops.dispatch import resolve_device
from elasticdl_tpu_torch.training.optimizers import adamw


class ViT(nn.Module):
    def __init__(self, image_size=32, channels=3, patch_size=4,
                 num_classes=10, embed_dim=128, num_heads=4, num_layers=4,
                 dtype=None, attn_impl="auto", tp_shard=True, lora_rank=0,
                 lora_alpha=16.0, dropout=0.1, device="cuda", seed=0):
        super().__init__()
        if image_size % patch_size:
            raise ValueError("image_size %d not divisible by patch_size %d"
                             % (image_size, patch_size))
        if embed_dim % num_heads:
            raise ValueError("embed_dim %d not divisible by num_heads %d"
                             % (embed_dim, num_heads))
        check_attn_impl(attn_impl)
        device = resolve_device(device)
        gen = flax_generator(device, seed)
        self.image_size, self.channels = int(image_size), int(channels)
        self.patch_size = int(patch_size)
        self.dtype = dtype or torch.float32
        self.attn_impl = attn_impl
        self.tp_shard = bool(tp_shard)
        n = self.image_size // self.patch_size
        p, c = self.patch_size, self.channels
        self.patch_embed = Dense(p * p * c, embed_dim, device=device,
                                 generator=gen)
        self.wpe = Embed(n * n, embed_dim, device=device, generator=gen)
        self.Dropout_0 = Dropout(dropout)
        self.blocks = encoder_blocks(
            self, embed_dim, num_heads, num_layers, lora_rank=lora_rank,
            lora_alpha=lora_alpha, attn_impl=attn_impl, device=device)
        for blk in self.blocks:
            init_flax_(blk, gen)
        self.ln_f = LayerNorm(embed_dim, device=device)
        self.head = Dense(embed_dim, num_classes, device=device,
                          generator=gen)

    @property
    def device(self):
        return self.wpe.embedding.device

    def forward(self, features, training=False):
        """features {"image": [b, s, s, c] or [b, s * s * c]} -> fp32
        logits [b, num_classes]."""
        refuse_mesh("vit", MeshAxis.ALL)
        x = torch.as_tensor(features["image"], device=self.device)
        b = x.shape[0]
        s, p, c = self.image_size, self.patch_size, self.channels
        n = s // p
        # [b, n, p, n, p, c] -> [b, n * n, p * p * c]: a row a patch
        x = x.reshape(b, n, p, n, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, n * n, p * p * c).to(self.dtype)
        x = _linear(self.patch_embed, x)
        x = x + self.wpe.embedding.to(self.dtype)[None]
        x = self.Dropout_0(x, training)
        positions = torch.arange(n * n, device=self.device)
        for blk in self.blocks:
            x, _rows = blk(x, positions)
        x = self.ln_f(x).mean(dim=1)  # mean over the patches (no CLS)
        return _linear(self.head, x).float()


def custom_model(**kwargs):
    return ViT(**resolve_dtype(kwargs, "vit"))


def loss(labels, predictions, sample_weights=None):
    labels = torch.as_tensor(labels, device=predictions.device)
    per = image_spec.softmax_cross_entropy(predictions, labels)
    if sample_weights is not None:
        w = torch.as_tensor(sample_weights, device=predictions.device,
                            dtype=per.dtype).reshape(-1)
        return (per * w).sum() / w.sum().clamp(min=1e-8)
    return per.mean()


def optimizer(lr=3e-4):
    return adamw(lr, weight_decay=0.05)


flax_param_path = zoo_flax_param_path
dataset_fn = image_spec.image_dataset_fn()
eval_metrics_fn = image_spec.eval_metrics_fn


def feature_shapes():
    return {"image": (32, 32, 3)}
