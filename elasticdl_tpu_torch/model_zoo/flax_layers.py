"""flax's layers for the port's zoo (`nn.Dense`, `nn.Embed`, `nn.Conv`,
`nn.BatchNorm`, `nn.LayerNorm`, `nn.Dropout`, `nn.max_pool`), named and
initialised as flax's, so a model's state_dict keys are its flax paths
with "." for "/" (`Dense_0.weight` is `Dense_0/kernel` transposed,
`Conv_0.weight` `Conv_0/kernel` permuted, `BatchNorm_0.mean` is
`batch_stats/BatchNorm_0/mean`; convert.zoo_params_from_flax carries
weights over).

* `Dense`: a torch Linear; the kernel lecun-normal (a normal cut at two
  standard deviations, rescaled to variance 1/fan_in), the bias zero;
* `Embed`: a [num_embeddings, features] table `embedding`, normal with
  variance 1/features; a lookup is F.embedding, as plain as torch's
  nn.Embedding: flax's nn.Embed launches no TPU kernel either;
* `Conv`: NCHW activations and a [out, in, kh, kw] `weight` for
  F.conv2d (flax's kernel is [kh, kw, in, out], NHWC), lecun-normal over
  fan_in = kh * kw * in; "SAME" pads as XLA does (the low side gets the
  smaller half), "VALID" not at all, or explicit [(lo, hi), (lo, hi)];
* `BatchNorm`: flax's semantics, not torch's nn.BatchNorm2d's. `scale`
  and `bias` are parameters, the running `mean` and `var` buffers (the
  flax `batch_stats` collection, `model_state_buffers`). In training it
  normalises with the batch's mean and biased variance (flax's
  E[x^2] - E[x]^2, clipped at 0) and sets ra = m * ra + (1 - m) *
  batch stat with that same variance; in evaluation it reads the
  running averages. `momentum` and `epsilon` are flax's (0.99 is torch's
  momentum 0.01);
* `LayerNorm`: flax's nn.LayerNorm(dtype) with `scale` and `bias`,
  epsilon 1e-6, the statistics and the affine in fp32 and the result in
  the input's dtype (as the transformer Block's norms run,
  model_zoo/transformer_lm.py);
* `init_flax_`: flax's initialisers over a torch module of nn.Linear
  and nn.LayerNorm layers (the transformer Block inside the bert and vit
  encoders): lecun-normal kernels, unit scales, zero biases, LoRA A
  lecun-normal and B zero;
* `Dropout`: keeps with probability 1 - rate and scales by 1 / (1 -
  rate); in training its mask comes from the generator `dropout_rng`
  opens for one step (the Trainer's, seeded from (seed, step) by
  `dropout_generator`). A training call outside it raises: no mask is
  drawn from torch's global generator. Masks are torch's, never
  `jax.random`'s bits;
* `max_pool`: flax's nn.max_pool over NCHW, padding with -inf.

Conv, BatchNorm, pooling and the dense layers launch none of the port's
kernels: they are XLA ops in the JAX package and aten (cuDNN, cuBLAS)
calls here. Parameters are drawn from the torch.Generator given, on the
layer's device, in the order a model builds them.
"""

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

# stddev of a unit normal cut at +-2, which flax's lecun_normal divides by
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight, fan_in, generator=None):
    """flax's lecun_normal in place: a normal cut at two standard
    deviations, rescaled to variance 1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)


class Dense(nn.Linear):
    """flax nn.Dense(n_out, use_bias) over n_in inputs."""

    def __init__(self, n_in, n_out, use_bias=True, device=None,
                 generator=None):
        super().__init__(n_in, n_out, bias=use_bias, device=device)
        lecun_normal_(self.weight, n_in, generator)
        if use_bias:
            with torch.no_grad():
                self.bias.zero_()


class LayerNorm(nn.Module):
    """flax nn.LayerNorm(dtype): see the module docstring."""

    def __init__(self, features, epsilon=1e-6, device=None):
        super().__init__()
        self.epsilon = float(epsilon)
        self.scale = nn.Parameter(torch.ones(int(features), device=device))
        self.bias = nn.Parameter(torch.zeros(int(features), device=device))

    def forward(self, x):
        return F.layer_norm(x.float(), self.scale.shape, self.scale.float(),
                            self.bias.float(), self.epsilon).to(x.dtype)


@torch.no_grad()
def init_flax_(module, generator=None):
    """flax's initialisers over every parameter of `module`, in its
    registration order: a 2-D `weight` (a torch Linear's [out, in])
    lecun-normal over its second axis, a 1-D `weight` (a LayerNorm's
    scale) ones, a `bias` and a LoRA `*_lora_b` zeros, a LoRA
    `*_lora_a` ([in, r]) lecun-normal over its first axis."""
    for name, p in module.named_parameters():
        leaf = name.rpartition(".")[2]
        if leaf.endswith("_lora_a"):
            lecun_normal_(p, p.shape[0], generator)
        elif leaf == "weight" and p.dim() == 2:
            lecun_normal_(p, p.shape[1], generator)
        elif leaf == "weight" and p.dim() == 1:
            p.fill_(1.0)
        elif leaf == "bias" or leaf.endswith("_lora_b"):
            p.zero_()
        else:
            raise ValueError("init_flax_: no flax initialiser for %r" % name)


class Embed(nn.Module):
    """flax nn.Embed(num_embeddings, features): ids of any shape ->
    ids.shape + (features,)."""

    def __init__(self, num_embeddings, features, device=None,
                 generator=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(
            (int(num_embeddings), int(features)), device=device))
        with torch.no_grad():
            self.embedding.normal_(0.0, features ** -0.5,
                                   generator=generator)

    def forward(self, ids):
        return F.embedding(ids.long(), self.embedding)


def flax_generator(device, seed):
    """The one generator a zoo model draws its parameters from."""
    return torch.Generator(device=device).manual_seed(int(seed))


def binary_cross_entropy_on_probs(labels, probs):
    """-mean(y log p + (1 - y) log(1 - p)) with p clipped to [1e-7,
    1 - 1e-7], the loss the tabular zoo writes out over sigmoid outputs;
    `labels` and `probs` of one shape."""
    p = probs.clamp(1e-7, 1 - 1e-7)
    labels = labels.to(p.dtype)
    return -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p)
             ).mean()


def _pairs(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (int(v), int(v))


def _pads(padding, sizes, kernel, strides):
    """[(lo, hi)] per spatial dim: flax's "SAME" (XLA's: out = ceil(n /
    s), the total pad split with the smaller half low), "VALID", or
    explicit pairs."""
    if isinstance(padding, str):
        if padding == "VALID":
            return [(0, 0)] * len(sizes)
        if padding != "SAME":
            raise ValueError("padding %r: SAME, VALID or [(lo, hi), ...]"
                             % padding)
        out = []
        for n, k, s in zip(sizes, kernel, strides):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            out.append((total // 2, total - total // 2))
        return out
    return [_pairs(p) for p in padding]


def _flat_pad(pads):
    """F.pad's argument (last dim first) of [(lo, hi)] over H, W."""
    return [x for lo_hi in reversed(pads) for x in lo_hi]


class Conv(nn.Module):
    """flax nn.Conv(features, kernel_size, strides, padding, use_bias)
    over NCHW inputs of `in_features` channels."""

    def __init__(self, in_features, features, kernel_size, strides=1,
                 padding="SAME", use_bias=True, device=None,
                 generator=None):
        super().__init__()
        self.kernel_size = _pairs(kernel_size)
        self.strides = _pairs(strides)
        self.padding = padding
        kh, kw = self.kernel_size
        self.weight = nn.Parameter(torch.empty(
            (int(features), int(in_features), kh, kw), device=device))
        self.bias = (nn.Parameter(torch.zeros(int(features), device=device))
                     if use_bias else None)
        lecun_normal_(self.weight, kh * kw * in_features, generator)

    def forward(self, x):
        pads = _pads(self.padding, x.shape[2:], self.kernel_size,
                     self.strides)
        if all(lo == hi for lo, hi in pads):
            return F.conv2d(x, self.weight, self.bias, self.strides,
                            [lo for lo, _hi in pads])
        return F.conv2d(F.pad(x, _flat_pad(pads)), self.weight, self.bias,
                        self.strides)


class BatchNorm(nn.Module):
    """flax nn.BatchNorm(momentum, epsilon) over the channel axis (1) of
    an NCHW or [n, features] input; see the module docstring."""

    def __init__(self, features, momentum=0.99, epsilon=1e-5, device=None):
        super().__init__()
        self.momentum = float(momentum)
        self.epsilon = float(epsilon)
        self.scale = nn.Parameter(torch.ones(int(features), device=device))
        self.bias = nn.Parameter(torch.zeros(int(features), device=device))
        self.register_buffer("mean", torch.zeros(int(features),
                                                 device=device))
        self.register_buffer("var", torch.ones(int(features), device=device))

    def forward(self, x, training=False):
        shape = [1, -1] + [1] * (x.dim() - 2)
        x = x.to(torch.float32)
        if training:
            axes = [0] + list(range(2, x.dim()))
            mean = x.mean(axes)
            var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)
            m = self.momentum
            with torch.no_grad():
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return (x - mean.reshape(shape)) * mul.reshape(shape) + (
            self.bias.reshape(shape))


class Dropout(nn.Module):
    """flax nn.Dropout(rate); see the module docstring."""

    def __init__(self, rate):
        super().__init__()
        self.rate = float(rate)
        self._generator = None

    def forward(self, x, training=False):
        if not training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        if self._generator is None:
            raise RuntimeError(
                "Dropout in training needs the step's generator "
                "(flax_layers.dropout_rng); none is open")
        keep = 1.0 - self.rate
        draw = torch.rand(x.shape, generator=self._generator,
                          device=x.device)
        return torch.where(draw < keep, x / keep, torch.zeros_like(x))


@contextlib.contextmanager
def dropout_rng(model, generator):
    """Give every Dropout of `model` `generator` for one forward (the
    Trainer opens one a step); a model without Dropout is untouched."""
    layers = [m for m in model.modules() if isinstance(m, Dropout)]
    for layer in layers:
        layer._generator = generator
    try:
        yield
    finally:
        for layer in layers:
            layer._generator = None


def dropout_generator(seed, step, device):
    """The generator the masks of step `step` of a model seeded `seed`
    draw from, on `device`: a function of (seed, step) only, mixed by
    splitmix64, as the JAX Trainer folds its key with the step."""
    mask = (1 << 64) - 1
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(step)) & mask
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & mask
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & mask
    x ^= x >> 31
    return torch.Generator(device=device).manual_seed(x & ((1 << 63) - 1))


def max_pool(x, window_shape, strides=None, padding="VALID"):
    """flax nn.max_pool over NCHW: windows of `window_shape`, `strides`
    (default 1), padding "VALID", "SAME" or [(lo, hi), (lo, hi)] with
    -inf."""
    window = _pairs(window_shape)
    strides = _pairs(strides) if strides is not None else (1, 1)
    pads = _pads(padding, x.shape[2:], window, strides)
    if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, window)):
        return F.max_pool2d(x, window, strides, [lo for lo, _hi in pads])
    x = F.pad(x, _flat_pad(pads), value=float("-inf"))
    return F.max_pool2d(x, window, strides)


def model_state_buffers(model):
    """{state_dict key: buffer} of `model`'s BatchNorm running averages:
    what flax keeps in the `batch_stats` collection."""
    return {("%s.%s" % (name, leaf)) if name else leaf: getattr(mod, leaf)
            for name, mod in model.named_modules()
            if isinstance(mod, BatchNorm) for leaf in ("mean", "var")}


def nhwc_to_nchw(x):
    return x.permute(0, 3, 1, 2)


def flatten_nhwc(x):
    """An NCHW activation flattened in flax's NHWC order, so a Dense
    kernel's rows map one to one."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
