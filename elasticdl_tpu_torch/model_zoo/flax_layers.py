"""flax's `nn.Dense` and `nn.Embed` for the port's tabular and CTR zoo,
named and initialised as flax's, so a model's state_dict keys are its
flax param paths with "." for "/" (`Dense_0.weight` is `Dense_0/kernel`
transposed, `thal_embedding.embedding` is `thal_embedding/embedding`;
convert.zoo_params_from_flax carries weights over).

* `Dense`: a torch Linear; the kernel lecun-normal (a normal cut at two
  standard deviations, rescaled to variance 1/fan_in), the bias zero;
* `Embed`: a [num_embeddings, features] table `embedding`, normal with
  variance 1/features; a lookup is F.embedding, as plain as torch's
  nn.Embedding: flax's nn.Embed launches no TPU kernel either.

Both draw from the torch.Generator they are given, on the layer's
device, in the order a model builds them.
"""

import torch
import torch.nn.functional as F
from torch import nn

# stddev of a unit normal cut at +-2, which flax's lecun_normal divides by
_TRUNC_STD = 0.87962566103423978


class Dense(nn.Linear):
    """flax nn.Dense(n_out, use_bias) over n_in inputs."""

    def __init__(self, n_in, n_out, use_bias=True, device=None,
                 generator=None):
        super().__init__(n_in, n_out, bias=use_bias, device=device)
        with torch.no_grad():
            std = (1.0 / n_in) ** 0.5 / _TRUNC_STD
            nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if use_bias:
                self.bias.zero_()


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
