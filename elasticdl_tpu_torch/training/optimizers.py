"""Optimizer factories for port zoo specs: the optax transforms the JAX
package's zoo returns, as torch.optim constructors.

A zoo's `optimizer()` returns a factory `params -> torch.optim.Optimizer`
(the Trainer decides which parameters train). One parameter group, so
weight decay reaches every trainable tensor, biases and LayerNorm
included, as optax's adamw decays every leaf.
"""

import functools

import torch


def adamw(learning_rate, weight_decay=1e-4, b1=0.9, b2=0.999, eps=1e-8):
    """optax.adamw(learning_rate, b1, b2, eps, weight_decay=...) as
    torch.optim.AdamW: the same decoupled decay scaled by the learning
    rate, the same bias correction; optax's defaults."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate,
                             betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)
