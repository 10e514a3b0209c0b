"""Optimizer factories for port zoo specs: the optax transforms the JAX
package's zoo returns, as torch.optim constructors.

A zoo's `optimizer()` returns a factory: calling it on the trainable
parameters builds the torch optimizer (the Trainer decides which
parameters train). One parameter group, so weight decay reaches every
trainable tensor, biases and LayerNorm included, as optax's adamw decays
every leaf.

Each factory also carries `row_rule`: the update the sparse-row tier
applies to tapped embedding tables with the same hyperparameters
(embedding/sparse_update.py `RowRule`), or None with `row_rule_missing`
saying why the row kernel has no exact counterpart of the transform.
"""

import torch

from elasticdl_tpu_torch.embedding.sparse_update import RowRule


class OptimizerFactory(object):
    """`factory(params)` -> `cls(params, **kwargs)`."""

    def __init__(self, cls, row_rule=None, row_rule_missing=None, **kwargs):
        self.cls = cls
        self.kwargs = kwargs
        self.row_rule = row_rule
        self.row_rule_missing = row_rule_missing

    def __call__(self, params):
        return self.cls(params, **self.kwargs)


def sgd(learning_rate, momentum=None, nesterov=False, weight_decay=0.0):
    """optax.sgd(learning_rate, momentum, nesterov) as torch.optim.SGD.
    optax's momentum is `trace` (v = mu v + g, the step v, or g + mu v
    with Nesterov), which is torch's momentum with dampening 0. Row rule
    "sgd", or "momentum" with a momentum.

    `weight_decay` stands for optax.chain(add_decayed_weights(wd),
    sgd(...)): torch's SGD adds wd * p to the gradient before the trace,
    which is that chain's first element. No row rule then: the row
    kernel has no decay term, so tapped tables would lose the decay of
    their touched rows."""
    if weight_decay:
        return OptimizerFactory(
            torch.optim.SGD, row_rule_missing=(
                "sgd with weight_decay (optax.add_decayed_weights) decays "
                "the touched rows of a table; the row-update kernel's "
                "rules have no decay term"),
            lr=learning_rate, momentum=momentum or 0.0,
            nesterov=bool(nesterov and momentum),
            weight_decay=float(weight_decay))
    rule = RowRule("momentum" if momentum else "sgd", learning_rate,
                   momentum=momentum, nesterov=nesterov)
    return OptimizerFactory(torch.optim.SGD, row_rule=rule, lr=learning_rate,
                            momentum=momentum or 0.0,
                            nesterov=bool(nesterov and momentum))


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8):
    """optax.adam as torch.optim.Adam (the same bias correction, eps
    outside the root); row rule "adam" with the eps the row kernel
    needs at each step (see RowRule.update)."""
    rule = RowRule("adam", learning_rate, b1=b1, b2=b2, eps=eps)
    return OptimizerFactory(torch.optim.Adam, row_rule=rule, lr=learning_rate,
                            betas=(b1, b2), eps=eps)


def adamw(learning_rate, weight_decay=1e-4, b1=0.9, b2=0.999, eps=1e-8):
    """optax.adamw(learning_rate, b1, b2, eps, weight_decay=...) as
    torch.optim.AdamW: the same decoupled decay scaled by the learning
    rate, the same bias correction; optax's defaults. No row rule: the
    row kernel's Adam has no decay term, so tapped tables would lose the
    decay optax applies to their touched rows."""
    return OptimizerFactory(
        torch.optim.AdamW, row_rule_missing=(
            "adamw decays the touched rows of a table; the row-update "
            "kernel's Adam rule has no decay term"),
        lr=learning_rate, betas=(b1, b2), eps=eps, weight_decay=weight_decay)
