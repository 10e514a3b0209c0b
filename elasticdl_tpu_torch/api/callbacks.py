"""Training callbacks: the port's copy of the part of
elasticdl_tpu/api/callbacks.py the local training path uses.

`LearningRateScheduler(multiplier_fn)` maps the count of applied
optimizer updates (from 0) to a multiplier on the optimizer's base
learning rate, as the JAX package's `optax.scale_by_schedule` does; the
multiplier scales the whole AdamW update, the decoupled weight decay
included. The Trainer sets each parameter group's lr to base x
multiplier before `step()`.
"""


class Callback(object):
    """Minimal callback interface; hooks are discovered by name."""


class LearningRateScheduler(Callback):
    def __init__(self, multiplier_fn):
        self.multiplier_fn = multiplier_fn
