"""Training callbacks: the port's copy of elasticdl_tpu/api/callbacks.py
without `SavedModelExporter` (it waits for the port's exporter).

* `CallbackList` holds the callbacks the TaskDispatcher calls on each
  completed task (`on_task_end`);
* `MaxStepsStopping(max_steps, minibatch_size)` counts the steps of
  completed training tasks (ceil(records / minibatch) each) and sets
  the dispatcher's `stop_training` at `max_steps`; on resume,
  `set_completed_steps` seeds the count with the restored model version,
  so max_steps counts the job's steps, not those since the restart;
* `LearningRateScheduler(multiplier_fn)` maps the count of applied
  optimizer updates (from 0) to a multiplier on the optimizer's base
  learning rate, as the JAX package's `optax.scale_by_schedule` does;
  the multiplier scales the whole AdamW update, the decoupled weight
  decay included. The Trainer sets each parameter group's lr to base x
  multiplier before `step()`.
"""

import logging

from elasticdl_tpu_torch.master.task_dispatcher import TaskType

logger = logging.getLogger(__name__)


class Callback(object):
    """Minimal callback interface; hooks are discovered by name."""


class CallbackList(object):
    def __init__(self, callbacks=None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)


class MaxStepsStopping(Callback):
    """Stops the job once `max_steps` steps of training tasks are done."""

    def __init__(self, max_steps, minibatch_size=32):
        self.max_steps = int(max_steps)
        self.minibatch_size = int(minibatch_size)
        self._completed_steps = 0
        self._dispatcher = None

    def set_task_dispatcher(self, dispatcher):
        self._dispatcher = dispatcher

    def set_completed_steps(self, steps):
        """Seed the counter on resume with the restored model version."""
        self._completed_steps = int(steps)

    def on_task_end(self, task):
        if task.type != TaskType.TRAINING:
            return
        records = task.end - task.start
        self._completed_steps += (
            records + self.minibatch_size - 1) // self.minibatch_size
        if (self._completed_steps >= self.max_steps
                and self._dispatcher is not None
                and not self._dispatcher.stop_training):
            logger.info("MaxStepsStopping: %d steps completed (max %d); "
                        "stopping", self._completed_steps, self.max_steps)
            self._dispatcher.stop_training = True


class LearningRateScheduler(Callback):
    def __init__(self, multiplier_fn):
        self.multiplier_fn = multiplier_fn
