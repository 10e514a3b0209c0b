"""Training callbacks: the port's copy of elasticdl_tpu/api/callbacks.py.

* `SavedModelExporter(export_dir)` writes the export artifact
  (api/exporter.py) of the worker's state when the worker runs the
  TRAIN_END_CALLBACK task; with `merge_lora=True` a LoRA model's
  adapters are folded into its kernels first (api/finetune.merge_lora),
  so the artifact is the plain dense model a `lora_rank=0` model loads;
  a host-tier model's artifact carries its host tables' rows;
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


class SavedModelExporter(Callback):
    """Exports the trained model at train end (the worker calls
    `on_train_end` on the TRAIN_END_CALLBACK task)."""

    def __init__(self, export_dir, merge_lora=False):
        self.export_dir = export_dir
        self.merge_lora = bool(merge_lora)

    def on_train_end(self, worker):
        from elasticdl_tpu_torch.api.exporter import export_model, flax_tree
        from elasticdl_tpu_torch.api.finetune import merge_lora
        from elasticdl_tpu_torch.training.trainer import TrainState

        if worker.state is None:
            logger.warning("No trained state to export")
            return
        state = worker.state
        model = worker.trainer.model
        if self.merge_lora and getattr(model, "lora_rank", 0):
            merged = merge_lora(flax_tree(model, state.params),
                                model=model)
            state = TrainState(state.step, merged, None)
        path = export_model(model, state, self.export_dir,
                            host_manager=worker.trainer.host_manager)
        logger.info("Exported trained model to %s", path)


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
