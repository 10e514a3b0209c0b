"""LocalExecutor: single-process train / evaluate / predict over a port
zoo spec, the counterpart of elasticdl_tpu/api/local_executor.py.

It drives the same in-memory TaskDispatcher the master uses (tasks stay
the unit of work) and the port's Trainer on one device, or on this rank
of an sp mesh (`mesh`, as the JAX executor passes its mesh to the
Trainer; every rank runs its own executor over the same data).

Crash recovery, as in the JAX executor:

* `checkpoint_dir` + `checkpoint_steps` save the TrainState every N
  steps (checkpoint/saver.py, the JAX package's format and names),
  keeping `keep_checkpoint_max` versions; `checkpoint_dir_for_init`
  restores the latest valid version into the fresh state before the
  first step;
* `job_state_dir` journals the dispatcher's task lifecycle
  (master/state_store.py), so a killed run resumes where it died and
  retrains no completed range;
* `fault_injector` (or EDL_FAULT_SPEC) intercepts the dispatch boundary
  (`local_get_task`, `local_report`) for drills.

A spec that declares `host_embeddings()` trains its tables in the
host-spill tier (embedding/host_bridge.py `attach_from_spec`, native
stores): every checkpoint carries the engines' state beside the
TrainState, and a restore reads both from one version.

Checkpoints under an sp mesh are not ported (every rank is a process of
its own; writing from many ranks comes with the rest of the parallel
port) and raise.
"""

import logging

import numpy as np

from elasticdl_tpu_torch.checkpoint.saver import CheckpointSaver
from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.common.fault_injection import FaultInjector
from elasticdl_tpu_torch.data.dataset import Dataset, pad_batch
from elasticdl_tpu_torch.data.reader.recordio_reader import (
    RecordIODataReader,
)
from elasticdl_tpu_torch.embedding.host_bridge import (
    attach_from_spec,
    restore_with_host_state,
)
from elasticdl_tpu_torch.master.state_store import JobStateStore
from elasticdl_tpu_torch.master.task_dispatcher import (
    Task,
    TaskDispatcher,
    TaskType,
)
from elasticdl_tpu_torch.training.metrics import MetricsAggregator
from elasticdl_tpu_torch.training.trainer import Trainer
from elasticdl_tpu_torch.worker.prediction_outputs_processor import (
    invoke_processor,
)

logger = logging.getLogger(__name__)


class LocalExecutor(object):
    def __init__(self, model_spec, training_data=None, validation_data=None,
                 prediction_data=None, minibatch_size=32, num_epochs=1,
                 records_per_task=256, evaluation_steps=0, model_params="",
                 seed=0, max_steps=None, checkpoint_dir=None,
                 checkpoint_steps=0, keep_checkpoint_max=0,
                 checkpoint_dir_for_init=None, grad_accum_steps=1,
                 trainable_pattern=None, job_state_dir=None,
                 fault_injector=None, device="cuda", mesh=None):
        if mesh is not None and (checkpoint_dir or checkpoint_dir_for_init):
            raise NotImplementedError(
                "LocalExecutor: checkpoints under an sp mesh are not "
                "ported (each rank is a process of its own)")
        self.spec = model_spec
        self.minibatch_size = minibatch_size
        self.num_epochs = num_epochs
        self.records_per_task = records_per_task
        self.evaluation_steps = evaluation_steps
        self.max_steps = max_steps
        self.training_data = training_data
        self.validation_data = validation_data
        self.prediction_data = prediction_data
        self.trainer = Trainer(
            model_spec, mesh=mesh, model_params=model_params, seed=seed,
            grad_accum_steps=grad_accum_steps,
            trainable_pattern=trainable_pattern, device=device,
        )
        self.host_manager = attach_from_spec(self.trainer, model_spec)
        self.state = None
        self.losses = []
        self._job_state_dir = job_state_dir
        self._fault_injector = fault_injector or FaultInjector.from_env()
        self._checkpoint_dir_for_init = checkpoint_dir_for_init
        self.restored_version = None
        self.checkpoint_saver = None
        if checkpoint_dir and checkpoint_steps:
            self.checkpoint_saver = CheckpointSaver(
                self.trainer, checkpoint_dir,
                checkpoint_steps=checkpoint_steps,
                keep_max_version=keep_checkpoint_max,
                extra_state_fn=(self.host_manager.flat_state
                                if self.host_manager else None))

    def _reader(self, data_origin):
        return RecordIODataReader(data_dir=data_origin)

    def _make_dispatcher(self):
        def shards_of(data):
            return self._reader(data).create_shards() if data else {}

        state_store = (JobStateStore(self._job_state_dir)
                       if self._job_state_dir else None)
        return TaskDispatcher(
            shards_of(self.training_data), shards_of(self.validation_data),
            shards_of(self.prediction_data), self.records_per_task,
            self.num_epochs, state_store=state_store)

    def _task_dataset(self, reader, task, mode):
        ds = Dataset.from_generator(lambda: reader.read_records(task))
        ds = self.spec.dataset_fn(ds, mode, reader.metadata)
        # background-thread prefetch overlaps host parsing with the step
        return ds.batch(self.minibatch_size).prefetch(1)

    def _ensure_state(self, batch):
        if self.state is not None:
            return
        self.state = self.trainer.init_state(batch)
        if self._checkpoint_dir_for_init:
            self.state, version = restore_with_host_state(
                self.trainer, self.state, self.host_manager,
                self._checkpoint_dir_for_init)
            self.restored_version = version
            logger.info("Restored model version %d from %s", version,
                        self._checkpoint_dir_for_init)

    def _intercept(self, hook):
        if self._fault_injector is not None:
            self._fault_injector.intercept(hook)

    def run(self):
        if self.training_data:
            return self.train()
        if self.validation_data:
            return self.evaluate()
        if self.prediction_data:
            return self.predict()
        raise ValueError("No data configured")

    def train(self):
        """Train over the training data's tasks until they run out or
        `max_steps` steps are taken; save every `checkpoint_steps`;
        evaluate every `evaluation_steps` steps and at the end when
        validation data is set. Returns (state, final metrics)."""
        dispatcher = self._make_dispatcher()
        reader = self._reader(self.training_data)
        eval_reader = (self._reader(self.validation_data)
                       if self.validation_data else None)
        stop = False
        while not stop:
            self._intercept("local_get_task")
            task_id, task = dispatcher.get("local")
            if task is None:
                break
            for batch in self._task_dataset(reader, task, Mode.TRAINING):
                padded, n = pad_batch(batch, self.minibatch_size)
                self._ensure_state(padded)
                self.state, loss = self.trainer.train_step(
                    self.state, padded, n)
                self.losses.append(float(loss))
                if self.checkpoint_saver is not None:
                    self.checkpoint_saver.maybe_save(self.state)
                step = self.state.version
                if (self.evaluation_steps and eval_reader
                        and step % self.evaluation_steps == 0):
                    metrics = self._evaluate_with_reader(eval_reader)
                    logger.info("Eval at step %d: %s", step, metrics)
                if self.max_steps and step >= self.max_steps:
                    dispatcher.stop_training = True
                    stop = True
                    break
            self._intercept("local_report")
            dispatcher.report(task_id, True)
        final_metrics = (self._evaluate_with_reader(eval_reader)
                         if eval_reader else {})
        if final_metrics:
            logger.info("Final eval: %s", final_metrics)
        return self.state, final_metrics

    def _shard_batches(self, reader, task_type, mode):
        """(padded batch, true count) of every record of `reader`."""
        for shard_name, (start, n) in reader.create_shards().items():
            task = Task(shard_name, start, start + n, task_type)
            for batch in self._task_dataset(reader, task, mode):
                padded, n_true = pad_batch(batch, self.minibatch_size)
                self._ensure_state(padded)
                yield padded, n_true

    def _evaluate_with_reader(self, reader):
        agg = MetricsAggregator(self.spec.eval_metrics_fn())
        for padded, n_true in self._shard_batches(
                reader, TaskType.EVALUATION, Mode.EVALUATION):
            outputs, labels = self.trainer.evaluate_batch(
                self.state, padded, n_true)
            agg.update(labels, outputs)
        return agg.result()

    def evaluate(self):
        return self._evaluate_with_reader(self._reader(self.validation_data))

    def predict(self):
        """The model's outputs over every prediction record, concatenated
        (per key for a dict of outputs), handed to the spec's
        PredictionOutputsProcessor when it has one."""
        reader = self._reader(self.prediction_data)
        outputs = [self.trainer.evaluate_batch(self.state, padded, n_true)[0]
                   for padded, n_true in self._shard_batches(
                       reader, TaskType.PREDICTION, Mode.PREDICTION)]
        if not outputs:
            result = np.array([])
        elif isinstance(outputs[0], dict):
            result = {k: np.concatenate([o[k] for o in outputs], axis=0)
                      for k in outputs[0]}
        else:
            result = np.concatenate(outputs, axis=0)
        if self.spec.prediction_outputs_processor is not None:
            invoke_processor(self.spec.prediction_outputs_processor, result)
        return result
