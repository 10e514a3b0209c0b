"""LocalExecutor: single-process training and evaluation over a port
zoo spec, the counterpart of elasticdl_tpu/api/local_executor.py.

It drives the same in-memory TaskDispatcher the master uses (tasks stay
the unit of work) and the port's Trainer on one device, or on this rank
of an sp mesh (`mesh`, as the JAX executor passes its mesh to the
Trainer; every rank runs its own executor over the same data). Checkpoints,
fault injection, the journaled job state and prediction are not ported
yet.
"""

import logging

from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.data.dataset import Dataset, pad_batch
from elasticdl_tpu_torch.data.reader.recordio_reader import (
    RecordIODataReader,
)
from elasticdl_tpu_torch.master.task_dispatcher import (
    Task,
    TaskDispatcher,
    TaskType,
)
from elasticdl_tpu_torch.training.metrics import MetricsAggregator
from elasticdl_tpu_torch.training.trainer import Trainer

logger = logging.getLogger(__name__)


class LocalExecutor(object):
    def __init__(self, model_spec, training_data=None, validation_data=None,
                 minibatch_size=32, num_epochs=1, records_per_task=256,
                 evaluation_steps=0, model_params="", seed=0, max_steps=None,
                 grad_accum_steps=1, trainable_pattern=None, device="cuda",
                 mesh=None):
        self.spec = model_spec
        self.minibatch_size = minibatch_size
        self.num_epochs = num_epochs
        self.records_per_task = records_per_task
        self.evaluation_steps = evaluation_steps
        self.max_steps = max_steps
        self.training_data = training_data
        self.validation_data = validation_data
        self.trainer = Trainer(
            model_spec, mesh=mesh, model_params=model_params, seed=seed,
            grad_accum_steps=grad_accum_steps,
            trainable_pattern=trainable_pattern, device=device,
        )
        self.state = None
        self.losses = []

    def _reader(self, data_origin):
        return RecordIODataReader(data_dir=data_origin)

    def _task_dataset(self, reader, task, mode):
        ds = Dataset.from_generator(lambda: reader.read_records(task))
        ds = self.spec.dataset_fn(ds, mode, reader.metadata)
        # background-thread prefetch overlaps host parsing with the step
        return ds.batch(self.minibatch_size).prefetch(1)

    def _ensure_state(self, batch):
        if self.state is None:
            self.state = self.trainer.init_state(batch)

    def train(self):
        """Train over the training data's tasks until they run out or
        `max_steps` steps are taken; evaluate every `evaluation_steps`
        steps and at the end when validation data is set. Returns
        (state, final metrics)."""
        reader = self._reader(self.training_data)
        dispatcher = TaskDispatcher(reader.create_shards(), {}, {},
                                    self.records_per_task, self.num_epochs)
        eval_reader = (self._reader(self.validation_data)
                       if self.validation_data else None)
        stop = False
        while not stop:
            task_id, task = dispatcher.get("local")
            if task is None:
                break
            for batch in self._task_dataset(reader, task, Mode.TRAINING):
                padded, n = pad_batch(batch, self.minibatch_size)
                self._ensure_state(padded)
                self.state, loss = self.trainer.train_step(
                    self.state, padded, n)
                self.losses.append(float(loss))
                step = self.state.version
                if (self.evaluation_steps and eval_reader
                        and step % self.evaluation_steps == 0):
                    metrics = self._evaluate_with_reader(eval_reader)
                    logger.info("Eval at step %d: %s", step, metrics)
                if self.max_steps and step >= self.max_steps:
                    dispatcher.stop_training = True
                    stop = True
                    break
            dispatcher.report(task_id, True)
        final_metrics = (self._evaluate_with_reader(eval_reader)
                         if eval_reader else {})
        if final_metrics:
            logger.info("Final eval: %s", final_metrics)
        return self.state, final_metrics

    def _evaluate_with_reader(self, reader):
        agg = MetricsAggregator(self.spec.eval_metrics_fn())
        for shard_name, (start, n) in reader.create_shards().items():
            task = Task(shard_name, start, start + n, TaskType.EVALUATION)
            for batch in self._task_dataset(reader, task, Mode.EVALUATION):
                padded, n_true = pad_batch(batch, self.minibatch_size)
                self._ensure_state(padded)
                outputs, labels = self.trainer.evaluate_batch(
                    self.state, padded, n_true)
                agg.update(labels, outputs)
        return agg.result()

    def evaluate(self):
        return self._evaluate_with_reader(self._reader(self.validation_data))
