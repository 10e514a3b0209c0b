"""Dynamic data sharding, in memory: the port's copy of the task queue
of elasticdl_tpu/master/task_dispatcher.py.

Tasks are record ranges (shard_name, start, end) of `records_per_task`
records. Training tasks are created per epoch and shuffled (with the
global `random` module, as there); `get` pops the next task and starts
the next epoch when the queue drains; `report` finishes a task or
re-queues a failed one at most MAX_TASK_RETRIES times; `stop_training`
drops the queue at the next successful report.

Not ported yet (the worker/master slice): the write-ahead journal
(`state_store`), evaluation tasks and the train-end callback task;
asking for them raises NotImplementedError.
"""

import logging
import random
import threading
import time

from elasticdl_tpu_torch.common.constants import MAX_TASK_RETRIES

logger = logging.getLogger(__name__)


class TaskType(object):
    TRAINING = "TRAINING"
    EVALUATION = "EVALUATION"
    PREDICTION = "PREDICTION"


class Task(object):
    """A record-range work item."""

    __slots__ = ("shard_name", "start", "end", "type", "model_version")

    def __init__(self, shard_name, start, end, type, model_version=-1):
        self.shard_name = shard_name
        self.start = start
        self.end = end
        self.type = type
        self.model_version = model_version

    def _info(self):
        return (self.shard_name, self.start, self.end, self.type,
                self.model_version)

    def __repr__(self):
        return "Task(%s[%d:%d], %s, v%d)" % self._info()


class TaskDispatcher(object):
    def __init__(self, training_shards, evaluation_shards,
                 prediction_shards, records_per_task, num_epochs,
                 state_store=None):
        if state_store is not None:
            raise NotImplementedError(
                "TaskDispatcher: the journaled state_store is not ported")
        self._lock = threading.Lock()
        self._num_epochs = num_epochs
        self._epoch = 0
        self._training_shards = training_shards
        self._evaluation_shards = evaluation_shards
        self._prediction_shards = prediction_shards
        self._records_per_task = records_per_task
        self.stop_training = False
        self._todo = []
        self._doing = {}  # task_id -> (worker_id, task, start_time)
        self._task_id = 0
        self._task_retry_count = {}
        if self._training_shards:
            logger.info("Starting epoch %d", self._epoch)
            self.create_tasks(TaskType.TRAINING)
        elif self._evaluation_shards:
            self.create_tasks(TaskType.EVALUATION)
        elif self._prediction_shards:
            self.create_tasks(TaskType.PREDICTION)

    def create_tasks(self, task_type, model_version=-1):
        with self._lock:
            return self._create_tasks_locked(task_type, model_version)

    def _create_tasks_locked(self, task_type, model_version=-1):
        if task_type == TaskType.EVALUATION:
            raise NotImplementedError(
                "TaskDispatcher: evaluation tasks are not ported")
        shards = (self._training_shards if task_type == TaskType.TRAINING
                  else self._prediction_shards)
        tasks = []
        for shard_name, (start_ind, num_records) in shards.items():
            max_ind = start_ind + num_records
            for task_start in range(start_ind, max_ind,
                                    self._records_per_task):
                tasks.append(Task(
                    shard_name=shard_name, start=task_start,
                    end=min(task_start + self._records_per_task, max_ind),
                    type=task_type, model_version=model_version,
                ))
        if task_type == TaskType.TRAINING:
            random.shuffle(tasks)
        self._todo.extend(tasks)
        logger.info("%d %s tasks created", len(tasks), task_type.lower())
        return len(tasks)

    def add_deferred_callback_create_train_end_task(self):
        raise NotImplementedError(
            "TaskDispatcher: the train-end callback task is not ported")

    def get(self, worker_id):
        """Pop the next (task_id, task), or (-1, None) when the job is
        done; a new epoch starts lazily when the queue drains."""
        with self._lock:
            if (not self._todo and not self.stop_training
                    and self._epoch < self._num_epochs - 1):
                self._epoch += 1
                self._create_tasks_locked(TaskType.TRAINING)
                logger.info("Starting epoch %d", self._epoch)
            if not self._todo:
                return -1, None
            self._task_id += 1
            task = self._todo.pop()
            self._doing[self._task_id] = (worker_id, task, time.time())
            return self._task_id, task

    def report(self, task_id, success):
        """Mark a doing task finished or failed; a failed task re-queues
        unless it exceeded MAX_TASK_RETRIES. Returns (elapsed_time, task,
        worker_id)."""
        with self._lock:
            worker_id, task, start_time = self._doing.pop(
                task_id, (-1, None, -1))
            if not task:
                logger.warning("Unknown task_id: %d", task_id)
            elif not success:
                logger.warning("Task %d of %s failed", task_id, task.type)
                if not self.check_exceed_max_task_retries(task):
                    self._todo.append(task)
            else:
                logger.info("Task:%d completed, %d remaining tasks",
                            task_id, len(self._todo) + len(self._doing))
            if success:
                if task:
                    self._task_retry_count.pop(task._info(), None)
                if self.stop_training and self._todo:
                    self._todo = []
        return (time.time() - start_time), task, worker_id

    def check_exceed_max_task_retries(self, task):
        key = task._info()
        self._task_retry_count.setdefault(key, 1)
        self._task_retry_count[key] += 1
        if self._task_retry_count[key] > MAX_TASK_RETRIES:
            logger.error("A %s task failed with %d retries", task.type,
                         MAX_TASK_RETRIES)
            self._task_retry_count.pop(key, None)
            return True
        return False
