"""Task data service: the port's copy of
elasticdl_tpu/worker/task_data_service.py, the bridge from the master's
task queue to the worker's input pipeline.

* a record generator pulls tasks from the master, queues each pending
  task and streams its records (batches may span task boundaries);
* ``report_record_done(count)`` pops the pending tasks the consumed
  records cover and reports them to the master (with failed-record
  counters); ``flush_record_accounting`` reports what is left at the
  end of a stream (cardinality-changing dataset_fns such as packing);
* WAIT: the current dataset ends and ``get_dataset`` returns a fresh
  one after a pause, so the worker can run evaluation tasks while
  training tasks are scarce;
* a TRAIN_END_CALLBACK task is parked for the worker.
"""

import logging
import threading
import time
from collections import deque

from elasticdl_tpu_torch.common.constants import TaskExecCounterKey
from elasticdl_tpu_torch.data.dataset import Dataset
from elasticdl_tpu_torch.data.reader.data_reader_factory import (
    build_data_reader,
)
from elasticdl_tpu_torch.proto import messages as pb

logger = logging.getLogger(__name__)


class TaskDataService(object):
    def __init__(
        self,
        worker,
        data_origin=None,
        data_reader_params=None,
        custom_data_reader=None,
        records_per_task=None,
        wait_sleep_secs=2.0,
    ):
        self._worker = worker
        self._lock = threading.Lock()
        self._pending_dataset = True
        self._pending_train_end_callback_task = None
        self._wait_sleep_secs = wait_sleep_secs
        self.data_reader = build_data_reader(
            data_origin, records_per_task, data_reader_params,
            custom_data_reader=custom_data_reader,
        )
        self._failed_record_count = 0
        self._reported_record_count = 0
        self._current_task = None
        self._pending_tasks = deque()

    def _reset_locked(self):
        self._reported_record_count = 0
        self._failed_record_count = 0
        self._pending_tasks = deque()
        self._current_task = None

    def get_current_task(self):
        with self._lock:
            return self._current_task

    def _do_report_task(self, task, err_msg=""):
        exec_counters = None
        if self._failed_record_count:
            exec_counters = {
                TaskExecCounterKey.FAIL_COUNT: self._failed_record_count
            }
        self._worker.report_task_result(
            task.task_id, err_msg, exec_counters=exec_counters
        )

    def report_record_done(self, count, err_msg=""):
        """Account `count` consumed records against the pending tasks;
        report and pop every task they cover. Returns True when a task
        was reported."""
        with self._lock:
            self._reported_record_count += count
            if err_msg:
                self._failed_record_count += count
            if not self._pending_tasks:
                return False
            task = self._pending_tasks[0]
            if self._reported_record_count < task.end - task.start:
                return False
            while self._pending_tasks and (
                self._reported_record_count
                >= self._pending_tasks[0].end
                - self._pending_tasks[0].start
            ):
                task = self._pending_tasks[0]
                self._reported_record_count -= task.end - task.start
                self._pending_tasks.popleft()
                self._do_report_task(task, err_msg)
                self._failed_record_count = 0
            if self._pending_tasks:
                self._current_task = self._pending_tasks[0]
            return True

    def flush_record_accounting(self, err_msg=""):
        """Report every still-pending task, with `err_msg`. Call only when
        the stream ended normally: every pending task's records went
        through the pipeline even where row counts undercount them (a
        packing dataset_fn). A crash mid-stream skips this, so the master
        recovers the tasks in flight."""
        with self._lock:
            while self._pending_tasks:
                task = self._pending_tasks.popleft()
                self._do_report_task(task, err_msg)
                # failure counters go with the first reported task
                self._failed_record_count = 0
            self._reported_record_count = 0
            self._current_task = None

    def get_train_end_callback_task(self):
        with self._lock:
            return self._pending_train_end_callback_task

    def clear_train_end_callback_task(self):
        with self._lock:
            self._pending_train_end_callback_task = None

    def get_dataset(self):
        """A fresh Dataset over the records of dispatched tasks, or None
        when the job has no more training work."""
        with self._lock:
            if not self._pending_dataset:
                return None
            if self._pending_tasks:
                logger.error("Cannot get a new dataset with pending tasks")
                return None
            self._reset_locked()
            self._pending_dataset = False
        return Dataset.from_generator(self._gen)

    def _gen(self):
        while True:
            task = self._worker.get_task()
            if not task.shard_name:
                if task.type == pb.WAIT:
                    with self._lock:
                        self._pending_dataset = True
                    logger.info("No tasks for now, maybe more later")
                    time.sleep(self._wait_sleep_secs)
                else:
                    logger.info("No more tasks, stopping")
                break
            with self._lock:
                if task.type == pb.TRAIN_END_CALLBACK:
                    self._pending_train_end_callback_task = task
                    continue
                self._pending_tasks.append(task)
                if len(self._pending_tasks) == 1:
                    self._current_task = task
            for record in self.data_reader.read_records(task):
                if record is not None:
                    yield record
