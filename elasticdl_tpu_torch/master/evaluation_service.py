"""Evaluation jobs on the master: the port's copy of
elasticdl_tpu/master/evaluation_service.py.

* a time-based trigger thread (start_delay_secs / throttle_secs) and a
  step-based trigger on the model versions workers report;
* one EvaluationJob at a time, further requested versions queued;
* workers report raw model outputs and labels (numpy, through
  common/tensor_utils.py's codec); the master aggregates them with the
  port's MetricsAggregator, on the host: the master never touches the
  device;
* a finished job's metrics go to `completed_job_metrics` and the log
  (the JAX service's TensorBoard writer is not ported)
"""

import logging
import threading
import time

from elasticdl_tpu_torch.common.tensor_utils import deserialize_ndarray_dict
from elasticdl_tpu_torch.master.task_dispatcher import TaskType
from elasticdl_tpu_torch.training.metrics import MetricsAggregator

logger = logging.getLogger(__name__)


class EvaluationJob(object):
    def __init__(self, metrics_dict, model_version, total_tasks=-1):
        self.model_version = model_version
        self._total_tasks = total_tasks
        self._completed_tasks = 0
        self._aggregator = MetricsAggregator(metrics_dict)

    def complete_task(self):
        self._completed_tasks += 1

    def finished(self):
        return self._completed_tasks >= self._total_tasks

    def report_evaluation_metrics(self, model_outputs_bytes, labels_bytes):
        outputs = deserialize_ndarray_dict(model_outputs_bytes)
        labels = deserialize_ndarray_dict(labels_bytes).get("labels")
        # single-output models report under "output"
        if set(outputs) == {"output"}:
            outputs = outputs["output"]
        self._aggregator.update(labels, outputs)
        return True

    def get_evaluation_summary(self):
        return self._aggregator.result()


class _EvaluationTrigger(threading.Thread):
    """Periodic time-based evaluation task creation."""

    def __init__(self, eval_service, start_delay_secs, throttle_secs):
        super().__init__(daemon=True)
        self._eval_service = eval_service
        self._stopper = threading.Event()
        self._throttle_secs = throttle_secs
        self._eval_min_time = time.time() + start_delay_secs

    def stop(self):
        self._stopper.set()

    def _wait_enough_time(self, cur, prev_start):
        if cur < self._eval_min_time:
            return False
        if prev_start != -1 and cur - prev_start < self._throttle_secs:
            return False
        return True

    def run(self):
        prev_start = -1
        while not self._stopper.is_set():
            now = time.time()
            if self._wait_enough_time(now, prev_start):
                self._eval_service.add_evaluation_task(
                    is_time_based_eval=True
                )
                prev_start = now
            self._stopper.wait(1.0)


class EvaluationService(object):
    def __init__(
        self,
        task_d,
        start_delay_secs,
        throttle_secs,
        eval_steps,
        eval_only,
        eval_metrics_fn,
    ):
        self._task_d = task_d
        # reentrant: complete_task -> try_to_create_new_job both lock
        self._lock = threading.RLock()
        self._eval_job = None
        self.trigger = _EvaluationTrigger(
            self, start_delay_secs, throttle_secs
        )
        self._time_based_eval = throttle_secs > 0
        self._eval_steps = eval_steps
        self._eval_checkpoint_versions = []
        self._last_eval_checkpoint_version = -1
        self._eval_only = eval_only
        self._eval_metrics_fn = eval_metrics_fn
        self._master_servicer = None
        self.completed_job_metrics = []  # [(version, {name: value})]

    def start(self):
        if self._time_based_eval and not self._eval_only:
            self.trigger.start()

    def stop(self):
        if self._time_based_eval and not self._eval_only:
            self.trigger.stop()

    def set_master_servicer(self, master_servicer):
        self._master_servicer = master_servicer

    def init_eval_only_job(self, num_task):
        with self._lock:
            self._eval_job = EvaluationJob(
                self._eval_metrics_fn(), -1, num_task
            )

    def add_evaluation_task(self, is_time_based_eval, model_version=None):
        if is_time_based_eval and self._task_d.finished():
            return
        if not model_version:
            model_version = self._master_servicer.get_model_version()
        with self._lock:
            # concurrent report_version calls for one version must not
            # queue it twice
            if model_version == self._last_eval_checkpoint_version:
                return
            self._eval_checkpoint_versions.append(model_version)
            self._last_eval_checkpoint_version = model_version
        self.try_to_create_new_job()

    def try_to_create_new_job(self):
        with self._lock:
            if self._eval_job is None and self._eval_checkpoint_versions:
                version = self._eval_checkpoint_versions.pop(0)
                task_count = self._task_d.create_tasks(
                    TaskType.EVALUATION, version
                )
                self._eval_job = EvaluationJob(
                    self._eval_metrics_fn(), version, task_count
                )
                return True
        return False

    def add_evaluation_task_if_needed(self, model_version):
        """The step-based trigger."""
        if not model_version:
            model_version = self._master_servicer.get_model_version()
        if (
            self._eval_steps
            and model_version % self._eval_steps == 0
            and model_version > self._last_eval_checkpoint_version
        ):
            self.add_evaluation_task(
                is_time_based_eval=False, model_version=model_version
            )

    def report_evaluation_metrics(self, model_outputs, labels):
        with self._lock:
            if self._eval_job is None:
                return False
            return self._eval_job.report_evaluation_metrics(
                model_outputs, labels
            )

    def complete_task(self):
        with self._lock:
            if self._eval_job is None:
                return None
            self._eval_job.complete_task()
            if not self._eval_job.finished():
                return None
            metrics = self._eval_job.get_evaluation_summary()
            version = self._eval_job.model_version
            self.completed_job_metrics.append((version, metrics))
            if not self._eval_only:
                self._eval_job = None
        logger.info("Evaluation metrics[v=%d]: %s", version, metrics)
        self.try_to_create_new_job()
        return metrics
