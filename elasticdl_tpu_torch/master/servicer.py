"""The Master service's handlers: the port's copy of
elasticdl_tpu/master/servicer.py.

`get_task` pops the dispatcher's next task (or the evaluation queue's,
for an EVALUATION request). With no task to give it answers WAIT while
the job can still produce work (tasks in flight may fail and requeue, a
deferred train-end task may be pending), and NONE with reason
JOB_COMPLETE once it cannot: the explicit end-of-job signal, the only
one on which a worker leaves its loop. `report_task_result` completes or
fails a task, `report_evaluation_metrics` feeds the evaluation service,
`report_version` records the model version (the step-based evaluation
trigger), `register_worker` records membership. The liveness times and
the average task times feed the master's straggler watchdog.

Training-plane tracing: `get_task` opens a `task_dispatch` span (task
id, worker id, type) on the process recorder and puts its ids on the
Task, so the worker's `worker_task` span parents under it; a second
dispatch under the same task id seals the first span `redispatched`, and
`report_task_result` seals the current one `ok` or `error` with a
`reported` event. A task the dispatcher requeues from a dead worker goes
out again under a new task id, so the dead worker's span stays open. A report's `tier/` and `fault/`
exec counters become TensorBoard gauges tagged `/worker-<id>` through
the `tensorboard_service`, at a per-worker report index.

The handlers touch no device: the master process never initializes
CUDA.
"""

import logging
import statistics
import threading
import time

from elasticdl_tpu_torch.master.task_dispatcher import TaskType
from elasticdl_tpu_torch.observability.tracing import recorder
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.proto.convert import TASK_TYPE_TO_PB

logger = logging.getLogger(__name__)


class MasterServicer(object):
    def __init__(self, minibatch_size, task_d, evaluation_service=None,
                 tensorboard_service=None):
        self._task_d = task_d
        self._lock = threading.Lock()
        self._minibatch_size = minibatch_size
        # a restored dispatcher carries the pre-crash model version, so
        # step-based evaluation triggers do not re-fire for old versions
        self._version = getattr(task_d, "model_version", 0) or 0
        self._evaluation_service = evaluation_service
        self._tensorboard_service = tensorboard_service
        self._task_complete_times = {
            TaskType.TRAINING: [],
            TaskType.EVALUATION: [],
        }
        self._worker_liveness_time = {}
        self._workers = {}
        self._cluster_version = 0
        # worker id -> its next tier-gauge step: one step a report, so
        # every cumulative value lands at its own step
        self._tier_gauge_steps = {}
        # task id -> the open task_dispatch span of its last dispatch
        self._task_spans = {}
        if evaluation_service:
            evaluation_service.set_master_servicer(self)

    def get_model_version(self):
        return self._version

    # ----------------------------------------------------------------- RPCs

    def get_task(self, request, _context=None):
        res = pb.Task(type=pb.NONE)
        res.model_version = self._version
        res.minibatch_size = self._minibatch_size
        if request.task_type == pb.EVALUATION:
            task_id, task = self._task_d.get_eval_task(request.worker_id)
        else:
            task_id, task = self._task_d.get(request.worker_id)

        if task:
            res.task_id = task_id
            res.shard_name = task.shard_name
            res.start = task.start
            res.end = task.end
            res.type = TASK_TYPE_TO_PB[task.type]
            if task.type == TaskType.EVALUATION:
                # evaluation tasks pin the model version they evaluate
                res.model_version = task.model_version
            span = recorder().start_span(
                "task_dispatch", task_id=task_id,
                worker_id=request.worker_id, type=str(task.type))
            res.trace_id = span.trace_id
            res.span_id = span.span_id
            with self._lock:
                old = self._task_spans.pop(task_id, None)
                self._task_spans[task_id] = span
            if old is not None:
                old.event("redispatched", worker_id=request.worker_id)
                old.finish("redispatched")
        elif (not self._task_d.finished()) or (
            self._task_d.invoke_deferred_callback()
        ):
            res.type = pb.WAIT
        else:
            # the explicit end-of-job signal
            res.reason = pb.JOB_COMPLETE
        with self._lock:
            self._worker_liveness_time[request.worker_id] = time.time()
        return res

    def report_task_result(self, request, _context=None):
        self._finish_task_span(request.task_id, ok=not request.err_message)
        if request.err_message:
            logger.warning(
                "Worker reported error: %s", request.err_message
            )
            _, _, worker_id = self._task_d.report(request.task_id, False)
        else:
            complete_time, task, worker_id = self._task_d.report(
                request.task_id, True)
            if task:
                with self._lock:
                    self._worker_liveness_time[worker_id] = time.time()
                    if task.type in self._task_complete_times:
                        self._task_complete_times[task.type].append(
                            complete_time
                        )
        self._write_tier_gauges(dict(request.exec_counters), worker_id)
        return pb.Empty()

    def _finish_task_span(self, task_id, ok):
        """Seal the dispatch span a report closes. A late duplicate
        report (a requeued straggler's) finds none: the re-dispatch
        sealed it."""
        with self._lock:
            span = self._task_spans.pop(task_id, None)
        if span is not None:
            span.event("reported", ok=ok)
            span.finish("ok" if ok else "error")

    def _write_tier_gauges(self, exec_counters, worker_id):
        """A report's cumulative `tier/` (host-tier health) and `fault/`
        (RPC retries, reconnects) counters as gauges tagged
        `/worker-<id>`, at that worker's report index. A report of an
        unknown task (worker id -1) is dropped: a bare tag would mix the
        workers' values."""
        if not self._tensorboard_service or worker_id < 0:
            return
        suffix = "/worker-%d" % worker_id
        gauges = {k + suffix: v for k, v in exec_counters.items()
                  if k.startswith(("tier/", "fault/"))}
        if gauges:
            with self._lock:
                step = self._tier_gauge_steps.get(worker_id, 0)
                self._tier_gauge_steps[worker_id] = step + 1
            self._tensorboard_service.write_dict_to_summary(gauges,
                                                            version=step)

    def report_evaluation_metrics(self, request, _context=None):
        with self._lock:
            self._worker_liveness_time[request.worker_id] = time.time()
        if self._evaluation_service:
            self._evaluation_service.report_evaluation_metrics(
                request.model_outputs, request.labels
            )
        return pb.Empty()

    def report_version(self, request, _context=None):
        self._version = max(self._version, request.model_version)
        self._task_d.record_model_version(request.model_version)
        if self._evaluation_service:
            self._evaluation_service.add_evaluation_task_if_needed(
                model_version=request.model_version
            )
        return pb.Empty()

    def register_worker(self, request, _context=None):
        with self._lock:
            self._workers[request.worker_id] = {
                "address": request.address,
                "num_devices": request.num_devices,
                "registered_at": time.time(),
            }
            self._cluster_version += 1
            self._worker_liveness_time[request.worker_id] = time.time()
            # the version this registration produced, taken under the lock
            cluster_version = self._cluster_version
        logger.info(
            "Worker %d registered from %s (%d devices)",
            request.worker_id, request.address, request.num_devices,
        )
        return pb.RegisterWorkerResponse(cluster_version=cluster_version)

    # ------------------------------------------------------ watchdog helpers

    def get_average_task_complete_time(self):
        """Per task type, the mean of the last 200 completion times, or
        300 s until 20 exist."""
        out = {}
        with self._lock:
            complete_times = {
                t: list(v) for t, v in self._task_complete_times.items()
            }
        for task_type, times in complete_times.items():
            if len(times) < 20:
                out[task_type] = 300.0
            else:
                out[task_type] = statistics.mean(times[-200:])
        return out

    def get_worker_liveness_time(self, worker_id):
        with self._lock:
            return self._worker_liveness_time.get(worker_id)
