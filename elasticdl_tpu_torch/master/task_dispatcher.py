"""Dynamic data sharding: the task queue, the port's copy of
elasticdl_tpu/master/task_dispatcher.py.

Tasks are record ranges (shard_name, start, end) of `records_per_task`
records; workers (the LocalExecutor here) pull them:

* per-epoch TRAINING task creation, shuffled with the global `random`
  module as there; EVALUATION tasks (`get_eval_task`), PREDICTION and a
  deferred TRAIN_END_CALLBACK task (one task-range of the first shard,
  appended after the training tasks finish, for train-end callbacks);
* todo / doing bookkeeping keyed by task_id with start timestamps;
* failed tasks re-queue at most ``MAX_TASK_RETRIES`` times; epochs roll
  over lazily inside ``get``; ``recover_tasks(worker_id)`` re-queues a
  dead worker's tasks; ``on_task_end`` callbacks (MaxStepsStopping)
  run on every completed task.

Crash recovery: with a ``state_store`` (master/state_store.py) every
lifecycle transition is journaled write-ahead, in the JAX package's line
format (so a journal either package wrote restores in the other):

    {"ev": "create", "task_type": T, "epoch": e, "tasks": [payload...]}
    {"ev": "dispatch", "id": i, "worker": w, "task": payload}
    {"ev": "done" | "done_recovered" | "fail", "id": i, "task": payload}
    {"ev": "stop"} {"ev": "version", "v": v}
    {"ev": "deferred_add"} {"ev": "deferred_invoked"}

with payload = [shard_name, start, end, type, model_version].
``restore()`` rebuilds todo and re-queues the tasks in flight at the
crash, keeping their old ids (``_recovered_doing``) so a late success
report is reconciled instead of running the range twice.

Evaluation tasks: `set_evaluation_service` wires the master's
EvaluationService (master/evaluation_service.py); a completed
evaluation task is handed to its `complete_task` outside the lock.
"""

import logging
import random
import threading
import time

from elasticdl_tpu_torch.common.constants import MAX_TASK_RETRIES

logger = logging.getLogger(__name__)


class TaskType(object):
    """Task types."""

    TRAINING = "TRAINING"
    EVALUATION = "EVALUATION"
    PREDICTION = "PREDICTION"
    WAIT = "WAIT"
    TRAIN_END_CALLBACK = "TRAIN_END_CALLBACK"


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
        return (
            self.shard_name, self.start, self.end, self.type,
            self.model_version,
        )

    def __repr__(self):
        return "Task(%s[%d:%d], %s, v%d)" % self._info()


def _payload(task):
    """JSON-serializable journal form of a task."""
    return list(task._info())


def _task_from_payload(p):
    return Task(p[0], p[1], p[2], p[3], model_version=p[4])


def _key(payload_or_task):
    if isinstance(payload_or_task, Task):
        return payload_or_task._info()
    return tuple(payload_or_task)


class TaskDispatcher(object):
    def __init__(
        self,
        training_shards,
        evaluation_shards,
        prediction_shards,
        records_per_task,
        num_epochs,
        callbacks_list=None,
        state_store=None,
    ):
        self._lock = threading.Lock()
        self._num_epochs = num_epochs
        self._epoch = 0
        self._training_shards = training_shards
        self._evaluation_shards = evaluation_shards
        self._prediction_shards = prediction_shards
        self._records_per_task = records_per_task
        self._callbacks_list = callbacks_list
        self.stop_training = False

        self._todo = []
        self._doing = {}  # task_id -> (worker_id, task, start_time)
        self._task_id = 0
        self._eval_todo = []
        self._evaluation_service = None
        self._tasks_done_deferred_callbacks = []
        # retry counts keyed by task payload (shard, start, end, type,
        # model_version) — payload keys survive the journal round-trip,
        # where object identity cannot
        self._task_retry_count = {}
        self._state_store = state_store
        # pre-crash task_id -> payload key of requeued-doing tasks, for
        # reconciling a surviving worker's late completion report
        self._recovered_doing = {}
        self._restored = False
        self._train_end_handled = False
        self.model_version = 0
        # observability (master/recovery gauges)
        self.requeued_on_recovery = 0
        self.recovered_late_completions = 0

        if state_store is not None and state_store.has_state():
            snapshot, events = state_store.load()
            self.restore(snapshot, events)
        elif self._training_shards:
            logger.info("Starting epoch %d", self._epoch)
            self.create_tasks(TaskType.TRAINING)
        elif self._evaluation_shards:
            self.create_tasks(TaskType.EVALUATION)
        elif self._prediction_shards:
            self.create_tasks(TaskType.PREDICTION)

    # ------------------------------------------------------------ journal

    def _journal(self, event):
        """Write-ahead one lifecycle event; compact when the store asks.
        Callers either hold self._lock or run single-threaded (ctor)."""
        if self._state_store is None:
            return
        if self._state_store.append(event):
            self._state_store.write_snapshot(self._snapshot_locked())

    def queue_depths(self):
        """(todo, doing, eval_todo) under the lock: the master's /metrics
        exposition reads the queues through this."""
        with self._lock:
            return (len(self._todo), len(self._doing),
                    len(self._eval_todo))

    def create_tasks(self, task_type, model_version=-1):
        """Public entry: callers outside the dispatcher (the evaluation
        service's trigger threads) do NOT hold the lock, but they race
        workers popping the queues — take it here. Internal callers
        already under the lock use _create_tasks_locked directly."""
        with self._lock:
            return self._create_tasks_locked(task_type, model_version)

    def _create_tasks_locked(self, task_type, model_version=-1):
        logger.info(
            "Creating a new set of %s tasks for model version %d",
            task_type.lower(),
            model_version,
        )
        if task_type == TaskType.TRAINING:
            shards = self._training_shards
        elif task_type == TaskType.EVALUATION:
            shards = self._evaluation_shards
        else:
            shards = self._prediction_shards
        tasks = []
        for shard_name, (start_ind, num_records) in shards.items():
            max_ind = start_ind + num_records
            for task_start in range(start_ind, max_ind,
                                    self._records_per_task):
                tasks.append(
                    Task(
                        shard_name=shard_name,
                        start=task_start,
                        end=min(task_start + self._records_per_task, max_ind),
                        type=task_type,
                        model_version=model_version,
                    )
                )
        if task_type == TaskType.TRAINING:
            random.shuffle(tasks)
        self._journal({
            "ev": "create",
            "task_type": task_type,
            "epoch": self._epoch,
            "tasks": [_payload(t) for t in tasks],
        })
        if task_type == TaskType.EVALUATION:
            self._eval_todo.extend(tasks)
        else:
            self._todo.extend(tasks)
        logger.info("%d tasks created", len(tasks))
        return len(tasks)

    def get_eval_task(self, worker_id):
        with self._lock:
            if not self._eval_todo:
                return -1, None
            self._task_id += 1
            task = self._eval_todo.pop()
            self._journal({
                "ev": "dispatch", "id": self._task_id,
                "worker": worker_id, "task": _payload(task),
            })
            self._doing[self._task_id] = (worker_id, task, time.time())
            return self._task_id, task

    def _create_train_end_callback_task_locked(self):
        """Append one TRAIN_END_CALLBACK task carrying the first shard's
        first task-range of data."""
        if not self._training_shards:
            return
        shard_name, (start_ind, num_records) = next(
            iter(self._training_shards.items())
        )
        task = Task(
            shard_name=shard_name,
            start=start_ind,
            end=start_ind + min(self._records_per_task, num_records),
            type=TaskType.TRAIN_END_CALLBACK,
        )
        self._journal({
            "ev": "create",
            "task_type": TaskType.TRAIN_END_CALLBACK,
            "epoch": self._epoch,
            "tasks": [_payload(task)],
        })
        self._todo.append(task)

    def add_deferred_callback_create_train_end_task(self):
        # runs on the master wait-loop thread while worker RPCs mutate
        # the same state — and after a restore the deferred callback (or
        # the train-end task it creates) is already part of the
        # recovered state, so re-adding it would run the train-end
        # export twice; both the check and the append belong under the
        # lock (the unlocked append was edl-lint EDL001's first catch)
        with self._lock:
            if self._restored and (
                self._tasks_done_deferred_callbacks
                or self._train_end_handled
            ):
                return
            self._journal({"ev": "deferred_add"})
            self._tasks_done_deferred_callbacks.append(
                self._create_train_end_callback_task_locked
            )

    def invoke_deferred_callback(self):
        with self._lock:
            if not self._tasks_done_deferred_callbacks:
                return False
            self._journal({"ev": "deferred_invoked"})
            callback = self._tasks_done_deferred_callbacks.pop()
            callback()
            return True

    def get(self, worker_id):
        """Pop the next (task_id, task), or (-1, None) when the job is
        done; a new epoch starts lazily when the todo list drains."""
        with self._lock:
            if (
                not self._todo
                and not self.stop_training
                and self._epoch < self._num_epochs - 1
            ):
                self._epoch += 1
                self._create_tasks_locked(TaskType.TRAINING)
                logger.info("Starting epoch %d", self._epoch)

            if not self._todo:
                return -1, None

            self._task_id += 1
            task = self._todo.pop()
            self._journal({
                "ev": "dispatch", "id": self._task_id,
                "worker": worker_id, "task": _payload(task),
            })
            self._doing[self._task_id] = (worker_id, task, time.time())
            return self._task_id, task

    def report(self, task_id, success):
        """Mark a doing task finished or failed; failed tasks re-queue unless
        they exceeded MAX_TASK_RETRIES.

        Returns (elapsed_time, task, worker_id)."""
        evaluation_task_completed = False
        eval_service = None
        with self._lock:
            worker_id, task, start_time = self._doing.pop(
                task_id, (-1, None, -1)
            )
            if not task:
                if task_id in self._recovered_doing:
                    worker_id = self._reconcile_recovered(
                        task_id, success
                    )
                else:
                    logger.warning("Unknown task_id: %d", task_id)
            elif not success:
                logger.warning("Task %d of %s failed", task_id, task.type)
                self._journal({
                    "ev": "fail", "id": task_id, "task": _payload(task),
                })
                if not self.check_exceed_max_task_retries(task):
                    # every non-eval task returns to the main todo queue
                    # (a failed prediction task in the eval queue would
                    # never be drained)
                    if task.type == TaskType.EVALUATION:
                        self._eval_todo.append(task)
                    else:
                        self._todo.append(task)
            elif (
                task.type == TaskType.EVALUATION
                and self._evaluation_service is not None
            ):
                self._journal({
                    "ev": "done", "id": task_id, "task": _payload(task),
                })
                evaluation_task_completed = True
                eval_service = self._evaluation_service
            else:
                self._journal({
                    "ev": "done", "id": task_id, "task": _payload(task),
                })
                self._call_on_task_end(task)
                logger.info(
                    "Task:%d completed, %d remaining tasks",
                    task_id,
                    len(self._todo) + len(self._doing),
                )

            if success:
                if task:
                    self._task_retry_count.pop(_key(task), None)
                    if task.type == TaskType.TRAIN_END_CALLBACK:
                        self._train_end_handled = True
                if self.stop_training and self._todo:
                    self._journal({"ev": "stop"})
                    self._todo = []

        # outside the lock: complete_task re-enters the dispatcher
        # (try_to_create_new_job -> create_tasks takes self._lock)
        if evaluation_task_completed:
            eval_service.complete_task()

        return (time.time() - start_time), task, worker_id

    def _reconcile_recovered(self, task_id, success):
        """A report arrived for a task dispatched BEFORE the master
        crashed. Its range was requeued on restore; a success report means
        the surviving worker finished it after all — pull the duplicate
        back out of todo so the range runs exactly once. Returns the
        pre-crash worker id (the reporter) so the servicer's per-worker
        gauges keep their identity. (Caller holds the lock.)"""
        worker_id, key = self._recovered_doing.pop(task_id)
        if not success:
            # already requeued at restore; nothing more to do
            logger.info(
                "Pre-crash task %d reported failed; already requeued",
                task_id,
            )
            return worker_id
        for queue in (self._todo, self._eval_todo):
            for i, queued in enumerate(queue):
                if _key(queued) == key:
                    task = queue.pop(i)
                    self._journal({
                        "ev": "done_recovered", "id": task_id,
                        "task": _payload(task),
                    })
                    self._task_retry_count.pop(key, None)
                    self.recovered_late_completions += 1
                    self._call_on_task_end(task)
                    logger.info(
                        "Pre-crash task %d completed by its worker; "
                        "de-duplicated from todo", task_id,
                    )
                    return worker_id
        # the requeued copy was already re-dispatched: let that execution
        # finish normally; the range ran (at most) twice — unavoidable
        # once both executions are in flight
        logger.warning(
            "Pre-crash task %d completed but its range was already "
            "re-dispatched", task_id,
        )
        return worker_id

    def check_exceed_max_task_retries(self, task):
        key = _key(task)
        self._task_retry_count.setdefault(key, 1)
        self._task_retry_count[key] += 1
        if self._task_retry_count[key] > MAX_TASK_RETRIES:
            logger.error(
                "A %s task failed with %d retries", task.type,
                MAX_TASK_RETRIES,
            )
            self._task_retry_count.pop(key, None)
            return True
        return False

    def record_model_version(self, version):
        """Journal the latest reported model version (the servicer owns
        the live max; this persists it for eval-trigger dedup across a
        master restart)."""
        with self._lock:
            if version > self.model_version:
                self.model_version = version
                self._journal({"ev": "version", "v": int(version)})

    def finished(self):
        """Job-complete test, read by servicer threads while dispatch/
        report mutate the queues — an unlocked read can see `_todo`
        empty and `_doing` already popped mid-report and tell a worker
        JOB_COMPLETE while the report is about to requeue a failed
        task (edl-lint EDL002)."""
        with self._lock:
            return (
                not self._todo
                and not self._eval_todo
                and not self._doing
            )

    def recover_tasks(self, worker_id):
        """Re-queue all doing tasks of a dead worker."""
        with self._lock:
            ids = [
                tid
                for tid, (wid, _, _) in self._doing.items()
                if wid == worker_id
            ]
        for tid in ids:
            self.report(tid, False)

    def set_evaluation_service(self, evaluation_service):
        with self._lock:
            self._evaluation_service = evaluation_service
            eval_only = (
                bool(self._evaluation_shards)
                and not self._training_shards
            )
            n_eval = len(self._eval_todo)
        # init takes the eval service's own lock; never nest it under ours
        if eval_only:
            evaluation_service.init_eval_only_job(n_eval)

    def _call_on_task_end(self, task):
        if self._callbacks_list:
            for callback in self._callbacks_list.callbacks:
                if hasattr(callback, "on_task_end"):
                    callback.on_task_end(task)

    # ------------------------------------------------- snapshot / restore

    def snapshot(self):
        with self._lock:
            return self._snapshot_locked()

    def _snapshot_locked(self):
        return {
            "format": 1,
            "epoch": self._epoch,
            "task_id": self._task_id,
            "todo": [_payload(t) for t in self._todo],
            "eval_todo": [_payload(t) for t in self._eval_todo],
            "doing": [
                [tid, wid, _payload(task)]
                for tid, (wid, task, _) in self._doing.items()
            ],
            "retry": [
                [list(k), v] for k, v in self._task_retry_count.items()
            ],
            "stop_training": self.stop_training,
            "model_version": self.model_version,
            "deferred_train_end": len(self._tasks_done_deferred_callbacks),
            "train_end_handled": self._train_end_handled,
            # un-reconciled pre-crash dispatches survive a SECOND crash
            "recovered_doing": [
                [tid, wid, list(key)]
                for tid, (wid, key) in self._recovered_doing.items()
            ],
        }

    def restore(self, snapshot, events):
        """Rebuild exact dispatcher state from a snapshot plus journal
        replay. Post-condition: todo = snapshot-todo ∪ requeued-doing
        (pre-crash in-flight ranges re-run; their old ids are kept in
        _recovered_doing for late-report reconciliation), retry counts
        and epoch position carry over, and no record range is lost."""
        snapshot = snapshot or {}
        epoch = snapshot.get("epoch", 0)
        task_id = snapshot.get("task_id", 0)
        todo = [list(p) for p in snapshot.get("todo", [])]
        eval_todo = [list(p) for p in snapshot.get("eval_todo", [])]
        doing = {
            tid: (wid, list(p))
            for tid, wid, p in snapshot.get("doing", [])
        }
        retry = {
            tuple(k): v for k, v in snapshot.get("retry", [])
        }
        stop_training = snapshot.get("stop_training", False)
        model_version = snapshot.get("model_version", 0)
        deferred = snapshot.get("deferred_train_end", 0)
        train_end_handled = snapshot.get("train_end_handled", False)
        recovered = {
            tid: (wid, tuple(key))
            for tid, wid, key in snapshot.get("recovered_doing", [])
        }

        def remove_one(queue, key):
            for i, p in enumerate(queue):
                if _key(p) == key:
                    queue.pop(i)
                    return True
            return False

        for ev in events:
            kind = ev.get("ev")
            if kind == "create":
                # idempotent under snapshot/journal overlap (a crash
                # between write_snapshot and the journal truncate
                # replays the full journal against a snapshot that
                # already incorporates it): a task whose range is
                # still queued or in flight is not re-added — later
                # dispatch/done/fail events re-consume the rest
                if ev["task_type"] == TaskType.EVALUATION:
                    queue = eval_todo
                else:
                    if ev["task_type"] == TaskType.TRAINING:
                        epoch = ev.get("epoch", epoch)
                    queue = todo
                present = {_key(p) for p in queue}
                present |= {_key(p) for _w, p in doing.values()}
                queue.extend(
                    p for p in ev["tasks"] if _key(p) not in present
                )
            elif kind == "dispatch":
                p = ev["task"]
                queue = (
                    eval_todo if p[3] == TaskType.EVALUATION else todo
                )
                # idempotent under snapshot/journal overlap: a dispatch
                # whose task is absent only claims the id
                remove_one(queue, _key(p))
                doing[ev["id"]] = (ev.get("worker", -1), p)
                task_id = max(task_id, ev["id"])
            elif kind == "done":
                _, p = doing.pop(ev["id"], (None, None))
                retry.pop(_key(ev["task"]), None)
                if ev["task"][3] == TaskType.TRAIN_END_CALLBACK:
                    train_end_handled = True
            elif kind == "done_recovered":
                p = ev["task"]
                queue = (
                    eval_todo if p[3] == TaskType.EVALUATION else todo
                )
                remove_one(queue, _key(p))
                retry.pop(_key(p), None)
                recovered.pop(ev["id"], None)
            elif kind == "fail":
                doing.pop(ev["id"], None)
                p = ev["task"]
                key = _key(p)
                retry.setdefault(key, 1)
                retry[key] += 1
                if retry[key] > MAX_TASK_RETRIES:
                    retry.pop(key, None)  # permanently failed
                elif p[3] == TaskType.EVALUATION:
                    eval_todo.append(p)
                else:
                    todo.append(p)
            elif kind == "stop":
                stop_training = True
                todo = []
            elif kind == "version":
                model_version = max(model_version, ev["v"])
            elif kind == "deferred_add":
                deferred += 1
            elif kind == "deferred_invoked":
                deferred -= 1
                train_end_handled = True
            else:
                logger.warning("Unknown journal event %r", kind)

        # materialize: requeue every pre-crash in-flight task and remember
        # its old id for late-report reconciliation
        self._epoch = epoch
        self._task_id = task_id
        self._todo = [_task_from_payload(p) for p in todo]
        self._eval_todo = [_task_from_payload(p) for p in eval_todo]
        self._doing = {}
        self._recovered_doing = dict(recovered)
        for tid, (wid, p) in sorted(doing.items()):
            task = _task_from_payload(p)
            if task.type == TaskType.EVALUATION:
                self._eval_todo.append(task)
            else:
                self._todo.append(task)
            self._recovered_doing[tid] = (wid, _key(p))
        self.requeued_on_recovery = len(doing)
        self._task_retry_count = dict(retry)
        self.stop_training = stop_training
        self.model_version = model_version
        self._train_end_handled = train_end_handled
        self._tasks_done_deferred_callbacks = [
            self._create_train_end_callback_task_locked
        ] * max(0, deferred)
        self._restored = True
        logger.info(
            "Dispatcher restored: epoch %d, %d todo, %d eval, %d "
            "requeued from pre-crash doing, %d retry entries",
            self._epoch, len(self._todo) - len(self._recovered_doing),
            len(self._eval_todo), self.requeued_on_recovery,
            len(self._task_retry_count),
        )
        # a compacted snapshot right away bounds the next crash's replay
        if self._state_store is not None:
            self._state_store.write_snapshot(self._snapshot_locked())

    @property
    def epoch(self):
        return self._epoch

    def doing_tasks(self):
        """{task_id: (worker_id, task, start time)} of the tasks in
        flight, for the straggler watchdog."""
        with self._lock:
            return dict(self._doing)
