"""Worker: the process the master's tasks drive, the port's copy of
elasticdl_tpu/worker/worker.py.

It trains the port's Trainer (training/trainer.py) on its device from
the record ranges it pulls from the master:

* task-driven training with batches spanning task boundaries;
* evaluation interleaved with training (TRAINING_WITH_EVALUATION pulls
  the evaluation queue before each minibatch), evaluation-only and
  prediction-only jobs, the TRAIN_END_CALLBACK task;
* a minibatch is retried up to MAX_MINIBATCH_RETRY_NUM times on a
  runtime failure (not on ValueError / TypeError / NotImplementedError,
  which do not heal);
* the model version is reported after each applied step, for the
  master's step-based evaluation trigger;
* `checkpoint_dir` + `checkpoint_steps` save on the step cadence
  through checkpoint/saver.py; `checkpoint_dir_for_init` restores the
  latest valid version before the first step.

Every worker -> master call goes through `_call_master`: a per-call
deadline, exponential backoff with jitter inside a bounded reconnect
window (common/retry.py), a fresh channel after each failure, and a
re-registration once a call succeeds after retries (the master may have
restarted). A worker leaves its task loop only on the master's explicit
JOB_COMPLETE; after it, further calls are best effort.

It connects in-process (`master_servicer=`, the test harness) or over
the port's transport (`master_addr="host:port"`, proto/service.py).

Several workers do not train one model. Outside SPMD each worker trains
its own state from the tasks it pulls, as the JAX package's workers do;
gradients are combined only in the SPMD lockstep loop (`spmd=True`),
which needs parallel/spmd.py and raises here until that is ported. A
spec that declares `host_embeddings()` trains its tables in the
host-spill tier (embedding/host_bridge.py `attach_from_spec`); its
checkpoints carry the engines' state and a restore reads both tiers from
one version, and every task report carries the Trainer's `tier_health`
counters as `tier/` exec counters once one is non-zero.

Training-plane tracing: a Task that carries trace ids (the master's
`task_dispatch` span) opens a `worker_task` span under it at the fetch,
with a `fetched` event (shard, start, end); the report records
`reported` and seals the span `ok` or `error` once the RPC returns, so
its duration is the task's fetch-to-report time on this worker.

`timeline` holds the wall-clock times (time.time()) at which the worker
was built (its Trainer and model on the device), first registered,
first got an answer to get_task, had its state ready (init_state and
any restore, the device synchronized) and finished its first step;
`rpc_seconds` the round-trip seconds of its recent calls, by method.
"""

import collections
import logging
import os
import time
import traceback

import numpy as np

from elasticdl_tpu_torch.checkpoint.saver import CheckpointSaver
from elasticdl_tpu_torch.common.constants import (
    MAX_MINIBATCH_RETRY_NUM,
    JobType,
    Mode,
)
from elasticdl_tpu_torch.common.model_utils import resolve_dataset_fn
from elasticdl_tpu_torch.common.retry import (
    RetryPolicy,
    is_transient_rpc_error,
    retry_call,
)
from elasticdl_tpu_torch.common.tensor_utils import serialize_ndarray_dict
from elasticdl_tpu_torch.common.timing_utils import Timing, cuda_sync
from elasticdl_tpu_torch.data.dataset import Dataset, pad_batch
from elasticdl_tpu_torch.embedding.host_bridge import (
    attach_from_spec,
    restore_with_host_state,
)
from elasticdl_tpu_torch.master.task_dispatcher import Task
from elasticdl_tpu_torch.observability.tracing import recorder
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.proto.convert import task_type_from_pb
from elasticdl_tpu_torch.proto.service import MasterStub, build_channel
from elasticdl_tpu_torch.training.trainer import Trainer
from elasticdl_tpu_torch.worker.prediction_outputs_processor import (
    resolve_processor,
)
from elasticdl_tpu_torch.worker.task_data_service import TaskDataService

logger = logging.getLogger(__name__)

#: per method, the round-trip seconds of the last calls kept
RPC_SECONDS_KEPT = 10000


def _default_retry_policy():
    """Worker RPC knobs; the environment can shrink them for drills."""
    return RetryPolicy(
        rpc_timeout_secs=float(os.environ.get("EDL_RPC_TIMEOUT_SECS", 30.0)),
        reconnect_window_secs=float(
            os.environ.get("EDL_RPC_RECONNECT_WINDOW_SECS", 120.0)
        ),
    )


class Worker(object):
    def __init__(
        self,
        worker_id,
        model_spec,
        master_addr=None,
        master_servicer=None,
        job_type=JobType.TRAINING_ONLY,
        minibatch_size=32,
        training_data=None,
        data_reader_params=None,
        records_per_task=None,
        model_params="",
        seed=0,
        callbacks=None,
        wait_sleep_secs=0.5,
        spmd=False,
        checkpoint_dir=None,
        checkpoint_steps=0,
        keep_checkpoint_max=0,
        checkpoint_dir_for_init=None,
        grad_accum_steps=1,
        retry_policy=None,
        device="cuda",
        trainable_pattern=None,
    ):
        """Connect in-process (`master_servicer`) or over the transport
        (`master_addr`). `trainable_pattern` freezes what it does not
        match, as the LocalExecutor's does (the Trainer's)."""
        if spmd:
            raise NotImplementedError(
                "Worker: the SPMD lockstep loop (spmd=True) needs "
                "parallel/spmd.py, which is not ported")
        self.worker_id = worker_id
        self.spec = model_spec
        self.job_type = job_type
        self.minibatch_size = minibatch_size
        self._channel = None
        self._master_addr = master_addr
        if master_servicer is not None:
            self._master = master_servicer
        elif master_addr:
            self._channel = build_channel(master_addr)
            self._master = MasterStub(self._channel)
        else:
            raise ValueError("need master_addr or master_servicer")
        self.trainer = Trainer(
            model_spec, model_params=model_params, seed=seed,
            grad_accum_steps=grad_accum_steps, device=device,
            trainable_pattern=trainable_pattern,
        )
        self.host_manager = attach_from_spec(self.trainer, model_spec)
        self.state = None
        self._task_data_service = TaskDataService(
            self,
            data_origin=training_data,
            data_reader_params=data_reader_params,
            custom_data_reader=getattr(model_spec, "custom_data_reader",
                                       None),
            records_per_task=records_per_task,
            wait_sleep_secs=wait_sleep_secs,
        )
        self._timing = Timing(enabled=True, logger=logger,
                              sync_device=self.trainer.device)
        self._callbacks = callbacks or []
        self._minibatch_retry_count = 0
        self._retry_policy = retry_policy or _default_retry_policy()
        # set only by the master's explicit JOB_COMPLETE signal, never
        # inferred from a transport error (see _call_master)
        self.job_complete = False
        self.rpc_retry_count = 0
        self.reconnect_count = 0
        # task id -> its open worker_task span (the task loop is one
        # thread)
        self._task_spans = {}
        self.rpc_seconds = collections.defaultdict(
            lambda: collections.deque(maxlen=RPC_SECONDS_KEPT))
        self.losses = []
        self._checkpoint_saver = None
        if checkpoint_dir and checkpoint_steps:
            self._checkpoint_saver = CheckpointSaver(
                self.trainer, checkpoint_dir,
                checkpoint_steps=checkpoint_steps,
                keep_max_version=keep_checkpoint_max,
                extra_state_fn=(self.host_manager.flat_state
                                if self.host_manager else None))
        self._checkpoint_dir_for_init = checkpoint_dir_for_init
        self.restored_version = None
        self.timeline = {"built": time.time()}

    # ------------------------------------------------------------ RPC layer

    def _rebuild_channel(self):
        """Dial the master fresh after a failed call."""
        if self._master_addr is None:
            return
        self._channel.close()
        self._channel = build_channel(self._master_addr)
        self._master = MasterStub(self._channel)

    def _call_master(self, rpc_name, request, default_after_complete=None):
        if self._channel is not None:
            def call():
                # through self._master each time: a retry may have
                # rebuilt the channel and stub
                return getattr(self._master, rpc_name)(
                    request, timeout=self._retry_policy.rpc_timeout_secs
                )
        else:
            def call():
                return getattr(self._master, rpc_name)(request)

        def attempt():
            t0 = time.perf_counter()
            out = call()
            self.rpc_seconds[rpc_name].append(time.perf_counter() - t0)
            return out

        if self.job_complete and default_after_complete is not None:
            # after the explicit end-of-job signal the master may be gone:
            # the remaining reports and polls are best effort
            try:
                return attempt()
            except Exception as e:
                if is_transient_rpc_error(e):
                    logger.info(
                        "Master gone after JOB_COMPLETE; dropping %s",
                        rpc_name,
                    )
                    return default_after_complete
                raise

        def on_retry(attempt_idx, exc):
            self.rpc_retry_count += 1
            if self._channel is not None:
                self._rebuild_channel()

        result, attempts = retry_call(
            attempt,
            policy=self._retry_policy,
            is_retryable=is_transient_rpc_error,
            on_retry=on_retry,
            what="%s(worker %s)" % (rpc_name, self.worker_id),
        )
        if attempts and rpc_name != "register_worker":
            # it took retries: the master may have restarted and lost its
            # membership, so register again
            self.reconnect_count += 1
            logger.info(
                "Reconnected to master after %d retries; re-registering",
                attempts,
            )
            self.register()
        return result

    def register(self):
        try:
            self._call_master(
                "register_worker",
                pb.RegisterWorkerRequest(
                    worker_id=self.worker_id, address="", num_devices=1
                ),
            )
            self.timeline.setdefault("registered", time.time())
        except Exception:
            logger.warning("register_worker failed", exc_info=True)

    def get_task(self, task_type=None):
        req = pb.GetTaskRequest(worker_id=self.worker_id)
        if task_type is not None:
            req.task_type = task_type
        task = self._call_master(
            "get_task",
            req,
            default_after_complete=pb.Task(
                type=pb.NONE, reason=pb.JOB_COMPLETE
            ),
        )
        self.timeline.setdefault("first_get_task", time.time())
        if task.type == pb.NONE and task.reason == pb.JOB_COMPLETE:
            if not self.job_complete:
                logger.info("Master signaled JOB_COMPLETE")
            self.job_complete = True
        if task.task_id and task.trace_id:
            span = recorder().start_span(
                "worker_task", trace_id=task.trace_id,
                parent_span_id=task.span_id, task_id=task.task_id,
                worker_id=self.worker_id)
            span.event("fetched", shard=task.shard_name, start=task.start,
                       end=task.end)
            self._task_spans[task.task_id] = span
        return task

    def report_task_result(self, task_id, err_msg="", exec_counters=None):
        req = pb.ReportTaskResultRequest(
            task_id=task_id, err_message=err_msg or ""
        )
        for k, v in (exec_counters or {}).items():
            req.exec_counters[k] = int(v)
        # the host tier's cumulative drop counters, as tier/ gauges
        if any(self.trainer.tier_health.values()):
            for k, v in self.trainer.tier_health.items():
                req.exec_counters["tier/" + k] = int(v)
        # the RPC-resilience counters ride every report
        if self.rpc_retry_count:
            req.exec_counters["fault/rpc_retries"] = self.rpc_retry_count
        if self.reconnect_count:
            req.exec_counters["fault/reconnects"] = self.reconnect_count
        span = self._task_spans.pop(task_id, None)
        if span is not None:
            span.event("reported", ok=not err_msg)
        try:
            return self._call_master(
                "report_task_result", req,
                default_after_complete=pb.Empty(),
            )
        finally:
            if span is not None:
                span.finish("ok" if not err_msg else "error")

    def report_version(self, version):
        self._call_master(
            "report_version",
            pb.ReportVersionRequest(
                worker_id=self.worker_id, model_version=int(version)
            ),
            default_after_complete=pb.Empty(),
        )

    def report_evaluation_metrics(self, outputs, labels, version):
        if not isinstance(outputs, dict):
            outputs = {"output": outputs}
        self._call_master(
            "report_evaluation_metrics",
            pb.ReportEvaluationMetricsRequest(
                worker_id=self.worker_id,
                model_version=int(version),
                model_outputs=serialize_ndarray_dict(outputs),
                labels=serialize_ndarray_dict({"labels": labels}),
            ),
            default_after_complete=pb.Empty(),
        )

    # ----------------------------------------------------------- train loop

    def _task_from_pb(self, task_pb):
        return Task(
            task_pb.shard_name,
            task_pb.start,
            task_pb.end,
            task_type_from_pb(task_pb.type),
            model_version=task_pb.model_version,
        )

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
        cuda_sync(self.trainer.device)
        self.timeline["state_ready"] = time.time()

    def _maybe_checkpoint(self):
        """Save on the checkpoint_steps cadence. Never raises: a failed
        save must not fail (or retry) the step already applied."""
        if self._checkpoint_saver is None or self.state is None:
            return
        try:
            self._checkpoint_saver.maybe_save(self.state)
        except Exception:
            logger.warning("checkpoint save failed", exc_info=True)

    def _process_minibatch(self, batch, true_count):
        """Train one minibatch, retrying runtime failures; returns the
        error message, "" on success."""
        err = ""
        for attempt in range(MAX_MINIBATCH_RETRY_NUM):
            try:
                self._ensure_state(batch)
                self.state, loss = self.trainer.train_step(
                    self.state, batch, true_count
                )
                self.losses.append(float(loss))
                self.timeline.setdefault("first_step", time.time())
                break
            except (ValueError, TypeError, NotImplementedError):
                # deterministic failures do not heal with retries
                raise
            except Exception as e:
                err = "%s" % e
                logger.warning(
                    "minibatch failed (attempt %d): %s", attempt + 1, err
                )
                self._minibatch_retry_count += 1
        else:
            return err or "minibatch failed"
        self._maybe_checkpoint()
        return ""

    def _train_and_evaluate(self):
        while True:
            dataset = self._task_data_service.get_dataset()
            if dataset is None:
                self._process_train_end_callback_task_if_needed()
                break
            reader = self._task_data_service.data_reader
            dataset = resolve_dataset_fn(self.spec, reader)(
                dataset, Mode.TRAINING, reader.metadata)
            dataset = dataset.batch(self.minibatch_size).prefetch(1)
            self._timing.start_record_time("task_process")
            stream_err = ""
            for batch in dataset:
                if self.job_type == JobType.TRAINING_WITH_EVALUATION:
                    self._evaluate_only()
                padded, n = pad_batch(batch, self.minibatch_size)
                with self._timing.record("batch_process"):
                    err_msg = self._process_minibatch(padded, n)
                if err_msg:
                    stream_err = err_msg
                else:
                    self.report_version(int(self.state.step))
                if self._task_data_service.report_record_done(n, err_msg):
                    self._timing.end_record_time("task_process")
                    self._timing.report_timing(reset=True)
                    self._timing.start_record_time("task_process")
            # the stream ended normally: complete the tasks row counts
            # could not cover; a failure in it fails them (retried)
            self._task_data_service.flush_record_accounting(stream_err)
            if self.job_type == JobType.TRAINING_WITH_EVALUATION:
                self._evaluate_only()
            self._process_train_end_callback_task_if_needed()

    def _evaluate_only(self):
        """Drain the master's evaluation queue; True when a task ran."""
        executed = False
        while True:
            task_pb = self.get_task(pb.EVALUATION)
            if not task_pb.shard_name:
                break
            self._process_eval_task(task_pb)
            executed = True
        return executed

    def _process_eval_task(self, task_pb):
        ds = self._task_dataset(self._task_from_pb(task_pb), Mode.EVALUATION)
        err = ""
        try:
            for batch in ds:
                padded, n = pad_batch(batch, self.minibatch_size)
                self._ensure_state(padded)
                outputs, labels = self.trainer.evaluate_batch(
                    self.state, padded, n
                )
                self.report_evaluation_metrics(
                    outputs, labels, task_pb.model_version
                )
        except Exception as e:
            err = "%s" % e
            logger.error("eval task failed: %s", traceback.format_exc())
        self.report_task_result(task_pb.task_id, err)

    def _predict_only(self):
        process_outputs = resolve_processor(
            self.spec.prediction_outputs_processor
        )
        results = []
        while True:
            task_pb = self.get_task()
            if not task_pb.shard_name:
                if task_pb.type == pb.WAIT:
                    time.sleep(self._task_data_service._wait_sleep_secs)
                    continue
                break
            ds = self._task_dataset(
                self._task_from_pb(task_pb), Mode.PREDICTION
            )
            err = ""
            try:
                for batch in ds:
                    padded, n = pad_batch(batch, self.minibatch_size)
                    self._ensure_state(padded)
                    preds, _ = self.trainer.evaluate_batch(
                        self.state, padded, n
                    )
                    results.append(preds)
                    if process_outputs is not None:
                        process_outputs(preds, self.worker_id)
            except Exception as e:
                err = "%s" % e
                logger.error(
                    "prediction task failed: %s", traceback.format_exc()
                )
            self.report_task_result(task_pb.task_id, err)
        if not results:
            return np.array([])
        if isinstance(results[0], dict):
            return {k: np.concatenate([r[k] for r in results], axis=0)
                    for k in results[0]}
        return np.concatenate(results, axis=0)

    def _process_train_end_callback_task_if_needed(self):
        task_pb = self._task_data_service.get_train_end_callback_task()
        if task_pb is None:
            return
        err = ""
        try:
            for cb in self._callbacks:
                if hasattr(cb, "on_train_end"):
                    cb.on_train_end(self)
        except Exception as e:
            err = "%s" % e
            logger.error(
                "train-end callback failed: %s", traceback.format_exc()
            )
        self._task_data_service.clear_train_end_callback_task()
        self.report_task_result(task_pb.task_id, err)

    def _task_dataset(self, task, mode):
        """Batched dataset over one task's records (the evaluation and
        prediction paths)."""
        reader = self._task_data_service.data_reader
        ds = Dataset.from_generator(lambda: reader.read_records(task))
        ds = resolve_dataset_fn(self.spec, reader)(ds, mode, reader.metadata)
        return ds.batch(self.minibatch_size)

    def run(self):
        self.register()
        if self.job_type in (
            JobType.TRAINING_ONLY,
            JobType.TRAINING_WITH_EVALUATION,
        ):
            self._train_and_evaluate()
            return self.state
        if self.job_type == JobType.EVALUATION_ONLY:
            self._evaluate_only()
            return self.state
        if self.job_type == JobType.PREDICTION_ONLY:
            return self._predict_only()
        raise ValueError("Unknown job type %s" % self.job_type)

    def close(self):
        if self._checkpoint_saver is not None:
            self._checkpoint_saver.wait()
        if self._channel is not None:
            self._channel.close()
