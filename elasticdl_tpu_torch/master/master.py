"""The master: the port's copy of elasticdl_tpu/master/master.py.

It builds the dispatcher (master/task_dispatcher.py, journaled to
`job_state_dir` when one is given), the evaluation service, the servicer
(wrapped by the fault injector when a spec is active) behind the port's
transport (proto/service.py), and, when given one, the instance manager
that launches the workers; `run` waits for the job with the straggler
watchdog (`check_timeout_tasks`) and `stop` tears it all down. A
`tensorboard_service` (master/tensorboard_service.py) receives the
evaluation metrics and the servicer's worker gauges; `prepare` starts
it and writes the recovery gauges (`master/restarts`,
`master/recovery_requeued_tasks`) when a state store exists, `stop`
stops it after the evaluation service.

The master never touches the device: it serves tasks and aggregates
evaluation outputs on the host, so a process that runs it (the CLI, a
test) keeps CUDA uninitialized for its worker processes.
"""

import logging
import threading
import time

from elasticdl_tpu_torch.checkpoint.saver import get_latest_checkpoint_version
from elasticdl_tpu_torch.common.fault_injection import maybe_wrap_servicer
from elasticdl_tpu_torch.data.reader.data_reader_factory import (
    create_data_reader,
)
from elasticdl_tpu_torch.master.evaluation_service import EvaluationService
from elasticdl_tpu_torch.master.servicer import MasterServicer
from elasticdl_tpu_torch.master.state_store import JobStateStore
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher, TaskType
from elasticdl_tpu_torch.proto.service import (
    add_master_servicer_to_server,
    build_server,
)

logger = logging.getLogger(__name__)

#: how long a finished master keeps answering JOB_COMPLETE before it stops
SHUTDOWN_LINGER_SECS = 2.0


class Master(object):
    def __init__(
        self,
        model_spec,
        training_data=None,
        validation_data=None,
        prediction_data=None,
        minibatch_size=32,
        records_per_task=256,
        num_epochs=1,
        evaluation_steps=0,
        eval_start_delay_secs=0,
        eval_throttle_secs=0,
        port=0,
        instance_manager=None,
        task_timeout_check_interval=30,
        callbacks_list=None,
        export_saved_model=False,
        tensorboard_service=None,
        checkpoint_dir_for_init=None,
        job_state_dir=None,
    ):
        self.spec = model_spec
        self.minibatch_size = minibatch_size

        def shards_of(data):
            if not data:
                return {}
            return create_data_reader(data, records_per_task).create_shards()

        # crash recovery: the dispatcher journals every task transition;
        # a relaunched master restores todo and the requeued doing set
        self.state_store = None
        if job_state_dir:
            self.state_store = JobStateStore(job_state_dir)
            if self.state_store.has_state():
                logger.info(
                    "Recovering master state from %s (restart #%d)",
                    job_state_dir, self.state_store.restart_count,
                )

        self.task_d = TaskDispatcher(
            shards_of(training_data),
            shards_of(validation_data),
            shards_of(prediction_data),
            records_per_task,
            num_epochs,
            callbacks_list=callbacks_list,
            state_store=self.state_store,
        )
        if export_saved_model and training_data:
            self.task_d.add_deferred_callback_create_train_end_task()
        # master-side callbacks acting on the dispatcher (MaxStepsStopping)
        if callbacks_list is not None:
            for cb in callbacks_list.callbacks:
                if hasattr(cb, "set_task_dispatcher"):
                    cb.set_task_dispatcher(self.task_d)
        # resume: check the init checkpoint here, and count max_steps
        # from its version
        if checkpoint_dir_for_init:
            version = get_latest_checkpoint_version(checkpoint_dir_for_init)
            if version < 0:
                raise ValueError(
                    "Invalid checkpoint directory %r"
                    % checkpoint_dir_for_init
                )
            if callbacks_list is not None:
                for cb in callbacks_list.callbacks:
                    if hasattr(cb, "set_completed_steps"):
                        cb.set_completed_steps(version)

        eval_only = bool(validation_data) and not training_data
        self.tensorboard_service = tensorboard_service
        self.evaluation_service = None
        if validation_data:
            self.evaluation_service = EvaluationService(
                tensorboard_service,
                self.task_d,
                eval_start_delay_secs,
                eval_throttle_secs,
                evaluation_steps,
                eval_only,
                model_spec.eval_metrics_fn,
            )
            self.task_d.set_evaluation_service(self.evaluation_service)

        # EDL_FAULT_SPEC arms the fault injector on the five methods
        self.servicer = maybe_wrap_servicer(MasterServicer(
            minibatch_size, self.task_d,
            evaluation_service=self.evaluation_service,
            tensorboard_service=tensorboard_service))
        self.instance_manager = instance_manager
        self._port = port
        self._server = None
        self.port = None
        self._task_timeout_check_interval = task_timeout_check_interval
        self._watchdog_stopper = threading.Event()

    # ------------------------------------------------------------ lifecycle

    def prepare(self):
        """Start the service, the evaluation trigger, the TensorBoard
        service and the workers."""
        server = build_server()
        add_master_servicer_to_server(self.servicer, server)
        self.port = server.add_insecure_port("[::]:%d" % self._port)
        server.start()
        self._server = server
        logger.info("Master server started on port %d", self.port)
        if self.evaluation_service:
            self.evaluation_service.start()
        if self.tensorboard_service:
            self.tensorboard_service.start()
        if self.instance_manager:
            self.instance_manager.start_workers()
        self._start_watchdog()
        self._write_recovery_gauges()

    def _write_recovery_gauges(self):
        """The crash-recovery counters as TensorBoard gauges at the
        restart count: master/restarts and the tasks requeued from the
        pre-crash doing set."""
        if not (self.tensorboard_service and self.state_store):
            return
        restarts = self.state_store.restart_count
        self.tensorboard_service.write_dict_to_summary(
            {"master/restarts": restarts,
             "master/recovery_requeued_tasks":
                 self.task_d.requeued_on_recovery},
            version=restarts)

    def run(self, poll_interval=1.0):
        """Block until every task is done, then linger and stop."""
        try:
            while not self.task_d.finished():
                if (
                    self.instance_manager
                    and self.instance_manager.all_workers_failed()
                ):
                    raise RuntimeError("All workers failed")
                time.sleep(poll_interval)
            # serve the deferred train-end callback task, if any
            while True:
                if self.task_d.finished():
                    if not self.task_d.invoke_deferred_callback():
                        break
                time.sleep(poll_interval)
            if self.state_store:
                # a relaunched master must not redo a finished job
                self.state_store.mark_job_complete()
            # linger so polling workers read the explicit JOB_COMPLETE
            # instead of racing the teardown into their retry path
            time.sleep(SHUTDOWN_LINGER_SECS)
        finally:
            self.stop()
        return 0

    def stop(self):
        self._watchdog_stopper.set()
        if self.evaluation_service:
            self.evaluation_service.stop()
        # after the evaluation service: late metrics must not reopen the
        # writer
        if self.tensorboard_service:
            self.tensorboard_service.stop()
        if self.instance_manager:
            self.instance_manager.stop()
        if self._server:
            self._server.stop(grace=1.0)
            self._server = None
        if self.state_store:
            self.state_store.close()

    # ------------------------------------------------------------ watchdog

    def _start_watchdog(self):
        t = threading.Thread(
            target=self._check_timeout_tasks_loop, daemon=True
        )
        t.start()

    def _check_timeout_tasks_loop(self):
        while not self._watchdog_stopper.wait(
            self._task_timeout_check_interval
        ):
            self.check_timeout_tasks()

    def check_timeout_tasks(self):
        """Straggler watchdog: a task running longer than 3x its type's
        average completion time is requeued and its worker removed."""
        avg_time = self.servicer.get_average_task_complete_time()
        now = time.time()
        for task_id, (worker_id, task, start_time) in (
            self.task_d.doing_tasks().items()
        ):
            if task.type not in (TaskType.TRAINING, TaskType.EVALUATION):
                continue
            if now - start_time > 3 * avg_time.get(task.type, 300.0):
                logger.info(
                    "Task %d timed out on worker %s; recovering",
                    task_id, worker_id,
                )
                self.task_d.recover_tasks(worker_id)
                if self.instance_manager:
                    self.instance_manager.remove_worker(worker_id)
