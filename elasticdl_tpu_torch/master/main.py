"""Master process entry point: the port's copy of
elasticdl_tpu/master/main.py for the no-cluster path.

    python -m elasticdl_tpu_torch.master.main --model_zoo DIR \\
        --model_def transformer_lm.custom_model --training_data DIR \\
        --num_workers 2 [--device cuda|cpu] [--job_status_file F] ...

It builds the Master, binds its port, launches --num_workers local
worker processes with the master's flags (less the master-only ones),
serves until the job is done and writes the job's phase to
--job_status_file. The master itself never touches the device; the
workers train on --device (cuda by default).

The task shuffle is drawn from Python's `random` seeded with --seed, so
one job's task order repeats from run to run. `--metrics_port N` (-1
resolves from EDL_METRICS_PORT, unset = off; 0 = an ephemeral port)
serves the master's Prometheus page at `GET /metrics` (queue depths, the
model version, restarts and requeued tasks) and prints `METRICS_READY
port=N`. Kubernetes workers (--worker_image) and the TensorBoard service
are not ported and raise (common/args.py).
"""

import logging
import random
import sys

from elasticdl_tpu_torch.api.callbacks import CallbackList
from elasticdl_tpu_torch.common import job_status
from elasticdl_tpu_torch.common.args import (
    MASTER_ONLY_ARGS,
    build_arguments_from_parsed_result,
    parse_master_args,
)
from elasticdl_tpu_torch.common.model_utils import (
    get_model_spec,
    resolve_dataset_fn,
)
from elasticdl_tpu_torch.data.reader.data_reader_factory import (
    build_data_reader,
)
from elasticdl_tpu_torch.master.instance_manager import LocalInstanceManager
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.observability.metrics import (
    MetricsServer,
    counter_family,
    gauge_family,
    metrics_port_default,
)

logger = logging.getLogger(__name__)


def _infer_job_type(args):
    if args.prediction_data and not args.training_data:
        return "prediction_only"
    if args.validation_data and not args.training_data:
        return "evaluation_only"
    if args.validation_data:
        return "training_with_evaluation"
    return "training_only"


def build_worker_args(args, master_addr):
    worker_args = build_arguments_from_parsed_result(
        args, filter_args=MASTER_ONLY_ARGS
    )
    worker_args += [
        "--master_addr", master_addr,
        "--job_type", _infer_job_type(args),
    ]
    return worker_args


def create_instance_manager(args, task_d, master_port, log_dir=None):
    """Local worker subprocesses, or None without --num_workers."""
    if args.num_workers <= 0:
        return None
    if args.worker_image:
        raise NotImplementedError(
            "Kubernetes workers (--worker_image) are not ported")
    return LocalInstanceManager(
        task_d,
        num_workers=args.num_workers,
        worker_args=build_worker_args(args, "localhost:%d" % master_port),
        relaunch_on_worker_failure=args.relaunch_on_worker_failure,
        disable_relaunch=args.disable_relaunch,
        log_dir=log_dir,
    )


def _validate_dataset_fn(spec, args):
    """A spec may omit dataset_fn only when its data reader provides
    one: check at submission, not in every worker's first task."""
    if spec.dataset_fn is not None:
        return
    data = (args.training_data or args.validation_data
            or args.prediction_data)
    reader = build_data_reader(
        data, args.records_per_task, args.data_reader_params,
        custom_data_reader=spec.custom_data_reader,
    )
    resolve_dataset_fn(spec, reader)


def _run_master(args):
    spec = get_model_spec(args.model_zoo, args.model_def)
    _validate_dataset_fn(spec, args)
    callbacks_list = None
    if spec.callbacks_fn is not None:
        callbacks_list = CallbackList(spec.callbacks_fn())
    # the task shuffle: one order for one seed
    random.seed(args.seed)
    master = Master(
        spec,
        training_data=args.training_data or None,
        validation_data=args.validation_data or None,
        prediction_data=args.prediction_data or None,
        minibatch_size=args.minibatch_size,
        records_per_task=args.records_per_task,
        num_epochs=args.num_epochs,
        evaluation_steps=args.evaluation_steps,
        eval_start_delay_secs=args.eval_start_delay_secs,
        eval_throttle_secs=args.eval_throttle_secs,
        port=args.port,
        task_timeout_check_interval=args.task_timeout_check_interval,
        callbacks_list=callbacks_list,
        export_saved_model=args.export_saved_model,
        checkpoint_dir_for_init=args.checkpoint_dir_for_init or None,
        job_state_dir=args.job_state_dir or None,
    )
    if master.state_store and master.state_store.is_job_complete():
        logger.info("Job already complete per %s; nothing to do",
                    args.job_state_dir)
        return 0
    # the port is bound in prepare(); the workers need it
    master.prepare()
    instance_manager = create_instance_manager(args, master.task_d,
                                               master.port)
    master.instance_manager = instance_manager
    if instance_manager:
        instance_manager.start_workers()
    logger.info("Master ready on port %d", master.port)
    metrics = _start_metrics(args, master)
    job_status.write_job_status(args.job_status_file, job_status.RUNNING)
    try:
        return master.run()
    finally:
        if metrics is not None:
            metrics.close()


def _metrics_families(master):
    """The master's exposition: task-queue pressure, the model version
    and the crash-recovery counters."""
    todo, doing, eval_todo = master.task_d.queue_depths()
    restarts = (master.state_store.restart_count
                if master.state_store else 0)
    return [
        gauge_family("edl_master_tasks_todo", "training tasks queued",
                     [({}, todo)]),
        gauge_family("edl_master_tasks_doing",
                     "training tasks dispatched and in flight",
                     [({}, doing)]),
        gauge_family("edl_master_eval_tasks_todo", "evaluation tasks queued",
                     [({}, eval_todo)]),
        gauge_family("edl_master_model_version", "dispatcher model version",
                     [({}, master.task_d.model_version)]),
        counter_family("edl_master_restarts_total",
                       "master crash recoveries", restarts),
        counter_family("edl_master_recovery_requeued_tasks_total",
                       "doing-tasks requeued by journal recovery",
                       master.task_d.requeued_on_recovery),
    ]


def _start_metrics(args, master):
    """The master's /metrics server (--metrics_port, or EDL_METRICS_PORT
    when it is -1; off when neither is set), or None."""
    port = (metrics_port_default() if args.metrics_port < 0
            else args.metrics_port)
    if port is None:
        return None
    server = MetricsServer(lambda: _metrics_families(master), port=port)
    logger.info("Master /metrics exposition on port %d", server.port)
    print("METRICS_READY port=%d" % server.port, flush=True)
    return server


def main(argv=None):
    args = parse_master_args(argv)
    logging.basicConfig(
        level=args.log_level,
        format="[%(asctime)s] [%(levelname)s] [master] %(message)s")
    status_file = args.job_status_file
    job_status.write_job_status(status_file, job_status.PENDING)
    try:
        rc = _run_master(args)
    except BaseException:
        job_status.write_job_status(status_file, job_status.FAILED)
        raise
    job_status.write_job_status(
        status_file,
        job_status.SUCCEEDED if rc == 0 else job_status.FAILED,
    )
    return rc


if __name__ == "__main__":
    sys.exit(main())
