"""Flags of the master, the worker and the client: the port's copy of
elasticdl_tpu/common/args.py.

The same declarative adders and the same propagation model: parsed args
are serialized back into child command lines
(`build_arguments_from_parsed_result`), which is how the master hands
its flags to the workers it launches. The port adds `--device` (default
"cuda"; "cpu" runs the kernels' plain versions, as the tests do), which
reaches every worker.

A flag the port does not honour raises when it is set to anything but
its default, instead of being ignored (`check_ported_args`):
--worker_image (Kubernetes workers), --distribution_strategy
AllreduceStrategy (the SPMD lockstep loop) and --mesh_spec. The
master's /metrics port (--metrics_port, or EDL_METRICS_PORT when the
flag is -1) and its TensorBoard service (--need_tensorboard, writing
under --tensorboard_log_dir) are honoured (master/main.py).
"""

import argparse
import shlex
import warnings

# master-only flags that must not propagate into worker command lines
MASTER_ONLY_ARGS = {
    "port", "num_workers", "worker_image", "namespace",
    "worker_pod_priority", "worker_resource_request",
    "worker_resource_limit", "relaunch_on_worker_failure",
    "disable_relaunch", "task_timeout_check_interval", "cluster_spec",
    "image_pull_policy", "restart_policy", "volume", "need_tensorboard",
    "tensorboard_log_dir", "export_saved_model", "job_status_file",
    "job_state_dir",
}

METRICS_PORT_ENV = "EDL_METRICS_PORT"

# flag -> (its default, what is missing); set to anything else, it raises
_NOT_PORTED = {
    "worker_image": ("", "Kubernetes workers (K8sInstanceManager)"),
    "distribution_strategy": (
        "Local", "the SPMD lockstep loop (parallel/spmd.py)"),
    "mesh_spec": ("", "device meshes through the CLI"),
}


def pos_int(arg):
    res = int(arg)
    if res <= 0:
        raise ValueError("Positive integer argument required, got %s" % res)
    return res


def non_neg_int(arg):
    res = int(arg)
    if res < 0:
        raise ValueError(
            "Non-negative integer argument required, got %s" % res
        )
    return res


def add_bool_param(parser, name, default, help):
    parser.add_argument(
        name,
        nargs="?",
        const=not default,
        default=default,
        type=lambda x: x.lower() in ["true", "yes", "t", "y"],
        help=help,
    )


def add_common_params(parser):
    """Flags shared by client, master and worker."""
    parser.add_argument(
        "--job_name", default="elasticdl-job", help="Job name"
    )
    parser.add_argument(
        "--model_zoo", required=True,
        help="Directory containing the model-zoo modules",
    )
    parser.add_argument(
        "--model_def", required=True,
        help="Dotted path to the model function inside the zoo, e.g. "
             "transformer_lm.custom_model",
    )
    parser.add_argument(
        "--model_params", default="",
        help="Model constructor kwargs, 'k1=v1; k2=v2'",
    )
    parser.add_argument("--minibatch_size", type=pos_int, default=32)
    parser.add_argument(
        "--grad_accum_steps", "--get_model_steps", dest="grad_accum_steps",
        type=pos_int, default=1,
        help="Apply the dense optimizer every N minibatches on the "
             "averaged gradient",
    )
    parser.add_argument("--num_epochs", type=pos_int, default=1)
    parser.add_argument(
        "--records_per_task", type=pos_int, default=256,
        help="Records per dynamic-sharding task",
    )
    parser.add_argument("--training_data", default="")
    parser.add_argument("--validation_data", default="")
    parser.add_argument("--prediction_data", default="")
    parser.add_argument(
        "--data_reader_params", default="",
        help="Data reader kwargs, 'k1=v1; k2=v2'",
    )
    parser.add_argument("--evaluation_steps", type=non_neg_int, default=0)
    parser.add_argument(
        "--eval_start_delay_secs", type=non_neg_int, default=0
    )
    parser.add_argument("--eval_throttle_secs", type=non_neg_int, default=0)
    parser.add_argument("--checkpoint_dir", default="")
    parser.add_argument("--checkpoint_steps", type=non_neg_int, default=0)
    parser.add_argument(
        "--keep_checkpoint_max", type=non_neg_int, default=0
    )
    parser.add_argument("--checkpoint_dir_for_init", default="")
    parser.add_argument(
        "--output", default="",
        help="Directory for the exported model at train end",
    )
    parser.add_argument(
        "--mesh_spec", default="",
        help="Device mesh axis sizes (not ported: raises when set)",
    )
    parser.add_argument(
        "--distribution_strategy", default="Local",
        choices=["Local", "AllreduceStrategy"],
        help="Local = each worker on its own; AllreduceStrategy (SPMD "
             "lockstep) is not ported and raises",
    )
    parser.add_argument("--log_level", default="INFO")
    parser.add_argument("--seed", type=int, default=0)
    add_bool_param(
        parser, "--use_go_ps", False,
        help="Accepted for CLI compatibility; ignored (there is no "
             "parameter server)",
    )
    parser.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="Where workers train: cuda runs the hand-written kernels "
             "(and raises without a card); cpu their plain versions",
    )


def add_master_params(parser):
    parser.add_argument("--port", type=non_neg_int, default=50001)
    parser.add_argument("--num_workers", type=non_neg_int, default=0)
    parser.add_argument(
        "--worker_image", default="",
        help="Worker container image (Kubernetes; not ported)",
    )
    parser.add_argument(
        "--namespace", default="default", help="Kubernetes namespace"
    )
    parser.add_argument("--worker_pod_priority", default="")
    parser.add_argument(
        "--worker_resource_request", default="cpu=1,memory=4096Mi",
    )
    parser.add_argument("--worker_resource_limit", default="")
    parser.add_argument(
        "--relaunch_on_worker_failure", type=non_neg_int, default=3,
        help="Max relaunches per worker",
    )
    add_bool_param(
        parser, "--disable_relaunch", False,
        help="Never relaunch failed workers",
    )
    parser.add_argument(
        "--task_timeout_check_interval", type=pos_int, default=30
    )
    parser.add_argument("--cluster_spec", default="")
    parser.add_argument(
        "--image_pull_policy", default="Always",
        choices=["Always", "IfNotPresent", "Never"],
    )
    parser.add_argument("--restart_policy", default="Never")
    parser.add_argument("--volume", default="")
    add_bool_param(
        parser, "--need_tensorboard", False,
        help="Start a TensorBoard service on the master (not ported)",
    )
    parser.add_argument("--tensorboard_log_dir", default="")
    add_bool_param(
        parser, "--export_saved_model", False,
        help="Queue the TRAIN_END_CALLBACK task at train end",
    )
    parser.add_argument(
        "--job_status_file", default="",
        help="Write the job phase (Pending/Running/Succeeded/Failed) to "
             "this JSON file",
    )
    parser.add_argument(
        "--job_state_dir", default="",
        help="Directory for the master's journal and snapshot of the "
             "dispatcher (master/state_store.py); a relaunched master "
             "pointed at it resumes the job",
    )
    parser.add_argument(
        "--metrics_port", type=int, default=-1,
        help="The master's /metrics port; -1 resolves from "
             "EDL_METRICS_PORT (unset = off), 0 = an ephemeral one",
    )


def add_worker_params(parser):
    parser.add_argument("--worker_id", type=non_neg_int, required=True)
    parser.add_argument(
        "--master_addr", required=True, help="host:port of the master"
    )
    parser.add_argument(
        "--job_type", default="training_only",
        choices=[
            "training_only",
            "training_with_evaluation",
            "evaluation_only",
            "prediction_only",
        ],
    )
    parser.add_argument(
        "--num_minibatches_per_task", type=pos_int, default=8
    )
    parser.add_argument("--coordinator_addr", default="")
    parser.add_argument("--num_processes", type=non_neg_int, default=0)
    parser.add_argument("--process_id", type=non_neg_int, default=0)


def check_ported_args(args):
    """Raise NotImplementedError for a flag set to what the port does not
    do; flags the namespace lacks are skipped."""
    for name, (default, what) in _NOT_PORTED.items():
        if hasattr(args, name) and getattr(args, name) != default:
            raise NotImplementedError(
                "--%s=%r needs %s, which is not ported"
                % (name, getattr(args, name), what))
    return args


def _parse(parser, args, what):
    parsed, unknown = parser.parse_known_args(args=args)
    if unknown:
        warnings.warn("Unknown %s args: %s" % (what, unknown))
    return check_ported_args(parsed)


def parse_master_args(args=None):
    parser = argparse.ArgumentParser(description="ElasticDL master (port)")
    add_common_params(parser)
    add_master_params(parser)
    return _parse(parser, args, "master")


def parse_worker_args(args=None):
    parser = argparse.ArgumentParser(description="ElasticDL worker (port)")
    add_common_params(parser)
    add_worker_params(parser)
    return _parse(parser, args, "worker")


def build_arguments_from_parsed_result(args, filter_args=None):
    """The command-line list of a parsed namespace: how flags propagate
    from the master to the workers."""
    items = vars(args).items()
    if filter_args:
        items = [(k, v) for k, v in items if k not in filter_args]
    arguments = []
    for key, value in sorted(items):
        if value is None or value == "":
            continue
        if isinstance(value, bool):
            value = "true" if value else "false"
        arguments.extend(["--" + key, str(value)])
    return arguments


def wrap_args_with_string(arguments):
    """Shell-quote an argument list into one string."""
    return " ".join(shlex.quote(a) for a in arguments)


def parse_resource_spec(spec):
    """'cpu=1,memory=4096Mi' -> {'cpu': '1', 'memory': '4096Mi'}."""
    out = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        out[k.strip()] = v.strip()
    return out
