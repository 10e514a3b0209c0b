"""Job submission on the no-cluster path: the port's copy of the job
part of elasticdl_tpu/client/api.py.

`train`, `evaluate` and `predict` rebuild the master's command line from
the parsed client args (`build_master_args`) and run the master
(master/main.py) in this process; it launches the worker processes.
Submitting the master as a Kubernetes pod (--image_name) and the zoo
commands (init / build / push, which build container images) are not
ported and raise.
"""

import logging

from elasticdl_tpu_torch.common.args import build_arguments_from_parsed_result

logger = logging.getLogger(__name__)

# flags that belong to the client only, never to the master process
_CLIENT_ONLY_ARGS = {
    "command", "zoo_command", "func", "image_name", "detach",
    "master_resource_request", "master_resource_limit",
    "master_pod_priority",
}


def _zoo_not_ported(args, extra=None):
    raise NotImplementedError(
        "`zoo %s` builds container images for Kubernetes jobs, which the "
        "port does not run" % getattr(args, "zoo_command", ""))


init_zoo = build_zoo = push_zoo = _zoo_not_ported


def train(args, extra=None):
    return _submit_job(args, extra, job_mode="train")


def evaluate(args, extra=None):
    _require(args.validation_data, "--validation_data")
    args.training_data = ""
    return _submit_job(args, extra, job_mode="evaluate")


def predict(args, extra=None):
    _require(args.prediction_data, "--prediction_data")
    args.training_data = ""
    args.validation_data = ""
    return _submit_job(args, extra, job_mode="predict")


def _require(value, flag):
    if not value:
        raise ValueError("%s is required for this command" % flag)


def build_master_args(args, extra=None):
    """The master's command line from the parsed client args."""
    master_args = build_arguments_from_parsed_result(
        args, filter_args=_CLIENT_ONLY_ARGS
    )
    return master_args + list(extra or [])


def _submit_job(args, extra, job_mode):
    if args.image_name:
        raise NotImplementedError(
            "--image_name submits the master as a Kubernetes pod, which is "
            "not ported; leave it empty to run the master here")
    master_args = build_master_args(args, extra)
    from elasticdl_tpu_torch.master.main import main as master_main

    logger.info("Running local master (%s)", job_mode)
    return master_main(master_args)
