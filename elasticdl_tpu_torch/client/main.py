"""The client CLI: the port's copy of elasticdl_tpu/client/main.py.

    python -m elasticdl_tpu_torch.client.main train \\
        --model_zoo elasticdl_tpu_torch/model_zoo \\
        --model_def transformer_lm.custom_model \\
        --model_params "vocab_size=32000; ...; dtype='bf16'" \\
        --training_data DIR --minibatch_size 8 --num_workers 2 \\
        [--device cuda|cpu] [--checkpoint_dir D --checkpoint_steps N] \\
        [--job_status_file F]

`train`, `evaluate` and `predict` run the master in this process, which
launches the workers as subprocesses (client/api.py). `zoo
init|build|push` and --image_name (Kubernetes) are not ported and
raise.
"""

import argparse
import sys

from elasticdl_tpu_torch.client import api
from elasticdl_tpu_torch.common.args import (
    add_common_params,
    add_master_params,
)


def _add_job_params(parser):
    add_common_params(parser)
    add_master_params(parser)
    parser.add_argument(
        "--image_name", default="",
        help="Job image (Kubernetes; not ported): leave empty to run the "
             "master here",
    )
    parser.add_argument(
        "--master_resource_request", default="cpu=0.1,memory=1024Mi"
    )
    parser.add_argument("--master_resource_limit", default="")
    parser.add_argument("--master_pod_priority", default="")
    parser.add_argument(
        "--detach", action="store_true",
        help="Don't monitor the submitted job",
    )


def build_argument_parser():
    parser = argparse.ArgumentParser(prog="elasticdl-tpu-torch")
    subparsers = parser.add_subparsers(dest="command")
    subparsers.required = True

    zoo_parser = subparsers.add_parser(
        "zoo", help="Manage model-zoo images (not ported)"
    )
    zoo_sub = zoo_parser.add_subparsers(dest="zoo_command")
    zoo_sub.required = True
    for name, fn in (("init", api.init_zoo), ("build", api.build_zoo),
                     ("push", api.push_zoo)):
        zoo_sub.add_parser(name).set_defaults(func=fn)

    for name, fn, what in (("train", api.train, "a training job"),
                           ("evaluate", api.evaluate, "an evaluation job"),
                           ("predict", api.predict, "a prediction job")):
        p = subparsers.add_parser(name, help="Run %s" % what)
        _add_job_params(p)
        p.set_defaults(func=fn)
    return parser


def main(argv=None):
    parser = build_argument_parser()
    args, extra = parser.parse_known_args(args=argv)
    return args.func(args, extra) or 0


if __name__ == "__main__":
    sys.exit(main())
