"""Worker process entry point: the port's copy of
elasticdl_tpu/worker/main.py. Parse the flags, connect to the master,
run the task loop. The local instance manager launches it as

    python -m elasticdl_tpu_torch.worker.main --worker_id N \\
        --master_addr localhost:PORT --model_zoo DIR --model_def ... \\
        [--device cuda|cpu] ...

It trains on the card unless --device cpu is passed, and raises when
the card is missing.
"""

import json
import logging
import sys
import time

from elasticdl_tpu_torch.common.args import parse_worker_args
from elasticdl_tpu_torch.common.model_utils import (
    get_dict_from_params_str,
    get_model_spec,
)
from elasticdl_tpu_torch.worker.worker import Worker

logger = logging.getLogger(__name__)


def build_worker(args):
    spec = get_model_spec(args.model_zoo, args.model_def)
    return Worker(
        args.worker_id,
        spec,
        master_addr=args.master_addr,
        job_type=args.job_type,
        minibatch_size=args.minibatch_size,
        training_data=args.training_data or None,
        data_reader_params=get_dict_from_params_str(
            args.data_reader_params
        ),
        records_per_task=args.records_per_task,
        model_params=args.model_params,
        seed=args.seed,
        checkpoint_dir=args.checkpoint_dir or None,
        checkpoint_steps=args.checkpoint_steps,
        keep_checkpoint_max=args.keep_checkpoint_max,
        checkpoint_dir_for_init=args.checkpoint_dir_for_init or None,
        grad_accum_steps=args.grad_accum_steps,
        device=args.device,
    )


def main(argv=None):
    t_main = time.time()
    args = parse_worker_args(argv)
    logging.basicConfig(
        level=args.log_level,
        format="[%(asctime)s] [%(levelname)s] [worker] %(message)s")
    logger.info(
        "Worker %d starting, master=%s", args.worker_id, args.master_addr
    )
    worker = build_worker(args)
    try:
        worker.run()
    finally:
        worker.close()
    # one JSON line of wall-clock stamps (main: the imports are done)
    logger.info("worker %d timeline %s", args.worker_id,
                json.dumps(dict(worker.timeline, main=t_main)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
