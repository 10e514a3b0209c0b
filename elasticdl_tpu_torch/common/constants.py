"""Constants the port shares with the JAX package
(elasticdl_tpu/common/constants.py), kept as its own copy."""


class Mode(object):
    """Job modes."""

    TRAINING = "training"
    EVALUATION = "evaluation"
    PREDICTION = "prediction"


#: a failed task is re-queued at most this many times
MAX_TASK_RETRIES = 3
