"""Constants the port shares with the JAX package
(elasticdl_tpu/common/constants.py), kept as its own copy."""


class Mode(object):
    """Job modes."""

    TRAINING = "training"
    EVALUATION = "evaluation"
    PREDICTION = "prediction"


#: a failed task is re-queued at most this many times
MAX_TASK_RETRIES = 3

#: embedding tables of at least this many bytes take the sparse-row
#: tier (O(touched rows) updates through the row tap); smaller ones take
#: the masked dense tier
EMBEDDING_PARTITION_THRESHOLD_BYTES = 2 * 1024 * 1024
