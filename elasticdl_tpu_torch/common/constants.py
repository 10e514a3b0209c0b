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


class MeshAxis(object):
    """Canonical mesh axis names, in order (the JAX package's MeshAxis):
    dp data, fsdp sharded-parameter data, ep expert / embedding shard,
    tp tensor, sp sequence / context (ring attention, Ulysses), pp
    pipeline. The port's mesh runs sp only."""

    DP = "dp"
    FSDP = "fsdp"
    EP = "ep"
    TP = "tp"
    SP = "sp"
    PP = "pp"
    ALL = (DP, FSDP, EP, TP, SP, PP)
