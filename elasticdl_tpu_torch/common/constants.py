"""Constants the port shares with the JAX package
(elasticdl_tpu/common/constants.py), kept as its own copy."""


class Mode(object):
    """Job modes."""

    TRAINING = "training"
    EVALUATION = "evaluation"
    PREDICTION = "prediction"


class TaskExecCounterKey(object):
    FAIL_COUNT = "fail_count"


class GRPC(object):
    """Control-plane message caps (256 MB each way). The port's transport
    (proto/service.py) is HTTP, not gRPC; it keeps the name and the caps
    so a request the JAX master takes, the port's master takes too."""

    MAX_SEND_MESSAGE_LENGTH = 256 * 1024 * 1024
    MAX_RECEIVE_MESSAGE_LENGTH = 256 * 1024 * 1024


class JobType(object):
    TRAINING_ONLY = "training_only"
    TRAINING_WITH_EVALUATION = "training_with_evaluation"
    EVALUATION_ONLY = "evaluation_only"
    PREDICTION_ONLY = "prediction_only"


class ReaderType(object):
    RECORDIO = "RecordIO"
    CSV = "CSV"
    TEXT = "Text"
    ODPS = "ODPS"


#: a failed task is re-queued at most this many times
MAX_TASK_RETRIES = 3

#: a worker retries one failing minibatch at most this many times
MAX_MINIBATCH_RETRY_NUM = 64

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
