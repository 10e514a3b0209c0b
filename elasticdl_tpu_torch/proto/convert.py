"""Conversions between the wire enum and the dispatcher's TaskType
strings: the port's copy of elasticdl_tpu/proto/convert.py."""

from elasticdl_tpu_torch.master.task_dispatcher import TaskType
from elasticdl_tpu_torch.proto import messages as pb

TASK_TYPE_TO_PB = {
    TaskType.TRAINING: pb.TRAINING,
    TaskType.EVALUATION: pb.EVALUATION,
    TaskType.PREDICTION: pb.PREDICTION,
    TaskType.WAIT: pb.WAIT,
    TaskType.TRAIN_END_CALLBACK: pb.TRAIN_END_CALLBACK,
}
PB_TO_TASK_TYPE = {v: k for k, v in TASK_TYPE_TO_PB.items()}


def task_type_from_pb(pb_type):
    return PB_TO_TASK_TYPE.get(pb_type)
