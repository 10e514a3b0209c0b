"""Iris DNN over table rows: the PyTorch twin of
model_zoo/odps_iris_dnn_model/odps_iris_dnn_model.py (the reference's
odps_iris_dnn_model.py:18-56), and the zoo spec around it.

Four floats flattened into one Dense(3) named `output`, softmax cross
entropy, SGD 0.1. Records are rows of strings, as the CSV reader
(data/reader/csv_reader.py) yields them and the reference's ODPS rows
were: dataset_fn parses them to floats, the last field the class.
"""

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.convert import zoo_flax_param_path
from elasticdl_tpu_torch.model_zoo import image_spec
from elasticdl_tpu_torch.model_zoo.flax_layers import Dense, flax_generator
from elasticdl_tpu_torch.ops.dispatch import resolve_device
from elasticdl_tpu_torch.training.optimizers import sgd


class IrisDnnModel(nn.Module):
    def __init__(self, device="cuda", seed=0):
        super().__init__()
        device = resolve_device(device)
        self.output = Dense(4, 3, device=device,
                            generator=flax_generator(device, seed))

    def forward(self, features, training=False):
        x = torch.as_tensor(features["input"],
                            device=self.output.weight.device)
        return self.output(x.reshape(x.shape[0], -1).to(torch.float32))


def custom_model(device="cuda", seed=0):
    return IrisDnnModel(device=device, seed=seed)


def loss(labels, predictions):
    return image_spec.mean_cross_entropy(labels, predictions)


def optimizer(lr=0.1):
    return sgd(lr)


def dataset_fn(dataset, mode, metadata):
    def _parse(record):
        # a row of string fields (a CSV row, as an ODPS row was)
        values = [float(v) for v in record]
        features = {"input": np.asarray(values[0:-1], np.float32)}
        if mode == Mode.PREDICTION:
            return features
        return features, np.asarray(values[-1], np.int32).reshape(())

    return dataset.map(_parse)


flax_param_path = zoo_flax_param_path
eval_metrics_fn = image_spec.eval_metrics_fn


def feature_shapes():
    return {"input": (4,)}
