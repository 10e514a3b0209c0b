"""Census-income DNN: the PyTorch twin of
model_zoo/census_dnn_model/census_functional_api.py (the reference's
census_functional_api.py:23-61): the feature layer over numeric and
hashed, embedded categoricals, Dense 16 - 16 - 1 with relu and a
sigmoid head, Adam(1e-3), binary cross entropy on the probabilities.
Parameter names are the flax paths (flax_layers.py); weights from seed
`seed` on `device`."""

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.convert import zoo_flax_param_path
from elasticdl_tpu_torch.data.example_codec import decode_example
from elasticdl_tpu_torch.model_zoo.census_dnn_model.census_feature_columns import (  # noqa: E501
    CATEGORICAL_FEATURE_KEYS,
    FEATURE_WIDTH,
    LABEL_KEY,
    NUMERIC_FEATURE_KEYS,
    CensusFeatureLayer,
    transform_categoricals,
)
from elasticdl_tpu_torch.model_zoo.flax_layers import (
    Dense,
    binary_cross_entropy_on_probs,
    flax_generator,
)
from elasticdl_tpu_torch.ops.dispatch import resolve_device
from elasticdl_tpu_torch.training.optimizers import adam

# the MLP's Dense layers in the order flax names them: (name, in, out)
MLP = (("Dense_0", FEATURE_WIDTH, 16), ("Dense_1", 16, 16),
       ("Dense_2", 16, 1))


class CensusDnnModel(nn.Module):
    """The feature layer `CensusFeatureLayer_0`, then `mlp` ((attribute,
    in, out) of the three Dense layers) with relu between and a sigmoid
    on the last."""

    def __init__(self, device="cuda", seed=0, features_name=None, mlp=MLP):
        super().__init__()
        device = resolve_device(device)
        gen = flax_generator(device, seed)
        self._features_name = features_name or "CensusFeatureLayer_0"
        self.add_module(self._features_name,
                        CensusFeatureLayer(device, gen))
        self._mlp = [name for name, _n_in, _n_out in mlp]
        for name, n_in, n_out in mlp:
            self.add_module(name, Dense(n_in, n_out, device=device,
                                        generator=gen))

    def forward(self, features, training=False):
        del training
        x = getattr(self, self._features_name)(features)
        for i, name in enumerate(self._mlp):
            x = getattr(self, name)(x)
            x = torch.relu(x) if i < len(self._mlp) - 1 else torch.sigmoid(x)
        return x


def custom_model(device="cuda", seed=0):
    return CensusDnnModel(device=device, seed=seed)


def loss(labels, predictions):
    labels = torch.as_tensor(labels, device=predictions.device)
    return binary_cross_entropy_on_probs(labels.reshape(-1, 1), predictions)


def optimizer():
    return adam(1e-3)


flax_param_path = zoo_flax_param_path


def dataset_fn(dataset, mode, _):
    def _parse(record):
        ex = decode_example(record)
        features = transform_categoricals(ex)
        for key in NUMERIC_FEATURE_KEYS:
            features[key] = np.asarray(ex[key], dtype=np.float32).reshape(())
        if mode == Mode.PREDICTION:
            return features
        return features, np.asarray(ex[LABEL_KEY], dtype=np.int32).reshape(())

    dataset = dataset.map(_parse)
    if mode == Mode.TRAINING:
        dataset = dataset.shuffle(buffer_size=1024, seed=0)
    return dataset


def eval_metrics_fn():
    return {
        "accuracy": lambda labels, predictions: (
            np.round(np.asarray(predictions).reshape(-1)).astype(np.int32)
            == np.asarray(labels).reshape(-1)
        ).astype(np.float32)
    }


def feature_shapes():
    shapes = {key: () for key in NUMERIC_FEATURE_KEYS}
    shapes.update({key: () for key in CATEGORICAL_FEATURE_KEYS})
    return shapes
