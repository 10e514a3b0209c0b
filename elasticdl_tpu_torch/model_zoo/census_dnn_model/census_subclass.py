"""Census DNN, subclass style: the PyTorch twin of
model_zoo/census_dnn_model/census_subclass.py (the reference's
census_subclass.py). The same MLP with explicit submodules, named as
flax's setup() names them: `_features`, `_dense1`, `_dense2`, `_head`."""

from elasticdl_tpu_torch.model_zoo.census_dnn_model.census_feature_columns import (  # noqa: E501
    FEATURE_WIDTH,
)
from elasticdl_tpu_torch.model_zoo.census_dnn_model.census_functional_api import (  # noqa: E501,F401
    CensusDnnModel,
    dataset_fn,
    eval_metrics_fn,
    feature_shapes,
    flax_param_path,
    loss,
    optimizer,
)

MLP = (("_dense1", FEATURE_WIDTH, 16), ("_dense2", 16, 16), ("_head", 16, 1))


def custom_model(device="cuda", seed=0):
    return CensusDnnModel(device=device, seed=seed, features_name="_features",
                          mlp=MLP)
