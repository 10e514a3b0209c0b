"""Census DNN, Sequential style: the PyTorch twin of
model_zoo/census_dnn_model/census_sequential.py (the reference's
census_sequential.py). The same MLP as the functional variant; flax
binds the Dense layers built for its nn.Sequential to the model, so
they carry the same names (`Dense_0`..`Dense_2`) and the model is
census_functional_api's."""

from elasticdl_tpu_torch.model_zoo.census_dnn_model.census_functional_api import (  # noqa: E501,F401
    CensusDnnModel,
    dataset_fn,
    eval_metrics_fn,
    feature_shapes,
    flax_param_path,
    loss,
    optimizer,
)


def custom_model(device="cuda", seed=0):
    return CensusDnnModel(device=device, seed=seed)
