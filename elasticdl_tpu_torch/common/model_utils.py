"""Model-zoo specs for the port: its copy of `get_dict_from_params_str`
and of the part of elasticdl_tpu/common/model_utils.py the local
training path needs (`ModelSpec`, `get_model_spec`,
`load_model_spec_from_module`).

A port zoo module (e.g. elasticdl_tpu_torch/model_zoo/transformer_lm.py)
exports, by name:

    custom_model(**kwargs) -> torch.nn.Module
    loss(labels, predictions[, sample_weights]) -> scalar tensor
    optimizer(**kwargs) -> a factory: params -> torch.optim.Optimizer
    dataset_fn(dataset, mode, metadata) -> dataset
    eval_metrics_fn() -> {metric_name: fn(labels, predictions)}

plus optionally `callbacks()`, `flax_param_path(param_name) -> the
flax path` (what a Trainer `trainable_pattern` regex matches and what
names the parameter in a checkpoint) and `PredictionOutputsProcessor`
(worker/prediction_outputs_processor.py).
"""

import importlib.util
import os


def get_dict_from_params_str(params_str):
    """Parse 'k1=v1; k2=v2' model params with Python literal values; a
    value that is not a literal stays a string ("dtype=bf16")."""
    if not params_str:
        return {}
    out = {}
    for kv in params_str.split(";"):
        kv = kv.strip()
        if not kv:
            continue
        k, _, v = kv.partition("=")
        k, v = k.strip(), v.strip()
        try:
            out[k] = eval(v, {"__builtins__": {}}, {})
        except Exception:  # noqa: BLE001 - any non-literal stays a string
            out[k] = v
    return out


class ModelSpec(object):
    """A resolved zoo spec."""

    def __init__(self, model_fn, dataset_fn, loss, optimizer,
                 eval_metrics_fn, callbacks_fn=None, flax_param_path=None,
                 prediction_outputs_processor=None):
        self.model_fn = model_fn
        self.dataset_fn = dataset_fn
        self.loss = loss
        self.optimizer = optimizer
        self.eval_metrics_fn = eval_metrics_fn
        self.callbacks_fn = callbacks_fn
        self.flax_param_path = flax_param_path
        self.prediction_outputs_processor = prediction_outputs_processor

    def create_model(self, model_params_str="", **overrides):
        """custom_model(**params, **overrides): `overrides` carries what
        the caller decides (the device, the init seed)."""
        kwargs = get_dict_from_params_str(model_params_str)
        kwargs.update(overrides)
        return self.model_fn(**kwargs)


def load_module(module_file):
    spec = importlib.util.spec_from_file_location(module_file, module_file)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _spec_from_dict(d, model_name):
    missing = [k for k in (model_name, "loss", "optimizer",
                           "eval_metrics_fn") if d.get(k) is None]
    if missing:
        raise ValueError("Missing required spec keys %s in the module"
                         % missing)
    return ModelSpec(
        model_fn=d[model_name], dataset_fn=d.get("dataset_fn"),
        loss=d["loss"], optimizer=d["optimizer"],
        eval_metrics_fn=d["eval_metrics_fn"],
        callbacks_fn=d.get("callbacks"),
        flax_param_path=d.get("flax_param_path"),
        prediction_outputs_processor=d.get("PredictionOutputsProcessor"),
    )


def get_model_spec(model_zoo, model_def):
    """Load '<model_zoo>/<a>/<b>.py' for model_def 'a.b.<model_fn name>'
    and resolve the spec by convention."""
    parts = model_def.split(".")
    module_file = os.path.join(model_zoo, *parts[:-1]) + ".py"
    return _spec_from_dict(load_module(module_file).__dict__, parts[-1])


def load_model_spec_from_module(module):
    """The spec of an already-imported zoo module (custom_model entry)."""
    return _spec_from_dict(module.__dict__, "custom_model")
