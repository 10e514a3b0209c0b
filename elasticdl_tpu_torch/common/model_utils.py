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

plus optionally `loss_parts(labels, predictions, sample_weights, mesh)
-> (numerator, denominator)`, the partial form of `loss` a Trainer
under a dp x sp mesh reduces over the ranks (training/trainer.py),
`callbacks()`, `flax_param_path(param_name) -> the
flax path` (what a Trainer `trainable_pattern` regex matches and what
names the parameter in a checkpoint), `PredictionOutputsProcessor`
(worker/prediction_outputs_processor.py), `custom_data_reader` and
`host_embeddings` (the host-spill tier, which the port's Trainer and
Worker refuse).
"""

import importlib.util
import os
import sys


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
                 prediction_outputs_processor=None, custom_data_reader=None,
                 host_embeddings_fn=None, loss_parts=None):
        self.model_fn = model_fn
        self.dataset_fn = dataset_fn
        self.loss = loss
        self.optimizer = optimizer
        self.eval_metrics_fn = eval_metrics_fn
        self.callbacks_fn = callbacks_fn
        self.flax_param_path = flax_param_path
        self.prediction_outputs_processor = prediction_outputs_processor
        self.custom_data_reader = custom_data_reader
        self.host_embeddings_fn = host_embeddings_fn
        self.loss_parts = loss_parts

    def create_model(self, model_params_str="", **overrides):
        """custom_model(**params, **overrides): `overrides` carries what
        the caller decides (the device, the init seed)."""
        kwargs = get_dict_from_params_str(model_params_str)
        kwargs.update(overrides)
        return self.model_fn(**kwargs)


def load_module(module_file):
    """The zoo module at `module_file`, registered in sys.modules under
    its path, so what it defines can find its module again (a model's
    `flax_param_path`, saver.model_flax_param_path)."""
    spec = importlib.util.spec_from_file_location(module_file, module_file)
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_file] = module
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
        custom_data_reader=d.get("custom_data_reader"),
        host_embeddings_fn=d.get("host_embeddings"),
        loss_parts=d.get("loss_parts"),
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


def resolve_dataset_fn(spec, reader):
    """spec.dataset_fn, else the reader's schema-driven default
    (`reader.default_dataset_fn()`), resolved once and cached on the
    spec."""
    if spec.dataset_fn is None:
        default = getattr(reader, "default_dataset_fn", None)
        if default is None:
            raise ValueError(
                "dataset_fn is required if the data reader used does "
                "not provide a default implementation of dataset_fn"
            )
        spec.dataset_fn = default()
    return spec.dataset_fn
