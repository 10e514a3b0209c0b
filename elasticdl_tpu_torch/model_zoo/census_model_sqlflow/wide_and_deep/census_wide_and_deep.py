"""Census Wide&Deep driven by the SQLFlow transform-op graph: the
PyTorch twin of
model_zoo/census_model_sqlflow/wide_and_deep/census_wide_and_deep.py
(the reference's wide_deep_subclass_keras.py:55-71 model math):

* dataset_fn topo-sorts FEATURE_TRANSFORM_INFO and runs its host stages
  (hash / lookup / bucketize / concat-with-offset) a record at a time;
* the model walks the same graph's EMBEDDING / ARRAY stages: each
  Embedding op is a table named as the op, each Array op says which
  tables feed the wide and which the deep tower;
* per-group embedding sums, deep Dense 16, 8, 4, concat(wide, deep) ->
  sum -> logits [b, 1], sigmoid probs [b]; sigmoid cross entropy,
  Adam(1e-3).

The towers are census_wide_deep_model's (WideDeepTowers). Parameter
names are the flax paths (flax_layers.py); weights from seed `seed` on
`device`.
"""

import numpy as np

from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.convert import zoo_flax_param_path
from elasticdl_tpu_torch.data.example_codec import decode_example
from elasticdl_tpu_torch.model_zoo.census_model_sqlflow import (
    feature_configs as cfg,
)
from elasticdl_tpu_torch.model_zoo.census_model_sqlflow.transform_ops import (  # noqa: E501
    HostOpExecutor,
    TransformOpType,
    topo_sort,
)
from elasticdl_tpu_torch.model_zoo.census_wide_deep_model.wide_deep_functional_api import (  # noqa: E501,F401
    WideDeepTowers,
    eval_metrics_fn,
    loss,
    optimizer,
)

_SOURCE_COLUMNS = [s.name for s in cfg.INPUT_SCHEMAS]
_SORTED_OPS = topo_sort(cfg.FEATURE_TRANSFORM_INFO, _SOURCE_COLUMNS)
_OPS_BY_OUTPUT = {op.output: op for op in _SORTED_OPS}
# layers built once (vocab tables etc.), reused for every record
_EXECUTOR = HostOpExecutor(_SORTED_OPS)


def _array_tables(array_name):
    """An Array op's Embedding ops as (group, table name, id-space size),
    their output dims (one each)."""
    tables, dims = [], set()
    for emb_name in _OPS_BY_OUTPUT[array_name].inputs:
        emb = _OPS_BY_OUTPUT[emb_name]
        if emb.op_type != TransformOpType.EMBEDDING:
            raise ValueError("%s feeds %s, not an Embedding op"
                             % (emb_name, array_name))
        tables.append((emb.input, emb.name, emb.input_dim))
        dims.add(emb.output_dim)
    return tables, dims


def custom_model(device="cuda", seed=0):
    wide, wide_dims = _array_tables("wide_embeddings")
    deep, deep_dims = _array_tables("deep_embeddings")
    if wide_dims != {1} or len(deep_dims) != 1:
        raise ValueError("the towers take dim-1 wide tables and one deep "
                         "dim, not %s / %s" % (wide_dims, deep_dims))
    return WideDeepTowers(wide, deep, deep_dim=deep_dims.pop(),
                          device=device, seed=seed)


flax_param_path = zoo_flax_param_path


def _group_names():
    return sorted({
        _OPS_BY_OUTPUT[e].input
        for out in cfg.TRANSFORM_OUTPUTS
        for e in _OPS_BY_OUTPUT[out].inputs
    })


def dataset_fn(dataset, mode, _):
    group_names = _group_names()

    def _parse(record):
        ex = decode_example(record)
        values = _EXECUTOR(ex)
        features = {
            name: values[name].astype(np.int64) for name in group_names
        }
        if mode == Mode.PREDICTION:
            return features
        return features, ex[cfg.LABEL_KEY].astype(np.int32).reshape(())

    return dataset.map(_parse)


def feature_shapes():
    return {
        op.input: (len(_OPS_BY_OUTPUT[op.input].inputs),)
        for out in cfg.TRANSFORM_OUTPUTS
        for e in _OPS_BY_OUTPUT[out].inputs
        for op in [_OPS_BY_OUTPUT[e]]
    }
