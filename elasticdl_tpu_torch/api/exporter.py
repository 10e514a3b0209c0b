"""Trained-model export and import: the port of
elasticdl_tpu/api/exporter.py, in the same artifact format.

    <dir>/params.msgpack    {"params": ..., "model_state": ...} in the
                            flax names and layout, written as
                            flax.serialization.to_bytes writes it
                            (common/flax_msgpack.py, byte for byte)
    <dir>/meta.json         version, num_params, model_class

so a JAX export loads in the port and a port export in
`flax.serialization.msgpack_restore`. The params tree's keys are sorted
at every level and its leaves are host arrays, as the JAX exporter's
`jax.tree.map` leaves them; a float leaf keeps its dtype (a
torch.bfloat16 tensor for bfloat16). A live state's parameters are
named and laid out as a checkpoint names them (`saver.params_tree`
with the model's zoo `flax_param_path`), so one naming serves
checkpoints and exports of every zoo model. `model_state` is flax's:
{"batch_stats": ...} of a model with BatchNorm running averages (the
state's `model_state` buffers, `saver.model_state_tree`), {} otherwise.
`make_serving_fn` turns (model, payload) into a features -> predictions
callable on the model's device, with the payload's running averages in
its BatchNorm buffers.

A model whose tables live in the host-spill tier (`host_manager`,
embedding/host_bridge.py) carries their trained rows in the artifact
too, as the JAX exporter writes them: `payload["host_embeddings"] =
{table: {"ids": int64 [n], "values": float32 [n, dim]}}`. Serving such
an export pulls its rows from a fresh clone of the caller's manager
seeded with them, per batch, as training does; the caller's engines are
never touched.
"""

import copy
import json
import logging
import os
import types
from collections.abc import Mapping

import numpy as np
import torch

from elasticdl_tpu_torch.api.quantization import load_params
from elasticdl_tpu_torch.checkpoint.saver import (
    MODEL_STATE_PREFIX,
    load_checkpoint,
    model_flax_param_path,
    model_state_tree,
    params_tree,
    params_tree_from_flat,
    params_tree_leaves,
    restore_model_state_from_flat,
)
from elasticdl_tpu_torch.common import flax_msgpack
from elasticdl_tpu_torch.embedding.host_bridge import check_manager
from elasticdl_tpu_torch.model_zoo.flax_layers import model_state_buffers

logger = logging.getLogger(__name__)

PARAMS_FILE = "params.msgpack"
META_FILE = "meta.json"


def _host_tree(node):
    """Sorted keys, host leaves: what the JAX exporter's jax.tree.map of
    np.asarray gives (a Python int becomes a 0-d int64 array)."""
    if isinstance(node, Mapping):
        return {k: _host_tree(node[k]) for k in sorted(node)}
    if isinstance(node, torch.Tensor):
        t = node.detach().to("cpu")
        return t.contiguous() if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(node)


def flax_tree(model, params):
    """The flax-named tree of `params`: a flax tree as it is, or a port
    state dict ({torch key: tensor}, e.g. `TrainState.params`) of
    `model` named by its zoo module's `flax_param_path`, as a checkpoint
    names it."""
    if any(isinstance(v, Mapping) for v in params.values()):
        return params
    return params_tree(params, model_flax_param_path(model))


def _model_state(model, state):
    """flax's model state of `state`: its `model_state` as a flax tree
    ({"batch_stats": ...}) as it is, or as {torch key: buffer} named by
    the zoo's `flax_param_path`; the model's own buffers when the state
    carries none."""
    buffers = getattr(state, "model_state", None)
    if buffers is None:
        buffers = model_state_buffers(model)
    if not buffers or any(isinstance(v, Mapping) for v in buffers.values()):
        return dict(buffers)
    return model_state_tree(buffers, model_flax_param_path(model))


def _num_params(tree):
    if isinstance(tree, Mapping):
        return sum(_num_params(v) for v in tree.values())
    return int(np.prod(tuple(tree.shape)))


def export_model(model, state, export_dir, host_manager=None):
    """Write the export artifact of `state` (anything with `.params`, a
    port state dict or a flax-named tree such as `merge_lora`'s or
    `quantize_params`' result, `.step`, and `.model_state` when the
    model keeps running averages), with every host table's rows when
    `host_manager` is given. Returns the dir."""
    if host_manager is not None:
        check_manager(host_manager)
    os.makedirs(export_dir, exist_ok=True)
    payload = {"params": _host_tree(flax_tree(model, state.params)),
               "model_state": _host_tree(_model_state(model, state))}
    if host_manager:
        host = {}
        for name, table in host_manager.tables().items():
            ids, values = table.engine.param.export_rows()
            host[name] = {"ids": np.asarray(ids, np.int64),
                          "values": np.asarray(values, np.float32)}
        payload["host_embeddings"] = host
    with open(os.path.join(export_dir, PARAMS_FILE), "wb") as f:
        flax_msgpack.write(f, payload)
    with open(os.path.join(export_dir, META_FILE), "w") as f:
        json.dump({"version": int(state.step),
                   "num_params": _num_params(payload["params"]),
                   "model_class": type(model).__name__}, f)
    return export_dir


def export_from_checkpoint(model, template_state, checkpoint_dir, export_dir,
                           host_manager=None):
    """Export the latest valid checkpoint under `checkpoint_dir`: its
    `.params` and `.model_state` leaves and version, read without touching
    `template_state` (the live state a caller trains keeps its values).
    With `host_manager`, the host rows of the same version restore into
    a fresh clone of it, never into the caller's engines, which a live
    job keeps training."""
    del template_state
    if host_manager is not None:
        check_manager(host_manager)
    flat, version = load_checkpoint(checkpoint_dir)
    logger.info("Exporting checkpoint version %d", version)
    state = types.SimpleNamespace(
        params=params_tree_from_flat(flat), step=version,
        model_state=params_tree_from_flat(flat, MODEL_STATE_PREFIX))
    export_manager = None
    if host_manager:
        export_manager = host_manager.fresh_clone()
        export_manager.load_flat_state(flat)
    return export_model(model, state, export_dir,
                        host_manager=export_manager)


def load_exported(export_dir):
    """({"params": ..., "model_state": ...}, meta dict) of an export."""
    with open(os.path.join(export_dir, PARAMS_FILE), "rb") as f:
        payload = flax_msgpack.msgpack_restore(f.read())
    meta = {}
    meta_path = os.path.join(export_dir, META_FILE)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return payload, meta


def make_serving_fn(model, payload, host_manager=None):
    """A features -> predictions callable over the exported weights: a
    copy of the port `model` (the caller's keeps its weights) holding
    the payload's params (int8 leaves dequantized once) and model state,
    run under torch.inference_mode on the model's device.

    An export with host tables (payload["host_embeddings"]) needs a
    manager whose tables are the artifact's (build_manager_from_spec);
    `serve` pulls each batch's rows from a fresh clone of it seeded
    with the exported rows, so the caller's engines never move."""
    if host_manager is not None:
        check_manager(host_manager)
    host_rows = payload.get("host_embeddings") or {}
    if host_rows and host_manager is None:
        raise ValueError(
            "exported model carries host-resident tables %s; pass the "
            "spec's HostEmbeddingManager (build_manager_from_spec)"
            % sorted(host_rows))
    if host_manager and not host_rows:
        raise ValueError(
            "manager declares host tables %s but the artifact carries "
            "none; re-export with host_manager passed to export_model"
            % sorted(host_manager.tables()))
    if host_rows:
        if set(host_manager.tables()) != set(host_rows):
            # a table missing from the artifact would serve lazily
            # initialised random rows
            raise ValueError(
                "host-table mismatch: artifact has %s, manager has %s"
                % (sorted(host_rows), sorted(host_manager.tables())))
        host_manager = host_manager.fresh_clone()
        tables = host_manager.tables()
        for name, rec in host_rows.items():
            tables[name].engine.param.set_rows(
                np.asarray(rec["ids"], np.int64),
                np.asarray(rec["values"], np.float32))
    served = load_params(copy.deepcopy(model), payload["params"]).eval()
    served.requires_grad_(False)
    buffers = model_state_buffers(served)
    if buffers or payload.get("model_state"):
        restore_model_state_from_flat(
            buffers, model_flax_param_path(served), params_tree_leaves(
                payload.get("model_state") or {}, MODEL_STATE_PREFIX))

    def serve(features):
        if host_rows:
            features = host_manager.prepare(dict(features))
        with torch.inference_mode():
            return served(features, training=False)

    return serve
