"""Weight-only int8 quantization for the decode path: the port of
elasticdl_tpu/api/quantization.py, over the same flax-named trees
(`convert.params_to_flax`, an export's or a checkpoint's params) and
with the same marker keys, so the int8 values and scales equal the JAX
package's bit for bit.

A quantized leaf is the dict {"__w8__": int8 [..., out], "__w8_scale__":
fp32 [out], "__w8_src_itemsize__": the source dtype's itemsize}. The
scale is per last axis of the flax layout ([in, out] kernels: per
output channel), amax / 127 with a zero channel at 1, the values
round-half-even and clipped to +-127. Work on the flax tree, never on
the port's transposed `Linear.weight` [out, in]: the channel axis would
flip there.

A bf16 leaf is a torch.bfloat16 tensor (numpy has no bfloat16; the
port's checkpoints carry it so too). Serving dequantizes once per
weight load (`load_params`, the engines' `set_params`) and serves float
weights, the JAX engines' default. Under EDL_SERVING_FUSED_DEQUANT=1
(`fused_dequant_default`) the serving entry instead keeps the int8
leaves resident (`hold_int8`): each quantized parameter gives way to
int8 values and fp32 scales in the port's layout, and the model
dequantizes a weight where a forward uses it (transformer_lm
`_weight` / `_rows`), so the weights stay int8 in memory.
"""

import os

import numpy as np
import torch

from elasticdl_tpu_torch.checkpoint.saver import (
    model_flax_param_path,
    params_tree_leaves,
    restore_params_from_flat,
)
from elasticdl_tpu_torch.convert import fp32_array

_Q8_KEY = "__w8__"
_SCALE_KEY = "__w8_scale__"
_ITEMSIZE_KEY = "__w8_src_itemsize__"


def _is_float_leaf(x):
    if isinstance(x, torch.Tensor):
        return x.is_floating_point()
    return np.issubdtype(np.asarray(x).dtype, np.floating)


def _quantize_leaf(w):
    """Symmetric per-output-channel (last axis) int8."""
    src_itemsize = (w.element_size() if isinstance(w, torch.Tensor)
                    else int(np.asarray(w).dtype.itemsize))
    w32 = fp32_array(w)
    amax = np.max(np.abs(w32), axis=tuple(range(w32.ndim - 1)))
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(w32 / scale), -127, 127).astype(np.int8)
    return {_Q8_KEY: q, _SCALE_KEY: scale, _ITEMSIZE_KEY: src_itemsize}


def quantize_params(params, min_size=4096):
    """A copy of the flax-named tree with every float leaf of ndim >= 2
    and size >= min_size in its int8 form. Biases, LayerNorm scales and
    small tensors stay as they are."""
    def visit(node):
        if isinstance(node, dict):
            return {k: visit(v) for k, v in node.items()}
        shape = tuple(node.shape) if hasattr(node, "shape") else ()
        if (len(shape) >= 2 and int(np.prod(shape)) >= min_size
                and _is_float_leaf(node)):
            return _quantize_leaf(node)
        return node

    return visit(params)


def is_quantized(params):
    """True if the tree holds any int8-quantized leaf."""
    if not isinstance(params, dict):
        return False
    if _Q8_KEY in params:
        return True
    return any(is_quantized(v) for v in params.values())


def _dequantize_leaf(q8, scale):
    scale = fp32_array(scale)
    return np.asarray(q8).astype(scale.dtype) * scale


def dequantize_params(params):
    """The inverse of quantize_params: fp32 leaves (the scale's dtype)
    where int8 ones were."""
    def visit(node):
        if isinstance(node, dict):
            if _Q8_KEY in node:
                return _dequantize_leaf(node[_Q8_KEY], node[_SCALE_KEY])
            return {k: visit(v) for k, v in node.items()}
        return node

    return visit(params)


def quantized_bytes(params):
    """(quantized bytes, original bytes) of the weight payload: the
    original counts each int8 leaf at its recorded source itemsize
    (float32 when none is recorded)."""
    q_total = o_total = 0
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            if _Q8_KEY in node:
                q = np.asarray(node[_Q8_KEY])
                itemsize = int(node.get(_ITEMSIZE_KEY, 4))
                q_total += q.size + np.asarray(node[_SCALE_KEY]).size * 4
                o_total += q.size * itemsize
            else:
                stack.extend(node.values())
            continue
        if isinstance(node, torch.Tensor):
            n = node.numel() * node.element_size()
        else:
            n = np.asarray(node).nbytes
        q_total += n
        o_total += n
    return q_total, o_total


def fused_dequant_default():
    """EDL_SERVING_FUSED_DEQUANT: int8 weights stay resident and are
    dequantized inside every step (set to anything but 0) instead of once
    at the load."""
    return os.environ.get("EDL_SERVING_FUSED_DEQUANT", "") not in ("", "0")


def holds_int8(model):
    """True if `model` holds any weight as resident int8 (`hold_int8`)."""
    return any(name.endswith("_q8") for name, _b in model.named_buffers())


def hold_int8(model, params):
    """Keep the int8 leaves of the flax-named tree `params` resident in
    `model`: each quantized parameter (`weight` of a module, or a LoRA
    adapter) is replaced by the buffers `<name>_q8` (int8, the port's
    layout: a flax kernel transposed) and `<name>_scale` (fp32, shaped
    to broadcast over it), and the float parameter is dropped. A module
    that holds them already gets the new values copied in place (a hot
    reload). Every shape is checked before anything changes. Leaves that
    are not quantized are left to the caller. Returns the number of
    leaves held."""
    path_fn = model_flax_param_path(model)
    held = dict(model.named_buffers())
    targets = []
    for key in list(dict(model.named_parameters())) + [
            k[:-len("_q8")] for k in held if k.endswith("_q8")]:
        path = path_fn(key).split("/")
        node = params
        for part in path:
            node = node.get(part) if isinstance(node, dict) else None
        if not isinstance(node, dict) or _Q8_KEY not in node:
            continue
        q8 = torch.tensor(np.asarray(node[_Q8_KEY]))
        scale = torch.tensor(fp32_array(node[_SCALE_KEY]))
        if path[-1] == "kernel":
            q8, scale = q8.t(), scale[:, None]
        mod_name, _, attr = key.rpartition(".")
        mod = model.get_submodule(mod_name)
        want = tuple((held.get(key + "_q8") if key + "_q8" in held
                      else getattr(mod, attr)).shape)
        if tuple(q8.shape) != want:
            raise ValueError("int8 leaf %s has shape %s, the model %s"
                             % ("/".join(path), tuple(q8.shape), want))
        targets.append((mod, attr, q8, scale))
    with torch.no_grad():
        for mod, attr, q8, scale in targets:
            if attr + "_q8" in mod._buffers:
                mod._buffers[attr + "_q8"].copy_(q8)
                mod._buffers[attr + "_scale"].copy_(scale)
                continue
            device = mod._parameters.pop(attr).device
            mod.register_buffer(attr + "_q8", q8.contiguous().to(device))
            mod.register_buffer(attr + "_scale",
                                scale.contiguous().to(device))
    return len(targets)


def load_params(model, params):
    """Load a flax-named params tree (an export's or a checkpoint's;
    float or int8) into the port `model` in place, as a checkpoint's
    leaves restore (the model's zoo `flax_param_path` names them),
    dequantizing int8 leaves once and casting each value to its
    parameter's dtype (and marking it `weights_int8`). Raises on a
    parameter the tree lacks or a leaf the model lacks. Returns the
    model."""
    if is_quantized(params):
        params = dequantize_params(params)
        model.weights_int8 = True
    flat = params_tree_leaves(params)
    restored = restore_params_from_flat(model, model_flax_param_path(model),
                                        flat, strict=True)
    if restored != len(flat):
        raise KeyError("params the model does not carry: %d of %d leaves"
                       % (len(flat) - restored, len(flat)))
    return model
