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
weights, the JAX engines' default.
"""

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


def load_params(model, params):
    """Load a flax-named params tree (an export's or a checkpoint's;
    float or int8) into the port `model` in place, as a checkpoint's
    leaves restore (the model's zoo `flax_param_path` names them),
    dequantizing int8 leaves once and casting each value to its
    parameter's dtype. Raises on a parameter the tree lacks or a leaf
    the model lacks. Returns the model."""
    if is_quantized(params):
        params = dequantize_params(params)
    flat = params_tree_leaves(params)
    restored = restore_params_from_flat(model, model_flax_param_path(model),
                                        flat, strict=True)
    if restored != len(flat):
        raise KeyError("params the model does not carry: %d of %d leaves"
                       % (len(flat) - restored, len(flat)))
    return model
