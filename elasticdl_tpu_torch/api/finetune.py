"""Fine-tuning utilities: LoRA adapter merging, the port of
elasticdl_tpu/api/finetune.py.

The training-side pieces live elsewhere: the Trainer's
`trainable_pattern` freezes what the pattern does not match;
`lora_rank` on the transformer_lm adds the adapter branches; a
checkpoint restored with `strict=False` warm-starts them from a dense
one. `merge_lora` folds trained adapters back into the base kernels, so
the deployed model is a plain dense model again: no extra products a
step, loadable by a `lora_rank=0` model, quantizable, exportable.
"""

from collections.abc import Mapping

import numpy as np
import torch

from elasticdl_tpu_torch.checkpoint.saver import params_tree
from elasticdl_tpu_torch.convert import (
    flax_param_path,
    fp32_array,
    params_from_flax,
)

_SUFFIXES = ("_lora_a", "_lora_b")


def _alpha(model, lora_alpha):
    """alpha from `model` or the explicit value; the two must agree."""
    if lora_alpha is None:
        lora_alpha = getattr(model, "lora_alpha", None)
        if lora_alpha is None:
            raise ValueError(
                "pass model= (to read its lora_alpha) or an explicit "
                "lora_alpha: a mismatched alpha merges silently wrong")
    if model is not None and lora_alpha != getattr(model, "lora_alpha",
                                                   lora_alpha):
        raise ValueError("explicit lora_alpha %r contradicts "
                         "model.lora_alpha %r"
                         % (lora_alpha, model.lora_alpha))
    return float(lora_alpha)


def _like(merged, kernel):
    """The fp32 numpy `merged` in `kernel`'s dtype and kind (numpy array,
    or a torch tensor for a torch.bfloat16 leaf)."""
    if isinstance(kernel, torch.Tensor):
        return torch.from_numpy(merged).to(kernel.dtype)
    return merged.astype(np.asarray(kernel).dtype)


def _merge_tree(node, alpha):
    if not isinstance(node, Mapping):
        return node
    out, adapters = {}, {}
    for key, val in node.items():
        if key.endswith(_SUFFIXES):
            adapters.setdefault(key[:-len("_lora_a")], {})[key[-1]] = val
        else:
            out[key] = _merge_tree(val, alpha)
    for base, ab in adapters.items():
        if sorted(ab) != ["a", "b"]:
            raise ValueError("incomplete LoRA pair for %r: found only %s"
                             % (base, sorted(ab)))
        target = out.get(base)
        if not isinstance(target, Mapping) or "kernel" not in target:
            raise ValueError("no base kernel %s/kernel to merge adapters "
                             "into" % base)
        a, b = fp32_array(ab["a"]), fp32_array(ab["b"])
        delta = (a @ b) * np.float32(alpha / a.shape[-1])
        kernel = target["kernel"]
        out[base] = dict(target, kernel=_like(fp32_array(kernel) + delta,
                                              kernel))
    return out


def merge_lora(params, model=None, lora_alpha=None):
    """Fold `*_lora_a` / `*_lora_b` adapter pairs into their base
    kernels, W += (A @ B) * alpha / rank in fp32 cast back to W's dtype,
    and drop the adapters. Outputs then equal the adapter model's up to
    float reassociation ((x @ A) @ B * s against x @ (W + A @ B * s)).

    `params` is either a flax-named tree (nested dicts of numpy arrays
    or torch.bfloat16 tensors, as checkpoints and exports hold them;
    returns a new tree shaped like a `lora_rank=0` model's), or a live
    port TransformerLM (returns the fp32 CPU state_dict a `lora_rank=0`
    model loads: the same merge of its flax tree). alpha comes from
    `model` (for a live model, the model itself) or `lora_alpha`; one of
    them must say it, and the two must agree. Raises on an incomplete
    pair or a pair with no base kernel. The input is not changed."""
    if isinstance(params, torch.nn.Module):
        alpha = _alpha(params if model is None else model, lora_alpha)
        return params_from_flax(_merge_tree(params_tree(
            dict(params.named_parameters()), flax_param_path), alpha))
    return _merge_tree(params, _alpha(model, lora_alpha))
