"""Carry the JAX package's transformer_lm params into the port.

`params_from_flax` maps the flax param tree of
model_zoo/transformer_lm/transformer_lm.py (as numpy arrays, nested
dicts or "a/b/c"-keyed flat dicts such as an .npz) onto the state_dict
of `elasticdl_tpu_torch.model_zoo.transformer_lm.TransformerLM`;
`params_to_flax` is its inverse. What differs between the two:

* flax `Dense` kernels are [in, out]; torch `Linear.weight` is
  [out, in]. `head/kernel` is [embed, vocab] (the LMHead param);
* the Block's LayerNorms are auto-named `LayerNorm_0` / `LayerNorm_1`
  with `scale`/`bias`; the port names them `ln_0` / `ln_1` with
  `weight`/`bias`;
* `mlp_up` / `mlp_down` carry biases, `qkv` / `proj` / `head` do not.
"""

import numpy as np
import torch

_LN = (("LayerNorm_0", "ln_0"), ("LayerNorm_1", "ln_1"))
_DENSE = (("attn", "qkv"), ("attn", "proj"), (None, "mlp_up"),
          (None, "mlp_down"))


def flatten_params(tree, prefix=""):
    """Nested param dict -> {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        key = "%s/%s" % (prefix, k) if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flatten_params(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten_params(flat):
    """{"a/b/c": array} -> nested param dict."""
    tree = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _block_keys(i):
    """(flax path, torch key, transpose) for block i's params."""
    out = []
    for flax_ln, torch_ln in _LN:
        out.append(("block_%d/%s/scale" % (i, flax_ln),
                    "blocks.%d.%s.weight" % (i, torch_ln), False))
        out.append(("block_%d/%s/bias" % (i, flax_ln),
                    "blocks.%d.%s.bias" % (i, torch_ln), False))
    for parent, name in _DENSE:
        fpath = "block_%d/%s%s" % (i, parent + "/" if parent else "", name)
        tpath = "blocks.%d.%s%s" % (i, parent + "." if parent else "", name)
        out.append((fpath + "/kernel", tpath + ".weight", True))
        if name.startswith("mlp"):
            out.append((fpath + "/bias", tpath + ".bias", False))
    return out


def _mapping(num_layers, learned_pos=True):
    keys = [("wte/embedding", "wte.weight", False)]
    if learned_pos:
        keys.append(("wpe/embedding", "wpe.weight", False))
    for i in range(num_layers):
        keys.extend(_block_keys(i))
    keys += [
        ("ln_f/scale", "ln_f.weight", False),
        ("ln_f/bias", "ln_f.bias", False),
        ("head/kernel", "head.weight", True),
    ]
    return keys


def _num_layers(flat):
    n = 0
    while any(k.startswith("block_%d/" % n) for k in flat):
        n += 1
    return n


def params_from_flax(params):
    """flax transformer_lm params (nested or flat, numpy-convertible)
    -> a state_dict of fp32 CPU tensors for the port's TransformerLM
    (load with `model.load_state_dict(sd)`). Raises KeyError on a
    missing or unexpected param."""
    flat = flatten_params(params) if not _is_flat(params) else {
        k: np.asarray(v) for k, v in params.items()}
    mapping = _mapping(_num_layers(flat), "wpe/embedding" in flat)
    sd = {}
    for fkey, tkey, transpose in mapping:
        arr = np.asarray(flat.pop(fkey), np.float32)
        sd[tkey] = torch.tensor(arr.T if transpose else arr)
    if flat:
        raise KeyError("params the port does not carry: %s" % sorted(flat))
    return sd


def params_to_flax(state_dict):
    """The inverse of `params_from_flax`: a nested dict of fp32 numpy
    arrays in the flax layout."""
    keys = list(state_dict)
    n = 0
    while any(k.startswith("blocks.%d." % n) for k in keys):
        n += 1
    flat = {}
    for fkey, tkey, transpose in _mapping(n, "wpe.weight" in state_dict):
        arr = state_dict[tkey].detach().to("cpu", torch.float32).numpy()
        flat[fkey] = np.ascontiguousarray(arr.T if transpose else arr)
    return unflatten_params(flat)


def _is_flat(params):
    return all(isinstance(k, str) and "/" in k for k in params)
