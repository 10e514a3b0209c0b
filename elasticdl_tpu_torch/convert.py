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
* `mlp_up` / `mlp_down` carry biases, `qkv` / `proj` / `head` do not;
* LoRA adapters (`lora_rank` > 0) keep the flax layout and names:
  `block_i/attn/qkv_lora_a` [embed, r] is `blocks.i.attn.qkv_lora_a`,
  likewise `qkv_lora_b`, `proj_lora_a` and `proj_lora_b`, untransposed.

`flax_param_path` names a port parameter by its flax path (what a
`trainable_pattern` regex matches), and `adam_state_from_optax` carries
an optax adamw state (count, mu, nu) into the port's Trainer.

`dlrm_params_from_flax` and `dlrm_flax_param_path` do the same for
model_zoo/dlrm/dlrm.py:
`table_t/embedding_table` -> `table_t.embedding_table`,
`bottom_i|top_i/kernel` -> `.weight` transposed, `/bias` -> `.bias`.

`deepfm_params_from_flax`, `deepfm_params_to_flax` and
`deepfm_flax_param_path` do it for the three DeepFM zoo models
(model_zoo/deepfm_edl_embedding, deepfm_functional_api and
deepfm_host_embedding): `Dense_0|Dense_1/kernel` -> `.weight`
transposed, `/bias` -> `.bias`; the `edl_embedding` / `edl_id_bias`
tables (`/embedding_table`, the port's Embedding) and the `embedding` /
`id_bias` tables (`/embedding`, flax nn.Embed, a torch nn.Embedding's
`.weight`) as they are. The host tables of deepfm_host_embedding are no
params: their engines' state carries across as `state_dict()` (ids,
values, step), which both packages' engines share.

`zoo_params_from_flax`, `zoo_params_to_flax` and `zoo_flax_param_path`
do it for the tabular, CTR and vision zoo (heart_functional_api,
census_dnn_model, census_wide_deep_model, census_model_sqlflow,
dac_ctr, mnist_*, cifar10_*, resnet50_subclass, imagenet_resnet50),
whose modules carry the flax names (model_zoo/flax_layers.py): one
rule for every family, "." for "/", a `weight` its `kernel` (a 2-D
Dense kernel transposed, a 4-D Conv kernel [kh, kw, in, out] permuted
to torch's [out, in, kh, kw]), every other leaf (`embedding`, `bias`,
`scale`, `cross_w_0`, `cin_w_0`) as it is. A BatchNorm's running `mean`
and `var` (flax's `batch_stats` collection) are the same modules'
buffers in the same state_dict, so one `load_state_dict` carries both.
The same rule carries the bert and vit encoders, whose transformer
Blocks sit under `layer_%d`: a Block's Dense layers (`attn/qkv`,
`attn/proj`, `mlp_up`, `mlp_down`), LoRA leaves and norms take the
names `_block_keys` gives a block (`layer_0.ln_1.weight` is
`layer_0/LayerNorm_1/scale`).
"""

import re

import numpy as np
import torch

_LN = (("LayerNorm_0", "ln_0"), ("LayerNorm_1", "ln_1"))
_DENSE = (("attn", "qkv"), ("attn", "proj"), (None, "mlp_up"),
          (None, "mlp_down"))


def flatten_params(tree, prefix=""):
    """Nested param dict -> {"a/b/c": array} (torch tensors, such as a
    torch.bfloat16 leaf, stay tensors)."""
    out = {}
    for k, v in tree.items():
        key = "%s/%s" % (prefix, k) if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flatten_params(v, key))
        else:
            out[key] = v if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def fp32_array(x):
    """A leaf (numpy array, or torch tensor such as a bfloat16 one) as an
    fp32 numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


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


_LORA = ("qkv_lora_a", "qkv_lora_b", "proj_lora_a", "proj_lora_b")


def _block_keys(i, lora=True):
    """(flax path, torch key, transpose) for block i's params; `lora`
    adds the adapters'."""
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
    if lora:
        out += [("block_%d/attn/%s" % (i, name),
                 "blocks.%d.attn.%s" % (i, name), False) for name in _LORA]
    return out


def _mapping(num_layers, learned_pos=True, lora=False):
    keys = [("wte/embedding", "wte.weight", False)]
    if learned_pos:
        keys.append(("wpe/embedding", "wpe.weight", False))
    for i in range(num_layers):
        keys.extend(_block_keys(i, lora))
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
    flat = flatten_params(params) if not _is_flat(params) else dict(params)
    mapping = _mapping(_num_layers(flat), "wpe/embedding" in flat,
                       "block_0/attn/qkv_lora_a" in flat)
    sd = {}
    for fkey, tkey, transpose in mapping:
        arr = fp32_array(flat.pop(fkey))
        sd[tkey] = torch.tensor(arr.T if transpose else arr)
    if flat:
        raise KeyError("params the port does not carry: %s" % sorted(flat))
    return sd


def params_to_flax(state_dict):
    """The inverse of `params_from_flax`: a nested dict of fp32 numpy
    arrays in the flax layout, copies of the tensors."""
    keys = list(state_dict)
    n = 0
    while any(k.startswith("blocks.%d." % n) for k in keys):
        n += 1
    flat = {}
    for fkey, tkey, transpose in _mapping(
            n, "wpe.weight" in state_dict,
            "blocks.0.attn.qkv_lora_a" in state_dict):
        arr = state_dict[tkey].detach().to("cpu", torch.float32).numpy()
        # a copy: a CPU fp32 tensor's numpy() shares its storage
        flat[fkey] = np.array(arr.T if transpose else arr, order="C")
    return unflatten_params(flat)


def _is_flat(params):
    return all(isinstance(k, str) and "/" in k for k in params)


def flax_param_path(torch_key):
    """The flax path of a port parameter: "blocks.7.attn.qkv.weight" ->
    "block_7/attn/qkv/kernel", "ln_f.weight" -> "ln_f/scale" (the
    inverse of the mapping `params_from_flax` applies)."""
    m = re.match(r"blocks\.(\d+)\.", torch_key)
    keys = _block_keys(int(m.group(1))) if m else _mapping(0)
    for fkey, tkey, _transpose in keys:
        if tkey == torch_key:
            return fkey
    raise KeyError("not a transformer_lm parameter: %r" % (torch_key,))


_DLRM_KEY = re.compile(r"^((?:table|bottom|top)_\d+)\."
                       r"(embedding_table|weight|bias)$")
_DLRM_LEAF = {"embedding_table": "embedding_table", "weight": "kernel",
              "bias": "bias"}


def dlrm_flax_param_path(torch_key):
    """The flax path of a port DLRM parameter: "table_3.embedding_table"
    -> "table_3/embedding_table", "top_0.weight" -> "top_0/kernel"."""
    m = _DLRM_KEY.match(torch_key)
    if not m:
        raise KeyError("not a dlrm parameter: %r" % (torch_key,))
    return "%s/%s" % (m.group(1), _DLRM_LEAF[m.group(2)])


def dlrm_params_from_flax(params):
    """flax DLRM params (nested or flat, numpy-convertible) -> a
    state_dict of fp32 CPU tensors for the port's DLRM. Raises KeyError
    on a param the port does not carry."""
    flat = flatten_params(params) if not _is_flat(params) else {
        k: np.asarray(v) for k, v in params.items()}
    to_torch = {v: k for k, v in _DLRM_LEAF.items()}
    sd = {}
    for fkey, arr in flat.items():
        mod, _, leaf = fkey.rpartition("/")
        torch_leaf = to_torch.get(leaf)
        tkey = "%s.%s" % (mod, torch_leaf)
        if torch_leaf is None or not _DLRM_KEY.match(tkey):
            raise KeyError("params the port does not carry: %r" % (fkey,))
        arr = np.asarray(arr, np.float32)
        sd[tkey] = torch.tensor(arr.T if leaf == "kernel" else arr)
    return sd


def _array_leaves(tree, prefix=""):
    """{"a/b/c": array} over the array leaves of a nested dict, skipping
    the empty placeholders optax leaves for masked (frozen) params."""
    out = {}
    for k, v in tree.items():
        key = "%s/%s" % (prefix, k) if prefix else str(k)
        if hasattr(v, "items"):
            out.update(_array_leaves(v, key))
        elif hasattr(v, "shape") and hasattr(v, "dtype"):
            out[key] = np.asarray(v)
    return out


def _find_adam_state(node):
    """The first node of an optax state tree with count, mu and nu (the
    ScaleByAdamState inside adamw, under chain / MultiSteps /
    multi_transform wrappers)."""
    if all(hasattr(node, a) for a in ("count", "mu", "nu")):
        return node
    if hasattr(node, "items"):
        children = list(node.values())
    elif isinstance(node, (tuple, list)):
        children = list(node)
    else:
        children = [getattr(node, f) for f in getattr(node, "_fields", ())]
    for child in children:
        found = _find_adam_state(child)
        if found is not None:
            return found
    return None


def adam_state_from_optax(opt_state):
    """An optax adamw state (the JAX Trainer's `state.opt_state`, any
    wrapping) -> {"count": int, "exp_avg": {torch key: fp32 tensor},
    "exp_avg_sq": {torch key: fp32 tensor}} for the port's
    `Trainer.init_state(..., opt_state=...)`. Dense kernels are
    transposed as `params_from_flax` transposes the params; frozen
    params (no slot in optax) get none."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no adam state (count, mu, nu) in %r"
                         % type(opt_state).__name__)
    mu, nu = _array_leaves(adam.mu), _array_leaves(adam.nu)
    n = 0
    while any(k.startswith("block_%d/" % n) for k in mu):
        n += 1
    out = {"count": int(np.asarray(adam.count)), "exp_avg": {},
           "exp_avg_sq": {}}
    for fkey, tkey, transpose in _mapping(n, "wpe/embedding" in mu, True):
        for name, slots in (("exp_avg", mu), ("exp_avg_sq", nu)):
            if fkey in slots:
                arr = np.asarray(slots[fkey], np.float32)
                out[name][tkey] = torch.tensor(arr.T if transpose else arr)
    return out


_DEEPFM_KEYS = {
    "edl_embedding.embedding_table": "edl_embedding/embedding_table",
    "edl_id_bias.embedding_table": "edl_id_bias/embedding_table",
    "embedding.weight": "embedding/embedding",
    "id_bias.weight": "id_bias/embedding",
    "Dense_0.weight": "Dense_0/kernel",
    "Dense_0.bias": "Dense_0/bias",
    "Dense_1.weight": "Dense_1/kernel",
    "Dense_1.bias": "Dense_1/bias",
}
_DEEPFM_TORCH = {v: k for k, v in _DEEPFM_KEYS.items()}


def deepfm_flax_param_path(torch_key):
    """The flax path of a port DeepFM parameter: "Dense_0.weight" ->
    "Dense_0/kernel", "embedding.weight" -> "embedding/embedding"."""
    try:
        return _DEEPFM_KEYS[torch_key]
    except KeyError:
        raise KeyError("not a deepfm parameter: %r" % (torch_key,))


def deepfm_params_from_flax(params):
    """flax DeepFM params (nested or flat, numpy-convertible) -> a
    state_dict of fp32 CPU tensors for the port's DeepFM models. Raises
    KeyError on a param the port does not carry."""
    flat = flatten_params(params) if not _is_flat(params) else dict(params)
    sd = {}
    for fkey, arr in flat.items():
        if fkey not in _DEEPFM_TORCH:
            raise KeyError("params the port does not carry: %r" % (fkey,))
        arr = fp32_array(arr)
        sd[_DEEPFM_TORCH[fkey]] = torch.tensor(
            arr.T if fkey.endswith("/kernel") else arr)
    return sd


def deepfm_params_to_flax(state_dict):
    """The inverse of `deepfm_params_from_flax`: a nested dict of fp32
    numpy arrays in the flax layout, copies of the tensors."""
    flat = {}
    for tkey, t in state_dict.items():
        fkey = deepfm_flax_param_path(tkey)
        arr = t.detach().to("cpu", torch.float32).numpy()
        flat[fkey] = np.array(arr.T if fkey.endswith("/kernel") else arr,
                              order="C")
    return unflatten_params(flat)


# a transformer Block's leaves below `layer_%d` in the bert and vit
# encoders: port key -> flax path, the names `_block_keys` gives block 0
_ZOO_BLOCK = re.compile(r"^(layer_\d+)[./](.+)$")
_BLOCK_TO_FLAX = {tkey[len("blocks.0."):]: fpath[len("block_0/"):]
                  for fpath, tkey, _t in _block_keys(0)}
_BLOCK_FROM_FLAX = {f: t for t, f in _BLOCK_TO_FLAX.items()}


def zoo_flax_param_path(torch_key):
    """The flax path of a parameter (or BatchNorm buffer) of the
    tabular, CTR, vision and encoder zoo, whose modules carry the flax
    names: "." becomes "/", a Dense's or Conv's `weight` its `kernel`,
    a transformer Block's leaf under `layer_%d` its `_block_keys` name:
    "inner.DNN_0.Dense_1.weight" -> "inner/DNN_0/Dense_1/kernel",
    "thal_embedding.embedding" -> "thal_embedding/embedding",
    "inner.CIN_0.cin_w_0" -> "inner/CIN_0/cin_w_0",
    "layer_3.ln_0.weight" -> "layer_3/LayerNorm_0/scale"."""
    block = _ZOO_BLOCK.match(torch_key)
    if block and block.group(2) in _BLOCK_TO_FLAX:
        return "%s/%s" % (block.group(1), _BLOCK_TO_FLAX[block.group(2)])
    mod, _, leaf = torch_key.rpartition(".")
    if leaf == "kernel":
        raise KeyError("not a zoo parameter: %r" % (torch_key,))
    leaf = "kernel" if leaf == "weight" else leaf
    return "%s/%s" % (mod.replace(".", "/"), leaf) if mod else leaf


def _zoo_torch_key(fkey):
    """The port key of a zoo leaf's flax path (`zoo_flax_param_path`
    read backwards)."""
    block = _ZOO_BLOCK.match(fkey)
    if block and block.group(2) in _BLOCK_FROM_FLAX:
        return "%s.%s" % (block.group(1), _BLOCK_FROM_FLAX[block.group(2)])
    mod, _, leaf = fkey.rpartition("/")
    tleaf = "weight" if leaf == "kernel" else leaf
    return ("%s.%s" % (mod.replace("/", "."), tleaf)) if mod else tleaf


# a zoo kernel's rank -> the permutation from flax's layout to torch's
_ZOO_FROM_FLAX = {2: (1, 0), 4: (3, 2, 0, 1)}
_ZOO_TO_FLAX = {2: (1, 0), 4: (2, 3, 1, 0)}
# the leaves of flax's `batch_stats` collection (flax_layers.BatchNorm)
_BATCH_STATS_LEAVES = ("mean", "var")


def _zoo_layout(fkey, arr, perms):
    if not fkey.endswith("/kernel") and fkey != "kernel":
        return arr
    if arr.ndim not in perms:
        raise ValueError("a %d-D kernel %r has no layout rule (2-D Dense "
                         "and 4-D Conv kernels do)" % (arr.ndim, fkey))
    return np.transpose(arr, perms[arr.ndim])


def zoo_params_from_flax(params, batch_stats=None):
    """flax params of a tabular, CTR, vision or encoder zoo model
    (nested or flat, numpy-convertible), and its `batch_stats`
    collection when it has one -> a state_dict of fp32 CPU tensors for
    its port (`zoo_flax_param_path` read backwards; Dense kernels
    transposed, Conv kernels permuted; the running averages as the
    BatchNorm buffers)."""
    sd = {}
    for tree, collection in ((params, "params"), (batch_stats or {},
                                                  "batch_stats")):
        flat = flatten_params(tree) if not _is_flat(tree) else dict(tree)
        for fkey, arr in flat.items():
            leaf = fkey.rpartition("/")[2]
            if leaf == "weight" or (leaf in _BATCH_STATS_LEAVES) != (
                    collection == "batch_stats"):
                raise KeyError("%s the port does not carry: %r"
                               % (collection, fkey))
            arr = _zoo_layout(fkey, fp32_array(arr), _ZOO_FROM_FLAX)
            sd[_zoo_torch_key(fkey)] = torch.tensor(
                np.ascontiguousarray(arr))
    return sd


def zoo_params_to_flax(state_dict, collection="params"):
    """The inverse of `zoo_params_from_flax`: the nested dict of fp32
    numpy arrays in the flax layout (copies of the tensors) of one
    collection, "params" or the BatchNorm buffers' "batch_stats"."""
    flat = {}
    for tkey, t in state_dict.items():
        stats = tkey.rpartition(".")[2] in _BATCH_STATS_LEAVES
        if stats != (collection == "batch_stats"):
            continue
        fkey = zoo_flax_param_path(tkey)
        arr = t.detach().to("cpu", torch.float32).numpy()
        flat[fkey] = np.array(_zoo_layout(fkey, arr, _ZOO_TO_FLAX),
                              order="C")
    return unflatten_params(flat)
