"""Sharded, versioned checkpoints: the port's copy of
elasticdl_tpu/checkpoint/saver.py, in the same on-disk format and with
the same leaf names, so a checkpoint either package wrote restores in
the other.

    <dir>/version-<V>/variables-<i>-of-<M>.ckpt
    <dir>/version-<V>/meta.json

* each shard file holds the leaves whose sha256(name) mod M is i
  (`string_to_id`), serialized by common/tensor_utils;
* a version dir is valid iff it holds all M ``variables-*-of-M`` files;
* a save writes a temp dir and renames it, then prunes to the newest
  ``keep_max_version`` versions; meta.json carries each shard's sha256
  (`verify_checkpoint` checks them without deserializing);
* restore merges every shard file of one complete set.

The leaf names are the JAX Trainer's: `flatten_state(trainer, state)`
names each leaf of the port's live state by the `jax.tree_util.keystr`
path of the same leaf in the JAX TrainState that the same spec and
options give (`.step`, `.params['block_0']['attn']['qkv']['kernel']` in
the flax [in, out] layout, a conv kernel in flax's [kh, kw, in, out],
`.opt_state[0].mu[...]`,
`.model_state['batch_stats']['BatchNorm_0']['mean']`, `.rng`,
`.embed_opt_state['table_0/embedding_table'][0].count`, ...), in its
leaf order. The optimizer state's names come from composing the
wrappers the JAX Trainer composes, in its order: the zoo transform
(optax.adam / adamw: ``[0].count``, ``[0].mu``, ``[0].nu``; optax.sgd
with momentum: ``[0].trace``; without: no leaf;
chain(add_decayed_weights, sgd with momentum), torch's SGD with a
weight_decay: ``[1][0].trace``), the learning-rate
schedule (``chain(tx, scale_by_schedule)``: ``[0]`` + tx, ``[1].count``),
the split that keeps tapped tables out of the dense update
(``.inner_states['dense'].inner_state``), the `trainable_pattern` freeze
(``.inner_states['train'].inner_state``) and accumulation
(optax.MultiSteps: ``.mini_step``, ``.gradient_step``,
``.inner_opt_state``, ``.acc_grads``). A composition these names do not
cover raises NotImplementedError.

Counts JAX does not store are derived on restore: the torch optimizer's
per-parameter ``step`` and a row table's count from the dense update
count, and that (under SGD, which stores none) from step //
grad_accum_steps. Values JAX keeps that the port does not are written
as JAX holds them: zeros for the accumulated gradient of a tapped table
(its dense gradient is zero in JAX) and of a frozen parameter (JAX
accumulates it, then the freeze discards it).

Restore copies each value in place (`copy_`) into the live parameters,
optimizer slots, accumulation buffers and row slots: the torch optimizer
keys its state by the Parameter object, so new tensors in their place
would detach the slots.

Leaves from `extra_state_fn` (the host-spill tier's
`.host_embeddings[...]` leaves, embedding/host_bridge.py `flat_state`)
ride shard 0 beside the state's; a load returns them with the rest,
`restore_state_from_flat` leaves them to the manager's
`load_flat_state`, and a restore without a manager ignores them.

Not ported: the multi-host branch (every process writing its own
shards), while the port runs one process a card.
"""

import hashlib
import json
import logging
import os
import re
import shutil
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

from elasticdl_tpu_torch.common.checkpoint_integrity import (  # noqa: F401
    _SHARD_RE,
    CheckpointCorruptError,
    _complete_set_counts,
    _read_meta,
    verify_checkpoint,
)
from elasticdl_tpu_torch.common.hash_utils import string_to_id
from elasticdl_tpu_torch.common.tensor_utils import (
    deserialize_ndarray_dict,
    ndarray_dict_parts,
)

logger = logging.getLogger(__name__)

_VERSION_RE = re.compile(r"^version-(\d+)$")


# ------------------------------------------------------------ leaf names


def _keystr(path):
    """jax.tree_util.keystr of a path of dict keys: "['a']['b']"."""
    return "".join("[%r]" % k for k in path)


# a kernel's rank -> the permutation from the torch layout to flax's
# (Dense: [out, in] -> [in, out]; Conv: [out, in, kh, kw] -> [kh, kw, in,
# out]) and back
_TO_FLAX = {2: (1, 0), 4: (2, 3, 1, 0)}
_FROM_FLAX = {2: (1, 0), 4: (3, 2, 0, 1)}


def _host(t, kernel=0):
    """A copy of `t` on the host: a numpy array, or a torch.bfloat16
    tensor (numpy has no bfloat16). A flax kernel (`kernel` its rank) is
    permuted to the flax layout on the tensor's own device first."""
    x = t.detach()
    if kernel:
        x = x.permute(*_TO_FLAX[kernel]).contiguous()
    x = x.to("cpu", copy=True)
    return x if x.dtype == torch.bfloat16 else x.numpy()


def _as_tensor(arr):
    if isinstance(arr, torch.Tensor):
        return arr
    with warnings.catch_warnings():
        # arrays read from a checkpoint are read-only views of its bytes;
        # they are only read here
        warnings.simplefilter("ignore", UserWarning)
        return torch.as_tensor(np.asarray(arr))


def _copy_into(dst, arr, kernel, name):
    # to the device first: a kernel is permuted there, not on the host
    src = _as_tensor(arr).to(dst.device)
    if kernel:
        src = src.permute(*_FROM_FLAX[kernel])
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError("checkpoint leaf %s has shape %s, the state %s"
                         % (name, tuple(src.shape), tuple(dst.shape)))
    with torch.no_grad():
        dst.copy_(src.to(dst.dtype))


def _scalar(arr):
    return int(np.asarray(_as_tensor(arr)).reshape(()))


def _is_kernel(path, t):
    """The rank of a flax kernel leaf, 0 for any other: a flax Dense
    kernel is [in, out], the torch Linear weight [out, in]; a flax Conv
    kernel [kh, kw, in, out], the torch conv weight [out, in, kh, kw].
    A kernel of another rank raises."""
    if path[-1] != "kernel":
        return 0
    if t.dim() not in _TO_FLAX:
        raise NotImplementedError(
            "checkpoint layout: a %d-D kernel %s has no flax layout rule "
            "(2-D Dense and 4-D Conv kernels do)" % (t.dim(), "/".join(path)))
    return t.dim()


def _param_leaves(params, paths):
    """The `.params` leaves of {torch key: parameter}, `paths` giving
    each key's flax path, in the JAX leaf order."""
    out = []
    for path, key in sorted((paths[k], k) for k in params):
        p = params[key]
        kernel = _is_kernel(path, p)
        out.append((".params" + _keystr(path),
                    lambda p=p, kernel=kernel: _host(p, kernel),
                    lambda v, p=p, kernel=kernel, n=key: _copy_into(
                        p, v, kernel, n)))
    return out


_KEYSTR_PART = re.compile(r"\['([^']*)'\]")


def params_tree_leaves(params, prefix=".params"):
    """{keystr: leaf} of a flax-named params tree, under the names the
    JAX Trainer's flatten_state gives them (`.params['block_0']['attn']
    ['qkv']['kernel']`; a quantized leaf's `['__w8__']`,
    `['__w8_scale__']` and `['__w8_src_itemsize__']`, the last a 0-d
    int64 array as np.asarray makes it)."""
    out = {}
    for key, val in params.items():
        name = prefix + "[%r]" % str(key)
        if isinstance(val, dict):
            out.update(params_tree_leaves(val, name))
        elif isinstance(val, torch.Tensor):
            out[name] = val
        else:
            out[name] = np.asarray(val)
    return out


def params_tree_from_flat(flat, prefix=".params"):
    """The nested flax-named tree of a flat checkpoint's `prefix` leaves
    (the inverse of `params_tree_leaves`)."""
    tree = {}
    for name, val in flat.items():
        if not name.startswith(prefix + "["):
            continue
        parts = _KEYSTR_PART.findall(name[len(prefix):])
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val
    return tree


def model_flax_param_path(model):
    """The `flax_param_path` of `model`'s zoo module: how a checkpoint
    or an export names its parameters."""
    path_fn = getattr(sys.modules[type(model).__module__],
                      "flax_param_path", None)
    if path_fn is None:
        raise NotImplementedError(
            "%s's zoo module defines no flax_param_path, so its parameters "
            "have no flax names" % type(model).__name__)
    return path_fn


def params_tree(params, flax_param_path):
    """The flax-named tree of {torch key: parameter}, under the names and
    in the layout a checkpoint gives its `.params` leaves (a kernel
    permuted to flax's layout, each tensor's dtype kept: a numpy array,
    or a torch.bfloat16 tensor)."""
    paths = {k: tuple(flax_param_path(k).split("/")) for k in params}
    return params_tree_from_flat({
        name: read() for name, read, _write in _param_leaves(params, paths)})


MODEL_STATE_PREFIX = ".model_state"
_BATCH_STATS = MODEL_STATE_PREFIX + "['batch_stats']"


def _model_state_leaves(buffers, flax_param_path):
    """The `.model_state['batch_stats']` leaves of {torch key: buffer}
    (TrainState.model_state, flax_layers.model_state_buffers), in the JAX
    leaf order."""
    out = []
    for path, key in sorted((tuple(flax_param_path(k).split("/")), k)
                            for k in buffers):
        b = buffers[key]
        out.append((_BATCH_STATS + _keystr(path), lambda b=b: _host(b),
                    lambda v, b=b, n=key: _copy_into(b, v, 0, n)))
    return out


def model_state_tree(buffers, flax_param_path):
    """flax's model state of {torch key: buffer}: {"batch_stats": the
    flax-named tree}, or {} for a model without one (what the JAX
    exporter writes as `model_state`)."""
    return params_tree_from_flat({
        name: read() for name, read, _write in _model_state_leaves(
            buffers, flax_param_path)}, prefix=MODEL_STATE_PREFIX)


def restore_model_state_from_flat(buffers, flax_param_path, flat):
    """Copy the `.model_state` leaves of a flat checkpoint (or of
    `params_tree_leaves(tree, MODEL_STATE_PREFIX)`) into {torch key:
    buffer} in place. Raises on a buffer the leaves lack or a leaf no
    buffer takes."""
    leaves = _model_state_leaves(buffers, flax_param_path)
    missing = [name for name, _r, _w in leaves if name not in flat]
    extra = set(n for n in flat if n.startswith(MODEL_STATE_PREFIX)) - set(
        name for name, _r, _w in leaves)
    if missing or extra:
        raise ValueError("model state mismatch: missing %s, extra %s"
                         % (missing[:3], sorted(extra)[:3]))
    for name, _read, write in leaves:
        write(flat[name])


def restore_params_from_flat(model, flax_param_path, flat, strict=False):
    """Copy the `.params` leaves of a flat checkpoint into `model`'s
    parameters in place (a server restores only these, as the JAX
    server uses only the params of the TrainState it restores).
    strict=False keeps the current value of a parameter the checkpoint
    lacks. Returns the number of parameters restored."""
    params = dict(model.named_parameters())
    paths = {k: tuple(flax_param_path(k).split("/")) for k in params}
    leaves = _param_leaves(params, paths)
    missing = [name for name, _r, _w in leaves if name not in flat]
    if missing and strict:
        raise ValueError("Checkpoint is missing %d parameters, e.g. %s"
                         % (len(missing), missing[:3]))
    for name, _read, write in leaves:
        if name in flat:
            write(flat[name])
    return len(leaves) - len(missing)


class _Layout(object):
    """The JAX leaves of one port TrainState: `leaves` is a list of
    (name, read, write) in the JAX Trainer's leaf order, `read()` giving
    the host value and `write(value)` copying one into the live state;
    `finish(restored)` derives the counts JAX does not store."""

    def __init__(self, trainer, state):
        path_fn = trainer.spec.flax_param_path
        if path_fn is None:
            raise NotImplementedError(
                "checkpoint names: the zoo spec has no flax_param_path, "
                "so its parameters have no JAX names")
        self.trainer, self.state = trainer, state
        opt = state.opt_state
        self.opt = opt
        self.optimizer = opt.optimizer
        self.kind = _dense_kind(self.optimizer)
        # chain(add_decayed_weights, sgd): the trace sits in element 1
        self.decayed = any(g.get("weight_decay")
                           for g in self.optimizer.param_groups) and (
            self.kind != "adam")
        self.k = trainer.grad_accum_steps
        self.scheduled = trainer._lr_multiplier_fn is not None
        self.paths = {key: tuple(path_fn(key).split("/"))
                      for key in state.params}
        self.tree = sorted((self.paths[k], k) for k in state.params)
        self.taps = set(state.embed_opt_state)
        self.train = trainer.train_names
        self.trainable = {id(p): i for i, p in enumerate(opt.trainable())}
        self.stores_count = False
        self.row_count_names = {}  # table key -> its count leaves
        self.leaves = [(".step", lambda: np.int32(self.state.step),
                        self._write_step)]
        self.leaves += _param_leaves(state.params, self.paths)
        self.leaves += self._opt_state()
        self.leaves += _model_state_leaves(state.model_state, path_fn)
        self.leaves.append((".rng", lambda: np.asarray(self.state.rng,
                                                       np.uint32),
                            self._write_rng))
        self.leaves += self._row_states()

    def _kernel(self, key):
        return _is_kernel(self.paths[key], self.state.params[key])

    # ----------------------------------------------------- the dense tier

    def _count_leaf(self, name):
        self.stores_count = True

        def write(v):
            self.opt.count = _scalar(v)

        return (name, lambda: np.int32(self.opt.count), write)

    def _slot_leaf(self, name, key, slot):
        p, kernel = self.state.params[key], self._kernel(key)

        def read():
            t = self.optimizer.state.get(p, {}).get(slot)
            return _host(t if t is not None else torch.zeros_like(p), kernel)

        def write(v):
            _copy_into(self._slots(p)[slot], v, kernel, name)

        return (name, read, write)

    def _slots(self, p):
        """p's torch optimizer state, made as the first step makes it
        when it does not exist yet (a restore before any step)."""
        st = self.optimizer.state[p]
        if not st:
            if self.kind == "adam":
                group = next(g for g in self.optimizer.param_groups
                             if any(q is p for q in g["params"]))
                on_device = group.get("capturable") or group.get("fused")
                st["step"] = torch.tensor(
                    0.0, device=p.device if on_device else "cpu")
                st["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
            else:
                st["momentum_buffer"] = torch.zeros_like(p)
        return st

    def _base(self, prefix, tree):
        """The zoo transform, a chain whose element 0 holds the state."""
        if self.kind == "adam":
            out = [self._count_leaf(prefix + "[0].count")]
            for field, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                out += [self._slot_leaf(prefix + "[0].%s" % field
                                        + _keystr(path), key, slot)
                        for path, key in tree]
            return out
        if self.kind == "momentum":
            at = "[1][0].trace" if self.decayed else "[0].trace"
            return [self._slot_leaf(prefix + at + _keystr(path),
                                    key, "momentum_buffer")
                    for path, key in tree]
        return []

    def _tx(self, prefix, tree):
        if self.scheduled:  # chain(tx, scale_by_schedule)
            return (self._base(prefix + "[0]", tree)
                    + [self._count_leaf(prefix + "[1].count")])
        return self._base(prefix, tree)

    def _split(self, prefix, tree):
        if self.taps:  # split_dense_tx: multi_transform {dense, sparse}
            return self._tx(prefix + ".inner_states['dense'].inner_state",
                            [(p, k) for p, k in tree if k not in self.taps])
        return self._tx(prefix, tree)

    def _freeze(self, prefix, tree):
        if self.trainer.trainable_pattern:  # _freeze_except
            return self._split(
                prefix + ".inner_states['train'].inner_state",
                [(p, k) for p, k in tree if k in self.train])
        return self._split(prefix, tree)

    def _opt_state(self):
        if self.k == 1:
            return self._freeze(".opt_state", self.tree)

        def write_mini(v):
            self.opt.mini_step = _scalar(v)

        out = [(".opt_state.mini_step", lambda: np.int32(self.opt.mini_step),
                write_mini),
               self._count_leaf(".opt_state.gradient_step")]
        out += self._freeze(".opt_state.inner_opt_state", self.tree)
        out += [self._acc_leaf(".opt_state.acc_grads" + _keystr(path), key)
                for path, key in self.tree]
        return out

    def _acc_leaf(self, name, key):
        p, kernel = self.state.params[key], self._kernel(key)
        i = self.trainable.get(id(p))

        def read():
            if i is None or not self.opt.accum:
                # a tapped table's dense gradient is zero in JAX; a
                # frozen parameter's sum never reaches an update
                return _host(torch.zeros_like(p), kernel)
            return _host(self.opt.accum[i], kernel)

        def write(v):
            if i is None:
                return
            if not self.opt.accum:
                self.opt.accum = [torch.zeros_like(q)
                                  for q in self.opt.trainable()]
            _copy_into(self.opt.accum[i], v, kernel, name)

        return (name, read, write)

    # ------------------------------------------------- the sparse-row tier

    def _row_states(self):
        rule = self.trainer._row_rule
        out = []
        for path_str, key in sorted(("/".join(self.paths[k]), k)
                                    for k in self.taps):
            rs = self.state.embed_opt_state[key]
            prefix = ".embed_opt_state[%r]" % path_str
            base = prefix + ("[0]" if self.scheduled else "")
            if rule.kind == "adam":
                out.append(self._row_count(base + "[0].count", key))
                out += [self._row_slot(base + "[0].%s" % field, rs, i)
                        for i, field in enumerate(("mu", "nu"))]
            elif rule.kind == "momentum":
                out.append(self._row_slot(base + "[0].trace", rs, 0))
            if self.scheduled:
                out.append(self._row_count(prefix + "[1].count", key))
        return out

    def _row_count(self, name, key):
        rs = self.state.embed_opt_state[key]
        self.row_count_names.setdefault(key, []).append(name)

        def write(v):
            rs.count = _scalar(v)

        return (name, lambda: np.int32(rs.count), write)

    def _row_slot(self, name, rs, i):
        return (name, lambda: _host(rs.slots[i]),
                lambda v: _copy_into(rs.slots[i], v, 0, name))

    # -------------------------------------------------------- top level

    def _write_step(self, v):
        self.state.step = _scalar(v)

    def _write_rng(self, v):
        self.state.rng = np.asarray(_as_tensor(v)).astype(np.uint32)

    def finish(self, restored):
        """Derive what JAX does not store from what was restored."""
        if not self.stores_count and ".step" in restored:
            self.opt.count = self.state.step // self.k
        for p in self.opt.trainable():
            st = self.optimizer.state.get(p)
            if st and "step" in st:
                st["step"].fill_(float(self.opt.count))
        for key, rs in self.state.embed_opt_state.items():
            if not restored.intersection(self.row_count_names.get(key, ())):
                rs.count = self.opt.count


def _dense_kind(optimizer):
    """The optax transform a torch optimizer stands for: "adam"
    (optax.adam / adamw), "momentum" (optax.sgd with momentum, after
    add_decayed_weights when the SGD has a weight_decay) or "sgd"."""
    groups = optimizer.param_groups
    if type(optimizer) in (torch.optim.Adam, torch.optim.AdamW):
        if any(g.get("amsgrad") for g in groups):
            raise NotImplementedError(
                "checkpoint names: amsgrad has no leaf in optax.adam's "
                "state")
        if type(optimizer) is torch.optim.Adam and any(
                g.get("weight_decay") for g in groups):
            raise NotImplementedError(
                "checkpoint names: Adam with a coupled weight_decay has no "
                "optax counterpart the JAX names cover")
        return "adam"
    if type(optimizer) is torch.optim.SGD:
        return "momentum" if any(g.get("momentum") for g in groups) else (
            "sgd")
    raise NotImplementedError(
        "checkpoint names: the torch optimizer %s has no optax "
        "counterpart the JAX names cover (Adam, AdamW and SGD do)"
        % type(optimizer).__name__)


def flatten_state(trainer, state):
    """{JAX keystr: host array} of a port TrainState, with exactly the
    names, shapes, dtypes and leaf order the JAX Trainer's flatten_state
    gives for the same spec and options (see the module docstring). The
    values are host copies: numpy arrays, or torch.bfloat16 tensors."""
    layout = _Layout(trainer, state)
    if state.opt_state.row_stage:
        logger.warning(
            "checkpoint between microbatches: the staged row gradients of "
            "the tapped tables are not part of the state (nor are they in "
            "the JAX Trainer's) and are not saved")
    return {name: read() for name, read, _write in layout.leaves}


def restore_state_from_flat(trainer, state, flat, strict=True):
    """Copy an already-loaded flat checkpoint into the live `state` in
    place and return it. Extra keys are ignored. strict=False warm
    starts: leaves absent from the checkpoint keep their current
    values."""
    layout = _Layout(trainer, state)
    missing = [name for name, _r, _w in layout.leaves if name not in flat]
    if missing and strict:
        raise ValueError(
            "Checkpoint is missing %d leaves, e.g. %s. Pass strict=False "
            "to warm-start: missing leaves keep their fresh "
            "initialization." % (len(missing), missing[:3]))
    if missing:
        logger.info("warm start: %d leaves kept their fresh init (e.g. %s)",
                    len(missing), missing[:3])
    restored = set()
    for name, _read, write in layout.leaves:
        if name in flat:
            write(flat[name])
            restored.add(name)
    layout.finish(restored)
    return state


def restore_state_from_checkpoint(trainer, state, checkpoint_dir,
                                  version=None, strict=True):
    """Restore `state` in place from a checkpoint (the latest valid
    version when `version` is None). Returns (state, version)."""
    flat, version = load_checkpoint(checkpoint_dir, version)
    return restore_state_from_flat(trainer, state, flat, strict=strict), (
        version)


# ---------------------------------------------------------------- saver


class CheckpointSaver(object):
    """Writes and prunes versioned sharded checkpoints of `trainer`'s
    state (or, with `save_flat`, of given leaves): checkpoint_steps
    (save every N model versions; 0 = disabled), keep_max_version (0 =
    keep all), num_shards files a version.

    extra_state_fn: () -> {name: array} merged into every save.
    async_save: the copy from the device to the host stays on the
    calling thread (a consistent snapshot of the live tensors the next
    step overwrites); serialization, sha256, the write and the prune run
    on a background thread, at most one in flight.

    `last_timing` holds the last save's seconds: `device_to_host_s` (on
    the caller), `serialize_sha256_s` and `write_rename_s`, and `bytes`.

    Under a mesh (`trainer.mesh` over more than one process, every rank
    holding the same replicated state) world rank 0 alone (`writer`)
    writes each version, the whole TrainState as on one device, and
    alone prunes; every rank then waits at the mesh's barrier, so no
    rank reads a half-written version.
    """

    def __init__(self, trainer, checkpoint_dir, checkpoint_steps=0,
                 keep_max_version=0, num_shards=1, extra_state_fn=None,
                 async_save=False):
        self.trainer = trainer
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_steps = int(checkpoint_steps)
        self.keep_max_version = int(keep_max_version)
        self.extra_state_fn = extra_state_fn
        self.async_save = bool(async_save)
        self._write_thread = None
        self._write_error = None
        if self.async_save:
            import atexit

            # drain an in-flight write on clean interpreter exit so the
            # final checkpoint is never lost to the daemon thread dying
            atexit.register(self.wait)
        self.num_shards = int(num_shards)
        if self.num_shards <= 0:
            raise ValueError("num_shards must be positive")
        self._last_saved_version = -1
        self.last_timing = {}
        mesh = getattr(trainer, "mesh", None)
        self._mesh = mesh if mesh is not None and mesh.world_size > 1 else None
        self.writer = self._mesh is None or self._mesh.world_rank == 0

    def is_enabled(self):
        return bool(self.checkpoint_dir) and self.checkpoint_steps > 0

    def save_flat(self, flat, version):
        """Write an already-flat {JAX keystr: array} as version-<V>, as
        `save` writes a state's leaves (synchronously; `trainer` may be
        None): how a derived artifact such as an int8-quantized params
        tree (`params_tree_leaves`) becomes a checkpoint a server
        restores. Returns the version dir."""
        version = int(version)
        out = self._write_and_log(dict(flat), {}, version,
                                  {"device_to_host_s": 0.0})
        self._last_saved_version = version
        return out

    def maybe_save(self, state, version=None):
        """Save iff `version` (default state.step) crosses a
        checkpoint_steps boundary."""
        if not self.is_enabled():
            return False
        version = int(version if version is not None else state.step)
        if version <= 0 or version % self.checkpoint_steps != 0:
            return False
        if version == self._last_saved_version:
            return False
        self.save(state, version)
        return True

    def save(self, state, version):
        """Write version-<V> atomically (temp dir + rename), then prune.
        With async_save, return once the host copy is taken; under a
        mesh, once the version is on disk and every rank is at the
        barrier."""
        version = int(version)
        if self._mesh is not None:
            if self.writer:
                self._save(state, version)
                self.wait()
            self._last_saved_version = version
            self._mesh.barrier()
            return self._version_dir(version)
        return self._save(state, version)

    def _save(self, state, version):
        extra = dict(self.extra_state_fn()) if self.extra_state_fn else {}
        t0 = time.perf_counter()
        flat = flatten_state(self.trainer, state)
        timing = {"device_to_host_s": time.perf_counter() - t0}
        if self.async_save:
            self.wait()  # at most one in-flight write; re-raises failures
            self._write_thread = threading.Thread(
                target=self._write_guarded,
                args=(flat, extra, version, timing),
                daemon=True, name="ckpt-write-v%d" % version)
            # eager: maybe_save must not fire this version twice while
            # the write is in flight (a failed write resets it)
            self._last_saved_version = version
            self._write_thread.start()
            return self._version_dir(version)
        out = self._write_and_log(flat, extra, version, timing)
        self._last_saved_version = version
        return out

    def wait(self):
        """Block until an in-flight async write completes, re-raising its
        failure."""
        if self._write_thread is not None:
            self._write_thread.join()
            self._write_thread = None
        if self._write_error is not None:
            err, self._write_error = self._write_error, None
            raise err

    def _write_guarded(self, flat, extra, version, timing):
        try:
            self._write_and_log(flat, extra, version, timing)
        except BaseException as e:  # noqa: BLE001 - re-raised in wait()
            self._write_error = e
            # the version was not durably written: let maybe_save retry
            self._last_saved_version = -1
            logger.error("async checkpoint write of version-%d failed: %s",
                         version, e)

    def _write_and_log(self, flat, extra, version, timing):
        final_dir = self._version_dir(version)
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        tmp_dir = tempfile.mkdtemp(prefix=".version-%d." % version,
                                   dir=self.checkpoint_dir)
        serialize_s = write_s = 0.0
        total = 0
        try:
            shards = self._partition(flat)
            if extra:
                shards[0].update(extra)
            digests = {}
            for i in range(self.num_shards):
                name = "variables-%d-of-%d.ckpt" % (i, self.num_shards)
                digest = hashlib.sha256()
                # stream each part to the hash and the file: the payload
                # is never built in memory (serialize_ndarray_dict's
                # bytes, byte for byte)
                with open(os.path.join(tmp_dir, name), "wb") as f:
                    t0 = time.perf_counter()
                    for part in ndarray_dict_parts(shards[i]):
                        digest.update(part)
                        t2 = time.perf_counter()
                        f.write(part)
                        t3 = time.perf_counter()
                        serialize_s += t2 - t0
                        write_s += t3 - t2
                        total += len(part)
                        t0 = t3
                digests[name] = digest.hexdigest()
            t1 = time.perf_counter()
            meta = {"version": version, "num_shards": self.num_shards,
                    "leaf_count": len(flat), "shard_digests": digests}
            with open(os.path.join(tmp_dir, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.isdir(final_dir):
                shutil.rmtree(final_dir)
            os.rename(tmp_dir, final_dir)
            tmp_dir = None
            write_s += time.perf_counter() - t1
        finally:
            if tmp_dir is not None and os.path.isdir(tmp_dir):
                shutil.rmtree(tmp_dir, ignore_errors=True)
        self.last_timing = dict(timing, serialize_sha256_s=serialize_s,
                                write_rename_s=write_s, bytes=total)
        logger.info("Saved checkpoint version-%d (%d shards) to %s",
                    version, self.num_shards, self.checkpoint_dir)
        self._prune()
        return final_dir

    def _version_dir(self, version):
        return os.path.join(self.checkpoint_dir, "version-%d" % version)

    def _partition(self, flat):
        shards = [dict() for _ in range(self.num_shards)]
        for name, arr in flat.items():
            shards[string_to_id(name, self.num_shards)][name] = arr
        return shards

    def _prune(self):
        if self.keep_max_version <= 0:
            return
        versions = _list_versions(self.checkpoint_dir)
        for v in versions[:-self.keep_max_version]:
            shutil.rmtree(self._version_dir(v), ignore_errors=True)
            logger.info("Pruned checkpoint version-%d", v)


def check_params_flat(model, flax_param_path, flat):
    """Raise ValueError when a `.params` leaf of `flat` has another shape
    than its parameter of `model` (a flax kernel transposed), before
    anything is copied: what a server checks before it swaps in a
    checkpoint, so a mismatched one leaves every weight as it was. An
    int8-quantized leaf (api/quantization) is checked by its int8
    values' shape, the float leaf's."""
    for key, p in model.named_parameters():
        path = tuple(flax_param_path(key).split("/"))
        name = ".params" + _keystr(path)
        leaf = flat.get(name, flat.get(name + "['__w8__']"))
        if leaf is None:
            continue
        kernel = _is_kernel(path, p)
        want = (tuple(p.shape[i] for i in _TO_FLAX[kernel]) if kernel
                else tuple(p.shape))
        if tuple(leaf.shape) != want:
            raise ValueError("checkpoint leaf %s has shape %s, the model %s"
                             % (name, tuple(leaf.shape), want))


# ------------------------------------------------------------- reading


def _list_versions(checkpoint_dir):
    if not checkpoint_dir or not os.path.isdir(checkpoint_dir):
        return []
    versions = []
    for name in os.listdir(checkpoint_dir):
        m = _VERSION_RE.match(name)
        if m:
            versions.append(int(m.group(1)))
    return sorted(versions)


def _has_complete_set(path, total):
    return total in _complete_set_counts(path)


def _is_valid_version_dir(path):
    """Valid iff it holds all M ``variables-*-of-M.ckpt`` files of some
    M."""
    return bool(_complete_set_counts(path))


def get_latest_checkpoint_version(checkpoint_dir):
    """Largest version whose dir is valid, or -1."""
    for v in reversed(_list_versions(checkpoint_dir)):
        if _is_valid_version_dir(
                os.path.join(checkpoint_dir, "version-%d" % v)):
            return v
    return -1


def load_checkpoint(checkpoint_dir, version=None):
    """Merge all shard files of one complete set of a version into one
    {name: array}; the set meta.json names, else the largest complete
    one. Returns (flat, version)."""
    if version is None:
        version = get_latest_checkpoint_version(checkpoint_dir)
    if version < 0:
        raise FileNotFoundError("No valid checkpoint under %r"
                                % checkpoint_dir)
    vdir = os.path.join(checkpoint_dir, "version-%d" % version)
    if not _is_valid_version_dir(vdir):
        raise FileNotFoundError("Invalid checkpoint dir %r" % vdir)
    want = None
    if os.path.exists(os.path.join(vdir, "meta.json")):
        try:
            want = int(_read_meta(vdir).get("num_shards"))
        except (ValueError, TypeError, OSError):
            want = None
    if want is None or not _has_complete_set(vdir, want):
        want = max(_complete_set_counts(vdir))
    flat = {}
    for name in sorted(os.listdir(vdir)):
        m = _SHARD_RE.match(name)
        if m and int(m.group(2)) == want:
            with open(os.path.join(vdir, name), "rb") as f:
                flat.update(deserialize_ndarray_dict(f.read()))
    return flat, version
