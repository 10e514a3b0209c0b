"""Host-spill embedding bridge: trains models whose embedding tables live
in host DRAM (embedding/host_spill.HostSpillEmbeddingEngine), the third
storage tier after tables in device memory (dense and sparse-row). The
port's copy of elasticdl_tpu/embedding/host_bridge.py, in the JAX
package's checkpoint names and export layout.

ElasticDL's worker pulled rows out of parameter-server memory before
the forward and pushed row gradients back after the backward. Here the
host side of the same process does both around the step on the card:

    features = manager.prepare(features)   # pull + dedup, on the host
    loss.backward()                        # on the card
    manager.apply(host_grads)              # native row optimizer update

On the card the pulled rows are a leaf tensor per table (`<table>.rows`
[cap, dim], requires_grad) and `HostEmbedding` gathers them at
`<table>.idx` through the gather kernel (embedding/layer.py
`EmbeddingGatherFunction`, csrc/embedding_gather.cu). After backward()
the leaf's `.grad` is the per-unique-row gradient the engines apply:
the backward of the gather sums the gradient of every id slot into its
row in a fixed order, so two runs of one step give the same row
gradients bit for bit.

Rows are padded to a cap (the id tensor's size rounded up to
`pad_multiple`), as in the JAX package, whose compiled step needs one
static shape.

Not ported: the SPMD multi-host mode (`enable_spmd`, which partitions
the id space over hosts), which waits for the port's parallel/ package
and raises.
"""

import re

import numpy as np
import torch
from torch import nn

from elasticdl_tpu_torch.common.tensor_utils import (
    deduplicate_indexed_slices,
)
from elasticdl_tpu_torch.embedding.host_spill import HostSpillEmbeddingEngine
from elasticdl_tpu_torch.embedding.layer import (
    EmbeddingGatherFunction,
    combine_gathered,
)
from elasticdl_tpu_torch.ops.dispatch import resolve_device
from elasticdl_tpu_torch.ops.embedding_ops import PADDING_ID, embedding_gather

# Feature-key suffixes the manager adds and HostEmbedding consumes.
ROWS_SUFFIX = ".rows"
IDX_SUFFIX = ".idx"

# Checkpoint key prefix of the engines' state, merged into the
# checkpoint's flat {keystr: array} map (checkpoint/saver.py).
CKPT_PREFIX = ".host_embeddings"


class HostEmbedding(nn.Module):
    """Model-side lookup over pre-pulled host rows.

    In place of embedding.Embedding when the table is registered with a
    HostEmbeddingManager under `table`: reads `<table>.rows` (the pulled
    unique rows) and `<table>.idx` (each id slot's row index) from the
    features the manager prepared (moved to `device` if they lie
    elsewhere) and gathers through the gather kernel on the card (its
    plain version on the CPU). With a combiner, `ids_feature` names the
    raw padded-ragged id tensor whose PADDING_ID entries the combiner
    masks. It has no parameters.
    """

    def __init__(self, table, ids_feature=None, combiner=None,
                 device="cuda"):
        super().__init__()
        self.table = table
        self.ids_feature = ids_feature
        self.combiner = combiner
        self.device = resolve_device(device)

    def forward(self, features, weights=None):
        rows = torch.as_tensor(features[self.table + ROWS_SUFFIX],
                               device=self.device)
        idx = torch.as_tensor(features[self.table + IDX_SUFFIX],
                              device=self.device)
        if torch.is_grad_enabled() and rows.requires_grad:
            gathered = EmbeddingGatherFunction.apply(rows, idx)
        else:
            gathered = embedding_gather(rows, idx)
        if self.combiner is None:
            return gathered
        if self.ids_feature is None:
            raise ValueError(
                "HostEmbedding(table=%r): combiner=%r needs ids_feature "
                "for the padding mask" % (self.table, self.combiner))
        ids = torch.as_tensor(features[self.ids_feature], device=self.device)
        return combine_gathered(gathered, ids, combiner=self.combiner,
                                weights=weights)


class _HostTable(object):
    def __init__(self, name, ids_feature, engine):
        self.name = name
        self.ids_feature = ids_feature
        self.engine = engine
        self.last_unique = None


def _round_up(n, k):
    return ((n + k - 1) // k) * k


def _host_array(x):
    """A row-gradient leaf as a host numpy array (a torch tensor on any
    device, or an array)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu").numpy()
    return np.asarray(x)


def check_manager(manager):
    """Raise TypeError unless `manager` is the port's
    HostEmbeddingManager (a JAX package manager, for one, is not)."""
    if not isinstance(manager, HostEmbeddingManager):
        raise TypeError(
            "the host-spill tier takes the port's HostEmbeddingManager "
            "(embedding/host_bridge.py); %r is not one"
            % (type(manager).__name__,))


class HostEmbeddingManager(object):
    """Owns the host engines and the pull / apply halves of the step, in
    single-process mode: each batch's unique rows are pulled from the
    local store and fed to the step as `<table>.rows` / `.idx`."""

    def __init__(self, pad_multiple=8):
        self._tables = {}
        self.pad_multiple = int(pad_multiple)
        # gradient-accumulation staging: {table: [(ids, grads), ...]}
        self._staged = {}

    def register(self, name, ids_feature, engine):
        if name in self._tables:
            raise ValueError("host table %r already registered" % name)
        self._tables[name] = _HostTable(name, ids_feature, engine)
        return self

    def enable_spmd(self, ctx):
        raise NotImplementedError(
            "HostEmbeddingManager.enable_spmd: the multi-host mode (the id "
            "space partitioned over hosts) needs the port's parallel/ "
            "package, which is not ported")

    def __bool__(self):
        return bool(self._tables)

    def tables(self):
        return dict(self._tables)

    def fresh_clone(self):
        """A new manager with the same registrations but fresh, empty
        engines: what a restore fills without touching the live stores
        (engines mutate in place)."""
        clone = HostEmbeddingManager(pad_multiple=self.pad_multiple)
        for name, t in self._tables.items():
            clone.register(name, t.ids_feature, t.engine.fresh_clone())
        return clone

    def rows_keys(self):
        """Feature keys of the pulled rows, sorted."""
        return tuple(sorted(n + ROWS_SUFFIX for n in self._tables))

    # -------------------------------------------------------------- pull

    def prepare(self, features):
        """Pull and dedup each registered table's rows for this batch.

        Returns a new features dict with `<table>.rows` [cap, dim]
        float32 and `<table>.idx` (the id tensor's shape, int32) added,
        numpy arrays. PADDING_ID ids map to row 0; the combiner mask or
        the model's own mask zeroes their gradient.
        """
        features = dict(features)
        for name, t in self._tables.items():
            ids = np.asarray(features[t.ids_feature])
            clean = np.where(ids == PADDING_ID, 0, ids).astype(np.int64)
            unique_ids, rows, inverse = t.engine.pull(clean)
            cap = _round_up(max(int(ids.size), 1), self.pad_multiple)
            padded = np.zeros((cap, t.engine.dim), np.float32)
            padded[: unique_ids.size] = rows
            features[name + ROWS_SUFFIX] = padded
            features[name + IDX_SUFFIX] = inverse.astype(np.int32)
            t.last_unique = unique_ids
        return features

    # ------------------------------------------------------------- apply

    def pending_row_count(self):
        """Rows the next apply() / stage() would update (unique pulled
        ids across tables, from the last prepare): what the Trainer's
        tier-health counters count as dropped when an apply fails."""
        return sum(t.last_unique.size for t in self._tables.values()
                   if t.last_unique is not None)

    def staged_row_count(self):
        """Row updates held in the accumulation buffer (every staged
        microbatch, repeats included): at risk if the boundary's
        apply_staged fails."""
        return sum(ids.size for pairs in self._staged.values()
                   for ids, _ in pairs)

    def apply(self, host_grads, lr_scale=1.0):
        """Apply the step's row gradients ({rows key: [cap, dim]}, the
        gradients of the loss with respect to the pulled rows, torch
        tensors or arrays) through each engine's optimizer. Must follow
        the prepare() that fed the same step. `lr_scale` multiplies
        each engine's own lr (the Trainer's learning-rate schedule).
        Every table's gradients reach the host before any engine moves,
        so a failure in the copy leaves every engine as it was."""
        for t, grads in self._local_row_grads(host_grads):
            t.engine.apply_gradients(t.last_unique, grads,
                                     lr_scale=lr_scale)

    # ------------------------------------------- gradient accumulation

    def _local_row_grads(self, host_grads):
        """[(table, its pulled rows' gradients as host arrays)]."""
        out = []
        for name, t in self._tables.items():
            if t.last_unique is None:
                raise RuntimeError(
                    "apply()/stage() before prepare() for host table %r"
                    % name)
            grads = host_grads[name + ROWS_SUFFIX][: t.last_unique.size]
            out.append((t, _host_array(grads)))
        return out

    def stage(self, host_grads, weight=1.0):
        """Hold one microbatch's row gradients (times `weight`, e.g. 1/k
        so the boundary's apply is the mean) without touching the
        engines; apply_staged applies them at the boundary. Staged
        gradients live in process memory only: a preemption inside a
        cycle drops the partial cycle."""
        for t, grads in self._local_row_grads(host_grads):
            self._staged.setdefault(t.name, []).append(
                (t.last_unique.copy(), grads * weight))

    def apply_staged(self, lr_scale=1.0):
        """Apply every staged microbatch in one engine update per table
        (repeats summed across microbatches), each engine's step
        advancing once per cycle, as every other tier does."""
        staged, self._staged = self._staged, {}
        for name, t in self._tables.items():
            pairs = staged.get(name, [])
            if not pairs:
                continue
            ids = np.concatenate([p[0] for p in pairs])
            grads = np.concatenate([p[1] for p in pairs])
            summed, uniq = deduplicate_indexed_slices(grads, ids)
            t.engine.apply_gradients(uniq, summed, lr_scale=lr_scale)

    # -------------------------------------------------------- checkpoint

    @staticmethod
    def _ckpt_base(name):
        return "%s['%s']" % (CKPT_PREFIX, name)

    def flat_state(self):
        """The engines' state as checkpoint leaves {keystr: array}, the
        JAX manager's names: `.host_embeddings['<table>'].step` and
        `.host_embeddings['<table>'].<param or slot>.ids / .values`."""
        out = {}
        for name, t in self._tables.items():
            sd = t.engine.state_dict()
            base = self._ckpt_base(name)
            out[base + ".step"] = np.asarray(sd["step"], np.int64)
            for key, value in sd.items():
                if key == "step":
                    continue
                ids, values = value
                out["%s.%s.ids" % (base, key)] = np.asarray(ids)
                out["%s.%s.values" % (base, key)] = np.asarray(values)
        return out

    def load_flat_state(self, flat):
        """Inverse of flat_state(); the restore REPLACES the engines'
        contents. A checkpoint the JAX package's SPMD mode wrote
        (`.partP` keys, one block a host) is merged: every block's rows
        restore into this one process."""
        for name, t in self._tables.items():
            base = self._ckpt_base(name)
            part_re = re.compile(re.escape(base) + r"(\.part\d+)?\.step$")
            bases = sorted(m.group(0)[: -len(".step")]
                           for m in (part_re.match(k) for k in flat) if m)
            if not bases:
                raise KeyError("checkpoint has no host-embedding state for "
                               "table %r" % name)
            state = {"step": max(int(np.asarray(flat[b + ".step"]))
                                 for b in bases)}
            for key in ["param"] + list(t.engine.slots):
                ids = np.concatenate([
                    np.atleast_1d(np.asarray(flat["%s.%s.ids" % (b, key)]))
                    for b in bases])
                values = np.concatenate([
                    np.asarray(flat["%s.%s.values" % (b, key)],
                               np.float32).reshape(-1, t.engine.dim)
                    for b in bases])
                state[key] = (ids, values)
            t.engine.load_state_dict(state)


def build_manager_from_spec(spec, force_python=False):
    """The HostEmbeddingManager a spec declares through the zoo's
    module-level `host_embeddings()`:

        {table_name: dict(ids_feature=..., dim=..., optimizer="adam",
                          <hyperparams>)}

    None when the spec declares no host table. The engines' stores are
    native unless `force_python`."""
    fn = getattr(spec, "host_embeddings_fn", None)
    if fn is None:
        return None
    config = fn()
    if not config:
        return None
    manager = HostEmbeddingManager()
    for name, cfg in config.items():
        cfg = dict(cfg)
        ids_feature = cfg.pop("ids_feature")
        dim = cfg.pop("dim")
        manager.register(name, ids_feature, HostSpillEmbeddingEngine(
            dim, force_python=force_python, **cfg))
    return manager


def attach_from_spec(trainer, spec, force_python=False):
    """Build the manager a spec declares (if any) and attach it to the
    trainer: the one wiring point of Worker and LocalExecutor. Returns
    the manager or None."""
    manager = build_manager_from_spec(spec, force_python=force_python)
    if manager:
        trainer.attach_host_embeddings(manager)
    return manager


def restore_host_state(manager, checkpoint_dir, version=None):
    """Restore the engines from a checkpoint written with the manager's
    flat_state() merged in (CheckpointSaver extra_state_fn). Returns the
    version. A caller that restores the TrainState too should call
    restore_with_host_state (one read, one version)."""
    from elasticdl_tpu_torch.checkpoint.saver import load_checkpoint

    flat, version = load_checkpoint(checkpoint_dir, version)
    manager.load_flat_state(flat)
    return version


def restore_with_host_state(trainer, state, manager, checkpoint_dir,
                            version=None):
    """Restore the TrainState in place and (when `manager` is truthy)
    the host engines from one checkpoint read: the resume path of Worker
    and LocalExecutor. One load pins both tiers to one version. Returns
    (state, version)."""
    from elasticdl_tpu_torch.checkpoint.saver import (
        load_checkpoint,
        restore_state_from_flat,
    )

    flat, version = load_checkpoint(checkpoint_dir, version)
    state = restore_state_from_flat(trainer, state, flat)
    if manager:
        manager.load_flat_state(flat)
    return state, version
