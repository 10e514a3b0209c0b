"""The training step of the port: the dense and sparse-row tiers of
elasticdl_tpu/training/trainer.py on PyTorch.

One `train_step` is the model's forward with autograd on, the zoo loss
over per-example weights (padded rows of a partial batch weigh 0),
`backward()`, the zoo optimizer's update and the row tier's. The JAX
package compiles that into one XLA program and returns a new state;
here PyTorch runs it eagerly and updates the parameters and optimizer
slots in place, and `train_step` returns the same `TrainState` with
`step` advanced.

Tiers:

* dense: every trainable parameter but the tapped tables, through the
  zoo's torch optimizer. Embedding tables it holds (the untapped ones)
  keep untouched rows and their slot rows still
  (embedding/sparse_optim.py, optax `make_row_sparse`);
* sparse-row: embedding tables the layer taps (`Embedding.sparse_enabled`,
  by default tables of at least 2 MiB). The forward runs inside
  `row_tap`; after backward() `apply_flat_row_updates` dedups each
  table's ids and updates the touched rows and their slots in place with the
  optimizer factory's row rule (the row-update kernel on the card). A
  table's row state (`TrainState.embed_opt_state`) keeps its own update
  count, as a per-table optax state does.

Semantics kept from the JAX Trainer:

* gradient accumulation as optax.MultiSteps: k calls make one applied
  update with the running mean of their gradients (the same Welford
  update, acc += (g - acc) / (n + 1)); the calls in between move no
  parameter, weight decay included; `step` advances on every call. The
  row tier stages each microbatch's (ids, row gradients / k) and applies
  their concatenation at the boundary, so every tier advances once per
  k calls, as one k-times-larger batch would;
* `trainable_pattern`: a regex over flax parameter paths
  ("block_7/attn/qkv/kernel"), as the spec's `flax_param_path` names
  them (the port's own names where the spec has none); parameters
  it does not match are frozen entirely, no gradient and no decay, as
  optax.set_to_zero does. A tapped table it does not match raises: the
  row tier would train it anyway;
* a `LearningRateScheduler` callback scales the whole update (decay
  included) by multiplier_fn(applied updates so far, from 0), as
  optax.chain(tx, scale_by_schedule(fn)) does: each parameter group's lr
  is set to base x multiplier before `step()`, and each tapped table's
  row lr by multiplier_fn(its own count).
* model state: `TrainState.model_state` is {state_dict key: buffer} of
  the model's BatchNorm running averages (flax's `batch_stats`,
  model_zoo/flax_layers.py `model_state_buffers`). Every training
  forward updates them in place, the microbatches of an accumulation
  cycle included and under a `trainable_pattern` freeze too, as the JAX
  step returns the mutated collection on every call; padded rows enter
  the batch statistics (only the loss is weighted), in both packages.
  Evaluation and prediction read the running averages;
* dropout: each training forward runs inside `dropout_rng` with a
  generator on the Trainer's device seeded from (seed, step before the
  call) (`dropout_generator`), as the JAX step folds its key with the
  step. The masks are torch's bits, not `jax.random`'s; a model without
  Dropout layers is untouched.

Meshes (`mesh` from `parallel.mesh.build_mesh({"dp": m, "sp": n})`,
one process per rank): every rank is given the same global batch. Dp
rank d takes rows [d b / m, (d + 1) b / m) (b % m == 0, as JAX's batch
sharding asks), so the padded rows of a partial batch all fall on the
last dp rank, and sp rank r takes its sequence slice of those rows'
[b, l] features and labels (l % n == 0). The model runs inside the
mesh, so its attention rings (or all-to-alls) the sp shards;
parameters are replicated. The loss is the global batch's, not a mean
of shard losses (the zoo losses average over rows' valid tokens or
masked positions, which split unevenly across shards), so the step
asks the spec's partial form, `loss_parts(labels, predictions,
weights, mesh)`: a local numerator and a denominator already reduced
over the mesh (it does not depend on the parameters). Each rank
back-propagates its numerator over the denominator, and the step's
loss is the numerators' sum over the world over the denominator, the
same on every rank. A spec without the partial form runs under sp
alone: the step all-gathers the detached local logits, runs the spec's
loss on the whole sequence through a leaf tensor and back-propagates
this rank's slice of that leaf's gradient. After backward the
gradients are summed over the world, so every rank applies the same
update and the parameters stay identical across ranks. `forward` and
`evaluate_batch` return the whole global batch's outputs on every rank.
The row tier, the host tier and the `*_assembled` entry points do not
run under a mesh (ROADMAP Queue 1 item 7).

The host-spill tier (`attach_host_embeddings`, before the first step;
embedding/host_bridge.py): `train_step` and `forward` pull each batch's
unique rows of the host tables on the host (`manager.prepare`), the
rows go to the device as one leaf tensor per table that requires grad,
and after backward() each leaf's `.grad` is the per-row gradient the
native engines apply (`manager.apply`, with the learning-rate
schedule's multiplier at the update count, as the JAX Trainer scales
the host tier). Under accumulation each microbatch stages its row
gradients / k and the boundary applies the cycle (`stage` /
`apply_staged`). A failed apply or stage is not retried: the rows miss
that update, and `tier_health` counts the failed cycles and dropped row
updates. The tier does not run under a mesh, nor with a
`trainable_pattern` (the engines would train the tables anyway).
"""

import contextlib
import inspect
import logging
import re

import numpy as np
import torch

from elasticdl_tpu_torch.api.callbacks import LearningRateScheduler
from elasticdl_tpu_torch.common.prng import state_rng
from elasticdl_tpu_torch.embedding import sparse_update
from elasticdl_tpu_torch.embedding.host_bridge import check_manager
from elasticdl_tpu_torch.embedding.layer import (
    EMBEDDING_PARAM_NAME,
    Embedding,
    is_embedding_param,
    row_tap,
)
from elasticdl_tpu_torch.embedding.sparse_optim import masked_step
from elasticdl_tpu_torch.model_zoo.flax_layers import (
    Dropout,
    dropout_generator,
    dropout_rng,
    model_state_buffers,
)
from elasticdl_tpu_torch.ops.dispatch import resolve_device
from elasticdl_tpu_torch.parallel.mesh import MESH_ITEM, WORLD, Mesh

logger = logging.getLogger(__name__)


class OptState(object):
    """The optimizer side of a TrainState: the torch optimizer (its
    per-parameter slots live in `optimizer.state`), the base learning
    rate of each parameter group, `count` (applied updates, what a
    learning-rate schedule reads) and the gradient-accumulation buffers
    (`accum`, one per trainable parameter, `row_stage`, the staged row
    gradients of the tapped tables, and `mini_step`)."""

    def __init__(self, optimizer, count=0):
        self.optimizer = optimizer
        self.base_lrs = [g["lr"] for g in optimizer.param_groups]
        self.count = int(count)
        self.accum = []
        self.row_stage = []
        self.mini_step = 0

    def trainable(self):
        return [p for g in self.optimizer.param_groups for p in g["params"]]


class TrainState(object):
    """step: train_step calls so far (the model version); params: {torch
    key: the model's live parameter}; opt_state: an OptState;
    embed_opt_state: {tapped table's key: sparse_update.RowState};
    model_state: {torch key: the model's live BatchNorm buffer} (flax's
    `batch_stats`); rng: the JAX Trainer's state key for the same seed
    (uint32 [2]), which no port model draws from (dropout draws from
    `dropout_generator`): it travels through checkpoints only."""

    def __init__(self, step, params, opt_state, embed_opt_state=None,
                 rng=None, model_state=None):
        self.step = int(step)
        self.params = params
        self.opt_state = opt_state
        self.embed_opt_state = embed_opt_state or {}
        self.model_state = model_state or {}
        self.rng = (np.zeros(2, np.uint32) if rng is None
                    else np.asarray(rng, np.uint32))

    @property
    def version(self):
        return int(self.step)


def _split_label(batch):
    """(features, labels) for train/eval batches, bare features else."""
    if isinstance(batch, tuple) and len(batch) == 2:
        return batch[0], batch[1]
    return batch, None


class Trainer(object):
    """Owns the model and optimizer of a port ModelSpec on one device,
    or on this rank of a dp x sp mesh."""

    def __init__(self, model_spec, mesh=None, model_params="", seed=0,
                 callbacks=None, grad_accum_steps=1, trainable_pattern=None,
                 device="cuda"):
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise NotImplementedError(
                    "Trainer: only the dp x sp mesh of parallel.mesh."
                    "build_mesh is ported (%s), got %r" % (MESH_ITEM, mesh))
            others = {a: n for a, n in mesh.shape.items()
                      if a not in ("dp", "sp") and n > 1}
            if others:
                raise NotImplementedError(
                    "Trainer: mesh axes %s are not ported; dp and sp only "
                    "(%s)" % (others, MESH_ITEM))
        self.mesh = mesh
        self.spec = model_spec
        self.seed = seed
        self.device = resolve_device(device)
        self.model = model_spec.create_model(model_params, device=self.device,
                                             seed=seed)
        if callbacks is None and model_spec.callbacks_fn is not None:
            callbacks = model_spec.callbacks_fn()
        self._lr_multiplier_fn = None
        for cb in callbacks or []:
            if isinstance(cb, LearningRateScheduler):
                self._lr_multiplier_fn = cb.multiplier_fn
                break
        self.grad_accum_steps = max(1, int(grad_accum_steps))
        self.trainable_pattern = trainable_pattern
        # filled by init_state: the parameters trainable_pattern trains,
        # the tapped tables, their row rule, the embedding tables of the
        # dense tier
        self.train_names = set()
        self._taps = {}
        self._row_rule = None
        self._masked_tables = []
        self._loss_takes_weights = (
            len(inspect.signature(model_spec.loss).parameters) >= 3)
        if not self._loss_takes_weights:
            logger.warning(
                "loss() takes no sample_weights arg: padded rows of partial "
                "final batches will enter the loss unmasked")
        self._host_manager = None
        self._ran = False
        self._has_dropout = any(isinstance(m, Dropout)
                                for m in self.model.modules())
        # the host tier's health: a failed apply or stage drops those
        # rows' update (no retry); cumulative for the Trainer's lifetime,
        # the worker forwards them to the master as tier/ counters
        self.tier_health = {"host_failed_cycles": 0,
                            "host_dropped_row_updates": 0}

    # ------------------------------------------------------- host bridge

    def attach_host_embeddings(self, manager):
        """Register a HostEmbeddingManager (embedding/host_bridge.py),
        before the first step or forward; None attaches no tier, as in
        the JAX Trainer. Anything else raises TypeError."""
        if manager is not None:
            check_manager(manager)
        if self._ran:
            raise RuntimeError(
                "attach_host_embeddings must precede the first step")
        if manager is not None and self._world() > 1:
            raise NotImplementedError(
                "the host-spill tier does not run under a mesh (%s)"
                % MESH_ITEM)
        self._host_manager = manager
        return self

    @property
    def host_manager(self):
        return self._host_manager

    def _host_prepare(self, features):
        if self._host_manager:
            return self._host_manager.prepare(features)
        return features

    def _host_lr_scale(self, pre_step):
        """The schedule's multiplier at the update count (the macro step
        under accumulation), as the JAX Trainer scales the host tier.
        Read before the step, so a schedule that raises fails while the
        batch can still be retried."""
        if self._lr_multiplier_fn is None:
            return 1.0
        return float(self._lr_multiplier_fn(pre_step
                                            // self.grad_accum_steps))

    def _host_post_step(self, pre_step, host_grads, scale):
        """Apply (k = 1) or stage the host tier's row gradients; the
        boundary of an accumulation cycle applies the staged cycle. A
        failure is logged and counted, never raised: the dense update
        has been applied, so a retry would apply it twice."""
        manager, k = self._host_manager, self.grad_accum_steps
        if k == 1:
            at_risk = self._host_rows_at_risk(staged=False)
            try:
                manager.apply(host_grads, lr_scale=scale)
            except Exception:
                self._count_dropped_host_rows(at_risk)
                logger.exception("host-embedding apply failed; affected "
                                 "rows miss this update (no retry)")
            return
        try:
            manager.stage(host_grads, weight=1.0 / k)
        except Exception:
            self._count_dropped_host_rows(
                self._host_rows_at_risk(staged=False))
            logger.exception("host-embedding stage failed; this "
                             "microbatch's rows miss the cycle (no retry)")
        if pre_step % k == k - 1:
            at_risk = self._host_rows_at_risk(pending=False)
            try:
                manager.apply_staged(lr_scale=scale)
            except Exception:
                self._count_dropped_host_rows(at_risk)
                logger.exception("host-embedding apply_staged failed; the "
                                 "staged cycle's rows miss this update (no "
                                 "retry)")

    def _host_rows_at_risk(self, pending=True, staged=True):
        """Row updates a failure would drop: the current microbatch's
        pulled rows (`pending`) and/or the accumulation buffer
        (`staged`). Never raises (it feeds exception handlers)."""
        try:
            rows = 0
            if pending:
                rows += self._host_manager.pending_row_count()
            if staged:
                rows += self._host_manager.staged_row_count()
            return rows
        except Exception:
            return 0

    def _count_dropped_host_rows(self, rows):
        self.tier_health["host_failed_cycles"] += 1
        self.tier_health["host_dropped_row_updates"] += int(rows)

    # ---------------------------------------------------------------- init

    def _trainable_names(self):
        names = [n for n, _p in self.model.named_parameters()]
        if not self.trainable_pattern:
            return set(names)
        rex = re.compile(self.trainable_pattern)
        path = self.spec.flax_param_path or (lambda name: name)
        train = {n for n in names if rex.search(path(n))}
        logger.info("trainable_pattern %r: %d/%d param tensors train",
                    self.trainable_pattern, len(train), len(names))
        if not train:
            logger.warning("trainable_pattern %r matches NOTHING — every "
                           "parameter is frozen and training is a no-op",
                           self.trainable_pattern)
        return train

    def _tapped_tables(self):
        """{table param key: Embedding layer} of the tables the row tier
        takes."""
        return {("%s." % name if name else "") + EMBEDDING_PARAM_NAME: mod
                for name, mod in self.model.named_modules()
                if isinstance(mod, Embedding) and mod.sparse_enabled}

    def init_state(self, example_batch, params=None, opt_state=None,
                   step=0):
        """A fresh TrainState over the model's seeded parameters.
        `params` (a state_dict, e.g. from convert.params_from_flax, with
        the BatchNorm buffers of a model that has them) replaces them;
        `opt_state` (as convert.adam_state_from_optax returns it) seeds
        the AdamW slots and the applied-update count;
        `step` sets the model version. Tapped embedding tables stay out
        of the torch optimizer and get zeroed row slots in
        `embed_opt_state`. `example_batch` is accepted for the JAX
        Trainer's signature: the port's parameters do not depend on
        it."""
        del example_batch
        if params is not None:
            self.model.load_state_dict(params)
        taps = self._tapped_tables()
        train = self.train_names = self._trainable_names()
        escaped = sorted(n for n in taps if n not in train)
        if self.trainable_pattern and self._host_manager is not None:
            raise NotImplementedError(
                "trainable_pattern freezes the dense optimizer path only; "
                "host-spill tables run their own update engines. Disable "
                "the tier (no host_embeddings) for fine-tuning.")
        if escaped:
            raise NotImplementedError(
                "trainable_pattern freezes the dense optimizer path only; "
                "sparse-row tables %s run their own update engine. Match "
                "them in the pattern, or set sparse_grads=False for "
                "fine-tuning." % escaped)
        factory = self.spec.optimizer()
        self._row_rule = getattr(factory, "row_rule", None)
        if taps and self._row_rule is None:
            raise NotImplementedError(
                "the sparse-row tier has no row rule for this optimizer: %s"
                % (getattr(factory, "row_rule_missing", None)
                   or "the factory carries none (training.optimizers.sgd "
                   "and adam do)"))
        if taps and self._world() > 1:
            raise NotImplementedError(
                "the sparse-row tier does not run under a mesh (%s); set "
                "sparse_grads=False" % MESH_ITEM)
        self._taps = taps
        named = dict(self.model.named_parameters())
        dense = [n for n in named if n in train and n not in taps]
        for name, p in named.items():
            p.requires_grad_(name in dense)
        optimizer = factory([named[n] for n in dense])
        self._masked_tables = [named[n] for n in dense
                               if is_embedding_param(n)]
        count = 0
        if opt_state is not None:
            count = int(opt_state["count"])
            for name in dense:
                optimizer.state[named[name]] = {
                    "step": torch.tensor(float(count)),
                    "exp_avg": opt_state["exp_avg"][name].to(self.device),
                    "exp_avg_sq": opt_state["exp_avg_sq"][name].to(
                        self.device),
                }
        embed_opt_state = {
            n: sparse_update.RowState(self._row_rule.init_slots(named[n]))
            for n in sorted(taps)}
        return TrainState(step, named, OptState(optimizer, count),
                          embed_opt_state, rng=state_rng(self.seed),
                          model_state=model_state_buffers(self.model))

    # ---------------------------------------------------------------- steps

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _features(self, features):
        if isinstance(features, dict):
            return {k: self._tensor(v) for k, v in features.items()}
        return self._tensor(features)

    def _compute_loss(self, labels, predictions, weights):
        if self._loss_takes_weights:
            return self.spec.loss(labels, predictions, weights)
        return self.spec.loss(labels, predictions)

    # ---------------------------------------------------- dp x sp (mesh)

    def _world(self):
        return 1 if self.mesh is None else self.mesh.world_size

    def _dropout_scope(self, step):
        if not self._has_dropout:
            return contextlib.nullcontext()
        return dropout_rng(self.model, dropout_generator(self.seed, step,
                                                         self.device))

    def _mesh_scope(self):
        return (self.mesh if self.mesh is not None
                else contextlib.nullcontext())

    def _dp_rows(self, x):
        """This dp rank's rows of `x` (a [b, ...] array or a dict of
        them; None stays None)."""
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: self._dp_rows(v) for k, v in x.items()}
        x = np.asarray(x)
        n, d = self.mesh.dp_size, self.mesh.dp_rank
        if x.shape[0] % n:
            raise ValueError("batch size %d is not a multiple of dp = %d"
                             % (x.shape[0], n))
        part = x.shape[0] // n
        return x[d * part:(d + 1) * part]

    def _sp_slice(self, features):
        """This rank's sequence slice of every [b, l] feature, and l."""
        if not isinstance(features, dict):
            raise ValueError("an sp step takes a feature dict")
        n, r = self.mesh.size, self.mesh.rank
        local, length = {}, None
        for key, x in features.items():
            x = np.asarray(x)
            if length is None and x.ndim >= 2:
                length = x.shape[1]
            if x.ndim < 2 or x.shape[1] != length:
                raise ValueError("sp features must all be [b, l, ...]; %r "
                                 "is %s" % (key, x.shape))
            if length % n:
                raise ValueError("sequence length %d is not a multiple of "
                                 "sp = %d" % (length, n))
            part = length // n
            local[key] = x[:, r * part:(r + 1) * part]
        return local, length

    def _local_batch(self, features, labels, weights):
        """This rank's share of a global batch: its dp rows, then its
        sp slice of the features (and of [b, l] labels when the spec
        has a partial loss). Returns (features, labels, weights,
        length)."""
        length = None
        if self.mesh.dp_size > 1:
            features = self._dp_rows(features)
            labels, weights = self._dp_rows(labels), self._dp_rows(weights)
        if self.mesh.size > 1:
            features, length = self._sp_slice(features)
            if self.spec.loss_parts is not None and labels is not None:
                labels, _ = self._sp_slice({"labels": labels})
                labels = labels["labels"]
        return features, labels, weights, length

    def _mesh_loss_backward(self, local_preds, labels, weights, length):
        """The global batch's loss from the spec's partial form (or, for
        a spec without one under sp alone, from the all-gathered
        logits), and this rank's share of its gradient back-propagated
        (see the module docstring). Returns the loss."""
        mesh = self.mesh
        parts = self.spec.loss_parts
        if parts is None:
            return self._sp_gather_loss_backward(local_preds, labels,
                                                 weights, length)
        num, den = parts(labels, local_preds, weights, mesh)
        if num.requires_grad:
            (num / den).backward()
        total = mesh.all_reduce_sum(num.detach().reshape(1), WORLD)[0]
        return total / den

    def _sp_gather_loss_backward(self, local_logits, labels, weights,
                                 length):
        """A spec without `loss_parts` under sp alone: the loss over the
        whole sequence from every rank's gathered logits."""
        if not isinstance(local_logits, torch.Tensor):
            raise NotImplementedError(
                "an sp step of a spec without loss_parts takes logits")
        full = self.mesh.all_gather(local_logits.detach(), 1)
        full.requires_grad_()
        loss = self._compute_loss(labels, full, weights)
        if loss.requires_grad:
            loss.backward()
            part = length // self.mesh.size
            start = self.mesh.rank * part
            local_logits.backward(full.grad[:, start:start + part])
        return loss

    def _sum_grads(self, params):
        """Sum each parameter's gradient over the world, in one flat
        exchange."""
        flat = torch.cat([p.grad.reshape(-1).float() for p in params])
        flat = self.mesh.all_reduce_sum(flat, WORLD)
        offset = 0
        for p in params:
            n = p.grad.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
            offset += n

    def train_step(self, state, batch, true_count=None):
        """One microbatch: forward, loss, backward and (on an update
        boundary) the optimizer step and the row updates. `batch` =
        (features, labels) numpy already padded to the static batch
        size; `true_count` masks the padding. Updates `state` in place;
        returns (state, float loss). After the call each dense trainable
        parameter's `.grad` holds the gradient the optimizer consumed
        (the accumulated mean at a boundary) or, between boundaries,
        this microbatch's gradient."""
        self._ran = True
        features, labels = _split_label(batch)
        weights = _make_weights(_leading_dim(features), true_count)
        opt = state.opt_state
        opt.optimizer.zero_grad(set_to_none=True)
        pre_step = state.step
        host = self._host_manager
        if host:
            scale = self._host_lr_scale(pre_step)
            features = host.prepare(features)
        sharded = self._world() > 1
        if sharded:
            if self.mesh.dp_size > 1 and self.spec.loss_parts is None:
                raise NotImplementedError(
                    "the dp axis needs the spec's partial loss "
                    "(loss_parts); this spec has none (%s)" % MESH_ITEM)
            features, labels, weights, length = self._local_batch(
                features, labels, weights)
        features = self._features(features)
        host_rows = {}
        if host:
            for key in host.rows_keys():
                host_rows[key] = features[key].requires_grad_()
        with row_tap(self._taps) as records, self._mesh_scope(), (
                self._dropout_scope(pre_step)):
            preds = self.model(features, training=True)
        labels, weights = self._tensor(labels), self._tensor(weights)
        trainable = opt.trainable()
        if sharded:
            loss = self._mesh_loss_backward(preds, labels, weights, length)
        else:
            loss = self._compute_loss(labels, preds, weights)
            if loss.requires_grad:
                loss.backward()
        for p in trainable:
            if p.grad is None:  # unused by this batch: optax sees zeros
                p.grad = torch.zeros_like(p)
        if sharded and trainable:
            self._sum_grads(trainable)
        rows = sparse_update.tap_gradients(records)
        state.step += 1
        k = self.grad_accum_steps
        if host:
            host_grads = {key: r.grad if r.grad is not None
                          else torch.zeros_like(r)
                          for key, r in host_rows.items()}
            self._host_post_step(pre_step, host_grads, scale)
        if k > 1:
            if not opt.accum:
                opt.accum = [torch.zeros_like(p) for p in trainable]
            n = opt.mini_step
            for acc, p in zip(opt.accum, trainable):
                acc.add_((p.grad - acc) / (n + 1))
            if rows:
                opt.row_stage.append(
                    {t: (ids, g / k) for t, (ids, g) in rows.items()})
            if n < k - 1:
                opt.mini_step = n + 1
                return state, float(loss.detach())
            for acc, p in zip(opt.accum, trainable):
                p.grad.copy_(acc)
                acc.zero_()
            staged, opt.row_stage = opt.row_stage, []
            rows = {t: (torch.cat([m[t][0] for m in staged]),
                        torch.cat([m[t][1] for m in staged]))
                    for t in rows}
            opt.mini_step = 0
        mult = 1.0
        if self._lr_multiplier_fn is not None:
            mult = float(self._lr_multiplier_fn(opt.count))
        for group, base in zip(opt.optimizer.param_groups, opt.base_lrs):
            group["lr"] = base * mult
        with masked_step(opt.optimizer, self._masked_tables):
            opt.optimizer.step()
        opt.count += 1
        if rows:
            sparse_update.apply_flat_row_updates(
                self._row_rule, state.params, state.embed_opt_state, rows,
                self._lr_multiplier_fn)
        return state, float(loss.detach())

    def forward(self, state, features):
        """Inference forward (evaluation / prediction) under no_grad;
        under a mesh, the outputs of the whole global batch on every
        rank."""
        del state
        self._ran = True
        features = self._host_prepare(features)
        sharded = self._world() > 1
        if sharded:
            features, _labels, _weights, _length = self._local_batch(
                features, None, None)
        with torch.no_grad(), self._mesh_scope():
            preds = self.model(self._features(features), training=False)
            if sharded:
                preds = self._gather_outputs(preds)
        return preds

    def _gather_outputs(self, preds):
        """Local outputs -> the global batch's: [b, l, ...] sequence
        shards gathered over sp, then rows over dp."""
        if isinstance(preds, dict):
            return {k: self._gather_outputs(v) for k, v in preds.items()}
        if self.mesh.size > 1:
            preds = self.mesh.all_gather(preds, 1)
        return self.mesh.all_gather(preds, 0, "dp")

    def evaluate_batch(self, state, batch, true_count=None):
        """(outputs, labels) as numpy, trimmed to true_count, for metric
        aggregation."""
        features, labels = _split_label(batch)
        preds = self.forward(state, features)

        def trim(x):
            if isinstance(x, torch.Tensor):
                x = x.detach().float().cpu().numpy()
            x = np.asarray(x)
            return x[:true_count] if true_count is not None else x

        if isinstance(preds, dict):
            preds = {k: trim(v) for k, v in preds.items()}
        else:
            preds = trim(preds)
        labels = trim(labels) if labels is not None else None
        return preds, labels

    # ------------------------------------------------- not ported (raise)

    def train_step_assembled(self, state, features, labels, weights):
        raise NotImplementedError(
            "Trainer: the SPMD (assembled) step is not ported (%s)"
            % MESH_ITEM)

    def forward_assembled(self, state, features):
        raise NotImplementedError(
            "Trainer: the SPMD (assembled) forward is not ported (%s)"
            % MESH_ITEM)


def _leading_dim(features):
    if isinstance(features, dict):
        return np.asarray(next(iter(features.values()))).shape[0]
    return np.asarray(features).shape[0]


def _make_weights(batch_size, true_count):
    if true_count is None or true_count >= batch_size:
        return np.ones((batch_size,), np.float32)
    w = np.zeros((batch_size,), np.float32)
    w[:true_count] = 1.0
    return w
