"""Row-sparse embedding updates: O(touched rows) per step. The
counterpart of elasticdl_tpu/embedding/sparse_update.py.

The Embedding layer taps each large table (embedding/layer.py
`row_tap`), so backward() gives a gradient per gathered row and no
[vocab, dim] gradient. The Trainer keeps tapped tables out of its torch
optimizer; after backward() it reads the taps (`tap_gradients`) and
calls `apply_flat_row_updates`: per table, dedup the ids (summing the
rows of repeated ids) and advance its update count, then one launch of
the row-update kernel over every table of one width (`row_update_many`,
each table with its own hyperparameters) updates the tables and their
slot tables in place with the optimizer's row rule. Under gradient accumulation the
Trainer stages each microbatch's taps and applies their concatenation at
the boundary; the JAX package's
`apply_row_updates` (taps straight to updates) is that call on one
microbatch.

The JAX package runs the optax transform itself on the gathered rows
and scatters the result back; here `RowRule` maps each optax transform
the port's optimizer factories stand for onto a rule of the row kernel
that computes the same update (training/optimizers.py).
"""

import math

import torch

from elasticdl_tpu_torch.ops import embedding_ops as eo
from elasticdl_tpu_torch.ops import update_math as um


class RowRule(object):
    """The update a table of the row tier takes: `kind` is "sgd",
    "momentum" or "adam", with the optax transform's hyperparameters
    (lr; momentum and nesterov; b1, b2 and eps)."""

    _SLOTS = {"sgd": 0, "momentum": 1, "adam": 2}

    def __init__(self, kind, lr, momentum=None, nesterov=False, b1=0.9,
                 b2=0.999, eps=1e-8):
        if kind not in self._SLOTS:
            raise ValueError("unknown row rule %r" % (kind,))
        self.kind = kind
        self.lr = float(lr)
        self.momentum = momentum
        self.nesterov = bool(nesterov)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)

    def init_slots(self, table):
        """Zero slot tables like `table` (optax initialises its traces
        and moments at zero)."""
        return [torch.zeros_like(table, memory_format=torch.contiguous_format)
                for _ in range(self._SLOTS[self.kind])]

    def kernel_hyper(self, count, scale=1.0):
        """The row kernel's hyperparameters (row_update_plain's `hyper`)
        for a table at its 1-based update count `count`, with `scale`
        the learning-rate schedule's multiplier."""
        lr = self.lr * scale
        if self.kind == "sgd":
            return [lr]
        if self.kind == "momentum":
            return [lr, self.momentum, 1.0 if self.nesterov else 0.0]
        # optax.adam steps lr m_hat / (sqrt(v_hat) + eps) with
        # m_hat = m / (1 - b1^t), v_hat = v / (1 - b2^t), which is
        #   [lr sqrt(1 - b2^t) / (1 - b1^t)]
        #     * m / (sqrt(v) + eps sqrt(1 - b2^t));
        # the kernel steps alpha m / (sqrt(v) + eps') with alpha =
        # lr sqrt(1 - b2^t) / (1 - b1^t) (adam_alpha), so the two agree
        # exactly for eps' = eps sqrt(1 - b2^t).
        eps = self.eps * math.sqrt(1.0 - self.b2 ** count)
        return [um.adam_alpha(lr, self.b1, self.b2, count), self.b1,
                self.b2, eps]


class RowState(object):
    """A tapped table's row-optimizer state: `slots` (tensors shaped like
    the table) and `count`, the row updates applied to this table so far
    (what the schedule and Adam's bias correction read), kept per table
    as a per-table optax state keeps its own."""

    def __init__(self, slots, count=0):
        self.slots = slots
        self.count = int(count)


def row_sparse_apply(rule, table, state, ids, row_grads, multiplier_fn=None):
    """Apply `rule` to exactly the rows named by `ids` (any shape; may
    repeat; ids < 0 or >= vocab are dropped), with `row_grads` the
    gradient of each gathered row ([*ids.shape, dim]). Updates the table
    and `state` in place; all data movement is O(len(ids) * dim)."""
    apply_flat_row_updates(rule, {"": table}, {"": state},
                           {"": (ids, row_grads)}, multiplier_fn)


def tap_gradients(records):
    """{table name: (ids, rows)} of a row tap after backward() ->
    {table name: (ids, row gradients)}; a table the loss did not reach
    gets zero gradients, as the JAX perturbation's gradient is zero."""
    out = {}
    for name, (ids, rows) in records.items():
        grad = rows.grad if rows.grad is not None else torch.zeros_like(rows)
        out[name] = (ids.reshape(-1), grad.reshape(ids.numel(), -1))
    return out


def apply_flat_row_updates(rule, tables, states, staged, multiplier_fn=None):
    """Row-sparse update of every table in `staged` ({table name: (ids
    [m], grads [m, dim])}), e.g. the concatenated microbatches of one
    gradient-accumulation cycle (the dedup sums repeats across them).
    `tables` and `states` are keyed by the same names. Each table's
    count advances and its schedule scale is read at its own count;
    then one `row_update_many` per table width updates them all (a DLRM
    step's 26 tables share one; DeepFM's [V, 64] table and [V, 1] bias
    take two)."""
    by_dim = {}  # dim -> (groups, ids, grads, hypers)
    for name in sorted(staged):
        table, state = tables[name].detach(), states[name]
        flat, row_grads = staged[name]
        flat = flat.reshape(-1)
        uniq, summed = eo.dedup_indexed_slices(
            flat, row_grads.reshape(flat.numel(), -1).to(table.dtype))
        scale = 1.0 if multiplier_fn is None else float(
            multiplier_fn(state.count))
        state.count += 1
        group = by_dim.setdefault(table.shape[1], ([], [], [], []))
        group[0].append([table] + state.slots)
        group[1].append(uniq)
        group[2].append(summed)
        group[3].append(rule.kernel_hyper(state.count, scale))
    for groups, ids, grads, hypers in by_dim.values():
        eo.row_update_many(rule.kind, groups, ids, grads, hypers)
