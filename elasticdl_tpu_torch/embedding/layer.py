"""Embedding layer of the port: the counterpart of
elasticdl_tpu/embedding/layer.py.

A table is one [vocab, dim] parameter named `embedding_table`; lookups
go through the gather kernel (`ops.embedding_ops`, csrc/embedding_gather.cu
on the card). `lookup_many(layers, ids)` looks up many layers at once, as
a DLRM forward does for its 26 tables: one launch gathers for every
layer whose table takes no autograd gradient here (tapped tables, and
every table under no_grad). Ragged inputs are padded id
matrices [batch, max_ids] where PADDING_ID (-1) marks absent entries; a
combiner (sum / mean / sqrtn) reduces them as `safe_embedding_lookup`
does (empty rows give zero vectors).

Gradients take one of two tiers, as in the JAX package:

* tapped tables (`sparse_grads`, by default every table of at least
  EMBEDDING_PARTITION_THRESHOLD_BYTES = 2 MiB): inside the Trainer's
  `row_tap`, a grad-enabled forward gathers from the detached table,
  makes the gathered rows a leaf that requires grad and records (ids,
  rows). After backward(), rows.grad is the per-row gradient the flax
  perturbation gives; nothing [vocab, dim] is made, and the row tier
  (embedding/sparse_update.py) applies it. A second call of one tapped
  layer in one forward raises.
* every other table: `EmbeddingGatherFunction`, whose forward is the
  gather kernel and whose backward is a dense scatter-add (index_put_
  with accumulate, in a fixed order) into a zero [vocab, dim] gradient
  (jnp.take's scatter-add backward); the masked dense tier
  (embedding/sparse_optim.py) keeps untouched rows still.

Ids outside [0, vocab) clamp into range (row 0 for padding, the last row
past the end), as the TPU gather kernel clamps; the JAX layer's
jnp.take returns NaN rows for ids >= vocab instead (ROADMAP queue 3).
"""

import contextlib

import torch
from torch import nn

from elasticdl_tpu_torch.common import constants
from elasticdl_tpu_torch.ops.dispatch import resolve_device
from elasticdl_tpu_torch.ops.embedding_ops import (
    PADDING_ID,
    embedding_gather,
    embedding_gather_many,
)

# Param name the row tiers key on.
EMBEDDING_PARAM_NAME = "embedding_table"


def get_initializer(name_or_fn):
    """Keras initializer names -> fn(tensor, generator) that fills the
    tensor in place from `generator`. 'uniform' is keras
    RandomUniform(-0.05, 0.05); normal and truncated_normal (cut at two
    standard deviations, as flax's) have stddev 0.05."""
    if callable(name_or_fn):
        return name_or_fn
    name = (name_or_fn or "uniform").lower()
    if name in ("uniform", "random_uniform"):
        return lambda t, gen: t.uniform_(-0.05, 0.05, generator=gen)
    if name in ("normal", "random_normal"):
        return lambda t, gen: t.normal_(0.0, 0.05, generator=gen)
    if name in ("truncated_normal",):
        return lambda t, gen: nn.init.trunc_normal_(
            t, 0.0, 0.05, -0.1, 0.1, generator=gen)
    if name in ("glorot_uniform", "xavier_uniform"):
        def _glorot(t, gen):
            limit = (6.0 / (t.shape[-2] + t.shape[-1])) ** 0.5
            return t.uniform_(-limit, limit, generator=gen)

        return _glorot
    if name in ("zeros", "zero"):
        return lambda t, gen: t.zero_()
    if name in ("ones", "one"):
        return lambda t, gen: t.fill_(1.0)
    raise ValueError("Unknown embeddings_initializer %r" % name_or_fn)


def combine_gathered(gathered, ids, combiner="mean", weights=None):
    """Combiner math over gathered rows [B, L, D]; see
    safe_embedding_lookup."""
    dtype = gathered.dtype
    mask = (ids != PADDING_ID).to(dtype)
    w = mask if weights is None else torch.as_tensor(
        weights, dtype=dtype, device=gathered.device) * mask
    summed = torch.einsum("bl,bld->bd", w, gathered)
    if combiner == "sum":
        return summed
    denom = w.sum(dim=1, keepdim=True)
    if combiner == "sqrtn":
        denom = denom.sqrt()
    elif combiner != "mean":
        raise ValueError("Unknown combiner %r" % combiner)
    return summed / denom.clamp(min=1e-12)


class EmbeddingGatherFunction(torch.autograd.Function):
    """table[clip(ids)] through the gather kernel; the table's gradient
    is the dense scatter-add of the output gradient at the clamped ids,
    as index_put_ with accumulate: on the card it sorts the ids and sums
    each row's contributions in one fixed order (index_add_'s atomic
    adds would sum them in any order), so a step's gradient is the same
    bit for bit on every run."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.vocab, ctx.dim = table.shape
        return embedding_gather(table, ids)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        rows = ids.reshape(-1).long().clamp(0, ctx.vocab - 1)
        dtable = torch.zeros((ctx.vocab, ctx.dim), dtype=grad.dtype,
                             device=grad.device)
        dtable.index_put_((rows,), grad.reshape(-1, ctx.dim),
                          accumulate=True)
        return dtable, None


def _gather(table, ids):
    if torch.is_grad_enabled() and table.requires_grad:
        return EmbeddingGatherFunction.apply(table, ids)
    return embedding_gather(table, ids)


def _gather_rows(layers, ids):
    """The gathered rows ids[t].shape + (dim,) of each layer: one
    embedding_gather_many per (dim, dtype) over the layers that are
    tapped (a grad-enabled forward under `row_tap`) or whose table
    takes no gradient here; EmbeddingGatherFunction for each table of
    the dense tier. A tapped layer records (ids, rows) with rows a leaf
    that requires grad; a second call of it in one forward raises."""
    grad = torch.is_grad_enabled()
    rows = [None] * len(layers)
    groups, taps = {}, set()
    for t, layer in enumerate(layers):
        table = layer.embedding_table
        if layer._tap is not None and grad:
            records, name = layer._tap
            if name in records or name in taps:
                # one tap per layer and forward: a second call's row
                # gradients could not be told apart from the first's
                raise ValueError(
                    "sparse-grad Embedding %r called more than once per "
                    "forward; use one layer instance per call site or set "
                    "sparse_grads=False" % name)
            taps.add(name)
        elif grad and table.requires_grad:
            rows[t] = EmbeddingGatherFunction.apply(table, ids[t])
            continue
        groups.setdefault((table.shape[1], table.dtype), []).append(t)
    for members in groups.values():
        # the whole id matrix when every layer is in the group: the
        # kernel reads each table's ids in place
        group_ids = ids if len(members) == len(layers) else [
            ids[t] for t in members]
        gathered = embedding_gather_many(
            [layers[t].embedding_table.detach() for t in members], group_ids)
        for t, out in zip(members, gathered):
            if layers[t]._tap is not None and grad:
                records, name = layers[t]._tap
                out.requires_grad_()
                records[name] = (ids[t], out)
            rows[t] = out
    return rows


def lookup_many(layers, ids):
    """[layer(ids[t]) for t, layer in enumerate(layers)] in as few
    launches as the tiers allow (see `_gather_rows`): `ids` is a list of
    id tensors, one per layer, or one tensor whose rows ids[t] are layer
    t's (a DLRM forward's [tables, batch] matrix)."""
    if len(ids) != len(layers):
        raise ValueError("lookup_many: %d layers, %d id sets"
                         % (len(layers), len(ids)))
    device = layers[0].embedding_table.device if layers else None
    if isinstance(ids, torch.Tensor):
        ids = ids.to(device)
    else:
        ids = [torch.as_tensor(i, device=device) for i in ids]
    for layer, i in zip(layers, ids):
        layer._check_ids(i)
    return [layer._combine(rows, i) for layer, rows, i in
            zip(layers, _gather_rows(layers, ids), ids)]


def safe_embedding_lookup(table, ids, combiner="mean", weights=None):
    """Combined lookup over padded ragged ids [batch, max_ids]
    (PADDING_ID = absent): rows with no ids give zero vectors; `weights`
    weight each id's vector and the mean/sqrtn denominators. Returns
    [batch, dim]."""
    return combine_gathered(_gather(table, ids), ids, combiner=combiner,
                            weights=weights)


def is_embedding_param(name):
    """True for a parameter name (state_dict key) of an embedding table."""
    return name.split(".")[-1] == EMBEDDING_PARAM_NAME


@contextlib.contextmanager
def row_tap(layers):
    """Tap the Embedding layers `layers` ({table param name: layer}) for
    one forward. Yields {table param name: (ids, rows)}, filled by each
    layer's grad-enabled call; rows.grad holds the per-row gradient
    after backward()."""
    records = {}
    for name, layer in layers.items():
        layer._tap = (records, name)
    try:
        yield records
    finally:
        for layer in layers.values():
            layer._tap = None


class Embedding(nn.Module):
    """Counterpart of the JAX package's `Embedding`.

    Input forms: int ids [batch] or [batch, k] with combiner=None ->
    embeddings with a trailing dim axis; padded ragged ids [batch,
    max_ids] with a combiner -> combined [batch, dim]. The table is
    drawn by the initializer from `generator` (a torch.Generator on the
    layer's device; seed 0 when None). `sparse_grads`: None = auto (the
    table's bytes against the 2 MiB threshold), True/False to override.
    """

    def __init__(self, input_dim, output_dim, embeddings_initializer="uniform",
                 combiner=None, param_dtype=torch.float32, sparse_grads=None,
                 device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        self.embeddings_initializer = embeddings_initializer
        self.combiner = combiner
        self.sparse_grads = sparse_grads
        self.embedding_table = nn.Parameter(torch.empty(
            (self.input_dim, self.output_dim), dtype=param_dtype,
            device=device))
        self._tap = None
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        if generator is None:
            generator = torch.Generator(
                device=self.embedding_table.device).manual_seed(0)
        get_initializer(self.embeddings_initializer)(self.embedding_table,
                                                     generator)

    @property
    def sparse_enabled(self):
        """True when the table takes the row tier: `sparse_grads` if set,
        else param bytes >= EMBEDDING_PARTITION_THRESHOLD_BYTES (the
        global 2 MiB, not a Trainer setting)."""
        if self.sparse_grads is not None:
            return bool(self.sparse_grads)
        t = self.embedding_table
        return (t.numel() * t.element_size()
                >= constants.EMBEDDING_PARTITION_THRESHOLD_BYTES)

    def forward(self, ids, weights=None):
        ids = torch.as_tensor(ids, device=self.embedding_table.device)
        self._check_ids(ids)
        return self._combine(_gather_rows([self], [ids])[0], ids, weights)

    def _check_ids(self, ids):
        if self.combiner is not None and ids.dim() != 2:
            raise ValueError(
                "combiner=%r needs [batch, max_ids] padded ids, got shape %s"
                % (self.combiner, tuple(ids.shape)))

    def _combine(self, gathered, ids, weights=None):
        if self.combiner is None:
            return gathered
        return combine_gathered(gathered, ids, combiner=self.combiner,
                                weights=weights)
