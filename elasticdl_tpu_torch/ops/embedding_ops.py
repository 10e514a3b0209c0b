"""Sparse embedding-row ops for the PyTorch port: the counterpart of
elasticdl_tpu/ops/embedding_ops.py.

* `embedding_gather(table, ids)` -> csrc/embedding_gather.cu, the port
  of `_gather_kernel`: table[clip(ids, 0, vocab - 1)] for int ids of any
  shape; `embedding_gather_many(tables, ids)` does it for many tables
  of one dim and dtype in one launch (a DLRM forward's 26 lookups);
* `sparse_sgd_update`, `sparse_momentum_update`, `sparse_adam_update`,
  `sparse_adagrad_update` -> csrc/row_update.cu, the port of
  `_make_row_kernel` and its four row kernels: in place, per id, read
  the row and its slot rows, apply the rule of `ops/update_math.py`,
  write them back; ids < 0 or >= vocab are skipped;
  `row_update_many(rule, groups, ids, grads, hypers)` does it for many
  tables, each with its own hyperparameters, in one launch (a DLRM
  step's 26 updates);
* `dedup_indexed_slices(ids, values)`: sum the value rows that share an
  id (`torch.unique` + `index_add_`), as the row tier does before every
  update.

Each kernel wrapper launches its kernel for CUDA tensors (or raises) and
runs its plain PyTorch version (`embedding_gather_plain`,
`row_update_plain`, and the loops over them `embedding_gather_many_plain`,
`row_update_many_plain`) for CPU tensors. A launch takes up to
GROUP_TABLES tables; a call with more launches once per GROUP_TABLES.
The one-table wrappers launch the same kernels with one table.
`KERNEL_LAUNCHES` counts kernel launches per wrapper. The TPU kernels'
128-lane padding and 8-id chunks are Mosaic layout rules and have no
counterpart here: any dim works.
"""

import ctypes

import torch

from elasticdl_tpu_torch.ops import _build
from elasticdl_tpu_torch.ops import update_math as um
from elasticdl_tpu_torch.ops.dispatch import on_kernel_path

PADDING_ID = -1

#: tables a launch takes (csrc's MAX_TABLES): their descriptors travel in
#: the kernel's parameters
GROUP_TABLES = 32

#: kernel launches per wrapper; chip_smoke.py resets and reads these to
#: show that the DLRM training path went through the kernels
KERNEL_LAUNCHES = {"embedding_gather": 0, "embedding_gather_many": 0,
                   "row_update": 0, "row_update_many": 0}

_GATHER_DTYPES = (torch.float32, torch.bfloat16)
# rule codes of csrc/row_update.cu and the number of tables each updates
_RULES = {"sgd": (0, 1), "momentum": (1, 2), "adam": (2, 3),
          "adagrad": (3, 2)}


def reset_launch_counts():
    for name in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[name] = 0


def _check_launch(err, name):
    if err != 0:
        raise RuntimeError(
            "%s kernel launch failed: cudaError %d" % (name, err))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_groups(launch, descs, counter):
    """launch(n, desc values) for each run of up to GROUP_TABLES of
    `descs` (one tuple of values per table), counting each launch."""
    for at in range(0, len(descs), GROUP_TABLES):
        part = descs[at:at + GROUP_TABLES]
        _check_launch(launch(len(part), part), counter)
        KERNEL_LAUNCHES[counter] += 1


# ------------------------------------------------------------------ gather


def embedding_gather_plain(table, ids):
    """Plain version of the gather kernel: table[clip(ids)]."""
    vocab = table.shape[0]
    return table[ids.long().clamp(0, vocab - 1)]


def embedding_gather_many_plain(tables, ids):
    """Plain version of the grouped gather: embedding_gather_plain per
    table."""
    return [embedding_gather_plain(t, i) for t, i in zip(tables, ids)]


def embedding_gather(table, ids):
    """table [vocab, dim] gathered at int ids of any shape ->
    ids.shape + (dim,), ids clamped into [0, vocab): padding ids (-1)
    read row 0 (the caller masks them out, see `safe_embedding_lookup`)
    and ids >= vocab read the last row. The csrc/embedding_gather.cu
    kernel for CUDA tensors (fp32 or bf16), `embedding_gather_plain`
    for CPU tensors. No autograd: see embedding/layer.py for the
    gradient."""
    if table.dim() != 2:
        raise ValueError("embedding_gather takes a [vocab, dim] table, "
                         "got shape %s" % (tuple(table.shape),))
    if not on_kernel_path(table, ids):
        return embedding_gather_plain(table, ids)
    return _gather([table], [ids], "embedding_gather")[0]


def embedding_gather_many(tables, ids):
    """embedding_gather for each table of `tables` ([vocab_t, dim], one
    dim and one dtype) at its ids: `ids` is a list of int tensors, one
    per table, or one tensor whose rows ids[t] are table t's. Returns the
    list of ids[t].shape + (dim,) outputs, each with embedding_gather's
    clamp. One kernel launch per GROUP_TABLES tables for CUDA tensors,
    `embedding_gather_many_plain` for CPU tensors."""
    tables = list(tables)
    if len(ids) != len(tables):
        raise ValueError("embedding_gather_many: %d tables, %d id sets"
                         % (len(tables), len(ids)))
    if not tables:
        return []
    if any(t.dim() != 2 for t in tables):
        raise ValueError("embedding_gather_many takes [vocab, dim] tables, "
                         "got shapes %s" % [tuple(t.shape) for t in tables])
    if len({t.shape[1] for t in tables}) > 1:
        raise ValueError("embedding_gather_many: tables of one dim, got %s"
                         % sorted({t.shape[1] for t in tables}))
    if len({t.dtype for t in tables}) > 1:
        raise TypeError("embedding_gather_many: tables of one dtype, got %s"
                        % sorted({str(t.dtype) for t in tables}))
    id_tensors = [ids] if isinstance(ids, torch.Tensor) else list(ids)
    if not on_kernel_path(*tables, *id_tensors):
        return embedding_gather_many_plain(tables, ids)
    return _gather(tables, ids, "embedding_gather_many")


def _gather(tables, ids, counter):
    """The gather kernel over `tables` at `ids` (a list, or a tensor
    whose rows are the tables' ids), on the card."""
    dim, dtype = tables[0].shape[1], tables[0].dtype
    if dtype not in _GATHER_DTYPES:
        raise TypeError("embedding_gather kernel takes %s tables, got %s"
                        % ([str(d) for d in _GATHER_DTYPES], dtype))
    if any(t.shape[0] == 0 for t in tables):
        raise ValueError("embedding_gather: empty table")
    tables = [t.detach().contiguous() for t in tables]
    if isinstance(ids, torch.Tensor):
        n = ids.numel() // len(tables)
        flat = ids.reshape(len(tables), n).to(torch.int32).contiguous()
        counts, shapes = [n] * len(tables), [tuple(ids.shape[1:])] * len(
            tables)
        id_ptrs = [flat.data_ptr() + 4 * n * t for t in range(len(tables))]
    else:
        flats = [i.reshape(-1).to(torch.int32).contiguous() for i in ids]
        counts = [f.numel() for f in flats]
        shapes = [tuple(i.shape) for i in ids]
        id_ptrs = [f.data_ptr() for f in flats]
    out = torch.empty((sum(counts), dim), dtype=dtype,
                      device=tables[0].device)
    if out.numel():
        size = tables[0].element_size()
        vec16 = int(dim * size % 16 == 0 and out.data_ptr() % 16 == 0
                    and all(t.data_ptr() % 16 == 0 for t in tables))
        descs, at = [], out.data_ptr()
        for t, ptr, n in zip(tables, id_ptrs, counts):
            if n:
                descs.append((t.data_ptr(), ptr, at, n, t.shape[0]))
            at += n * dim * size
        fn, stream = _gather_lib().edl_embedding_gather, _stream(out)
        _launch_groups(
            lambda k, part: fn(k, (ctypes.c_longlong * (5 * k))(
                *[v for d in part for v in d]), dim, size, vec16, stream),
            descs, counter)
    return [o.view(s + (dim,)) for o, s in zip(out.split(counts), shapes)]


def _gather_lib():
    lib = _build.load("embedding_gather")
    fn = lib.edl_embedding_gather
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)] + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


# ------------------------------------------------------------- row updates


@torch.no_grad()
def row_update_plain(rule, tables, ids, grads, hyper):
    """Plain version of the row-update kernel: mask the ids in [0,
    vocab), gather their rows, apply `rule`'s update math with the
    hyperparameters `hyper` (as the kernel takes them), write the rows
    back with index_copy_. In place; ids must be unique."""
    vocab = tables[0].shape[0]
    ids = ids.reshape(-1).long()
    keep = (ids >= 0) & (ids < vocab)
    rows_at = ids[keep]
    g = grads.reshape(ids.numel(), tables[0].shape[1])[keep]
    new = um.rule_math(rule, [t[rows_at] for t in tables], g, hyper)
    for t, rows in zip(tables, new):
        t.index_copy_(0, rows_at, rows)


def row_update_many_plain(rule, groups, ids, grads, hypers):
    """Plain version of the grouped row update: row_update_plain per
    table."""
    for args in zip(groups, ids, grads, hypers):
        row_update_plain(rule, *args)


def row_update_many(rule, groups, ids, grads, hypers):
    """Run `rule` (sgd / momentum / adam / adagrad) over many tables in
    place: groups[t] is table t and its slot tables, ids[t] its unique
    ids, grads[t] their gradient rows [n_t, dim] and hypers[t] its
    hyperparameters as the kernel takes them (row_update_plain's
    `hyper`: each table has its own update count and schedule). One
    dim for every table. One kernel launch per GROUP_TABLES tables for
    CUDA tensors, `row_update_many_plain` for CPU tensors."""
    _row_update_groups(rule, groups, ids, grads, hypers, "row_update_many")


def _row_update(rule, tables, ids, grads, hyper):
    """Run `rule` over the rows named by `ids` of `tables` (the parameter
    table first, then its slots), in place: the kernel for CUDA tensors,
    `row_update_plain` for CPU tensors."""
    _row_update_groups(rule, [tables], [ids], [grads], [hyper],
                       "row_update")


def _row_update_groups(rule, groups, ids, grads, hypers, counter):
    code, n_tables = _RULES[rule]
    if not len(groups) == len(ids) == len(grads) == len(hypers):
        raise ValueError("row_update: %d table groups, %d id sets, %d grad "
                         "sets, %d hyperparameter sets" % (
                             len(groups), len(ids), len(grads), len(hypers)))
    if not groups:
        return
    dim = groups[0][0].shape[-1]
    for tables, i, g in zip(groups, ids, grads):
        if len(tables) != n_tables:
            raise ValueError("%s updates %d tables, got %d"
                             % (rule, n_tables, len(tables)))
        if tables[0].dim() != 2 or tables[0].shape[1] != dim:
            raise ValueError("row_update: [vocab, %d] tables, got shape %s"
                             % (dim, tuple(tables[0].shape)))
        if g.numel() != i.numel() * dim:
            raise ValueError("row_update: grads must be [%d, %d], got "
                             "shape %s" % (i.numel(), dim, tuple(g.shape)))
        if any(t.shape != tables[0].shape for t in tables):
            raise ValueError("row_update: slot tables must match the table")
    if not on_kernel_path(*[t for tables in groups for t in tables], *ids,
                          *grads):
        row_update_many_plain(rule, groups, ids, grads, hypers)
        return
    for t in [t for tables in groups for t in tables] + list(grads):
        if t.dtype != torch.float32:
            raise TypeError("row_update kernel takes float32 tables and "
                            "grads, got %s" % t.dtype)
    if not all(t.is_contiguous() for tables in groups for t in tables):
        raise ValueError("row_update kernel updates contiguous tables in "
                         "place")
    flats = [i.reshape(-1).to(torch.int32).contiguous() for i in ids]
    gs = [g.reshape(-1).contiguous() for g in grads]
    descs = []
    for tables, f, g, hyper in zip(groups, flats, gs, hypers):
        if not f.numel() or not dim:
            continue
        ptrs = [t.data_ptr() for t in tables] + [0] * (3 - n_tables)
        h = [float(x) for x in hyper] + [0.0] * (4 - len(hyper))
        # Adam's 1 - b1 and 1 - b2, from the hyperparameters in double
        # and rounded once, as the plain version's Python scalars and
        # optax round them (1 - b2 in fp32 from b2 = 0.999 would be
        # 1.3e-5 off)
        h += [1.0 - h[1], 1.0 - h[2]] if rule == "adam" else [0.0, 0.0]
        descs.append((ptrs + [f.data_ptr(), g.data_ptr(), f.numel(),
                              tables[0].shape[0]], h))
    if not descs:
        return
    vec16 = int(dim % 4 == 0 and all(
        p % 16 == 0 for d, _h in descs for p in d[:3] + [d[4]] if p))
    fn, stream = _row_lib().edl_row_update, _stream(gs[0])
    _launch_groups(
        lambda k, part: fn(
            code, k, (ctypes.c_longlong * (7 * k))(
                *[v for d, _h in part for v in d]),
            (ctypes.c_float * (6 * k))(*[v for _d, h in part for v in h]),
            dim, vec16, stream),
        descs, counter)


def _row_lib():
    lib = _build.load("row_update")
    fn = lib.edl_row_update
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_longlong),
                       ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def sparse_sgd_update(table, ids, grads, lr):
    """rows[ids] -= lr * grads, in place; returns `table`. The ids must
    be unique (dedup_indexed_slices first): two lanes of the kernel
    writing one row would race. Ids < 0 or >= vocab are skipped."""
    _row_update("sgd", [table], ids, grads, [lr])
    return table


def sparse_momentum_update(table, velocity, ids, grads, lr, momentum=0.9,
                           nesterov=False):
    """Momentum (optax `trace`) on the rows named by unique `ids`, in
    place. Returns (table, velocity)."""
    _row_update("momentum", [table, velocity], ids, grads,
                [lr, momentum, 1.0 if nesterov else 0.0])
    return table, velocity


def sparse_adam_update(table, m, v, ids, grads, step, lr, beta1=0.9,
                       beta2=0.999, eps=1e-8):
    """Bias-corrected Adam on the rows named by unique `ids`, in place,
    for the 1-based update count `step`: p -= alpha m' / (sqrt(v') +
    eps) with alpha from `adam_alpha`. Returns (table, m, v)."""
    alpha = um.adam_alpha(lr, beta1, beta2, step)
    _row_update("adam", [table, m, v], ids, grads,
                [alpha, beta1, beta2, eps])
    return table, m, v


def sparse_adagrad_update(table, accum, ids, grads, lr, eps=1e-10):
    """Adagrad on the rows named by unique `ids`, in place. Returns
    (table, accum)."""
    _row_update("adagrad", [table, accum], ids, grads, [lr, eps])
    return table, accum


# ------------------------------------------------------------------ dedup


def dedup_indexed_slices(ids, values, num_unique=None):
    """Sum the `values` rows that share an id. Returns (unique_ids [k],
    summed [k, dim]) with k = `num_unique` (default len(ids)): the
    sorted distinct ids, then PADDING_ID with zero rows up to k, the
    JAX package's static-shape layout. A padding id among the inputs
    is a distinct id of its own whose summed row is zero. Raises when k
    is below the number of distinct ids."""
    ids = ids.reshape(-1)
    values = values.reshape(ids.numel(), -1)
    k = ids.numel() if num_unique is None else int(num_unique)
    uniq, inverse = torch.unique(ids, sorted=True, return_inverse=True)
    if uniq.numel() > k:
        raise ValueError("num_unique=%d < %d distinct ids: gradients would "
                         "be silently dropped" % (k, uniq.numel()))
    summed = torch.zeros((k, values.shape[1]), dtype=values.dtype,
                         device=values.device)
    summed.index_add_(0, inverse, values)
    out_ids = torch.full((k,), PADDING_ID, dtype=ids.dtype,
                         device=ids.device)
    out_ids[:uniq.numel()] = uniq
    summed.masked_fill_((out_ids == PADDING_ID)[:, None], 0.0)
    return out_ids, summed
