"""Sparse embedding-row ops for the PyTorch port: the counterpart of
elasticdl_tpu/ops/embedding_ops.py.

* `embedding_gather(table, ids)` -> csrc/embedding_gather.cu, the port
  of `_gather_kernel`: table[clip(ids, 0, vocab - 1)] for int ids of any
  shape;
* `sparse_sgd_update`, `sparse_momentum_update`, `sparse_adam_update`,
  `sparse_adagrad_update` -> csrc/row_update.cu, the port of
  `_make_row_kernel` and its four row kernels: in place, per id, read
  the row and its slot rows, apply the rule of `ops/update_math.py`,
  write them back; ids < 0 or >= vocab are skipped;
* `dedup_indexed_slices(ids, values)`: sum the value rows that share an
  id (`torch.unique` + `index_add_`), as the row tier does before every
  update.

Each kernel wrapper launches its kernel for CUDA tensors (or raises) and
runs its plain PyTorch version (`embedding_gather_plain`,
`row_update_plain`) for CPU tensors. `KERNEL_LAUNCHES` counts kernel
launches per wrapper. The TPU kernels' 128-lane padding and 8-id chunks
are Mosaic layout rules and have no counterpart here: any dim works.
"""

import ctypes

import torch

from elasticdl_tpu_torch.ops import _build
from elasticdl_tpu_torch.ops import update_math as um
from elasticdl_tpu_torch.ops.dispatch import on_kernel_path

PADDING_ID = -1

#: kernel launches per wrapper; chip_smoke.py resets and reads these to
#: show that the DLRM training path went through the kernels
KERNEL_LAUNCHES = {"embedding_gather": 0, "row_update": 0}

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


# ------------------------------------------------------------------ gather


def embedding_gather_plain(table, ids):
    """Plain version of the gather kernel: table[clip(ids)]."""
    vocab = table.shape[0]
    return table[ids.long().clamp(0, vocab - 1)]


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
    vocab, dim = table.shape
    if table.dtype not in _GATHER_DTYPES:
        raise TypeError("embedding_gather kernel takes %s tables, got %s"
                        % ([str(d) for d in _GATHER_DTYPES], table.dtype))
    if vocab == 0:
        raise ValueError("embedding_gather: empty table")
    table = table.detach().contiguous()
    flat = ids.reshape(-1).to(torch.int32).contiguous()
    out = torch.empty((flat.numel(), dim), dtype=table.dtype,
                      device=table.device)
    if flat.numel() and dim:
        size = table.element_size()
        vec16 = int(dim * size % 16 == 0 and table.data_ptr() % 16 == 0
                    and out.data_ptr() % 16 == 0)
        err = _gather_lib().edl_embedding_gather(
            table.data_ptr(), flat.data_ptr(), out.data_ptr(), flat.numel(),
            vocab, dim, size, vec16, _stream(table))
        _check_launch(err, "embedding_gather")
        KERNEL_LAUNCHES["embedding_gather"] += 1
    return out.reshape(tuple(ids.shape) + (dim,))


def _gather_lib():
    lib = _build.load("embedding_gather")
    fn = lib.edl_embedding_gather
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_void_p] * 3
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
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
    g = grads.reshape(ids.numel(), -1)[keep]
    new = um.rule_math(rule, [t[rows_at] for t in tables], g, hyper)
    for t, rows in zip(tables, new):
        t.index_copy_(0, rows_at, rows)


def _row_update(rule, tables, ids, grads, hyper):
    """Run `rule` (sgd / momentum / adam / adagrad) over the rows named
    by `ids` of `tables` (the parameter table first, then its slots),
    in place: the kernel for CUDA tensors, `row_update_plain` for CPU
    tensors."""
    code, n_tables = _RULES[rule]
    if len(tables) != n_tables:
        raise ValueError("%s updates %d tables, got %d"
                         % (rule, n_tables, len(tables)))
    vocab, dim = tables[0].shape
    n = ids.numel()
    if grads.numel() != n * dim:
        raise ValueError("row_update: grads must be [%d, %d], got shape %s"
                         % (n, dim, tuple(grads.shape)))
    if any(t.shape != tables[0].shape for t in tables):
        raise ValueError("row_update: slot tables must match the table")
    if not on_kernel_path(ids, grads, *tables):
        row_update_plain(rule, tables, ids, grads, hyper)
        return
    for t in tables + [grads]:
        if t.dtype != torch.float32:
            raise TypeError("row_update kernel takes float32 tables and "
                            "grads, got %s" % t.dtype)
    if not all(t.is_contiguous() for t in tables):
        raise ValueError("row_update kernel updates contiguous tables in "
                         "place")
    flat = ids.reshape(-1).to(torch.int32).contiguous()
    g = grads.reshape(n, dim).contiguous()
    if n == 0 or dim == 0:
        return
    ptrs = [t.data_ptr() for t in tables] + [None] * (3 - n_tables)
    h = list(hyper) + [0.0] * (4 - len(hyper))
    # Adam's 1 - b1 and 1 - b2, from the hyperparameters in double and
    # rounded once, as the plain version's Python scalars and optax round
    # them (1 - b2 in fp32 from b2 = 0.999 would be 1.3e-5 off)
    h += [1.0 - h[1], 1.0 - h[2]] if rule == "adam" else [0.0, 0.0]
    err = _row_lib().edl_row_update(
        code, *ptrs, flat.data_ptr(), g.data_ptr(), n, vocab, dim,
        *[float(x) for x in h], _stream(g))
    _check_launch(err, "row_update")
    KERNEL_LAUNCHES["row_update"] += 1


def _row_lib():
    lib = _build.load("row_update")
    fn = lib.edl_row_update
    if not fn.argtypes:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int]
                       + [ctypes.c_float] * 6 + [ctypes.c_void_p])
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
