"""The port's embedding-row ops against the JAX package's kernels.

The JAX side runs its Pallas kernels (`_gather_kernel`, the row-update
kernels) in interpret mode, as tests/test_ops.py does; the port's
wrappers take CPU tensors, so they run their kernels' plain versions.
Inputs are drawn by numpy from a seed; both sides fp32. Tolerances:

* gather: exact (both copy rows);
* row updates: 1e-6 relative (rtol) with atol 1e-7 for values near
  zero: the same formulas, rounded at other places;
* dedup: exact ids, sums to 1e-6;
* the row rules (sgd, momentum, adam with eps' = eps sqrt(1 - b2^t))
  against the optax transforms on the same rows over three steps: 1e-6
  relative.
"""

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from elasticdl_tpu.ops import embedding_ops as jeo
from elasticdl_tpu.ops import update_math as jum
from elasticdl_tpu_torch.embedding.sparse_update import (
    RowRule,
    RowState,
    row_sparse_apply,
)
from elasticdl_tpu_torch.ops import embedding_ops as eo
from elasticdl_tpu_torch.ops import update_math as um

VOCAB = 48
RTOL, ATOL = 1e-6, 1e-7


@pytest.fixture(autouse=True)
def _interpreted_pallas_kernels(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode (off a TPU
    use_pallas() would route them to their jnp reference paths)."""
    monkeypatch.setenv("ELASTICDL_TPU_FORCE_INTERPRET", "1")


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _ids_with_edges(n, seed):
    """n ids in [0, VOCAB) with repeats, plus padding (-1) and ids past
    the table."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, VOCAB, size=n).astype(np.int32)
    ids[:3] = ids[3:6]
    ids[6], ids[7], ids[8] = -1, VOCAB, VOCAB + 7
    return ids


def _unique_ids_with_edges(n, seed):
    """n unique ids in [0, VOCAB) shuffled with padding and past-the-end
    ids: the row kernels' contract."""
    rs = np.random.RandomState(seed)
    ids = np.concatenate([rs.permutation(VOCAB)[:n],
                          [-1, -1, VOCAB, VOCAB + 3]]).astype(np.int32)
    return ids[rs.permutation(ids.size)]


@pytest.mark.parametrize("dim", [32, 40])
@pytest.mark.parametrize("shape", [(12,), (4, 5)])
def test_gather_plain_matches_pallas_kernel(dim, shape):
    table = _rand(VOCAB, dim, seed=dim)
    ids = _ids_with_edges(int(np.prod(shape)), seed=dim).reshape(shape)
    ref = np.asarray(jeo.embedding_gather(jnp.asarray(table), ids))
    got = eo.embedding_gather(torch.from_numpy(table), torch.from_numpy(ids))
    assert got.shape == shape + (dim,)
    np.testing.assert_array_equal(got.numpy(), ref)
    # ids are clamped into range: padding reads row 0, past-the-end the
    # last row
    flat = got.reshape(-1, dim).numpy()
    np.testing.assert_array_equal(flat[6], table[0])
    np.testing.assert_array_equal(flat[7], table[VOCAB - 1])


def _row_case(rule, dim, seed):
    """(port call, jax call, tables) for one rule on the same inputs."""
    ids = _unique_ids_with_edges(20, seed)
    grads = _rand(ids.size, dim, seed=seed + 1)
    n_tables = {"sgd": 1, "momentum": 2, "adam": 3, "adagrad": 2}[rule]
    tables = [_rand(VOCAB, dim, seed=seed + 2)]
    for k in range(1, n_tables):
        slot = 0.1 * _rand(VOCAB, dim, seed=seed + 2 + k)
        tables.append(np.abs(slot) if rule == "adagrad" or k == 2 else slot)
    kw = {
        "sgd": dict(lr=0.05),
        "momentum": dict(lr=0.05, momentum=0.9, nesterov=True),
        "adam": dict(step=3, lr=0.01, beta1=0.9, beta2=0.999, eps=1e-8),
        "adagrad": dict(lr=0.05, eps=1e-10),
    }[rule]
    port = getattr(eo, "sparse_%s_update" % rule)
    jax_fn = getattr(jeo, "sparse_%s_update" % rule)
    return ids, grads, tables, kw, port, jax_fn


@pytest.mark.parametrize("rule", ["sgd", "momentum", "adam", "adagrad"])
@pytest.mark.parametrize("dim", [32, 40])
def test_row_rules_match_pallas_kernels(rule, dim):
    ids, grads, tables, kw, port, jax_fn = _row_case(rule, dim, seed=dim)
    ref = jax_fn(*[jnp.asarray(t) for t in tables], ids, grads, **kw)
    ref = [np.asarray(r) for r in (ref if isinstance(ref, tuple) else [ref])]
    ours = [torch.from_numpy(t.copy()) for t in tables]
    out = port(*ours, torch.from_numpy(ids), torch.from_numpy(grads), **kw)
    out = out if isinstance(out, tuple) else (out,)
    assert all(o is t for o, t in zip(out, ours))  # updated in place
    touched = np.zeros(VOCAB, bool)
    touched[ids[(ids >= 0) & (ids < VOCAB)]] = True
    for got, want, before in zip(ours, ref, tables):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(got.numpy()[~touched],
                                      before[~touched])
        assert not np.array_equal(got.numpy()[touched], before[touched])


def test_update_math_matches_jax():
    p, m, v, g = (_rand(6, 8, seed=i) for i in range(4))
    v = np.abs(v)
    tp, tm, tv, tg = (torch.from_numpy(x) for x in (p, m, v, g))
    pairs = [
        (um.sgd_math(tp, tg, 0.1), jum.sgd_math(p, g, 0.1)),
        (um.momentum_math(tp, tm, tg, 0.1, 0.9, True),
         jum.momentum_math(p, m, g, 0.1, 0.9, 1.0)),
        (um.momentum_math(tp, tm, tg, 0.1, 0.9, False),
         jum.momentum_math(p, m, g, 0.1, 0.9, 0.0)),
        (um.adam_math(tp, tm, tv, tg, 0.01, 0.9, 0.999, 1e-8),
         jum.adam_math(p, m, v, g, 0.01, 0.9, 0.999, 1e-8)),
        (um.adagrad_math(tp, tv, tg, 0.1, 1e-10),
         jum.adagrad_math(p, v, g, 0.1, 1e-10)),
    ]
    for ours, ref in pairs:
        ours = ours if isinstance(ours, (tuple, list)) else [ours]
        ref = ref if isinstance(ref, (tuple, list)) else [ref]
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=ATOL)
    for step in (1, 2, 10, 1000):
        assert um.adam_alpha(0.01, 0.9, 0.999, step) == float(
            jum.adam_alpha(0.01, 0.9, 0.999, step))


@pytest.mark.parametrize("num_unique", [None, 12])
def test_dedup_matches_jax(num_unique):
    ids = _ids_with_edges(10, seed=3)[:10]
    vals = _rand(10, 5, seed=4)
    ref_ids, ref_sum = jeo.dedup_indexed_slices(ids, vals,
                                                num_unique=num_unique)
    got_ids, got_sum = eo.dedup_indexed_slices(
        torch.from_numpy(ids), torch.from_numpy(vals), num_unique=num_unique)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_allclose(got_sum.numpy(), np.asarray(ref_sum),
                               rtol=RTOL, atol=ATOL)
    # the padding id's own row and the fill rows are zero
    assert not got_sum[got_ids == -1].any()
    with pytest.raises(ValueError, match="distinct ids"):
        eo.dedup_indexed_slices(torch.from_numpy(ids),
                                torch.from_numpy(vals), num_unique=3)


def _optax_rows(tx, table, ids_seq, grads_seq):
    """optax `tx` run on the gathered rows of `table`, scattered back,
    for each (unique ids, grads) step: the JAX row tier's arithmetic."""
    table = jnp.asarray(table)
    state = tx.init(table)
    for ids, grads in zip(ids_seq, grads_seq):
        rows_state = jax_tree_rows(state, ids)
        updates, new_rows_state = tx.update(jnp.asarray(grads), rows_state,
                                            table[ids])
        table = table.at[ids].add(updates)
        state = jax_tree_scatter(state, new_rows_state, ids)
    return np.asarray(table), state


def jax_tree_rows(state, ids):
    import jax

    return jax.tree.map(
        lambda x: x[ids] if getattr(x, "ndim", 0) == 2 else x, state)


def jax_tree_scatter(state, new, ids):
    import jax

    return jax.tree.map(
        lambda old, n: old.at[ids].set(n) if getattr(old, "ndim", 0) == 2
        else n, state, new)


@pytest.mark.parametrize("name", ["sgd", "momentum", "nesterov", "adam"])
def test_row_rules_match_optax_on_rows(name):
    """RowRule through row_sparse_apply (dedup, then the row kernel's
    plain version) against the optax transform each port optimizer
    factory stands for, over three steps with repeated ids. For Adam
    this checks the eps' = eps sqrt(1 - b2^t) mapping."""
    lr = 0.05
    rule, tx = {
        "sgd": (RowRule("sgd", lr), optax.sgd(lr)),
        "momentum": (RowRule("momentum", lr, momentum=0.9),
                     optax.sgd(lr, momentum=0.9)),
        "nesterov": (RowRule("momentum", lr, momentum=0.9, nesterov=True),
                     optax.sgd(lr, momentum=0.9, nesterov=True)),
        "adam": (RowRule("adam", lr, eps=1e-3), optax.adam(lr, eps=1e-3)),
    }[name]
    table = _rand(VOCAB, 8, seed=7)
    rs = np.random.RandomState(8)
    raw = [rs.randint(0, 12, size=16).astype(np.int32) for _ in range(3)]
    grads = [_rand(16, 8, seed=9 + i) for i in range(3)]
    # the optax side sums repeated ids first, as dedup does
    uniq_seq, summed_seq = [], []
    for ids, g in zip(raw, grads):
        uniq, inv = np.unique(ids, return_inverse=True)
        summed = np.zeros((uniq.size, 8), np.float32)
        np.add.at(summed, inv.reshape(-1), g)
        uniq_seq.append(uniq)
        summed_seq.append(summed)
    ref_table, ref_state = _optax_rows(tx, table, uniq_seq, summed_seq)
    ours = torch.from_numpy(table.copy())
    state = RowState(rule.init_slots(ours))
    for ids, g in zip(raw, grads):
        row_sparse_apply(rule, ours, state, torch.from_numpy(ids),
                         torch.from_numpy(g))
    assert state.count == 3
    np.testing.assert_allclose(ours.numpy(), ref_table, rtol=RTOL, atol=ATOL)
    import jax

    ref_slots = [np.asarray(x) for x in jax.tree.leaves(ref_state)
                 if getattr(x, "ndim", 0) == 2]
    assert len(ref_slots) == len(state.slots)
    for got, want in zip(state.slots, ref_slots):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_row_update_rejects_bad_arguments():
    table = torch.zeros(VOCAB, 4)
    ids = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="grads must be"):
        eo.sparse_sgd_update(table, ids, torch.zeros(3, 4), 0.1)
    with pytest.raises(ValueError, match="slot tables"):
        eo.sparse_momentum_update(table, torch.zeros(VOCAB, 5), ids,
                                  torch.zeros(2, 4), 0.1)
    with pytest.raises(ValueError, match="vocab, dim"):
        eo.embedding_gather(torch.zeros(VOCAB), ids)
