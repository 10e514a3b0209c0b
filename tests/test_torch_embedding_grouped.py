"""The port's grouped embedding ops (one launch for many tables) against
the JAX package's one-table kernels, table by table.

The JAX side runs its Pallas kernels (`_gather_kernel`, the row-update
kernels) in interpret mode, as tests/test_torch_embedding_ops.py does;
the port's wrappers take CPU tensors, so they run their kernels' plain
versions, which the card's kernels are held to in chip_smoke.py. Inputs
are drawn by numpy from a seed. Tolerances:

* gather: exact (both copy rows), fp32 and bf16;
* row updates: 1e-6 relative (rtol) with atol 1e-7 for values near
  zero, as the one-table row tests: the same formulas, rounded at
  other places; rows the ids do not name stay bit-identical;
* DLRM: logits 1e-5, Trainer steps as tests/test_torch_dlrm.py.
"""

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from elasticdl_tpu.ops import embedding_ops as jeo
from elasticdl_tpu_torch.convert import dlrm_params_from_flax
from elasticdl_tpu_torch.embedding import layer
from elasticdl_tpu_torch.model_zoo import dlrm as tdlrm
from elasticdl_tpu_torch.ops import embedding_ops as eo
from elasticdl_tpu_torch.ops import update_math as um
from elasticdl_tpu_torch.training import optimizers
from model_zoo.dlrm import dlrm as zoo
from tests.test_torch_dlrm import (
    TAPPED,
    TOL,
    assert_params_close,
    dlrm_batch,
    jax_row_slots,
    jax_trainer,
    numpy_params,
    port_trainer,
    run_both,
)

torch.set_num_threads(2)

RTOL, ATOL = 1e-6, 1e-7
VOCABS = (48, 7, 130, 1)  # tables of different vocab in one group


@pytest.fixture(autouse=True)
def _interpreted_pallas_kernels(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode (off a TPU
    use_pallas() would route them to their jnp reference paths)."""
    monkeypatch.setenv("ELASTICDL_TPU_FORCE_INTERPRET", "1")


def _ids_with_edges(rs, vocab, n):
    """n ids in [0, vocab) with repeats, padding (-1) and ids past the
    table."""
    ids = rs.randint(0, vocab, size=n).astype(np.int32)
    ids[:2] = ids[2:4]
    ids[4], ids[5], ids[6] = -1, vocab, vocab + 9
    return ids


def _unique_ids_with_edges(rs, vocab, n):
    """Up to n unique ids in [0, vocab) shuffled with padding and
    past-the-end ids: the row kernels' contract."""
    ids = np.concatenate([rs.permutation(vocab)[:n],
                          [-1, vocab, vocab + 3]]).astype(np.int32)
    return ids[rs.permutation(ids.size)]


def _tables(rs, dim, vocabs=VOCABS):
    return [rs.randn(v, dim).astype(np.float32) for v in vocabs]


# ------------------------------------------------------------------ gather


@pytest.mark.parametrize("dim", [13, 32, 40])
@pytest.mark.parametrize("form", ["list", "matrix"])
def test_gather_many_matches_pallas_kernel_per_table(dim, form):
    rs = np.random.RandomState(dim)
    tables = _tables(rs, dim)
    ids = [_ids_with_edges(rs, v, 12).reshape(3, 4) for v in VOCABS]
    want = [np.asarray(jeo.embedding_gather(jnp.asarray(t), i))
            for t, i in zip(tables, ids)]
    arg = ([torch.from_numpy(i) for i in ids] if form == "list"
           else torch.from_numpy(np.stack(ids)))
    got = eo.embedding_gather_many([torch.from_numpy(t) for t in tables],
                                   arg)
    assert len(got) == len(tables)
    for g, w, t in zip(got, want, tables):
        assert g.shape == (3, 4, dim)
        np.testing.assert_array_equal(g.numpy(), w)
        flat = g.reshape(-1, dim).numpy()
        np.testing.assert_array_equal(flat[4], t[0])   # padding: row 0
        np.testing.assert_array_equal(flat[5], t[-1])  # past the end
        np.testing.assert_array_equal(flat[6], t[-1])


def test_gather_many_bf16_and_empty_tables_match_pallas_kernel():
    rs = np.random.RandomState(3)
    tables = [torch.from_numpy(t).to(torch.bfloat16)
              for t in _tables(rs, 32)]
    ids = [_ids_with_edges(rs, v, 9) for v in VOCABS]
    ids[2] = ids[2][:0]  # a table with no ids
    got = eo.embedding_gather_many(tables, [torch.from_numpy(i)
                                            for i in ids])
    for g, t, i in zip(got, tables, ids):
        if not i.size:
            assert g.shape == (0, 32)
            continue
        want = np.asarray(jeo.embedding_gather(
            jnp.asarray(t.float().numpy(), jnp.bfloat16), i))
        assert g.dtype == torch.bfloat16 and g.shape == (i.size, 32)
        np.testing.assert_array_equal(g.float().numpy(),
                                      want.astype(np.float32))


def test_gather_many_over_more_tables_than_one_launch_takes():
    n = eo.GROUP_TABLES + 3
    rs = np.random.RandomState(4)
    vocabs = [int(v) for v in rs.randint(1, 40, size=n)]
    tables = _tables(rs, 8, vocabs)
    ids = np.stack([_ids_with_edges(rs, v, 10) for v in vocabs])
    got = eo.embedding_gather_many([torch.from_numpy(t) for t in tables],
                                   torch.from_numpy(ids))
    for g, t, i in zip(got, tables, ids):
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(jeo.embedding_gather(jnp.asarray(t), i)))


def test_launches_split_into_groups_of_at_most_group_tables():
    """The kernel path's chunking: one launch per GROUP_TABLES tables, in
    order, each counted (the launch itself needs the card)."""
    descs = list(range(2 * eo.GROUP_TABLES + 5))
    seen = []
    before = eo.KERNEL_LAUNCHES["row_update_many"]
    eo._launch_groups(lambda k, part: seen.append((k, list(part))) or 0,
                      descs, "row_update_many")
    assert [k for k, _ in seen] == [eo.GROUP_TABLES, eo.GROUP_TABLES, 5]
    assert sum((p for _, p in seen), []) == descs
    assert eo.KERNEL_LAUNCHES["row_update_many"] == before + 3
    with pytest.raises(RuntimeError, match="cudaError 700"):
        eo._launch_groups(lambda k, part: 700, descs, "row_update_many")


# ------------------------------------------------------------- row updates


RULE_TABLES = {"sgd": 1, "momentum": 2, "adam": 3, "adagrad": 2}


def _rule_kwargs(rule, t):
    """Table t's hyperparameters: its own learning rate and (adam) its
    own update count, so that a mix-up of tables shows."""
    lr = 0.01 * (t + 1)
    return {
        "sgd": dict(lr=lr),
        "momentum": dict(lr=lr, momentum=0.9, nesterov=t % 2 == 0),
        "adam": dict(step=t + 1, lr=lr, beta1=0.9, beta2=0.999, eps=1e-8),
        "adagrad": dict(lr=lr, eps=1e-10),
    }[rule]


def _kernel_hyper(rule, kw):
    """The hyperparameters as the row kernel (and row_update_plain) takes
    them."""
    if rule == "sgd":
        return [kw["lr"]]
    if rule == "momentum":
        return [kw["lr"], kw["momentum"], 1.0 if kw["nesterov"] else 0.0]
    if rule == "adam":
        return [um.adam_alpha(kw["lr"], kw["beta1"], kw["beta2"],
                              kw["step"]), kw["beta1"], kw["beta2"],
                kw["eps"]]
    return [kw["lr"], kw["eps"]]


@pytest.mark.parametrize("rule", sorted(RULE_TABLES))
@pytest.mark.parametrize("dim", [13, 32])
def test_row_update_many_matches_pallas_kernels_per_table(rule, dim):
    rs = np.random.RandomState(dim + len(rule))
    groups, ids, grads = [], [], []
    for v in VOCABS:
        group = [rs.randn(v, dim).astype(np.float32)]
        for k in range(1, RULE_TABLES[rule]):
            slot = 0.1 * rs.randn(v, dim).astype(np.float32)
            group.append(np.abs(slot) if rule == "adagrad" or k == 2
                         else slot)
        groups.append(group)
        ids.append(_unique_ids_with_edges(rs, v, 20))
        grads.append(rs.randn(ids[-1].size, dim).astype(np.float32))
    # a table with no ids keeps every row
    ids[2], grads[2] = ids[2][:0], grads[2][:0]
    kws = [_rule_kwargs(rule, t) for t in range(len(VOCABS))]
    jax_fn = getattr(jeo, "sparse_%s_update" % rule)
    want = []
    for group, i, g, kw in zip(groups, ids, grads, kws):
        if not i.size:
            want.append(group)
            continue
        ref = jax_fn(*[jnp.asarray(t) for t in group], i, g, **kw)
        want.append([np.asarray(r) for r in
                     (ref if isinstance(ref, tuple) else [ref])])
    ours = [[torch.from_numpy(t.copy()) for t in group] for group in groups]
    eo.row_update_many(rule, ours, [torch.from_numpy(i) for i in ids],
                       [torch.from_numpy(g) for g in grads],
                       [_kernel_hyper(rule, kw) for kw in kws])
    for group, ref, before, i in zip(ours, want, groups, ids):
        touched = np.zeros(before[0].shape[0], bool)
        touched[i[(i >= 0) & (i < touched.size)]] = True
        for got, w, b in zip(group, ref, before):
            np.testing.assert_allclose(got.numpy(), w, rtol=RTOL, atol=ATOL)
            np.testing.assert_array_equal(got.numpy()[~touched],
                                          b[~touched])


def test_row_update_many_over_more_tables_than_one_launch_takes():
    n = eo.GROUP_TABLES + 2
    rs = np.random.RandomState(5)
    tables = [rs.randn(30, 8).astype(np.float32) for _ in range(n)]
    ids = [_unique_ids_with_edges(rs, 30, 6) for _ in range(n)]
    grads = [rs.randn(i.size, 8).astype(np.float32) for i in ids]
    ours = [[torch.from_numpy(t.copy())] for t in tables]
    eo.row_update_many("sgd", ours, [torch.from_numpy(i) for i in ids],
                       [torch.from_numpy(g) for g in grads],
                       [[0.01 * (t + 1)] for t in range(n)])
    for t, (got, table, i, g) in enumerate(zip(ours, tables, ids, grads)):
        want = np.asarray(jeo.sparse_sgd_update(jnp.asarray(table), i, g,
                                                0.01 * (t + 1)))
        np.testing.assert_allclose(got[0].numpy(), want, rtol=RTOL,
                                   atol=ATOL)


def _bad_gather_args():
    a, b = torch.zeros(5, 4), torch.zeros(6, 4)
    ids = torch.tensor([1, 2], dtype=torch.int32)
    return {
        "mixed dims": ([a, torch.zeros(5, 3)], [ids, ids], ValueError,
                       "one dim"),
        "mixed dtypes": ([a, b.double()], [ids, ids], TypeError,
                         "one dtype"),
        "lengths": ([a, b], [ids], ValueError, "2 tables, 1 id sets"),
        "devices": ([a, b.to("meta")], [ids, ids], ValueError,
                    "one CUDA device or all on the CPU"),
    }


@pytest.mark.parametrize("case", sorted(_bad_gather_args()))
def test_gather_many_rejects_bad_arguments(case):
    tables, ids, error, match = _bad_gather_args()[case]
    with pytest.raises(error, match=match):
        eo.embedding_gather_many(tables, ids)


def test_row_update_many_rejects_bad_arguments():
    a, b = torch.zeros(5, 4), torch.zeros(6, 4)
    ids = torch.tensor([1, 2], dtype=torch.int32)
    g = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="2 table groups, 1 id sets"):
        eo.row_update_many("sgd", [[a], [b]], [ids], [g, g], [[0.1]] * 2)
    with pytest.raises(ValueError, match=r"\[vocab, 4\] tables"):
        eo.row_update_many("sgd", [[a], [torch.zeros(6, 3)]], [ids, ids],
                           [g, g], [[0.1]] * 2)
    with pytest.raises(ValueError, match="momentum updates 2 tables"):
        eo.row_update_many("momentum", [[a, a], [b]], [ids, ids], [g, g],
                           [[0.1, 0.9, 0.0]] * 2)
    with pytest.raises(ValueError, match="one CUDA device or all on the"):
        eo.row_update_many("sgd", [[a], [b]], [ids, ids.to("meta")],
                           [g, g], [[0.1]] * 2)


# ------------------------------------------------------------ the layer


def _counting(monkeypatch):
    """Count calls of the grouped and the one-table gather wrappers as
    embedding/layer.py reaches them."""
    calls = {"many": 0, "one": 0}

    def many(*args):
        calls["many"] += 1
        return eo.embedding_gather_many(*args)

    def one(*args):
        calls["one"] += 1
        return eo.embedding_gather(*args)

    monkeypatch.setattr(layer, "embedding_gather_many", many)
    monkeypatch.setattr(layer, "embedding_gather", one)
    return calls


@pytest.mark.parametrize("mode", ["no_grad", "row_tap"])
def test_dlrm_grouped_logits_match_flax(mode, monkeypatch):
    """Evaluation (no_grad) and a tapped training forward gather every
    table in one grouped call and give flax's logits; under the tap each
    table records its own (ids, rows), rows a leaf whose grad is that
    table's row gradient."""
    params = numpy_params(TAPPED)
    features, _labels = dlrm_batch(2, table_size=TAPPED["table_size"])
    ref = zoo.DLRM(**TAPPED).apply({"params": params}, features)
    model = tdlrm.custom_model(device="cpu", **TAPPED)
    model.load_state_dict(dlrm_params_from_flax(params))
    for p in model.parameters():
        p.requires_grad_(mode == "no_grad")  # a tapped table takes none
    taps = {"table_%d.embedding_table" % t: m
            for t, m in enumerate(model.tables())}
    calls = _counting(monkeypatch)
    if mode == "no_grad":
        with torch.no_grad():
            out = model(features)
        records = {}
    else:
        with layer.row_tap(taps) as records:
            out = model(features)
        out["logits"].sum().backward()
    assert calls == {"many": 1, "one": 0}
    np.testing.assert_allclose(out["logits"].detach().numpy(),
                               np.asarray(ref["logits"]), atol=TOL, rtol=TOL)
    if mode == "row_tap":
        assert sorted(records) == sorted(taps)
        ids = features["sparse"] % TAPPED["table_size"]
        for t in range(TAPPED["num_tables"]):
            rec_ids, rows = records["table_%d.embedding_table" % t]
            np.testing.assert_array_equal(rec_ids.numpy(), ids[:, t])
            assert rows.is_leaf and rows.grad is not None
            assert rows.grad.shape == (ids.shape[0], TAPPED["embedding_dim"])
            np.testing.assert_array_equal(
                rows.detach().numpy(),
                params["table_%d" % t]["embedding_table"][ids[:, t]])


def test_lookup_many_mixes_tiers_and_refuses_a_second_tap():
    """Tapped layers share one grouped gather; a dense-tier layer keeps
    its autograd gather (a dense gradient into its table); a layer named
    twice in one forward raises."""
    tapped = [layer.Embedding(40, 4, sparse_grads=True, device="cpu",
                              generator=torch.Generator().manual_seed(t))
              for t in range(3)]
    dense = layer.Embedding(40, 4, sparse_grads=False, device="cpu")
    ids = torch.tensor([[1, 2, 3], [0, 39, 7], [5, 5, 6], [9, 8, 1]])
    with layer.row_tap({"t%d" % t: m for t, m in enumerate(tapped)}) as rec:
        out = layer.lookup_many(tapped + [dense], ids)
        assert sorted(rec) == ["t0", "t1", "t2"]
        sum(o.sum() for o in out).backward()
        with pytest.raises(ValueError, match="more than once"):
            layer.lookup_many([tapped[0]], ids[:1])
    for t, m in enumerate(tapped):
        np.testing.assert_array_equal(out[t].detach().numpy(),
                                      m.embedding_table.detach()[ids[t]])
        assert rec["t%d" % t][1].grad is not None
    grad = dense.embedding_table.grad
    assert grad is not None and int((grad != 0).any(dim=1).sum()) == 3
    with layer.row_tap({"t0": tapped[0]}):
        with pytest.raises(ValueError, match="more than once"):
            layer.lookup_many([tapped[0], tapped[0]], ids[:2])


# -------------------------------------------------------------- trainer


OPTIMIZERS = {
    "sgd": (lambda: optax.sgd(0.05), lambda: optimizers.sgd(0.05)),
    "adam": (lambda: optax.adam(0.01), lambda: optimizers.adam(0.01)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_trainer_steps_through_grouped_calls_match_jax(name, monkeypatch):
    """3 Trainer steps on tapped tables against the JAX Trainer: each
    step's forward is one grouped gather and its update one grouped row
    update over the 4 tables, never the one-table wrappers."""
    params = numpy_params(TAPPED)
    batches = [(dlrm_batch(40), None), (dlrm_batch(41), 5),
               (dlrm_batch(42), None)]
    jopt, popt = OPTIMIZERS[name]
    jt, js = jax_trainer(TAPPED, params, batches[0][0], jopt)
    pt, ps = port_trainer(TAPPED, params, popt)
    calls = _counting(monkeypatch)
    updates = []
    monkeypatch.setattr(
        eo, "row_update_many",
        lambda *a, f=eo.row_update_many: updates.append(len(a[1])) or f(*a))
    monkeypatch.setattr(
        eo, "_row_update",
        lambda *a: pytest.fail("a one-table row update on the DLRM path"))
    js, ps = run_both(jt, js, pt, ps, batches)
    assert calls == {"many": 3, "one": 0}
    assert updates == [4, 4, 4]
    assert_params_close(ps, js)
    for key, state in ps.embed_opt_state.items():
        assert state.count == 3
        for got, want in zip(state.slots, jax_row_slots(js, key)):
            np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL,
                                       err_msg=key)
