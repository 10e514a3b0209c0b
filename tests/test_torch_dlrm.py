"""The port's DLRM slice against the JAX package's, same inputs.

flax-layout DLRM params are drawn by numpy from a seed and carried into
the port by `dlrm_params_from_flax`; batches come from numpy too. Both
sides run fp32 on the CPU (the port takes its kernels' plain versions).
Tolerances:

* logits: 1e-5;
* Trainer steps: losses to 1e-5 relative; every parameter and every row
  slot to TOL = 1e-5 (absolute and relative); rows no id touched are
  bit-identical to their initial values;
* LocalExecutor: losses to 1e-5 relative, `logits_accuracy` and
  `probs_auc` to 1e-6 (both count the same thresholds over logits equal
  to 1e-5).
"""

import random

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from elasticdl_tpu.api.local_executor import LocalExecutor as JLocalExecutor
from elasticdl_tpu.common.model_utils import (
    load_model_spec_from_module as jax_spec_of,
)
from elasticdl_tpu.data import recordio_gen
from elasticdl_tpu.embedding import layer as jlayer
from elasticdl_tpu.embedding import sparse_update as jsparse
from elasticdl_tpu.parallel import mesh as mesh_lib
from elasticdl_tpu.training.metrics import (
    MetricsAggregator as JMetricsAggregator,
)
from elasticdl_tpu.training.trainer import Trainer as JTrainer
from elasticdl_tpu_torch.api.local_executor import LocalExecutor
from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.common.model_utils import (
    load_model_spec_from_module,
)
from elasticdl_tpu_torch.convert import dlrm_params_from_flax
from elasticdl_tpu_torch.data.dataset import Dataset
from elasticdl_tpu_torch.data.reader.recordio_reader import (
    RecordIODataReader,
)
from elasticdl_tpu_torch.embedding import layer
from elasticdl_tpu_torch.master.task_dispatcher import Task, TaskType
from elasticdl_tpu_torch.model_zoo import dlrm as tdlrm
from elasticdl_tpu_torch.training import optimizers
from elasticdl_tpu_torch.training.metrics import MetricsAggregator
from elasticdl_tpu_torch.training.trainer import Trainer
from model_zoo.dlrm import dlrm as zoo

torch.set_num_threads(2)

TOL = 1e-5
# every table is tapped: 20000 x 32 x 4 B = 2.56 MB >= 2 MiB
TAPPED = dict(table_size=20000, embedding_dim=32, num_tables=4)
# every table takes the masked dense tier: 1024 x 8 x 4 B = 32 KiB
MASKED = dict(table_size=1024, embedding_dim=8)


def _params_str(cfg):
    return "; ".join("%s=%r" % kv for kv in cfg.items())


def numpy_params(cfg, seed=0):
    """flax-layout DLRM params with every leaf drawn by numpy."""
    shapes = jax.eval_shape(
        lambda: zoo.DLRM(**cfg).init(
            jax.random.PRNGKey(0),
            {"dense": jnp.zeros((1, 13)),
             "sparse": jnp.zeros((1, 26), jnp.int32)}))["params"]
    rs = np.random.RandomState(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "embedding_table" in name:
            return rs.uniform(-0.05, 0.05, s.shape).astype(np.float32)
        if "kernel" in name:
            return (rs.randn(*s.shape) / np.sqrt(s.shape[0])).astype(
                np.float32)
        return (0.1 * rs.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def dlrm_batch(seed, bsz=8, num_ids=40, table_size=20000):
    """Dense features in [0, 4), ids from a small range (repeats within
    and across examples) and a few large ones that fold by % table_size."""
    rs = np.random.RandomState(seed)
    sparse = rs.randint(0, num_ids, size=(bsz, 26)).astype(np.int32)
    sparse[0, :4] += table_size  # folds onto a repeated row
    features = {"dense": (4 * rs.rand(bsz, 13)).astype(np.float32),
                "sparse": sparse}
    return features, rs.randint(0, 2, size=(bsz,)).astype(np.int32)


def jax_trainer(cfg, params, batch, optimizer, **kwargs):
    spec = jax_spec_of(zoo)
    spec.optimizer = optimizer
    mesh = mesh_lib.build_mesh({"dp": 1}, devices=jax.devices()[:1])
    trainer = JTrainer(spec, mesh=mesh, model_params=_params_str(cfg),
                       **kwargs)
    state = trainer.init_state(batch)
    jp = jax.tree.map(jnp.asarray, params)
    return trainer, state.replace(
        params=jp, opt_state=trainer._train_tx.init(jp),
        embed_opt_state=jsparse.init_row_opt_states(
            trainer._base_tx, jp, trainer._sparse_paths))


def port_trainer(cfg, params, optimizer, **kwargs):
    spec = load_model_spec_from_module(tdlrm)
    spec.optimizer = optimizer
    trainer = Trainer(spec, model_params=_params_str(cfg), device="cpu",
                      **kwargs)
    return trainer, trainer.init_state(
        None, params=dlrm_params_from_flax(params))


def assert_params_close(ps, js):
    ref = {}
    for path, x in jax.tree_util.tree_flatten_with_path(js.params)[0]:
        keys = [getattr(k, "key", k) for k in path]
        ref[flax_param_path_inverse(keys)] = np.asarray(x)
    ours = {k: p.detach().numpy() for k, p in ps.params.items()}
    assert sorted(ours) == sorted(ref)
    for key, want in ref.items():
        got = ours[key].T if key.endswith(".weight") else ours[key]
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL,
                                   err_msg=key)


def flax_param_path_inverse(keys):
    mod, leaf = keys
    return "%s.%s" % (mod, {"kernel": "weight"}.get(leaf, leaf))


def jax_row_slots(js, table_key):
    """The slot tables of one tapped table in the JAX row state."""
    flax_key = table_key.replace(".", "/")
    state = js.embed_opt_state[flax_key]
    return [np.asarray(x) for x in jax.tree.leaves(state)
            if getattr(x, "ndim", 0) == 2]


def run_both(jt, js, pt, ps, batches):
    for batch, n in batches:
        js, jl = jt.train_step(js, batch, n)
        ps, pl = pt.train_step(ps, batch, n)
        np.testing.assert_allclose(pl, float(jl), rtol=TOL, atol=0)
    return js, ps


# ---------------------------------------------------------------- model


@pytest.mark.parametrize("cfg", [TAPPED, MASKED])
def test_dlrm_logits_match_flax(cfg):
    params = numpy_params(cfg)
    features, labels = dlrm_batch(1, table_size=cfg["table_size"])
    ref = zoo.DLRM(**cfg).apply({"params": params}, features)
    model = tdlrm.custom_model(device="cpu", **cfg)
    model.load_state_dict(dlrm_params_from_flax(params))
    out = model(features)
    for key in ("logits", "probs"):
        assert out[key].shape == ref[key].shape
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(ref[key]), atol=TOL, rtol=TOL)
    w = np.array([1, 1, 0.5, 1, 0, 1, 1, 1], np.float32)
    for weights in (None, w):
        np.testing.assert_allclose(
            float(tdlrm.loss(labels, out, weights).detach()),
            float(zoo.loss(labels, ref, weights)), rtol=TOL)


def test_dlrm_init_and_param_names():
    model = tdlrm.custom_model(device="cpu", seed=3, **TAPPED)
    sd = model.state_dict()
    flax_keys = set(flat_params_keys(numpy_params(TAPPED)))
    assert {tdlrm.flax_param_path(k) for k in sd} == flax_keys
    for t in model.tables():
        table = t.embedding_table.detach()
        assert t.sparse_enabled and table.abs().max() <= 0.05
    # lecun-normal kernels: variance 1 / fan_in, cut at 2 stddev
    w = model.top_0.weight.detach()
    std = (1.0 / w.shape[1]) ** 0.5
    assert abs(float(w.std()) / std - 1.0) < 0.1
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    again = tdlrm.custom_model(device="cpu", seed=3, **TAPPED).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    with pytest.raises(KeyError):
        dlrm_params_from_flax({"table_0/nope": np.zeros(2)})


def flat_params_keys(params):
    return ["/".join(str(getattr(k, "key", k)) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]


# -------------------------------------------------------------- trainer


OPTIMIZERS = {
    "sgd": (lambda: optax.sgd(0.05), lambda: optimizers.sgd(0.05)),
    "momentum": (lambda: optax.sgd(0.05, momentum=0.9),
                 lambda: optimizers.sgd(0.05, momentum=0.9)),
    "adam": (lambda: optax.adam(0.01), lambda: optimizers.adam(0.01)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_tapped_tier_steps_match_jax_trainer(name):
    params = numpy_params(TAPPED)
    batches = [(dlrm_batch(10), None), (dlrm_batch(11), 6),
               (dlrm_batch(12), None)]
    jopt, popt = OPTIMIZERS[name]
    jt, js = jax_trainer(TAPPED, params, batches[0][0], jopt)
    pt, ps = port_trainer(TAPPED, params, popt)
    assert len(jt._sparse_paths) == 4
    assert sorted(ps.embed_opt_state) == [
        "table_%d.embedding_table" % t for t in range(4)]
    # tapped tables stay out of the torch optimizer and out of autograd
    dense = ps.opt_state.trainable()
    assert len(dense) == 10
    assert not any(p.requires_grad for k, p in ps.params.items()
                   if k.startswith("table_"))
    before = {k: p.detach().clone() for k, p in ps.params.items()}
    js, ps = run_both(jt, js, pt, ps, batches)
    assert ps.step == int(js.step) == 3
    assert_params_close(ps, js)
    for key, state in ps.embed_opt_state.items():
        assert state.count == 3
        ref = jax_row_slots(js, key)
        assert len(ref) == len(state.slots)
        for got, want in zip(state.slots, ref):
            np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL,
                                       err_msg=key)
    # rows no batch named are bit-identical, slots still zero
    for t in range(4):
        key = "table_%d.embedding_table" % t
        touched = np.zeros(TAPPED["table_size"], bool)
        for (features, _labels), _n in batches:
            touched[features["sparse"][:, t] % TAPPED["table_size"]] = True
        table = ps.params[key].detach()
        np.testing.assert_array_equal(table[~touched].numpy(),
                                      before[key][~touched].numpy())
        assert not torch.equal(table[touched], before[key][touched])
        for slot in ps.embed_opt_state[key].slots:
            assert not slot[~touched].any()


def test_masked_dense_tier_matches_jax_and_keeps_untouched_rows():
    params = numpy_params(MASKED)
    batches = [(dlrm_batch(20, table_size=1024), None),
               (dlrm_batch(21, table_size=1024), None)]
    jt, js = jax_trainer(MASKED, params, batches[0][0],
                         lambda: optax.adam(0.01))
    pt, ps = port_trainer(MASKED, params, lambda: optimizers.adam(0.01))
    assert not jt._sparse_paths and not ps.embed_opt_state
    before = {k: p.detach().clone() for k, p in ps.params.items()}
    js, ps = run_both(jt, js, pt, ps, batches)
    assert_params_close(ps, js)
    opt = ps.opt_state.optimizer
    for t in range(26):
        key = "table_%d.embedding_table" % t
        touched = np.zeros(1024, bool)
        for (features, _labels), _n in batches:
            touched[features["sparse"][:, t] % 1024] = True
        p = ps.params[key]
        np.testing.assert_array_equal(p.detach()[~touched].numpy(),
                                      before[key][~touched].numpy())
        slots = opt.state[p]
        assert not slots["exp_avg"][~touched].any()
        assert not slots["exp_avg_sq"][~touched].any()
        assert slots["exp_avg"][touched].abs().sum() > 0
    # torch Adam's scalar step advances globally, as optax's count does
    assert all(float(s["step"]) == 2 for s in opt.state.values())


def test_grad_accumulation_with_tapped_tables_matches_jax():
    params = numpy_params(TAPPED)
    micro = [(dlrm_batch(30 + i, bsz=4), None) for i in range(4)]
    jt, js = jax_trainer(TAPPED, params, micro[0][0],
                         lambda: optax.sgd(0.05, momentum=0.9),
                         grad_accum_steps=2)
    pt, ps = port_trainer(TAPPED, params,
                          lambda: optimizers.sgd(0.05, momentum=0.9),
                          grad_accum_steps=2)
    before = {k: p.detach().clone() for k, p in ps.params.items()}
    js, ps = run_both(jt, js, pt, ps, micro[:1])
    # a non-boundary microbatch moves no table and no slot
    for key, p in ps.params.items():
        assert torch.equal(p.detach(), before[key]), key
    assert all(s.count == 0 for s in ps.embed_opt_state.values())
    js, ps = run_both(jt, js, pt, ps, micro[1:])
    assert ps.step == 4 and ps.opt_state.count == 2
    assert all(s.count == 2 for s in ps.embed_opt_state.values())
    assert_params_close(ps, js)
    for key, state in ps.embed_opt_state.items():
        for got, want in zip(state.slots, jax_row_slots(js, key)):
            np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_row_tier_raises_without_an_exact_row_rule():
    spec = load_model_spec_from_module(tdlrm)
    spec.optimizer = lambda: optimizers.adamw(0.01)
    trainer = Trainer(spec, model_params=_params_str(TAPPED), device="cpu")
    with pytest.raises(NotImplementedError, match="decay"):
        trainer.init_state(None)
    # a freeze pattern that leaves a tapped table out raises too
    trainer = Trainer(load_model_spec_from_module(tdlrm),
                      model_params=_params_str(TAPPED), device="cpu",
                      trainable_pattern="top_|table_[0-2]/")
    with pytest.raises(NotImplementedError, match="table_3"):
        trainer.init_state(None)


# ------------------------------------------------------------ the layer


def test_double_call_of_a_tapped_layer_raises():
    emb = layer.Embedding(1000, 4, sparse_grads=True, device="cpu")
    ids = torch.tensor([1, 2, 3])
    with layer.row_tap({"emb.embedding_table": emb}) as records:
        rows = emb(ids)
        assert rows.requires_grad and rows.grad_fn is None
        with pytest.raises(ValueError, match="more than once"):
            emb(ids)
    assert list(records) == ["emb.embedding_table"]
    # outside a tap (and under no_grad) the layer is a plain lookup
    assert emb(ids).grad_fn is not None
    with torch.no_grad():
        assert torch.equal(emb(ids), emb.embedding_table[ids])


def test_out_of_range_ids_clamp_where_jax_gives_nan():
    """Contract: the port clamps an id >= vocab onto the last row (the
    TPU gather kernel's rule); the JAX layer's jnp.take returns a NaN
    row. DLRM folds ids into range, so its path never sees one."""
    table = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    emb = layer.Embedding(4, 3, device="cpu")
    with torch.no_grad():
        emb.embedding_table.copy_(torch.from_numpy(table))
    ids = np.array([0, 5, -1], np.int32)
    got = emb(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_array_equal(got, table[[0, 3, 0]])
    ref = np.asarray(jlayer.Embedding(4, 3).apply(
        {"params": {"embedding_table": table}}, ids))
    assert np.isnan(ref[1]).all()
    np.testing.assert_array_equal(ref[[0, 2]], got[[0, 2]])


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_combined_lookup_and_gradient_match_jax(combiner):
    rs = np.random.RandomState(1)
    table = rs.randn(30, 6).astype(np.float32)
    ids = rs.randint(0, 30, size=(5, 4)).astype(np.int32)
    ids[1, 2:] = -1
    ids[3, :] = -1  # a row with no id
    weights = rs.rand(5, 4).astype(np.float32)
    for w in (None, weights):
        def jfn(t):
            return jlayer.safe_embedding_lookup(t, ids, combiner, w)

        ref = np.asarray(jfn(jnp.asarray(table)))
        cot = rs.randn(*ref.shape).astype(np.float32)
        jgrad = jax.grad(lambda t: (jfn(t) * cot).sum())(jnp.asarray(table))
        tt = torch.from_numpy(table).requires_grad_()
        out = layer.safe_embedding_lookup(
            tt, torch.from_numpy(ids), combiner,
            None if w is None else torch.from_numpy(w))
        np.testing.assert_allclose(out.detach().numpy(), ref, atol=TOL,
                                   rtol=TOL)
        (out * torch.from_numpy(cot)).sum().backward()
        np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jgrad),
                                   atol=TOL, rtol=TOL)


def test_initializers_and_sparse_threshold():
    gen = torch.Generator().manual_seed(0)
    for name, lo, hi in (("uniform", -0.05, 0.05),
                         ("truncated_normal", -0.1, 0.1),
                         ("zeros", 0.0, 0.0), ("ones", 1.0, 1.0)):
        t = torch.empty(200, 8)
        layer.get_initializer(name)(t, gen)
        assert lo <= float(t.min()) and float(t.max()) <= hi, name
    with pytest.raises(ValueError):
        layer.get_initializer("nope")
    # 2 MiB exactly is tapped; one row less is not
    rows = 2 * 1024 * 1024 // (4 * 16)
    assert layer.Embedding(rows, 16, device="cpu").sparse_enabled
    assert not layer.Embedding(rows - 1, 16, device="cpu").sparse_enabled
    assert not layer.Embedding(rows, 16, sparse_grads=False,
                               device="cpu").sparse_enabled


# --------------------------------------------- data, metrics, executor


def test_dataset_fn_and_metrics_match_jax(tmp_path):
    data = str(tmp_path / "criteo")
    recordio_gen.gen_criteo_like(data, num_files=1, records_per_file=20)
    reader = RecordIODataReader(data_dir=data)
    (shard, (start, n)), = reader.create_shards().items()
    task = Task(shard, start, start + n, TaskType.TRAINING)
    records = list(reader.read_records(task))
    for mode in (Mode.TRAINING, Mode.EVALUATION):
        ours = list(tdlrm.dataset_fn(Dataset.from_list(records), mode, None))
        ref = list(zoo.dataset_fn(Dataset.from_list(records), mode, None))
        assert len(ours) == len(ref) == 20
        for (f, l), (jf, jl) in zip(ours, ref):
            np.testing.assert_array_equal(f["sparse"], jf["sparse"])
            np.testing.assert_array_equal(f["dense"], jf["dense"])
            assert l == jl
    rs = np.random.RandomState(0)
    ours = MetricsAggregator(tdlrm.eval_metrics_fn())
    ref = JMetricsAggregator(zoo.eval_metrics_fn())
    for _ in range(3):
        logits = rs.randn(50).astype(np.float32)
        preds = {"logits": logits,
                 "probs": (1 / (1 + np.exp(-logits)))[:, None]}
        labels = rs.randint(0, 2, size=50)
        ours.update(labels, preds)
        ref.update(labels, preds)
    assert ours.result() == ref.result()
    assert sorted(ours.result()) == ["logits_accuracy", "probs_auc"]


def test_local_executor_matches_jax(tmp_path):
    data = str(tmp_path / "train")
    recordio_gen.gen_criteo_like(data, num_files=2, records_per_file=40)
    params = numpy_params(TAPPED)
    kwargs = dict(training_data=data, validation_data=data,
                  minibatch_size=16, records_per_task=40,
                  model_params=_params_str(TAPPED))
    mesh = mesh_lib.build_mesh({"dp": 1}, devices=jax.devices()[:1])
    jex = JLocalExecutor(jax_spec_of(zoo), mesh=mesh, **kwargs)
    first, _n = next(iter(_padded(jex, data)))
    state = jex.trainer.init_state(first)
    jp = jax.tree.map(jnp.asarray, params)
    jex.state = state.replace(
        params=jp, opt_state=jex.trainer._train_tx.init(jp),
        embed_opt_state=jsparse.init_row_opt_states(
            jex.trainer._base_tx, jp, jex.trainer._sparse_paths))
    ex = LocalExecutor(load_model_spec_from_module(tdlrm), device="cpu",
                       **kwargs)
    ex.state = ex.trainer.init_state(None,
                                     params=dlrm_params_from_flax(params))
    random.seed(0)
    _jstate, jmetrics = jex.train()
    random.seed(0)
    state, metrics = ex.train()
    assert state.step == len(ex.losses) == len(jex.losses) == 6
    np.testing.assert_allclose(ex.losses, jex.losses, rtol=TOL)
    assert sorted(metrics) == sorted(jmetrics) == ["logits_accuracy",
                                                   "probs_auc"]
    for key in metrics:
        np.testing.assert_allclose(metrics[key], jmetrics[key], atol=1e-6)
    assert 0.0 <= metrics["probs_auc"] <= 1.0


def _padded(jex, data):
    from elasticdl_tpu.data.dataset import pad_batch
    from elasticdl_tpu.master.task_dispatcher import Task as JTask

    reader = jex._reader(data)
    shard, (start, n) = next(iter(reader.create_shards().items()))
    task = JTask(shard, start, start + n, "TRAINING")
    for b in jex._task_dataset(reader, task, "training"):
        yield pad_batch(b, jex.minibatch_size)
