"""The port's DeepFM family and host-spill tier against the JAX
package's, on the CPU, same inputs.

flax-layout dense params are drawn by numpy from a seed and carried into
the port by `convert.deepfm_params_from_flax`; batches are numpy too.
Host tables start from the stores' lazy rows, which both packages make
bit for bit from (seed, id) (the JAX stores are its numpy store,
force_python=True; the port's are the native store). Both sides run
fp32 on the CPU, the port with its kernels' plain versions.
Tolerances (tests/test_host_bridge.py's for loss paths):

* logits and probs: 1e-5;
* Trainer steps, checkpoints and exports: losses rtol 2e-4, atol 2e-5;
  every dense parameter, table and touched host row atol 2e-5, rtol
  2e-4 (XLA and PyTorch sum in other orders); the ids of the rows each
  host store holds exactly;
* what crosses a package unchanged (restored params and rows, exported
  rows): bit for bit;
* LocalExecutor: losses as the Trainer's; `probs_auc` and
  `logits_accuracy` to 1e-6 (both count thresholds over logits equal to
  2e-4).
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from elasticdl_tpu.api import exporter as jexporter
from elasticdl_tpu.api.callbacks import (
    LearningRateScheduler as JLearningRateScheduler,
)
from elasticdl_tpu.api.local_executor import LocalExecutor as JLocalExecutor
from elasticdl_tpu.checkpoint.saver import CheckpointSaver as JSaver
from elasticdl_tpu.common.model_utils import (
    load_model_spec_from_module as jax_spec_of,
)
from elasticdl_tpu.data import recordio_gen as jrecordio_gen
from elasticdl_tpu.embedding import host_bridge as jbridge
from elasticdl_tpu.embedding.host_spill import (
    HostSpillEmbeddingEngine as JEngine,
)
from elasticdl_tpu.native import host_embedding as jstore
from elasticdl_tpu.parallel import mesh as mesh_lib
from elasticdl_tpu.training.trainer import Trainer as JTrainer
from elasticdl_tpu_torch.api import exporter
from elasticdl_tpu_torch.api.callbacks import LearningRateScheduler
from elasticdl_tpu_torch.api.local_executor import LocalExecutor
from elasticdl_tpu_torch.checkpoint.saver import (
    CheckpointSaver,
    load_checkpoint,
    restore_state_from_checkpoint,
)
from elasticdl_tpu_torch.common.model_utils import (
    load_model_spec_from_module,
)
from elasticdl_tpu_torch.convert import (
    deepfm_params_from_flax,
    deepfm_params_to_flax,
)
from elasticdl_tpu_torch.data import recordio_gen
from elasticdl_tpu_torch.embedding import host_bridge
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.model_zoo import deepfm_edl_embedding as tedl
from elasticdl_tpu_torch.model_zoo import deepfm_functional_api as tfunc
from elasticdl_tpu_torch.model_zoo import deepfm_host_embedding as thost
from elasticdl_tpu_torch.native import host_embedding as native_store
from elasticdl_tpu_torch.training.trainer import Trainer
from elasticdl_tpu_torch.worker.worker import Worker
from model_zoo.deepfm_edl_embedding import deepfm_edl_embedding as jedl
from model_zoo.deepfm_functional_api import deepfm_functional_api as jfunc
from model_zoo.deepfm_host_embedding import deepfm_host_embedding as jhost

torch.set_num_threads(2)

TOL = 1e-5
RTOL, ATOL = 2e-4, 2e-5
METRIC_TOL = 1e-6
DIM, LENGTH, FC, VOCAB, BATCH = 8, 5, 4, 100, 8
ZOOS = {"functional": (jfunc, tfunc), "edl": (jedl, tedl),
        "host": (jhost, thost)}
# deepfm_edl_embedding's tiers: 100 x 8 fp32 trains dense; 10000 x 64 fp32
# (2.56 MB >= 2 MiB) takes the sparse-row tier
DENSE_CFG = dict(input_dim=VOCAB, embedding_dim=DIM, input_length=LENGTH,
                 fc_unit=FC)
SPARSE_CFG = dict(input_dim=10000, embedding_dim=64, input_length=LENGTH,
                  fc_unit=FC)
HOST_CFG = dict(input_length=LENGTH, fc_unit=FC)


def _params_str(cfg):
    return "; ".join("%s=%r" % kv for kv in cfg.items())


def _batches(n, vocab=VOCAB, seed=3, batch=BATCH):
    """Ids in [0, vocab): 0 is padding to the model's mask, ids repeat
    within and across rows."""
    rng = np.random.RandomState(seed)
    return [({"feature": rng.randint(0, vocab, (batch, LENGTH)).astype(
        np.int32)}, rng.randint(0, 2, (batch,)).astype(np.int32))
        for _ in range(n)]


def _cfg_dims(kind, cfg):
    dim = cfg.get("embedding_dim", DIM)
    return dim, cfg.get("input_dim", VOCAB)


def numpy_params(kind, cfg, seed=0):
    """flax-layout DeepFM params with every leaf drawn by numpy."""
    dim, vocab = _cfg_dims(kind, cfg)
    rs = np.random.RandomState(seed)
    width = LENGTH * dim
    # flax builds the outer Dense of Dense(1)(Dense(fc)(x)) first
    out = {"Dense_1": {"kernel": rs.randn(width, FC) / np.sqrt(width),
                       "bias": 0.1 * rs.randn(FC)},
           "Dense_0": {"kernel": rs.randn(FC, 1) / np.sqrt(FC),
                       "bias": 0.1 * rs.randn(1)}}
    tables = {"functional": (("embedding", "embedding"),
                             ("id_bias", "embedding")),
              "edl": (("edl_embedding", "embedding_table"),
                      ("edl_id_bias", "embedding_table")),
              "host": ()}[kind]
    for (mod, leaf), d in zip(tables, (dim, 1)):
        out[mod] = {leaf: rs.uniform(-0.05, 0.05, (vocab, d))}
    return jax.tree.map(lambda x: np.asarray(x, np.float32), out)


def _jax_manager(dim=DIM, pad=8):
    manager = jbridge.HostEmbeddingManager(pad_multiple=pad)
    for name, d in (("edl_embedding", dim), ("edl_id_bias", 1)):
        manager.register(name, "feature", JEngine(
            d, optimizer="sgd", lr=0.1, force_python=True))
    return manager


def _port_manager(dim=DIM, pad=8):
    manager = host_bridge.HostEmbeddingManager(pad_multiple=pad)
    for name, d in (("edl_embedding", dim), ("edl_id_bias", 1)):
        manager.register(name, "feature", host_bridge.HostSpillEmbeddingEngine(
            d, optimizer="sgd", lr=0.1))
    return manager


def _multiplier(step):
    return 1.0 / (1.0 + 0.5 * step)


def jax_trainer(kind, cfg, params, batch, accum=1, lr_schedule=False):
    spec = jax_spec_of(ZOOS[kind][0])
    kwargs = {}
    if lr_schedule:
        kwargs["callbacks"] = [JLearningRateScheduler(_multiplier)]
    trainer = JTrainer(spec, mesh=mesh_lib.build_mesh(
        {"dp": 1}, devices=jax.devices()[:1]),
        model_params=_params_str(cfg), grad_accum_steps=accum, **kwargs)
    manager = None
    if kind == "host":
        manager = _jax_manager(cfg.get("embedding_dim", DIM))
        trainer.attach_host_embeddings(manager)
    state = trainer.init_state(batch)
    from elasticdl_tpu.embedding import sparse_update as jsparse

    jp = jax.tree.map(jnp.asarray, params)
    state = state.replace(
        params=jp, opt_state=trainer._train_tx.init(jp),
        embed_opt_state=jsparse.init_row_opt_states(
            trainer._base_tx, jp, trainer._sparse_paths))
    return trainer, state, manager


def port_trainer(kind, cfg, params, accum=1, lr_schedule=False,
                 tap_all=False):
    """`tap_all`: both deepfm_edl tables take the sparse-row tier
    (sparse_grads=True), however small."""
    spec = load_model_spec_from_module(ZOOS[kind][1])
    kwargs = {}
    if lr_schedule:
        kwargs["callbacks"] = [LearningRateScheduler(_multiplier)]
    extra = dict(embedding_dim=DIM) if kind == "host" else {}
    trainer = Trainer(spec, model_params=_params_str(dict(cfg, **extra)),
                      grad_accum_steps=accum, device="cpu", **kwargs)
    if tap_all:
        trainer.model.edl_embedding.sparse_grads = True
        trainer.model.edl_id_bias.sparse_grads = True
    manager = None
    if kind == "host":
        manager = _port_manager()
        trainer.attach_host_embeddings(manager)
    return trainer, trainer.init_state(
        None, params=deepfm_params_from_flax(params)), manager


def assert_params_close(ps, js, rtol=RTOL, atol=ATOL):
    ours = deepfm_params_to_flax(ps.params)
    ref = jax.tree.map(np.asarray, jax.device_get(js.params))
    flat_ours = jax.tree_util.tree_flatten_with_path(ours)[0]
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert len(flat_ours) == len(flat_ref)
    for path, got in flat_ours:
        np.testing.assert_allclose(got, flat_ref[path], rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def _sorted_rows(engine_store):
    ids, values = engine_store.export_rows()
    order = np.argsort(ids)
    return ids[order], values[order]


def assert_host_rows_close(manager, jmanager, exact=False):
    for name, t in manager.tables().items():
        ids, got = _sorted_rows(t.engine.param)
        jids, want = _sorted_rows(jmanager.tables()[name].engine.param)
        np.testing.assert_array_equal(ids, jids)
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=name)


# ---------------------------------------------------------------- model


@pytest.mark.parametrize("kind", sorted(ZOOS))
def test_forward_matches_flax(kind):
    cfg = HOST_CFG if kind == "host" else DENSE_CFG
    params = numpy_params(kind, cfg)
    features, labels = _batches(1)[0]
    jmodel = ZOOS[kind][0].custom_model(**cfg)
    extra = dict(embedding_dim=DIM) if kind == "host" else {}
    model = ZOOS[kind][1].custom_model(device="cpu", **cfg, **extra)
    model.load_state_dict(deepfm_params_from_flax(params))
    jfeatures = features
    if kind == "host":
        features = _port_manager().prepare(features)
        jfeatures = _jax_manager().prepare(jfeatures)
        for key in ("edl_embedding.rows", "edl_embedding.idx"):
            np.testing.assert_array_equal(features[key], jfeatures[key])
    ref = jmodel.apply({"params": params}, jfeatures)
    out = model(features)
    for key in ("logits", "probs"):
        assert tuple(out[key].shape) == ref[key].shape
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(ref[key]), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(
        float(ZOOS[kind][1].loss(labels, out).detach()),
        float(ZOOS[kind][0].loss(labels, ref)), rtol=TOL)
    assert sorted(deepfm_params_to_flax(model.state_dict())) == sorted(params)


STEP_CASES = {
    "functional": ("functional", DENSE_CFG, {}),
    "edl_dense": ("edl", DENSE_CFG, {}),
    "edl_sparse_row": ("edl", SPARSE_CFG, {}),
    # both tables tapped, as at a Criteo-scale input_dim: the [V, 8]
    # table and the [V, 1] bias take one row update each; the JAX side
    # trains them dense, the same SGD
    "edl_both_tapped": ("edl", DENSE_CFG, dict(tap_all=True)),
    "host": ("host", HOST_CFG, {}),
    "host_accum2_lr": ("host", HOST_CFG, dict(accum=2, lr_schedule=True)),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_trainer_steps_match_jax(case):
    kind, cfg, kw = STEP_CASES[case]
    params = numpy_params(kind, cfg)
    batches = _batches(4, vocab=cfg.get("input_dim", VOCAB))
    jkw = {k: v for k, v in kw.items() if k != "tap_all"}
    jt, js, jm = jax_trainer(kind, cfg, params, batches[0], **jkw)
    pt, ps, pm = port_trainer(kind, cfg, params, **kw)
    if case == "edl_sparse_row":
        assert sorted(pt._taps) == ["edl_embedding.embedding_table"]
        assert list(jt._sparse_paths)
    elif case == "edl_both_tapped":
        assert sorted(pt._taps) == ["edl_embedding.embedding_table",
                                    "edl_id_bias.embedding_table"]
    elif kind == "edl":
        assert not pt._taps
    for batch in batches:
        js, jl = jt.train_step(js, batch)
        ps, pl = pt.train_step(ps, batch)
        np.testing.assert_allclose(pl, float(jl), rtol=RTOL, atol=ATOL)
    assert ps.step == int(js.step) == 4
    assert_params_close(ps, js)
    if kind == "host":
        assert_host_rows_close(pm, jm)
        for name, t in pm.tables().items():
            assert t.engine.state_dict()["step"] == (
                jm.tables()[name].engine.state_dict()["step"]) == (
                4 // kw.get("accum", 1))


# ------------------------------------------------------------ checkpoints


def _host_setup(seed=0):
    params = numpy_params("host", HOST_CFG, seed=seed)
    batches = _batches(3, seed=seed + 5)
    return params, batches


def test_port_checkpoint_restores_in_jax(tmp_path):
    params, batches = _host_setup()
    pt, ps, pm = port_trainer("host", HOST_CFG, params)
    for batch in batches[:2]:
        ps, _ = pt.train_step(ps, batch)
    CheckpointSaver(pt, str(tmp_path), extra_state_fn=pm.flat_state).save(
        ps, 2)
    # a load with host leaves and no manager keeps them and reads the
    # dense leaves right
    flat, version = load_checkpoint(str(tmp_path))
    assert version == 2
    for key, val in pm.flat_state().items():
        np.testing.assert_array_equal(flat[key], val)
    bare = Trainer(load_model_spec_from_module(thost), device="cpu",
                   model_params=_params_str(dict(HOST_CFG, embedding_dim=DIM)))
    bare_state, _ = restore_state_from_checkpoint(
        bare, bare.init_state(None), str(tmp_path))
    for key, p in ps.params.items():
        assert torch.equal(bare_state.params[key], p)
    # the JAX package restores dense params and host rows bit for bit,
    # and the next step matches
    jt, js, jm = jax_trainer("host", HOST_CFG, numpy_params(
        "host", HOST_CFG, seed=9), batches[0])
    js, jversion = jbridge.restore_with_host_state(js, jm, str(tmp_path))
    assert jversion == 2 and int(js.step) == 2
    assert_params_close(ps, js, rtol=0, atol=0)
    assert_host_rows_close(pm, jm, exact=True)
    js, jl = jt.train_step(js, batches[2])
    ps, pl = pt.train_step(ps, batches[2])
    np.testing.assert_allclose(pl, float(jl), rtol=RTOL, atol=ATOL)
    assert_host_rows_close(pm, jm)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    params, batches = _host_setup(seed=1)
    jt, js, jm = jax_trainer("host", HOST_CFG, params, batches[0])
    for batch in batches[:2]:
        js, _ = jt.train_step(js, batch)
    JSaver(str(tmp_path), extra_state_fn=jm.flat_state).save(js, 2)
    pt, ps, pm = port_trainer("host", HOST_CFG, numpy_params(
        "host", HOST_CFG, seed=8))
    pm.tables()["edl_embedding"].engine.pull(np.arange(500))  # replaced
    ps, version = host_bridge.restore_with_host_state(pt, ps, pm,
                                                      str(tmp_path))
    assert version == 2 and ps.step == 2
    assert_params_close(ps, js, rtol=0, atol=0)
    assert_host_rows_close(pm, jm, exact=True)
    assert pm.tables()["edl_embedding"].engine.state_dict()["step"] == 2
    js, jl = jt.train_step(js, batches[2])
    ps, pl = pt.train_step(ps, batches[2])
    np.testing.assert_allclose(pl, float(jl), rtol=RTOL, atol=ATOL)
    assert_host_rows_close(pm, jm)
    alone = _port_manager()  # the engines alone, from the same read
    assert host_bridge.restore_host_state(alone, str(tmp_path)) == 2
    assert_host_rows_close(alone, _jax_restored_manager(tmp_path), exact=True)
    with pytest.raises(KeyError, match="host-embedding state"):
        _port_manager().load_flat_state({})


def _jax_restored_manager(path):
    """A JAX manager restored from the checkpoint under `path`."""
    manager = _jax_manager()
    jbridge.restore_host_state(manager, str(path))
    return manager


# ---------------------------------------------------------------- exports


def _store_bytes(manager):
    return {name: (len(t.engine.param), _sorted_rows(t.engine.param)[1]
                   .tobytes()) for name, t in manager.tables().items()}


def test_exports_serve_across_packages(tmp_path):
    params, batches = _host_setup(seed=2)
    jt, js, jm = jax_trainer("host", HOST_CFG, params, batches[0])
    pt, ps, pm = port_trainer("host", HOST_CFG, params)
    for batch in batches[:2]:
        js, _ = jt.train_step(js, batch)
        ps, _ = pt.train_step(ps, batch)
    held = _batches(1, seed=77, batch=16)[0][0]
    held["feature"][0, :3] = 0
    # a JAX export served by the port
    jexporter.export_model(jt.model, js, str(tmp_path / "j"),
                           host_manager=jm)
    payload, meta = exporter.load_exported(str(tmp_path / "j"))
    assert meta["version"] == 2 and sorted(payload["host_embeddings"]) == [
        "edl_embedding", "edl_id_bias"]
    before = _store_bytes(pm)
    serve = exporter.make_serving_fn(pt.model, payload, host_manager=pm)
    ref = jexporter.make_serving_fn(jt.model, jexporter.load_exported(
        str(tmp_path / "j"))[0], host_manager=jm)(held)
    got = serve(held)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(ref["logits"]), rtol=RTOL,
                               atol=ATOL)
    assert _store_bytes(pm) == before  # the caller's engines never move
    # a port export served by JAX, its rows those of the port's stores
    exporter.export_model(pt.model, ps, str(tmp_path / "p"),
                          host_manager=pm)
    jpayload, jmeta = jexporter.load_exported(str(tmp_path / "p"))
    assert jmeta["version"] == 2
    for name, t in pm.tables().items():
        ids, values = _sorted_rows(t.engine.param)
        rec = jpayload["host_embeddings"][name]
        order = np.argsort(rec["ids"])
        np.testing.assert_array_equal(rec["ids"][order], ids)
        np.testing.assert_array_equal(rec["values"][order], values)
    jgot = jexporter.make_serving_fn(jt.model, jpayload,
                                     host_manager=jm)(held)
    ours = exporter.make_serving_fn(pt.model, exporter.load_exported(
        str(tmp_path / "p"))[0], host_manager=pm)(held)
    np.testing.assert_allclose(ours["logits"].numpy(),
                               np.asarray(jgot["logits"]), rtol=RTOL,
                               atol=ATOL)
    with pytest.raises(ValueError, match="host-resident"):
        exporter.make_serving_fn(pt.model, payload)
    with pytest.raises(ValueError, match="carries none"):
        exporter.make_serving_fn(pt.model, {"params": payload["params"]},
                                 host_manager=pm)


def test_export_from_checkpoint_restores_into_a_clone(tmp_path):
    params, batches = _host_setup(seed=3)
    pt, ps, pm = port_trainer("host", HOST_CFG, params)
    ps, _ = pt.train_step(ps, batches[0])
    CheckpointSaver(pt, str(tmp_path / "ck"),
                    extra_state_fn=pm.flat_state).save(ps, 1)
    snapshot = pm.flat_state()
    ps, _ = pt.train_step(ps, batches[1])  # the live tier moves on
    live = _store_bytes(pm)
    exporter.export_from_checkpoint(pt.model, ps, str(tmp_path / "ck"),
                                    str(tmp_path / "e"), host_manager=pm)
    payload, meta = exporter.load_exported(str(tmp_path / "e"))
    assert meta["version"] == 1 and _store_bytes(pm) == live
    for name in pm.tables():
        rec = payload["host_embeddings"][name]
        base = ".host_embeddings['%s'].param" % name
        want = dict(zip(snapshot[base + ".ids"].tolist(),
                        snapshot[base + ".values"]))
        assert sorted(rec["ids"].tolist()) == sorted(want)
        for i, row in zip(rec["ids"].tolist(), rec["values"]):
            np.testing.assert_array_equal(row, want[i])


# ---------------------------------------------------------- the executor


def test_local_executor_matches_jax_on_frappe_records(tmp_path, monkeypatch):
    """deepfm_host_embedding at the zoo's widths (embedding 64, fc 64,
    frappe's 5383 ids) through both LocalExecutors over the same
    gen_frappe_like records, from one JAX checkpoint."""
    monkeypatch.setattr(jstore, "available", lambda: False)  # numpy store
    train, val = str(tmp_path / "train"), str(tmp_path / "val")
    recordio_gen.gen_frappe_like(train, num_files=1, records_per_file=64)
    jrecordio_gen.gen_frappe_like(val, num_files=1, records_per_file=48,
                                  seed=7)
    init = str(tmp_path / "init")
    jt = JTrainer(jax_spec_of(jhost), mesh=mesh_lib.build_mesh(
        {"dp": 1}, devices=jax.devices()[:1]))
    jm = jbridge.attach_from_spec(jt, jax_spec_of(jhost), force_python=True)
    example = ({"feature": np.zeros((16, 10), np.int32)},
               np.zeros((16,), np.int32))
    JSaver(init, extra_state_fn=jm.flat_state).save(jt.init_state(example),
                                                    0)
    common = dict(training_data=train, validation_data=val,
                  minibatch_size=16, records_per_task=32,
                  checkpoint_dir_for_init=init)
    ref = JLocalExecutor(jax_spec_of(jhost), **common)
    random.seed(0)  # the task shuffle
    _jstate, jmetrics = ref.train()
    ours = LocalExecutor(load_model_spec_from_module(thost), device="cpu",
                         **common)
    random.seed(0)
    _state, metrics = ours.train()
    assert isinstance(ours.host_manager.tables()["edl_embedding"].engine
                      .param, native_store._NativeStore)
    assert len(ours.losses) == len(ref.losses) == 4
    np.testing.assert_allclose(ours.losses, ref.losses, rtol=RTOL,
                               atol=ATOL)
    assert sorted(metrics) == sorted(jmetrics)
    for key in ("probs_auc", "logits_accuracy"):
        np.testing.assert_allclose(metrics[key], jmetrics[key],
                                   atol=METRIC_TOL)
    assert_host_rows_close(ours.host_manager, ref._host_manager)


def test_worker_checkpoint_holds_the_host_leaves(tmp_path):
    """A Worker over the in-process master trains deepfm_host_embedding
    (the spec's manager, attached through attach_from_spec); its
    checkpoint holds the host leaves, and a second worker restored from
    it holds the same rows."""
    train = str(tmp_path / "train")
    recordio_gen.gen_frappe_like(train, num_files=1, records_per_file=32,
                                 input_dim=200)
    spec = load_model_spec_from_module(thost)
    params = "input_length=10; fc_unit=8"
    master = Master(spec, training_data=train, minibatch_size=8,
                    records_per_task=16)
    worker = Worker(0, spec, master_servicer=master.servicer,
                    training_data=train, minibatch_size=8,
                    model_params=params, wait_sleep_secs=0.01,
                    checkpoint_dir=str(tmp_path / "ck"), checkpoint_steps=2,
                    device="cpu")
    worker.run()
    assert master.task_d.finished() and worker.state.step == 4
    assert isinstance(worker.host_manager, host_bridge.HostEmbeddingManager)
    flat, version = load_checkpoint(str(tmp_path / "ck"))
    assert version == 4
    want = worker.host_manager.flat_state()
    assert sorted(k for k in flat if k.startswith(".host_embeddings")) == (
        sorted(want))
    assert int(flat[".host_embeddings['edl_embedding'].step"]) == 4
    master2 = Master(spec, training_data=train, minibatch_size=8,
                     records_per_task=16)
    again = Worker(1, spec, master_servicer=master2.servicer,
                   training_data=train, minibatch_size=8, model_params=params,
                   checkpoint_dir_for_init=str(tmp_path / "ck"),
                   device="cpu")
    again._ensure_state(None)
    assert again.state.step == 4
    got = again.host_manager.flat_state()
    for name in ("edl_embedding", "edl_id_bias"):
        base = ".host_embeddings['%s'].param" % name
        o, p = np.argsort(got[base + ".ids"]), np.argsort(want[base + ".ids"])
        np.testing.assert_array_equal(got[base + ".ids"][o],
                                      want[base + ".ids"][p])
        np.testing.assert_array_equal(got[base + ".values"][o],
                                      want[base + ".values"][p])
    for key, p in worker.state.params.items():
        assert torch.equal(again.state.params[key], p)
