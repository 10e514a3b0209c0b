"""Packed and sliding-window transformer_lm in the port against the JAX
package, same inputs.

flax-layout params are drawn by numpy and carried into the port by
`params_from_flax`; documents, batches and requests come from numpy
seeds. Both sides run fp32 on the CPU (the port takes its kernels'
plain versions). Tolerances:

* packing: rows, ids and labels equal;
* logits with `segment_ids` or `attn_window` against flax: 1e-4; a
  packed row's logits against each of its documents run alone: 1e-5;
* Trainer steps (AdamW, lr 1e-2, weight decay 0.1): losses to 1e-5
  relative; parameters at least 999 elements in 1,000 within 2e-6 and
  every element within 5e-4 (the bounds of tests/test_torch_training.py,
  where the reason for the looser one is given);
* LocalExecutor on the packed family: losses to 1e-5 relative, token
  accuracy to 1e-6;
* greedy token streams of the paged engines: equal.
"""

import flax
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from elasticdl_tpu.api.local_executor import LocalExecutor as JLocalExecutor
from elasticdl_tpu.common.constants import Mode as JMode
from elasticdl_tpu.common.model_utils import (
    load_model_spec_from_module as jax_spec_of,
)
from elasticdl_tpu.data import packing as jpacking
from elasticdl_tpu.data import recordio_gen
from elasticdl_tpu.data.dataset import Dataset as JDataset
from elasticdl_tpu.master.task_dispatcher import Task as JTask
from elasticdl_tpu.parallel import mesh as mesh_lib
from elasticdl_tpu.serving.admission import ServingRequest as JaxRequest
from elasticdl_tpu.serving.engine import (
    PagedContinuousBatchingEngine as JaxPagedEngine,
)
from elasticdl_tpu.training.trainer import Trainer as JTrainer
from elasticdl_tpu_torch.api.local_executor import LocalExecutor
from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.common.model_utils import load_model_spec_from_module
from elasticdl_tpu_torch.convert import (
    flatten_params,
    params_from_flax,
    params_to_flax,
)
from elasticdl_tpu_torch.data import packing
from elasticdl_tpu_torch.data.dataset import Dataset, pad_batch
from elasticdl_tpu_torch.master.task_dispatcher import Task, TaskType
from elasticdl_tpu_torch.model_zoo import transformer_lm as tzoo
from elasticdl_tpu_torch.model_zoo import transformer_lm_packed as tpacked
from elasticdl_tpu_torch.serving import main as port_main
from elasticdl_tpu_torch.serving.admission import ServingRequest
from elasticdl_tpu_torch.serving.engine import PagedContinuousBatchingEngine
from elasticdl_tpu_torch.training.optimizers import adamw
from elasticdl_tpu_torch.training.trainer import Trainer
from model_zoo.transformer_lm import transformer_lm as zoo
from model_zoo.transformer_lm_packed import transformer_lm_packed as jpacked

torch.set_num_threads(2)

TOL = 1e-5
LOGIT_TOL = 1e-4
PARAM_TOL = 2e-6
PARAM_TOL_WORST = 5e-4
LR, WD = 1e-2, 0.1
CFG = dict(vocab_size=64, seq_len=32, embed_dim=32, num_heads=2,
           num_layers=2)


def _params_str(cfg):
    return "; ".join("%s=%r" % kv for kv in cfg.items())


def numpy_params(cfg, seed=0):
    """flax-layout params with every leaf drawn by numpy."""
    shapes = jax.eval_shape(
        lambda: zoo.TransformerLM(**cfg).init(
            jax.random.PRNGKey(0),
            {"tokens": jnp.zeros((1, cfg["seq_len"]), jnp.int32)})
    )["params"]
    rs = np.random.RandomState(seed)

    def draw(leaf):
        shape = leaf.value.shape if hasattr(leaf, "value") else leaf.shape
        scale = 1.0 / np.sqrt(shape[0]) if len(shape) == 2 else 0.1
        base = 1.0 if len(shape) == 1 else 0.0
        return (base + scale * rs.randn(*shape)).astype(np.float32)

    return jax.tree.map(
        draw, shapes,
        is_leaf=lambda x: hasattr(x, "value") or hasattr(x, "shape"))


def port_model(cfg, params):
    model = tzoo.custom_model(device="cpu", **cfg)
    model.load_state_dict(params_from_flax(params))
    return model


def documents(seed, n, lo=2, hi=20, vocab=64):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, size=rs.randint(lo, hi + 1)).astype(
        np.int32) for _ in range(n)]


def packed_batch(seed, n_rows=4, row_len=32, vocab=64):
    """(features, labels) of packed rows: first-fit over seeded documents
    of 2-20 tokens, as the JAX packer lays them out."""
    tokens, seg, labels = jpacking.pack_sequences(
        documents(seed, 4 * n_rows, vocab=vocab), row_len)
    tokens, seg, labels = (np.asarray(x)[:n_rows] for x in (tokens, seg,
                                                            labels))
    return {"tokens": tokens, "segment_ids": seg}, labels


# ---------------------------------------------------------------- packing


@pytest.mark.parametrize("seed,row_len", [(0, 32), (1, 16), (2, 64)])
def test_pack_sequences_equals_jax(seed, row_len):
    docs = documents(seed, 30, lo=1, hi=70)  # chunks past row_len, len 1
    got = packing.pack_sequences(docs, row_len)
    ref = jpacking.pack_sequences(docs, row_len)
    for a, b in zip(got, ref):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert packing.packing_efficiency(docs, row_len) == (
        jpacking.packing_efficiency(docs, row_len))
    assert packing.IGNORE_LABEL == jpacking.IGNORE_LABEL == -100
    with pytest.raises(ValueError, match="no packable"):
        packing.pack_sequences([[1]], row_len)


@pytest.mark.parametrize("open_rows", [1, 8])
def test_pack_dataset_streams_jax_rows(open_rows):
    docs = documents(7, 40, lo=1, hi=50)
    got = list(packing.pack_dataset(Dataset.from_list(docs), 32,
                                    open_rows=open_rows))
    ref = list(jpacking.pack_dataset(JDataset.from_list(docs), 32,
                                     open_rows=open_rows))
    assert len(got) == len(ref) > 0
    for (f, l), (jf, jl) in zip(got, ref):
        assert sorted(f) == ["segment_ids", "tokens"]
        np.testing.assert_array_equal(f["tokens"], jf["tokens"])
        np.testing.assert_array_equal(f["segment_ids"], jf["segment_ids"])
        np.testing.assert_array_equal(l, jl)


# ------------------------------------------------------------------ model


MODEL_CASES = {
    # name: (model kwargs beyond CFG, packed batch or not)
    "packed_learned": ({}, True),
    "packed_rope": ({"pos_emb": "rope"}, True),
    "packed_gqa": ({"num_heads": 4, "num_kv_heads": 2}, True),
    "window_learned": ({"attn_window": 5}, False),
    "window_rope_gqa": ({"pos_emb": "rope", "num_heads": 4,
                         "num_kv_heads": 1, "attn_window": 7}, False),
    "packed_window_rope": ({"pos_emb": "rope", "attn_window": 6}, True),
}


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_logits_match_flax(name):
    extra, packed = MODEL_CASES[name]
    cfg = dict(CFG, **extra)
    params = numpy_params(cfg, seed=len(name))
    if packed:
        features, _ = packed_batch(3)
    else:
        rs = np.random.RandomState(4)
        features = {"tokens": rs.randint(0, 64, size=(3, 32)).astype(
            np.int32)}
    ref = zoo.TransformerLM(**cfg).apply({"params": params}, features,
                                         training=True)
    got = port_model(cfg, params)(features, training=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("pos_emb", ["learned", "rope"])
def test_packed_row_equals_each_document_alone(pos_emb):
    """Segment masks plus restarting positions make a packed row's
    logits those of its documents run one by one."""
    cfg = dict(CFG, pos_emb=pos_emb)
    model = port_model(cfg, numpy_params(cfg, seed=5))
    docs = documents(11, 4, lo=3, hi=9)
    tokens, seg, _labels = packing.pack_sequences(docs, 32)
    assert tokens.shape[0] == 1
    packed = model({"tokens": tokens, "segment_ids": seg}).detach()
    at = 0
    for doc in sorted(docs, key=len, reverse=True):  # first-fit order
        alone = model({"tokens": doc[None]}).detach()
        np.testing.assert_allclose(packed[0, at:at + len(doc)].numpy(),
                                   alone[0].numpy(), atol=TOL, rtol=TOL)
        at += len(doc)


def test_windowed_and_packed_models_carry_flagship_params():
    """A window or packing changes no parameter: the flax params of a
    windowed model convert, load strictly and round-trip unchanged."""
    params = numpy_params(dict(CFG, attn_window=4), seed=2)
    plain = numpy_params(CFG, seed=2)
    assert sorted(flatten_params(params)) == sorted(flatten_params(plain))
    sd = params_from_flax(params)
    model = tzoo.custom_model(device="cpu", attn_window=4, **CFG)
    model.load_state_dict(sd)
    back = flatten_params(params_to_flax(model.state_dict()))
    for key, value in flatten_params(params).items():
        np.testing.assert_array_equal(back[key], value)
    packed = tpacked.custom_model(device="cpu", **dict(CFG, seq_len=128))
    packed.load_state_dict(params_from_flax(
        numpy_params(dict(CFG, seq_len=128), seed=3)))


# --------------------------------------------------------------- training


def jax_trainer(module, params, batch, model_params):
    spec = jax_spec_of(module)
    spec.optimizer = lambda: optax.adamw(LR, weight_decay=WD)
    mesh = mesh_lib.build_mesh({"dp": 1}, devices=jax.devices()[:1])
    trainer = JTrainer(spec, mesh=mesh, model_params=model_params)
    state = trainer.init_state(batch)
    jp = jax.tree.map(jnp.asarray, params)
    return trainer, state.replace(params=jp,
                                  opt_state=trainer._train_tx.init(jp))


def port_trainer(module, params, model_params):
    spec = load_model_spec_from_module(module)
    spec.optimizer = lambda: adamw(LR, weight_decay=WD)
    trainer = Trainer(spec, model_params=model_params, device="cpu")
    return trainer, trainer.init_state(None, params=params_from_flax(params))


def assert_params_close(port_state, jax_state):
    ours = flatten_params(params_to_flax(
        {k: p.detach() for k, p in port_state.params.items()}))
    ref = flatten_params(jax.tree.map(np.asarray, jax_state.params))
    assert sorted(ours) == sorted(ref)
    diffs = []
    for key in ref:
        np.testing.assert_allclose(ours[key], ref[key], atol=PARAM_TOL_WORST,
                                   rtol=0, err_msg=key)
        diffs.append(np.abs(ours[key] - ref[key]).ravel())
    diffs = np.concatenate(diffs)
    assert (diffs > PARAM_TOL).mean() <= 1e-3, np.sort(diffs)[-10:]


@pytest.mark.parametrize("name", ["packed", "windowed"])
def test_train_steps_match_jax_trainer(name):
    """Three AdamW steps: packed batches (the last one padded, 3 of 4
    rows real), or a window of 6 over unpacked rows."""
    cfg = dict(CFG, attn_window=6) if name == "windowed" else CFG
    params = numpy_params(cfg, seed=9)
    if name == "packed":
        batches = [packed_batch(20 + i) for i in range(3)]
    else:
        rs = np.random.RandomState(21)
        batches = []
        for _ in range(3):
            toks = rs.randint(0, 64, size=(4, 33)).astype(np.int32)
            batches.append(({"tokens": toks[:, :-1]}, toks[:, 1:]))
    model_params = _params_str(cfg)
    jt, js = jax_trainer(zoo, params, batches[0], model_params)
    pt, ps = port_trainer(tzoo, params, model_params)
    for i, (features, labels) in enumerate(batches):
        if i == 2:  # a partial batch: pad_batch repeats the last row
            features = {k: v[:3] for k, v in features.items()}
            labels = labels[:3]
        padded, n_true = pad_batch((features, labels), 4)
        assert n_true == (3 if i == 2 else 4)
        for v in padded[0].values():
            assert v.dtype == np.int32 and v.shape == (4, 32)
        js, jl = jt.train_step(js, padded, n_true)
        ps, pl = pt.train_step(ps, padded, n_true)
        np.testing.assert_allclose(pl, float(jl), rtol=TOL, atol=0)
    assert ps.step == 3
    assert_params_close(ps, js)


def test_packed_family_spec_checks():
    with pytest.raises(ValueError, match="128-token rows"):
        tpacked.custom_model(device="cpu", **CFG)
    with pytest.raises(ValueError, match="trains and evaluates"):
        tpacked.dataset_fn(Dataset.from_list([]), Mode.PREDICTION, {})
    assert tpacked.feature_shapes() == jpacked.feature_shapes()
    assert tpacked.loss is tzoo.loss and tpacked.optimizer is tzoo.optimizer
    labels = np.array([[1, 2, -100], [-100, -100, -100]])
    preds = np.zeros((2, 3, 4), np.float32)
    preds[0, 0, 1] = preds[0, 1, 3] = 1.0
    ours = tpacked.eval_metrics_fn()["token_accuracy"](labels, preds)
    ref = jpacked.eval_metrics_fn()["token_accuracy"](labels, preds)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, [0.5, 0.0])


def test_local_executor_on_packed_docs_matches_jax(tmp_path):
    """The packed family over gen_docs_like records: the same packed
    batches as the JAX executor's, and from the same weights the same
    losses over 3 steps and the same token accuracy."""
    data = str(tmp_path / "docs")
    recordio_gen.gen_docs_like(data, num_files=1, records_per_file=60,
                               vocab_size=64)
    cfg = dict(CFG, seq_len=tpacked.ROW_LEN)
    model_params = _params_str(cfg)
    params = numpy_params(cfg, seed=13)
    mesh = mesh_lib.build_mesh({"dp": 1}, devices=jax.devices()[:1])
    jex = JLocalExecutor(jax_spec_of(jpacked), training_data=data,
                         validation_data=data, minibatch_size=4,
                         records_per_task=60, model_params=model_params,
                         mesh=mesh, max_steps=3)
    ex = LocalExecutor(load_model_spec_from_module(tpacked),
                       training_data=data, validation_data=data,
                       minibatch_size=4, records_per_task=60,
                       model_params=model_params, max_steps=3, device="cpu")
    reader = ex._reader(data)
    (shard, (start, n)), = reader.create_shards().items()
    task = Task(shard, start, start + n, TaskType.TRAINING)
    ours = list(ex._task_dataset(reader, task, Mode.TRAINING))
    ref = list(jex._task_dataset(jex._reader(data),
                                 JTask(shard, start, start + n, "TRAINING"),
                                 JMode.TRAINING))
    assert len(ours) == len(ref) >= 3
    for (f, l), (jf, jl) in zip(ours, ref):
        for key in ("tokens", "segment_ids"):
            np.testing.assert_array_equal(f[key], jf[key])
        np.testing.assert_array_equal(l, jl)
    # both start from the same numpy weights and the zoo's AdamW
    jp = jax.tree.map(jnp.asarray, params)
    jex.state = jex.trainer.init_state(pad_batch(ref[0], 4)[0]).replace(
        params=jp, opt_state=jex.trainer._train_tx.init(jp))
    ex.state = ex.trainer.init_state(None, params=params_from_flax(params))
    _js, jmetrics = jex.train()
    _ps, metrics = ex.train()
    np.testing.assert_allclose(ex.losses, jex.losses, rtol=TOL, atol=0)
    assert len(ex.losses) == 3
    np.testing.assert_allclose(metrics["token_accuracy"],
                               jmetrics["token_accuracy"], atol=1e-6)


# ---------------------------------------------------------------- serving


ENGINE_WINDOW = 5
BLOCK, SLOTS, NUM_BLOCKS = 4, 3, 24
PREFIX = [5, 9, 14, 3, 22, 7, 41, 18]  # two full blocks
# prompts longer than the window; a shared prefix seated by incref with
# a suffix tile over it, a full-prompt match, a one-token answer
REQUESTS = [
    (PREFIX + [11, 2], 6),
    (list(range(30, 43)), 7),
    (PREFIX + [33, 1, 60, 4, 4, 9], 5),
    (PREFIX, 4),
    ([7, 7, 8], 1),
    (PREFIX + [11, 2, 50, 51, 52], 9),
]


def engine_params(kv):
    return _params_str(dict(CFG, attn_window=ENGINE_WINDOW,
                            kv_cache_dtype=kv))


@pytest.fixture(scope="module", params=["", "int8"])
def rig(request):
    kv = request.param
    mesh = mesh_lib.build_mesh({"dp": 1}, devices=jax.devices()[:1])
    trainer = JTrainer(jax_spec_of(zoo), mesh=mesh,
                       model_params=engine_params(kv), seed=0)
    toks = (np.arange(33)[None, :] % 64).astype(np.int32)
    state = trainer.init_state(({"tokens": toks[:, :-1]}, toks[:, 1:]))
    params = jax.tree.map(np.asarray, flax.core.meta.unbox(state.params))
    return kv, trainer, state, params


def windowed_port_model(params, kv):
    return port_model(dict(CFG, attn_window=ENGINE_WINDOW,
                           kv_cache_dtype=kv), params)


def drive(engine, reqs):
    pending = list(reqs)
    for _ in range(200):
        while pending and engine.free_slots() and engine.can_seat(
                pending[0]):
            engine.insert(pending.pop(0))
        if not pending and not engine.active_count():
            break
        engine.step()
    assert not pending and not engine.active_count()
    return [list(r.generated) for r in reqs]


def test_windowed_greedy_streams_match_jax_engine(rig):
    kv, trainer, state, params = rig
    jeng = JaxPagedEngine(trainer, state, SLOTS, block_size=BLOCK,
                          num_blocks=NUM_BLOCKS, share_prefix=True)
    peng = PagedContinuousBatchingEngine(
        windowed_port_model(params, kv), SLOTS, block_size=BLOCK,
        num_blocks=NUM_BLOCKS, share_prefix=True)
    ref = drive(jeng, [JaxRequest(p, n) for p, n in REQUESTS])
    got = drive(peng, [ServingRequest(p, n) for p, n in REQUESTS])
    assert got == ref
    assert [len(g) for g in got] == [n for _p, n in REQUESTS]
    assert peng.kv.allocator.prefix_hit_tokens == (
        jeng.kv.allocator.prefix_hit_tokens) > 0
    assert peng.kv.allocator.blocks_in_use() == 0
    # the window changes the streams: the unwindowed model differs
    full = PagedContinuousBatchingEngine(
        port_model(dict(CFG, kv_cache_dtype=kv), params), SLOTS,
        block_size=BLOCK, num_blocks=NUM_BLOCKS, share_prefix=True)
    assert drive(full, [ServingRequest(p, n) for p, n in REQUESTS]) != got


def test_main_serves_a_windowed_model_on_cpu(rig, tmp_path):
    kv, _trainer, state, params = rig
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                flax.core.meta.unbox(state.params))[0]}
    npz = tmp_path / "params.npz"
    np.savez(npz, **flat)
    args = port_main.parse_serving_args([
        "--device", "cpu", "--model_params", engine_params(kv),
        "--num_slots", "2", "--kv_paged", "1", "--kv_block_size", "4",
        "--params_npz", str(npz),
    ])
    server = port_main.build_server(args).start()
    try:
        assert server.engine.model.attn_window == ENGINE_WINDOW
        answers = port_main.serve_lines(server, [
            '{"prompt": %s, "max_new_tokens": 6}' % REQUESTS[1][0],
            '{"status": true}',
        ])
    finally:
        server.stop(timeout=30)
    offline = drive(
        PagedContinuousBatchingEngine(windowed_port_model(params, kv), SLOTS,
                                      block_size=BLOCK,
                                      num_blocks=NUM_BLOCKS),
        [ServingRequest(*REQUESTS[1])])
    assert answers[0] == {"tokens": REQUESTS[1][0] + offline[0][:6]}
    assert answers[1]["status"]["completed"] == 1
