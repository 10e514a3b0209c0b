"""The port's training slice against the JAX package's, same inputs.

flax-layout params are drawn by numpy from a seed and carried into the
port by `params_from_flax`; batches come from numpy too. Both sides run
fp32 on the CPU (the port takes its kernels' plain versions there; the
JAX model takes its jnp attention). Tolerances:

* logits and losses: 1e-5;
* Trainer steps (AdamW, lr 1e-2, weight decay 0.1): losses to 1e-5
  relative; parameters: at least 999 elements in 1,000 to PARAM_TOL =
  2e-6 absolute, and every element to PARAM_TOL_WORST = 5e-4. The
  looser bound is for the few elements whose gradient is near Adam's
  eps (1e-8): there the update lr * m / (sqrt(v) + eps) turns fp32
  reassociation noise in the gradient (XLA's sum order against
  PyTorch's) into update noise of up to lr * noise / eps. Measured: 5
  of 27,776 elements above 2e-6 after three steps (worst 1.9e-5), 13
  with 2-row microbatches under accumulation (worst 2.2e-4), none at
  eps 1e-4 (worst 1.5e-6). A missed or doubled decay term moves every
  element by 1e-3 x |p| per step, far outside the first bound;
* accumulated vs doubled batch (both in the port, SGD, which is linear
  in the gradient): 1e-6.
"""

import functools
import os
import random

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from elasticdl_tpu.api.callbacks import (
    LearningRateScheduler as JLearningRateScheduler,
)
from elasticdl_tpu.api.local_executor import LocalExecutor as JLocalExecutor
from elasticdl_tpu.common.constants import Mode as JMode
from elasticdl_tpu.common.model_utils import (
    load_model_spec_from_module as jax_spec_of,
)
from elasticdl_tpu.data import recordio_gen
from elasticdl_tpu.data.dataset import Dataset as JDataset
from elasticdl_tpu.data.dataset import pad_batch as jpad_batch
from elasticdl_tpu.data.example_codec import decode_example as jdecode
from elasticdl_tpu.data.example_codec import encode_example as jencode
from elasticdl_tpu.data.record_format import Scanner as JScanner
from elasticdl_tpu.data.record_format import write_records as jwrite_records
from elasticdl_tpu.master.task_dispatcher import Task as JTask
from elasticdl_tpu.master.task_dispatcher import (
    TaskDispatcher as JTaskDispatcher,
)
from elasticdl_tpu.ops.losses import chunked_softmax_xent as jchunked_xent
from elasticdl_tpu.parallel import mesh as mesh_lib
from elasticdl_tpu.training.metrics import (
    MetricsAggregator as JMetricsAggregator,
)
from elasticdl_tpu.training.trainer import Trainer as JTrainer
from elasticdl_tpu_torch.api.callbacks import LearningRateScheduler
from elasticdl_tpu_torch.api.local_executor import LocalExecutor
from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.common.model_utils import (
    get_model_spec,
    load_model_spec_from_module,
)
from elasticdl_tpu_torch.convert import (
    adam_state_from_optax,
    flatten_params,
    flax_param_path,
    params_from_flax,
    params_to_flax,
)
from elasticdl_tpu_torch.data.dataset import Dataset, pad_batch
from elasticdl_tpu_torch.data.example_codec import (
    decode_example,
    encode_example,
)
from elasticdl_tpu_torch.data.record_format import RecordWriter, Scanner
from elasticdl_tpu_torch.master.task_dispatcher import Task, TaskDispatcher
from elasticdl_tpu_torch.master.task_dispatcher import TaskType
from elasticdl_tpu_torch.model_zoo import transformer_lm as tzoo
from elasticdl_tpu_torch.ops.losses import chunked_softmax_xent
from elasticdl_tpu_torch.training.metrics import MetricsAggregator
from elasticdl_tpu_torch.training.optimizers import adamw
from elasticdl_tpu_torch.training.trainer import Trainer
from model_zoo.transformer_lm import transformer_lm as zoo

torch.set_num_threads(2)

TOL = 1e-5
PARAM_TOL = 2e-6
PARAM_TOL_WORST = 5e-4
CFG = dict(vocab_size=32, seq_len=16, embed_dim=32, num_heads=2,
           num_layers=2)
PARAMS = "; ".join("%s=%r" % kv for kv in CFG.items())
LR, WD = 1e-2, 0.1


def sgd(learning_rate):
    """optax.sgd as a port optimizer factory: linear in the gradient, so
    microbatch means and one big batch give the same update."""
    return functools.partial(torch.optim.SGD, lr=learning_rate)


def numpy_params(cfg=CFG, seed=0):
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


def tokens_batch(seed, bsz=4, cfg=CFG):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, cfg["vocab_size"],
                        size=(bsz, cfg["seq_len"] + 1)).astype(np.int32)
    return {"tokens": tokens[:, :-1]}, tokens[:, 1:]


def jax_trainer(params, batch, optimizer=None, **kwargs):
    spec = jax_spec_of(zoo)
    spec.optimizer = optimizer or (lambda: optax.adamw(LR, weight_decay=WD))
    mesh = mesh_lib.build_mesh({"dp": 1}, devices=jax.devices()[:1])
    trainer = JTrainer(spec, mesh=mesh, model_params=PARAMS, **kwargs)
    state = trainer.init_state(batch)
    jp = jax.tree.map(jnp.asarray, params)
    return trainer, state.replace(params=jp,
                                  opt_state=trainer._train_tx.init(jp))


def port_trainer(params, optimizer=None, model_params=PARAMS, **kwargs):
    spec = load_model_spec_from_module(tzoo)
    spec.optimizer = optimizer or (lambda: adamw(LR, weight_decay=WD))
    trainer = Trainer(spec, model_params=model_params, device="cpu",
                      **kwargs)
    return trainer, trainer.init_state(None, params=params_from_flax(params))


def flat_port(state):
    return flatten_params(params_to_flax(
        {k: p.detach() for k, p in state.params.items()}))


def flat_jax(state):
    return flatten_params(jax.tree.map(np.asarray, state.params))


def assert_params_close(port_state, jax_state):
    ours, ref = flat_port(port_state), flat_jax(jax_state)
    assert sorted(ours) == sorted(ref)
    diffs = []
    for key in ref:
        np.testing.assert_allclose(ours[key], ref[key], atol=PARAM_TOL_WORST,
                                   rtol=0, err_msg=key)
        diffs.append(np.abs(ours[key] - ref[key]).ravel())
    diffs = np.concatenate(diffs)
    assert (diffs > PARAM_TOL).mean() <= 1e-3, np.sort(diffs)[-10:]


def run_both(jt, js, pt, ps, batches):
    for batch, n in batches:
        js, jl = jt.train_step(js, batch, n)
        ps, pl = pt.train_step(ps, batch, n)
        np.testing.assert_allclose(pl, float(jl), rtol=TOL, atol=0)
    return js, ps


# ---------------------------------------------------------------- model


def test_training_forward_and_losses_match_flax():
    params = numpy_params()
    features, labels = tokens_batch(1)
    labels = labels.copy()
    labels[0, :5] = -100
    labels[2, :] = -100  # a row with no valid token
    weights = np.array([1.0, 0.5, 1.0, 0.0], np.float32)
    fmodel = zoo.TransformerLM(**CFG)
    jlogits = fmodel.apply({"params": params}, features, training=True)
    model = tzoo.custom_model(device="cpu", **CFG)
    model.load_state_dict(params_from_flax(params))
    logits = model(features, training=True)
    assert logits.dtype == torch.float32 and logits.requires_grad
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=TOL, rtol=TOL)
    for w in (None, weights):
        ref = float(zoo.loss(labels, jlogits, w))
        got = float(tzoo.loss(labels, logits, w).detach())
        np.testing.assert_allclose(got, ref, rtol=TOL)
    # fused head: the chunked loss over (hidden, kernel), values and
    # parameter gradients
    fcfg = dict(CFG, fused_head=True)
    jpreds = zoo.TransformerLM(**fcfg).apply({"params": params}, features,
                                            training=True)
    fused = tzoo.custom_model(device="cpu", **fcfg)
    fused.load_state_dict(params_from_flax(params))
    preds = fused(features, training=True)
    assert preds["lm_head_kernel"].shape == (CFG["embed_dim"],
                                             CFG["vocab_size"])
    ref = float(zoo.loss(labels, jpreds, weights))
    got = tzoo.loss(labels, preds, weights)
    np.testing.assert_allclose(float(got.detach()), ref, rtol=TOL)
    got.backward()
    jgrads = jax.grad(lambda p: zoo.loss(labels, zoo.TransformerLM(
        **fcfg).apply({"params": p}, features, training=True), weights))(
            params)
    ours = flatten_params(params_to_flax(
        {k: p.grad for k, p in fused.named_parameters()}))
    for key, g in flatten_params(jax.tree.map(np.asarray, jgrads)).items():
        np.testing.assert_allclose(ours[key], g, atol=TOL, rtol=TOL,
                                   err_msg=key)
    # eval forward ignores fused_head; the serving prefill is unchanged
    assert fused(features, training=False).shape == logits.shape
    prefill, kv = model(torch.as_tensor(features["tokens"]))
    assert prefill.grad_fn is None and len(kv) == CFG["num_layers"]
    np.testing.assert_allclose(prefill.numpy(), logits.detach().numpy(),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("s,num_chunks", [(13, 8), (16, 4), (5, 1)])
def test_chunked_xent_matches_jax(s, num_chunks):
    rs = np.random.RandomState(s)
    hidden = rs.randn(2, s, 8).astype(np.float32)
    kernel = rs.randn(8, 24).astype(np.float32)
    labels = rs.randint(0, 24, size=(2, s)).astype(np.int32)
    ref = jchunked_xent(jnp.asarray(hidden), jnp.asarray(kernel),
                        jnp.asarray(labels), num_chunks=num_chunks)
    th = torch.from_numpy(hidden).requires_grad_()
    got = chunked_softmax_xent(th, torch.from_numpy(kernel),
                               torch.from_numpy(labels),
                               num_chunks=num_chunks)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=TOL, rtol=TOL)
    got.sum().backward()
    jg = jax.grad(lambda h: jchunked_xent(h, jnp.asarray(kernel),
                                          jnp.asarray(labels),
                                          num_chunks=num_chunks).sum())(
        jnp.asarray(hidden))
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jg), atol=TOL,
                               rtol=TOL)


def test_unported_options_raise():
    # remat and lora_rank are ported (tests/test_torch_finetune_export.py);
    # an unknown remat mode is refused as flax refuses it
    for kwargs in ({"remat": "full"}, {"remat": "dots"}, {"lora_rank": 4}):
        tzoo.custom_model(device="cpu", **dict(CFG, **kwargs))
    with pytest.raises(ValueError, match="remat"):
        tzoo.custom_model(device="cpu", **dict(CFG, remat="all"))
    # attn_window and segment_ids are ported
    # (tests/test_torch_packed_windowed.py)
    model = tzoo.custom_model(device="cpu", **dict(CFG, attn_window=8))
    features, _ = tokens_batch(0)
    logits = model(dict(features, segment_ids=np.zeros((4, 16), np.int32)),
                   training=True)
    assert logits.shape == (4, 16, CFG["vocab_size"])
    spec = load_model_spec_from_module(tzoo)
    with pytest.raises(NotImplementedError):
        Trainer(spec, mesh=object(), model_params=PARAMS, device="cpu")
    trainer = Trainer(spec, model_params=PARAMS, device="cpu")
    for call in (lambda: trainer.train_step_assembled(None, None, None,
                                                      None),
                 lambda: trainer.forward_assembled(None, None)):
        with pytest.raises(NotImplementedError):
            call()
    # attach_host_embeddings: None attaches no tier and the step runs
    # unchanged, as in the JAX Trainer; a non-manager is a TypeError
    with pytest.raises(TypeError):
        trainer.attach_host_embeddings(object())
    params = numpy_params()
    plain, plain_state = port_trainer(params)
    none, none_state = port_trainer(params)
    assert none.attach_host_embeddings(None) is none
    assert none.host_manager is None
    plain_state, plain_loss = plain.train_step(plain_state, tokens_batch(3))
    none_state, none_loss = none.train_step(none_state, tokens_batch(3))
    assert none_loss == plain_loss
    assert all(torch.equal(none_state.params[k], plain_state.params[k])
               for k in plain_state.params)
    # checkpoints under an sp mesh (tests/test_torch_checkpoint.py has
    # the single-device ones)
    with pytest.raises(NotImplementedError):
        LocalExecutor(spec, mesh=object(), checkpoint_dir="ckpt",
                      checkpoint_steps=1, device="cpu")


def test_flax_param_path_inverts_the_mapping():
    params = numpy_params()
    sd = params_from_flax(params)
    paths = {flax_param_path(k) for k in sd}
    assert paths == set(flatten_params(params))
    assert flax_param_path("blocks.1.attn.qkv.weight") == (
        "block_1/attn/qkv/kernel")
    assert flax_param_path("blocks.0.ln_1.bias") == "block_0/LayerNorm_1/bias"
    with pytest.raises(KeyError):
        flax_param_path("blocks.0.nope.weight")


# -------------------------------------------------------------- trainer


def test_train_steps_match_jax_trainer():
    params = numpy_params()
    batches = [(tokens_batch(10), None), (tokens_batch(11), 3),
               (tokens_batch(12), None)]
    jt, js = jax_trainer(params, batches[0][0])
    pt, ps = port_trainer(params)
    js, ps = run_both(jt, js, pt, ps, batches)
    assert ps.step == int(js.step) == 3 and ps.version == 3
    assert_params_close(ps, js)
    # the state keeps fp32 parameters and the optimizer saw every one
    assert all(p.dtype == torch.float32 for p in ps.params.values())
    assert len(ps.opt_state.optimizer.state) == len(ps.params)


def test_grad_accumulation_matches_jax_and_doubled_batch():
    params = numpy_params()
    micro = [(tokens_batch(20 + i, bsz=2), None) for i in range(4)]
    jt, js = jax_trainer(params, micro[0][0], grad_accum_steps=2)
    pt, ps = port_trainer(params, grad_accum_steps=2)
    before = flat_port(ps)
    js, jl = jt.train_step(js, *micro[0])
    ps, pl = pt.train_step(ps, *micro[0])
    np.testing.assert_allclose(pl, float(jl), rtol=TOL)
    # a non-boundary microbatch moves no parameter (decay included)
    after = flat_port(ps)
    for key in before:
        np.testing.assert_array_equal(after[key], before[key])
    assert ps.step == 1 and ps.opt_state.count == 0
    js, ps = run_both(jt, js, pt, ps, micro[1:])
    assert ps.step == 4 and ps.opt_state.count == 2
    assert_params_close(ps, js)

    # k microbatches of the port == one step on the k-times batch (SGD)
    def doubled(i, j):
        (fa, la), (fb, lb) = micro[i][0], micro[j][0]
        return ({"tokens": np.concatenate([fa["tokens"], fb["tokens"]])},
                np.concatenate([la, lb]))

    acc_t, acc_s = port_trainer(params, optimizer=lambda: sgd(0.1),
                                grad_accum_steps=2)
    big_t, big_s = port_trainer(params, optimizer=lambda: sgd(0.1))
    for i in range(4):
        acc_s, _ = acc_t.train_step(acc_s, *micro[i])
        if i % 2:
            big_s, _ = big_t.train_step(big_s, doubled(i - 1, i))
    a, b = flat_port(acc_s), flat_port(big_s)
    for key in a:
        np.testing.assert_allclose(a[key], b[key], atol=1e-6, rtol=0,
                                   err_msg=key)


def test_trainable_pattern_matches_jax_and_freezes():
    params = numpy_params()
    pattern = "head|block_1"
    batches = [(tokens_batch(30 + i), None) for i in range(3)]
    jt, js = jax_trainer(params, batches[0][0], trainable_pattern=pattern)
    pt, ps = port_trainer(params, trainable_pattern=pattern)
    js, ps = run_both(jt, js, pt, ps, batches)
    assert_params_close(ps, js)
    ours, init = flat_port(ps), flatten_params(params)
    frozen = [k for k in init if not ("head" in k or "block_1" in k)]
    assert frozen and len(frozen) < len(init)
    for key in init:
        if key in frozen:
            np.testing.assert_array_equal(ours[key], init[key])
            np.testing.assert_array_equal(flat_jax(js)[key], init[key])
        else:
            assert not np.array_equal(ours[key], init[key]), key
    trainable = ps.opt_state.trainable()
    assert len(trainable) == len(init) - len(frozen)
    assert all(not p.requires_grad for k, p in ps.params.items()
               if flax_param_path(k) in frozen)


def test_lr_scheduler_matches_jax():
    params = numpy_params()
    batches = [(tokens_batch(40 + i), None) for i in range(3)]
    jt, js = jax_trainer(params, batches[0][0], callbacks=[
        JLearningRateScheduler(lambda c: 0.5 ** c)])
    pt, ps = port_trainer(params, callbacks=[
        LearningRateScheduler(lambda c: 0.5 ** c)])
    js, ps = run_both(jt, js, pt, ps, batches)
    assert_params_close(ps, js)
    assert ps.opt_state.optimizer.param_groups[0]["lr"] == LR * 0.25


def test_adam_state_from_optax_continues_jax():
    params = numpy_params()
    batches = [(tokens_batch(50 + i), None) for i in range(3)]
    jt, js = jax_trainer(params, batches[0][0])
    for batch, n in batches[:2]:
        js, _ = jt.train_step(js, batch, n)
    # the step donates the JAX state's buffers: copy what is carried
    carried_params = jax.tree.map(np.asarray, js.params)
    opt = adam_state_from_optax(jax.tree.map(np.asarray, js.opt_state))
    assert opt["count"] == 2
    assert sorted(opt["exp_avg"]) == sorted(params_from_flax(params))
    js, jl = jt.train_step(js, *batches[2])
    spec = load_model_spec_from_module(tzoo)
    spec.optimizer = lambda: adamw(LR, weight_decay=WD)
    pt = Trainer(spec, model_params=PARAMS, device="cpu")
    ps = pt.init_state(None, params=params_from_flax(carried_params),
                       opt_state=opt, step=2)
    ps, pl = pt.train_step(ps, *batches[2])
    np.testing.assert_allclose(pl, float(jl), rtol=TOL)
    assert ps.step == 3 and ps.opt_state.count == 3
    assert_params_close(ps, js)


def test_padded_rows_do_not_train():
    params = numpy_params()
    (features, labels), n = tokens_batch(60, bsz=2), 2
    padded, true_count = pad_batch((features, labels), 4)
    assert true_count == n and padded[0]["tokens"].shape == (4, 16)
    a_t, a_s = port_trainer(params, optimizer=lambda: sgd(0.1))
    b_t, b_s = port_trainer(params, optimizer=lambda: sgd(0.1))
    a_s, la = a_t.train_step(a_s, padded, true_count)
    b_s, lb = b_t.train_step(b_s, (features, labels))
    np.testing.assert_allclose(la, lb, rtol=TOL)
    a, b = flat_port(a_s), flat_port(b_s)
    for key in a:
        np.testing.assert_allclose(a[key], b[key], atol=1e-6, rtol=0,
                                   err_msg=key)


def test_bf16_step_keeps_fp32_params():
    params = numpy_params()
    pt, ps = port_trainer(params, model_params=PARAMS + "; dtype='bf16'")
    ps, loss = pt.train_step(ps, tokens_batch(70))
    assert np.isfinite(loss) and abs(loss - np.log(CFG["vocab_size"])) < 2
    assert all(p.dtype == torch.float32 for p in ps.params.values())
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in ps.params.values())


# ------------------------------------------------- data and the executor


def test_records_codec_and_shuffle_match_jax(tmp_path):
    rs = np.random.RandomState(0)
    examples = [{"tokens": rs.randint(0, 9, size=(5,)).astype(np.int64),
                 "w": np.float32(i), "name": np.array(b"r%d" % i)}
                for i in range(6)]
    ours = str(tmp_path / "ours.trec")
    with RecordWriter(ours) as w:
        for ex in examples:
            w.write(encode_example(ex))
    theirs = str(tmp_path / "theirs.trec")
    jwrite_records(theirs, [jencode(ex) for ex in examples])
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    for got, ex in zip(JScanner(ours, 1, 4), examples[1:5]):
        for k, v in jdecode(got).items():
            np.testing.assert_array_equal(v, ex[k])
    assert [decode_example(p)["w"] for p in Scanner(theirs, 2)] == [
        np.float32(i) for i in range(2, 6)]
    got = list(Dataset.from_list(range(50)).shuffle(8, seed=3))
    ref = list(JDataset.from_list(range(50)).shuffle(8, seed=3))
    assert got == ref and sorted(got) == list(range(50))


def test_task_dispatcher_matches_jax():
    shards = {"a": (0, 10), "b": (0, 7)}
    orders = []
    for cls in (JTaskDispatcher, TaskDispatcher):
        random.seed(5)
        d = cls(dict(shards), {}, {}, 4, 2)
        order = []
        while True:
            task_id, task = d.get("w")
            if task is None:
                break
            order.append((task.shard_name, task.start, task.end))
            d.report(task_id, len(order) != 2)  # one failure re-queues
        orders.append(order)
    assert orders[0] == orders[1]
    assert len(orders[1]) == 2 * 5 + 1


def test_metrics_aggregator_matches_jax():
    rs = np.random.RandomState(0)
    fns = tzoo.eval_metrics_fn()
    ours, ref = MetricsAggregator(fns), JMetricsAggregator(fns)
    for _ in range(3):
        labels = rs.randint(0, 5, size=(4, 6))
        preds = rs.randn(4, 6, 5).astype(np.float32)
        ours.update(labels, preds)
        ref.update(labels, preds)
    assert ours.result() == ref.result()


def _jax_batches(jex, shards, mode):
    reader = jex._reader(jex.training_data)
    out = []
    for shard, (start, n) in shards.items():
        task = JTask(shard, start, start + n, "TRAINING")
        out.extend(jpad_batch(b, jex.minibatch_size)
                   for b in jex._task_dataset(reader, task, mode))
    return out


def test_local_executor_matches_jax_batches_and_trains(tmp_path):
    data = str(tmp_path / "train")
    recordio_gen.gen_tokens_like(data, num_files=2, records_per_file=10,
                                 seq_len=CFG["seq_len"] + 1,
                                 vocab_size=CFG["vocab_size"])
    mesh = mesh_lib.build_mesh({"dp": 1}, devices=jax.devices()[:1])
    jex = JLocalExecutor(jax_spec_of(zoo), training_data=data,
                         minibatch_size=4, records_per_task=10,
                         model_params=PARAMS, mesh=mesh)
    spec = get_model_spec(os.path.dirname(tzoo.__file__),
                          "transformer_lm.custom_model")
    ex = LocalExecutor(spec, training_data=data, validation_data=data,
                       minibatch_size=4, records_per_task=10,
                       model_params=PARAMS, max_steps=5, device="cpu",
                       evaluation_steps=2)
    evaluated_at = []
    evaluate = ex._evaluate_with_reader

    def counting(reader):
        evaluated_at.append(ex.state.step)
        return evaluate(reader)

    ex._evaluate_with_reader = counting
    reader = ex._reader(data)
    shards = reader.create_shards()
    assert len(shards) == 2
    ours = []
    for shard, (start, n) in shards.items():
        task = Task(shard, start, start + n, TaskType.TRAINING)
        ours.extend(pad_batch(b, 4) for b in ex._task_dataset(
            reader, task, Mode.TRAINING))
    ref = _jax_batches(jex, shards, JMode.TRAINING)
    assert [n for _b, n in ours] == [n for _b, n in ref] == [4, 4, 2] * 2
    for ((f, l), _n), ((jf, jl), _jn) in zip(ours, ref):
        np.testing.assert_array_equal(f["tokens"], jf["tokens"])
        np.testing.assert_array_equal(l, jl)
    state, metrics = ex.train()
    assert state.step == 5 and len(ex.losses) == 5
    assert evaluated_at == [2, 4, 5]  # every 2 steps, then the final one
    assert all(np.isfinite(ex.losses))
    assert 0.0 <= metrics["token_accuracy"] <= 1.0
    assert ex.evaluate() == metrics  # nothing trained since
