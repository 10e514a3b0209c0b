"""Fine-tuning and export in the port against the JAX package, same
inputs: LoRA adapters (forward and backward in training, prefill and
dense decode), remat, the dense-checkpoint warm start, adapter-only
training, merge_lora, int8 weights, the flax msgpack codec, the
exporter, SavedModelExporter and ModelHandler.

Weights are drawn by numpy from a seed in the flax layout and carried
into the port by convert.params_from_flax; both sides run fp32 on the
CPU (the port takes its kernels' plain versions there). Tolerances:

* logits, gradients and losses: 1e-5 (LOGIT_TOL), as
  tests/test_torch_training.py;
* Trainer steps: losses 1e-5 relative, parameters by
  test_torch_training.assert_params_close (2e-6 for all but one element
  in 1,000, 5e-4 for every element);
* remat against plain in the port: bit for bit (the same ops on the
  same inputs, recomputed);
* merge_lora: the merged tree against JAX's within 1e-6 (numpy's and
  XLA's fp32 products of A @ B may sum in another order); the merged
  model's logits against the adapter model's within 2e-5 relative,
  2e-6 absolute (tests/test_finetune.py:257: reassociation only);
* quantize_params, the codec's bytes, checkpoints and exports: bit for
  bit.
"""

import json
import os
import types

import flax
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import jax
import jax.numpy as jnp

from elasticdl_tpu.api import exporter as jexporter
from elasticdl_tpu.api import finetune as jfinetune
from elasticdl_tpu.api import quantization as jq
from elasticdl_tpu.checkpoint.saver import CheckpointSaver as JSaver
from elasticdl_tpu.checkpoint.saver import flatten_state as jflatten_state
from elasticdl_tpu.checkpoint.saver import load_checkpoint as jload
from elasticdl_tpu.common import constants as jconstants
from elasticdl_tpu.common.model_utils import (
    load_model_spec_from_module as jax_spec_of,
)
from elasticdl_tpu.parallel import mesh as mesh_lib
from elasticdl_tpu.training.trainer import Trainer as JTrainer
from elasticdl_tpu_torch.api import exporter, finetune
from elasticdl_tpu_torch.api import quantization as q
from elasticdl_tpu_torch.api.callbacks import SavedModelExporter
from elasticdl_tpu_torch.checkpoint.saver import (
    CheckpointSaver,
    load_checkpoint,
    params_tree_from_flat,
    params_tree_leaves,
    restore_state_from_checkpoint,
)
from elasticdl_tpu_torch.common import flax_msgpack
from elasticdl_tpu_torch.common.model_handler import (
    MESH_STRATEGIES,
    LocalModelHandler,
    MeshModelHandler,
    ModelHandler,
)
from elasticdl_tpu_torch.convert import (
    flatten_params,
    params_from_flax,
    params_to_flax,
)
from elasticdl_tpu_torch.model_zoo import transformer_lm as tzoo
from elasticdl_tpu_torch.serving import main as port_main
from elasticdl_tpu_torch.serving.admission import ServingRequest
from elasticdl_tpu_torch.serving.engine import (
    ContinuousBatchingEngine,
    PagedContinuousBatchingEngine,
)
from elasticdl_tpu_torch.serving.hot_reload import CheckpointWatcher
from model_zoo.transformer_lm import transformer_lm as zoo
from tests import test_torch_dlrm as D
from tests import test_torch_training as T

torch.set_num_threads(2)

LOGIT_TOL = 1e-5
CFG = dict(vocab_size=64, seq_len=32, embed_dim=64, num_heads=2,
           num_layers=2)
LORA = dict(CFG, lora_rank=4)
PARAMS = "; ".join("%s=%r" % kv for kv in CFG.items())
LORA_PARAMS = PARAMS + "; lora_rank=4"


def numpy_params(cfg, seed=0):
    """flax-layout params drawn by numpy; LoRA B scaled down to a
    trained adapter's size (it starts at zero)."""
    params = T.numpy_params(cfg, seed)
    for blk in params.values():
        for name, leaf in blk.get("attn", {}).items():
            if name.endswith("_lora_b"):
                blk["attn"][name] = (0.1 * leaf).astype(np.float32)
    return params


def unboxed(tree):
    return jax.tree.map(np.asarray, flax.core.meta.unbox(tree))


def port_model(cfg, params, **kw):
    model = tzoo.custom_model(device="cpu", **dict(cfg, **kw))
    model.load_state_dict(params_from_flax(params))
    return model


def batch(seed, bsz=4, cfg=CFG):
    return T.tokens_batch(seed, bsz, cfg)


def jax_trainer(params, model_params, **kwargs):
    """The JAX Trainer (optax.adamw, test_torch_training's lr and decay)
    over `params`, with fresh optimizer slots."""
    spec = jax_spec_of(zoo)
    spec.optimizer = lambda: optax.adamw(T.LR, weight_decay=T.WD)
    mesh = mesh_lib.build_mesh({"dp": 1}, devices=jax.devices()[:1])
    trainer = JTrainer(spec, mesh=mesh, model_params=model_params, **kwargs)
    state = trainer.init_state(batch(0))
    jp = jax.tree.map(jnp.asarray, params)
    return trainer, state.replace(params=jp,
                                  opt_state=trainer._train_tx.init(jp))


def port_trainer(params, model_params, **kwargs):
    return T.port_trainer(params, model_params=model_params, **kwargs)


def assert_trees_equal(got, ref):
    got, ref = flatten_params(got), flatten_params(ref)
    assert sorted(got) == sorted(ref)
    for key in ref:
        g, r = got[key], ref[key]
        if isinstance(g, torch.Tensor):
            g = g.view(torch.int16).numpy()
            r = np.asarray(r).view(np.int16)
        assert np.asarray(g).dtype == np.asarray(r).dtype, key
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r),
                                      err_msg=key)


# ---------------------------------------------------------------- LoRA


@pytest.mark.parametrize("mode", ["training", "prefill", "decode"])
def test_lora_forward_and_backward_match_flax(mode):
    """The adapters ride every forward: the training forward's logits and
    every parameter's gradient (adapters included), the prefill's logits
    and rows, and a 3-token dense decode chunk after a prefill."""
    params = numpy_params(LORA)
    fm = zoo.TransformerLM(**LORA)
    model = port_model(LORA, params)
    features, labels = batch(1)
    toks = features["tokens"]
    if mode == "training":
        def jloss(p):
            return zoo.loss(labels, fm.apply({"params": p}, features,
                                             training=True))
        jl, jgrads = jax.value_and_grad(jloss)(params)
        loss = tzoo.loss(labels, model(features, training=True))
        np.testing.assert_allclose(float(loss.detach()), float(jl),
                                   rtol=LOGIT_TOL)
        loss.backward()
        ours = flatten_params(params_to_flax(
            {k: p.grad for k, p in model.named_parameters()}))
        ref = flatten_params(unboxed(jgrads))
        assert sorted(ours) == sorted(ref)
        assert any("lora_a" in k for k in ref)
        for key in ref:
            np.testing.assert_allclose(ours[key], ref[key], atol=LOGIT_TOL,
                                       rtol=LOGIT_TOL, err_msg=key)
        return
    p = 9
    ref_logits, upd = fm.apply(
        {"params": params}, {"tokens": jnp.asarray(toks[:1, :p])},
        training=False, prefill=True, prompt_len=p, mutable=["cache"])
    logits, rows = model(torch.as_tensor(toks[:1, :p]).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    for i, (k, v) in enumerate(rows):
        attn = upd["cache"]["block_%d" % i]["attn"]
        for got, key in ((k, "k"), (v, "v")):
            np.testing.assert_allclose(
                got[0].numpy(), np.asarray(attn[key])[0, :, :p],
                atol=LOGIT_TOL, rtol=0)
    if mode == "prefill":
        return
    chunk = toks[:1, p:p + 3]
    ref_step, _ = fm.apply({"params": params, "cache": upd["cache"]},
                           {"tokens": jnp.asarray(chunk)}, training=False,
                           decode=True, mutable=["cache"])
    caches = model.dense_cache(1)
    for layer, new in zip(caches, rows):
        for leaf, r in zip(layer, new):
            leaf[:, :, :p] = r
    step = model.decode_dense(torch.as_tensor(chunk).long(),
                              torch.tensor([p]), caches, span=p + 3)
    np.testing.assert_allclose(step.numpy(), np.asarray(ref_step),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_lora_paged_decode_serves_flax_tokens():
    """An unmerged adapter model on the paged engine (its paged decode
    and verify tiles take the adapters too) serves the greedy tokens
    of flax's own decode loop."""
    from elasticdl_tpu.api import generation as jgen

    params = numpy_params(LORA, seed=3)
    trainer, state = jax_trainer(params, LORA_PARAMS)
    prompt = np.asarray([[5, 9, 14, 3, 22, 7]], np.int32)
    ref = np.asarray(jgen.autoregressive_generate(
        trainer, state, prompt, 10, use_cache=True))[0, 6:]
    engine = PagedContinuousBatchingEngine(
        port_model(LORA, params), 2, block_size=4,
        draft=port_model(LORA, params), draft_k=2)
    req = ServingRequest(list(prompt[0]), 10)
    engine.insert(req)
    while engine.active_count():
        engine.step()
    assert list(req.generated) == list(ref)


def test_lora_warm_start_from_dense_checkpoint(tmp_path):
    """A dense checkpoint restores into a LoRA model only with
    strict=False; since B is zero the logits then equal the dense
    model's, and a JAX LoRA Trainer warm-started from the same
    checkpoint holds the same parameters."""
    from elasticdl_tpu.checkpoint.saver import (
        restore_state_from_checkpoint as jrestore,
    )

    dense = numpy_params(CFG)
    jt, js = jax_trainer(dense, PARAMS)
    JSaver(str(tmp_path), checkpoint_steps=1, num_shards=2).save(js, 3)
    lt, ls = port_trainer(numpy_params(LORA, seed=5), LORA_PARAMS,
                          trainable_pattern="lora")
    with torch.no_grad():
        for name, p in ls.params.items():
            if name.endswith("_lora_b"):
                p.zero_()
    with pytest.raises(ValueError, match="strict=False"):
        restore_state_from_checkpoint(lt, ls, str(tmp_path))
    ls, version = restore_state_from_checkpoint(lt, ls, str(tmp_path),
                                                strict=False)
    assert version == 3
    features, _ = batch(7)
    ref = port_model(CFG, dense)(features, training=False)
    got = lt.forward(ls, features)
    assert torch.equal(got, ref)
    jlt, jls = jax_trainer(numpy_params(LORA, seed=5), LORA_PARAMS,
                           trainable_pattern="lora")
    jls, _ = jrestore(jls, str(tmp_path), strict=False)
    ours = flatten_params(params_to_flax(ls.params))
    for key, val in flatten_params(unboxed(jls.params)).items():
        if "lora" not in key:
            np.testing.assert_array_equal(ours[key], val, err_msg=key)


def test_lora_adapter_training_matches_jax_trainer():
    """trainable_pattern="lora": losses and every parameter against the
    JAX Trainer over three AdamW steps; the base parameters do not move
    at all (no gradient, no decay), the adapters do; the checkpoint
    names of the adapters and their slots are the JAX Trainer's."""
    from elasticdl_tpu_torch.checkpoint.saver import flatten_state

    params = numpy_params(LORA)
    jt, js = jax_trainer(params, LORA_PARAMS, trainable_pattern="lora")
    pt, ps = port_trainer(params, LORA_PARAMS, trainable_pattern="lora")
    before = flatten_params(params_to_flax(ps.params))
    js, ps = T.run_both(jt, js, pt, ps, [(batch(s), None) for s in (1, 2,
                                                                    3)])
    T.assert_params_close(ps, js)
    after = flatten_params(params_to_flax(ps.params))
    for key in before:
        if "lora" in key:
            assert not np.array_equal(before[key], after[key]), key
        else:
            np.testing.assert_array_equal(before[key], after[key],
                                          err_msg=key)
    ours, ref = flatten_state(pt, ps), jflatten_state(js)
    assert list(ours) == list(ref)
    assert any("inner_states['train']" in k and "qkv_lora_b" in k
               for k in ours)


# ---------------------------------------------------------------- remat


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_trains_as_plain_and_as_jax(remat):
    """Two AdamW steps under remat: losses, parameters and gradients equal
    remat "" in the port bit for bit, and the JAX Trainer with the same
    remat at test_torch_training's tolerances (the LoRA model, so the
    adapters' products are recomputed or saved too). The parameter tree
    does not change (remat is invisible to checkpoints)."""
    params = numpy_params(LORA)
    extra = "; remat=%r" % remat
    jt, js = jax_trainer(params, LORA_PARAMS + extra)
    pt, ps = port_trainer(params, LORA_PARAMS + extra)
    qt, qs = port_trainer(params, LORA_PARAMS)
    assert sorted(ps.params) == sorted(qs.params)
    for seed in (1, 2):
        js, jl = jt.train_step(js, batch(seed))
        ps, pl = pt.train_step(ps, batch(seed))
        qs, ql = qt.train_step(qs, batch(seed))
        assert pl == ql
        np.testing.assert_allclose(pl, float(jl), rtol=LOGIT_TOL)
        for key, p in ps.params.items():
            assert torch.equal(p.grad, qs.params[key].grad), key
            assert torch.equal(p, qs.params[key]), key
    T.assert_params_close(ps, js)


def test_remat_dots_saves_the_products():
    """remat "full" recomputes every product of a block in the backward;
    "dots" keeps their outputs and recomputes none (the
    dots_with_no_batch_dims_saveable policy), while the flash forward
    (a custom autograd Function, no aten op) runs again under both."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from elasticdl_tpu_torch.ops import attention as att

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default):
                self.mm += 1
            return func(*args, **(kwargs or {}))

    params = numpy_params(LORA)
    features, labels = batch(1)
    counts = {}
    calls = {}
    real = att.flash_attention_plain

    def counted(*a, **kw):
        calls["n"] = calls.get("n", 0) + 1
        return real(*a, **kw)

    for remat in ("", "full", "dots"):
        model = port_model(LORA, params, remat=remat)
        loss = tzoo.loss(labels, model(features, training=True))
        calls["n"] = 0
        att.flash_attention_plain = counted
        try:
            with Count() as mode:
                loss.backward()
        finally:
            att.flash_attention_plain = real
        counts[remat] = (mode.mm, calls["n"])
    # backward products only without remat; full runs the forward's
    # products again (as far as the backward needs them); dots none
    assert counts["full"][0] >= counts[""][0] + 6 * CFG["num_layers"]
    assert counts["dots"][0] == counts[""][0]
    assert counts[""][1] == 0
    assert counts["full"][1] == counts["dots"][1] == CFG["num_layers"]


def test_remat_modes_validated_and_skipped_in_serving():
    with pytest.raises(ValueError, match="remat"):
        tzoo.custom_model(device="cpu", remat="most", **CFG)
    params = numpy_params(CFG)
    model = port_model(CFG, params, remat="full")
    toks = torch.as_tensor(batch(2)[0]["tokens"]).long()
    with torch.no_grad():
        ref = port_model(CFG, params)(toks)[0]
        assert torch.equal(model(toks)[0], ref)


# ------------------------------------------------------------ merge_lora


def test_merge_lora_matches_jax_and_adapter_model():
    params = numpy_params(LORA)
    ref = jfinetune.merge_lora(params, lora_alpha=16.0)
    merged = finetune.merge_lora(params, model=port_model(LORA, params))
    got, want = flatten_params(merged), flatten_params(unboxed(ref))
    assert sorted(got) == sorted(want)
    assert not any("lora" in k for k in got)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-6, rtol=0,
                                   err_msg=key)
    features, _ = batch(4)
    lora_logits = port_model(LORA, params)(features, training=False)
    dense_logits = port_model(CFG, merged)(features, training=False)
    np.testing.assert_allclose(dense_logits.detach().numpy(),
                               lora_logits.detach().numpy(), rtol=2e-5,
                               atol=2e-6)
    # the live model's merge: a lora_rank=0 state dict of the same values
    sd = finetune.merge_lora(port_model(LORA, params))
    dense = tzoo.custom_model(device="cpu", **CFG)
    dense.load_state_dict(sd)
    assert_trees_equal(params_to_flax(sd), merged)


def test_merge_lora_refuses_what_jax_refuses():
    params = numpy_params(LORA)
    model = port_model(LORA, params)
    with pytest.raises(ValueError, match="incomplete"):
        finetune.merge_lora({"attn": {"qkv_lora_a": np.zeros((4, 2))}},
                            lora_alpha=16.0)
    with pytest.raises(ValueError, match="base kernel"):
        finetune.merge_lora({"qkv_lora_a": np.zeros((4, 2)),
                             "qkv_lora_b": np.zeros((2, 8))},
                            lora_alpha=16.0)
    with pytest.raises(ValueError, match="lora_alpha"):
        finetune.merge_lora(params)
    with pytest.raises(ValueError, match="contradicts"):
        finetune.merge_lora(params, model=model, lora_alpha=32.0)
    with pytest.raises(ValueError, match="contradicts"):
        finetune.merge_lora(model, lora_alpha=8.0)


# -------------------------------------------------------------- int8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_bit_for_bit(dtype):
    """int8 values, scales, itemsize, is_quantized, dequantize and
    quantized_bytes equal JAX's, fp32 and bf16 sources (a zero channel
    included)."""
    rs = np.random.RandomState(0)
    w = rs.randn(128, 64).astype(np.float32)
    w[:, 3] = 0.0
    tree = {"dense": {"kernel": w},
            "norm": {"scale": rs.randn(64).astype(np.float32)},
            "tiny": {"kernel": rs.randn(4, 4).astype(np.float32)}}
    jtree = jax.tree.map(jnp.asarray, tree)
    if dtype == "bfloat16":
        jtree["dense"]["kernel"] = jnp.asarray(w, jnp.bfloat16)
        tree["dense"]["kernel"] = torch.from_numpy(w).to(torch.bfloat16)
    ref = jq.quantize_params(jtree, min_size=1024)
    got = q.quantize_params(tree, min_size=1024)
    assert q.is_quantized(got) and not q.is_quantized(tree)
    for key in ("__w8__", "__w8_scale__", "__w8_src_itemsize__"):
        np.testing.assert_array_equal(np.asarray(got["dense"]["kernel"][
            key]), np.asarray(ref["dense"]["kernel"][key]))
    assert got["dense"]["kernel"]["__w8__"].dtype == np.int8
    np.testing.assert_array_equal(
        q.dequantize_params(got)["dense"]["kernel"],
        np.asarray(jq.dequantize_params(ref)["dense"]["kernel"]))
    assert q.quantized_bytes(got) == jq.quantized_bytes(ref)


def test_quantized_checkpoint_round_trip(tmp_path):
    """A quantized params tree rides the checkpoint format both ways with
    int8 kept int8: the port's leaves are the JAX Trainer's names and
    bytes of the same quantized state; a JAX checkpoint reads back as
    the same tree; serving/main.py --checkpoint_dir serves it with the
    float export's tokens."""
    params = numpy_params(CFG)
    jt, js = jax_trainer(params, PARAMS)
    qjs = js.replace(params=jq.quantize_params(js.params, min_size=1024))
    JSaver(str(tmp_path / "jax"), checkpoint_steps=1).save(qjs, 1)
    qtree = q.quantize_params(params, min_size=1024)
    leaves = dict(params_tree_leaves(qtree), **{".step": np.int32(1)})
    CheckpointSaver(None, str(tmp_path / "port")).save_flat(leaves, 1)
    ref, _ = jload(str(tmp_path / "port"))
    want = {k: v for k, v in jflatten_state(qjs).items()
            if k.startswith(".params")}
    assert sorted(ref) == sorted(want) + [".step"]
    del ref[".step"]
    for name, val in ref.items():
        assert np.asarray(val).dtype == np.asarray(want[name]).dtype, name
        np.testing.assert_array_equal(np.asarray(val),
                                      np.asarray(want[name]), err_msg=name)
    assert all(ref[k].dtype == np.int8 for k in ref if "__w8__'" in k)
    flat, _ = load_checkpoint(str(tmp_path / "jax"))
    assert_trees_equal(params_tree_from_flat(flat), qtree)
    args = port_main.parse_serving_args([
        "--device", "cpu", "--model_params", PARAMS, "--checkpoint_dir",
        str(tmp_path / "jax"), "--reload_poll_secs", "0",
        "--num_slots", "2"])
    served, version = port_main.build_model(args)
    assert version == 1
    want_model = port_model(CFG, q.dequantize_params(qtree))
    for key, p in served.named_parameters():
        assert torch.equal(p, dict(want_model.named_parameters())[key]), key


@pytest.mark.parametrize("paged", [False, True])
def test_engines_serve_int8_weights_dequantized_once(paged, monkeypatch):
    """An engine over an int8 checkpoint's weights: set_params with the
    quantized leaves holds the dequantized weights and serves the tokens
    of an engine given those float weights; with
    EDL_SERVING_FUSED_DEQUANT=1 the model holds the int8 leaves instead
    and serves the same tokens."""
    params = numpy_params(CFG)
    qtree = q.quantize_params(params, min_size=1024)
    flat = params_tree_leaves(qtree)
    cls = PagedContinuousBatchingEngine if paged else (
        ContinuousBatchingEngine)
    kw = {"block_size": 4} if paged else {}
    engine = cls(q.load_params(tzoo.custom_model(device="cpu", **CFG),
                               qtree), 2, **kw)
    engine.set_params(flat, 7)
    ref = cls(port_model(CFG, q.dequantize_params(qtree)), 2, **kw)
    monkeypatch.setenv("EDL_SERVING_FUSED_DEQUANT", "1")
    held = tzoo.custom_model(device="cpu", **CFG)
    q.hold_int8(held, qtree)
    fused = cls(held, 2, **kw)
    fused.set_params(flat, 8)
    streams = []
    for eng in (engine, ref, fused):
        req = ServingRequest([3, 1, 4, 1, 5], 8)
        eng.insert(req)
        while eng.active_count():
            eng.step()
        streams.append(list(req.generated))
    assert streams[0] == streams[1] == streams[2]
    assert engine.model_version == 7 and fused.model_version == 8


def test_watcher_checks_int8_checkpoint_before_the_swap(tmp_path):
    """The hot-reload watcher checks a quantized checkpoint's int8 leaves
    against the model's shapes and hands them on as they are; the
    engine dequantizes them once, at set_params. A quantized checkpoint
    of another width fails the check and nothing is swapped."""
    params = numpy_params(CFG)
    qtree = q.quantize_params(params, min_size=1024)
    CheckpointSaver(None, str(tmp_path / "ok")).save_flat(
        params_tree_leaves(qtree), 3)
    engine = ContinuousBatchingEngine(q.load_params(
        tzoo.custom_model(device="cpu", **CFG), qtree), 2)
    watcher = CheckpointWatcher(str(tmp_path / "ok"), engine.model,
                                poll_secs=0.0, sleep=lambda s: None)
    flat, version = watcher.poll(force=True)
    assert version == 3 and any("__w8__" in k for k in flat)
    engine.set_params(flat, version)
    want = port_model(CFG, q.dequantize_params(qtree))
    for key, p in engine.model.named_parameters():
        assert torch.equal(p, dict(want.named_parameters())[key]), key
    wide = q.quantize_params(numpy_params(dict(CFG, embed_dim=128)),
                             min_size=1024)
    CheckpointSaver(None, str(tmp_path / "bad")).save_flat(
        params_tree_leaves(wide), 4)
    watcher = CheckpointWatcher(str(tmp_path / "bad"), engine.model,
                                poll_secs=0.0, sleep=lambda s: None,
                                retries=1)
    assert watcher.poll(force=True) is None
    assert watcher.reload_failed and "has shape" in watcher.last_error


@pytest.mark.parametrize("change", ["extra_leaf", "missing_leaf"])
def test_load_params_rejects_a_tree_of_another_model(change):
    """load_params restores every parameter or none of the tree's
    surplus: a leaf the model lacks and a parameter the tree lacks both
    raise."""
    params = numpy_params(CFG)
    if change == "extra_leaf":
        params = dict(params, extra={"kernel": np.ones((2, 2), np.float32)})
    else:
        params = {k: v for k, v in params.items() if k != "ln_f"}
    with pytest.raises((KeyError, ValueError)):
        q.load_params(tzoo.custom_model(device="cpu", **CFG), params)


def test_dlrm_export_against_jax(tmp_path):
    """The exporter names every zoo model's parameters as checkpoints do:
    a port export of a DLRM state is byte for byte JAX's export of the
    same params, and make_serving_fn serves it with JAX's logits
    (1e-5)."""
    cfg = D.MASKED
    params = D.numpy_params(cfg)
    features, _labels = D.dlrm_batch(3, table_size=cfg["table_size"])
    jt, js = D.jax_trainer(cfg, params, features, lambda: optax.sgd(0.05))
    pt, ps = D.port_trainer(cfg, params, lambda: D.optimizers.sgd(0.05))
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jexporter.export_model(jt.model, js, jdir)
    exporter.export_model(pt.model, ps, pdir)
    for name in (exporter.PARAMS_FILE, exporter.META_FILE):
        with open(os.path.join(jdir, name), "rb") as a, open(
                os.path.join(pdir, name), "rb") as b:
            assert a.read() == b.read(), name
    payload, _meta = exporter.load_exported(jdir)
    got = exporter.make_serving_fn(
        D.tdlrm.custom_model(device="cpu", **cfg), payload)(features)
    ref = jexporter.make_serving_fn(jt.model, jexporter.load_exported(
        jdir)[0])(features)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(ref["logits"]), atol=D.TOL,
                               rtol=D.TOL)


# ---------------------------------------------------------------- codec


def codec_tree(seed):
    rs = np.random.RandomState(seed)
    return {"params": {
        "z": {"kernel": rs.randn(9, 7).astype(np.float32),
              "bias": np.zeros(7, np.float32)},
        "a": {"__w8__": rs.randint(-127, 128, (40, 5)).astype(np.int8),
              "__w8_scale__": rs.rand(5).astype(np.float32),
              "__w8_src_itemsize__": np.asarray(4)},
        "ints": np.arange(300, dtype=np.int64), "empty": np.zeros((0, 3)),
        "scalar": np.float32(2.5), "zero_d": np.asarray(7.0)},
        "model_state": {}, "step": 70000, "neg": -40000, "lr": 1.5,
        "none": None, "flag": True}


@pytest.mark.parametrize("chunk", [None, 64])
def test_codec_bytes_equal_flax_and_read_both_ways(chunk, monkeypatch):
    """to_bytes equals flax.serialization.to_bytes of the same tree (with
    MAX_CHUNK_SIZE patched small: chunked arrays too, bf16 included);
    each side reads the other's bytes leaf for leaf."""
    if chunk:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", chunk)
    tree = codec_tree(0)
    w = np.random.RandomState(1).randn(6, 5).astype(np.float32)
    jtree = dict(tree, bf16=jnp.asarray(w, jnp.bfloat16))
    tree = dict(tree, bf16=torch.from_numpy(w).to(torch.bfloat16))
    data = serialization.to_bytes(jtree)
    assert flax_msgpack.to_bytes(tree) == data
    back = flax_msgpack.msgpack_restore(data)
    assert back["bf16"].dtype == torch.bfloat16
    assert torch.equal(back["bf16"], tree["bf16"])
    assert back["step"] == 70000 and back["none"] is None
    theirs = serialization.msgpack_restore(flax_msgpack.to_bytes(tree))
    for ours in (back, theirs):
        for key, val in flatten_params(tree["params"]).items():
            got = flatten_params(ours["params"])[key]
            np.testing.assert_array_equal(np.asarray(got), val)
            assert np.asarray(got).dtype == np.asarray(val).dtype


# --------------------------------------------------------------- export


def test_export_load_serve_against_jax(tmp_path):
    """A port export of a Trainer state is byte for byte JAX's export of
    the same state (params.msgpack and meta.json); each loads the
    other's; make_serving_fn's logits equal the trainer's forward."""
    params = numpy_params(LORA)
    jt, js = jax_trainer(params, LORA_PARAMS)
    pt, ps = port_trainer(params, LORA_PARAMS)
    features, labels = batch(1)
    js, _ = jt.train_step(js, (features, labels))
    ps, _ = pt.train_step(ps, (features, labels))
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jexporter.export_model(jt.model, js.replace(params=jax.tree.map(
        np.asarray, params)), jdir)
    exporter.export_model(pt.model, types.SimpleNamespace(
        params=params, step=1), pdir)
    for name in (exporter.PARAMS_FILE, exporter.META_FILE):
        with open(os.path.join(jdir, name), "rb") as a, open(
                os.path.join(pdir, name), "rb") as b:
            assert a.read() == b.read(), name
    payload, meta = exporter.load_exported(pdir)
    assert meta == {"version": 1, "num_params": sum(
        v.size for v in flatten_params(params).values()),
        "model_class": "TransformerLM"}
    jpayload, _ = jexporter.load_exported(pdir)
    assert_trees_equal(payload["params"], jpayload["params"])
    edir = exporter.export_model(pt.model, ps, str(tmp_path / "trained"))
    payload, meta = exporter.load_exported(edir)
    assert meta["version"] == 1
    serve = exporter.make_serving_fn(
        tzoo.custom_model(device="cpu", **LORA), payload)
    torch.testing.assert_close(serve(features), pt.forward(ps, features),
                               rtol=0, atol=0)
    jserve = jexporter.make_serving_fn(jt.model, jexporter.load_exported(
        edir)[0])
    np.testing.assert_allclose(np.asarray(jserve(features)),
                               serve(features).numpy(), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def test_saved_model_exporter_and_merged_export(tmp_path):
    """SavedModelExporter at train end writes the worker's state; with
    merge_lora=True the artifact is the merged dense tree, which JAX's
    load_exported reads and a lora_rank=0 model serves."""
    params = numpy_params(LORA)
    pt, ps = port_trainer(params, LORA_PARAMS, trainable_pattern="lora")
    ps, _ = pt.train_step(ps, batch(2))

    worker = types.SimpleNamespace(trainer=pt, state=ps)
    SavedModelExporter(str(tmp_path / "plain")).on_train_end(worker)
    payload, meta = exporter.load_exported(str(tmp_path / "plain"))
    assert_trees_equal(payload["params"], params_to_flax(ps.params))
    assert meta["version"] == 1
    SavedModelExporter(str(tmp_path / "merged"),
                       merge_lora=True).on_train_end(worker)
    merged = finetune.merge_lora(params_to_flax(ps.params), model=pt.model)
    payload, _ = jexporter.load_exported(str(tmp_path / "merged"))
    assert_trees_equal(jax.tree.map(np.asarray, payload["params"]), merged)
    serve = exporter.make_serving_fn(
        tzoo.custom_model(device="cpu", **CFG),
        exporter.load_exported(str(tmp_path / "merged"))[0])
    features, _ = batch(3)
    np.testing.assert_allclose(serve(features).numpy(),
                               pt.forward(ps, features).numpy(), rtol=2e-5,
                               atol=2e-6)

    SavedModelExporter(str(tmp_path / "none")).on_train_end(
        types.SimpleNamespace(state=None))
    assert not os.path.exists(str(tmp_path / "none"))


def test_model_handler_prefers_checkpoint(tmp_path):
    params = numpy_params(CFG)
    pt, ps = port_trainer(params, PARAMS)
    trained, _ = pt.train_step(ps, batch(1))
    snapshot = params_to_flax(trained.params)
    CheckpointSaver(pt, str(tmp_path / "ckpt"), checkpoint_steps=1).save(
        trained, 1)
    pt.train_step(trained, batch(2))  # the live state moves on
    handler = ModelHandler.get_model_handler(
        "Local", checkpoint_dir=str(tmp_path / "ckpt"))
    assert isinstance(handler, LocalModelHandler)
    assert handler.get_model_to_train(pt.model) is pt.model
    handler.get_model_to_export(pt.model, trained, str(tmp_path / "e"))
    payload, meta = exporter.load_exported(str(tmp_path / "e"))
    assert meta["version"] == 1
    assert_trees_equal(payload["params"], snapshot)
    # no checkpoint: the live state
    ModelHandler.get_model_handler(None).get_model_to_export(
        pt.model, trained, str(tmp_path / "live"))
    payload, meta = exporter.load_exported(str(tmp_path / "live"))
    assert meta["version"] == 2
    assert_trees_equal(payload["params"], params_to_flax(trained.params))
    assert sorted(MESH_STRATEGIES) == sorted(
        (jconstants.DistributionStrategy.MESH,
         jconstants.DistributionStrategy.PARAMETER_SERVER,
         jconstants.DistributionStrategy.ALLREDUCE))
    for strategy in MESH_STRATEGIES:
        with pytest.raises(NotImplementedError, match="SPMD"):
            ModelHandler.get_model_handler(strategy)
    assert issubclass(MeshModelHandler, ModelHandler)
    with pytest.raises(TypeError, match="host-spill"):
        exporter.export_model(pt.model, trained, str(tmp_path / "h"),
                              host_manager=object())
    with open(os.path.join(str(tmp_path / "live"), "meta.json")) as f:
        assert json.load(f)["model_class"] == "TransformerLM"


def test_jax_export_of_a_trained_state_serves_in_the_port(tmp_path):
    """A JAX export of a JAX Trainer's state (boxed params, after a step)
    loads in the port: make_serving_fn's logits equal the JAX serving
    function's, and its int8 form serves through load_params."""
    params = numpy_params(CFG)
    jt, js = jax_trainer(params, PARAMS)
    js, _ = jt.train_step(js, batch(1))
    jexporter.export_model(jt.model, js, str(tmp_path))
    payload, meta = exporter.load_exported(str(tmp_path))
    assert meta["version"] == 1
    features, _ = batch(5)
    ref = jexporter.make_serving_fn(jt.model, jexporter.load_exported(
        str(tmp_path))[0])(features)
    got = exporter.make_serving_fn(
        tzoo.custom_model(device="cpu", **CFG), payload)(features)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    qpayload = {"params": q.quantize_params(payload["params"],
                                            min_size=1024)}
    qmodel = q.load_params(tzoo.custom_model(device="cpu", **CFG),
                           qpayload["params"])
    want = port_model(CFG, q.dequantize_params(qpayload["params"]))
    for key, p in qmodel.named_parameters():
        assert torch.equal(p, dict(want.named_parameters())[key]), key
