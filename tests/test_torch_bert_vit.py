"""The port's bidirectional encoders (bert, vit) against the JAX
package's, on the CPU, and the transformer_lm argument surface they
share.

Models are found by the JAX `--model_def` strings in both zoos. flax
weights are drawn by numpy over the names and shapes of
`jax.eval_shape` (test_torch_vision_zoo's `numpy_variables`) and
carried into the port by `convert.zoo_params_from_flax`; a Block under
`layer_%d` keeps flax's names (`LayerNorm_0/scale`, `attn/qkv/kernel`,
the LoRA leaves). Dropout is the identity on both sides (a flax
interceptor; the port's rate 0). The JAX attention runs its plain
reference on the CPU (blockwise, as `flash_attention` falls back off
the TPU), the port's the kernels' plain versions. Tolerances, fp32:

* logits: rtol 2e-4, atol 2e-5 (tests/test_packing.py's packed-row
  contract), packed rows against unpacked ones in the port too;
* Trainer steps (adamw): losses to 1e-5 relative; parameters under the
  AdamW-near-eps contract of tests/test_torch_training.py (every element
  to 5e-4, 999 in 1,000 to 2e-6);
* dataset_fn, record files, checkpoint and export leaves: exact.
"""

import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from elasticdl_tpu.api import exporter as jexporter
from elasticdl_tpu.api import generation as jgeneration
from elasticdl_tpu.checkpoint.saver import CheckpointSaver as JSaver
from elasticdl_tpu.checkpoint.saver import flatten_state as jflatten_state
from elasticdl_tpu.common.model_utils import get_dict_from_params_str
from elasticdl_tpu.common.model_utils import get_model_spec as jget_spec
from elasticdl_tpu.data import recordio_gen as jrecordio_gen
from elasticdl_tpu.data.dataset import Dataset as JDataset
from elasticdl_tpu.parallel import mesh as mesh_lib
from elasticdl_tpu.training.trainer import Trainer as JTrainer
from elasticdl_tpu_torch.api import exporter
from elasticdl_tpu_torch.api import generation
from elasticdl_tpu_torch.api.local_executor import LocalExecutor
from elasticdl_tpu_torch.checkpoint import (
    CheckpointSaver,
    flatten_state,
    restore_state_from_checkpoint,
)
from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.common.model_utils import (
    get_model_spec,
    load_model_spec_from_module,
)
from elasticdl_tpu_torch.convert import (
    flatten_params,
    zoo_flax_param_path,
    zoo_params_from_flax,
    zoo_params_to_flax,
)
from elasticdl_tpu_torch.data import recordio_gen
from elasticdl_tpu_torch.data.dataset import Dataset
from elasticdl_tpu_torch.data.record_format import Scanner
from elasticdl_tpu_torch.model_zoo import transformer_lm as tzoo
from elasticdl_tpu_torch.model_zoo.bert import bert as pbert
from elasticdl_tpu_torch.training.trainer import Trainer
from model_zoo.transformer_lm.transformer_lm import Block as JBlock
from test_torch_training import PARAM_TOL, PARAM_TOL_WORST
from test_torch_vision_zoo import (
    JAX_ZOO,
    PORT_ZOO,
    no_jax_dropout,
    no_port_dropout,
    numpy_variables,
    unflat,
)

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 2e-5
LOSS_RTOL = 1e-5
BERT_DEF = "bert.bert.custom_model"
VIT_DEF = "vit.vit.custom_model"
BERT = dict(vocab_size=32, seq_len=16, embed_dim=32, num_heads=2,
            num_layers=2)
VIT = dict(image_size=8, patch_size=4, embed_dim=16, num_heads=2,
           num_layers=2)
FAMILIES = {"bert": (BERT_DEF, BERT), "vit": (VIT_DEF, VIT)}
# the bert cases: a two-sided window, LoRA adapters, packed rows
BERT_CASES = {"full": {}, "window": {"attn_window": 3},
              "lora": {"lora_rank": 4}, "packed": {}}


def params_str(cfg):
    return "; ".join("%s=%r" % kv for kv in cfg.items())


def specs(family):
    model_def = FAMILIES[family][0]
    return jget_spec(JAX_ZOO, model_def), get_model_spec(PORT_ZOO, model_def)


def bert_batch(seed, n=3, cfg=BERT):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, cfg["vocab_size"] + 1,
                        size=(n, cfg["seq_len"])).astype(np.int32)
    labels = np.where(rs.rand(n, cfg["seq_len"]) < 0.3, tokens % cfg[
        "vocab_size"], pbert.IGNORE_LABEL).astype(np.int32)
    return {"tokens": tokens}, labels


def vit_batch(seed, n=3, cfg=VIT):
    rs = np.random.RandomState(seed)
    s = cfg["image_size"]
    return ({"image": rs.rand(n, s, s, 3).astype(np.float32)},
            rs.randint(10, size=n).astype(np.int32))


BATCHES = {"bert": bert_batch, "vit": vit_batch}


def models(family, cfg):
    """(flax model, its numpy variables, the port model carrying them);
    the flax model without the tp annotation, whose boxed leaves are
    the same parameters."""
    jspec, spec = specs(family)
    jmodel = jspec.model_fn(**dict(cfg, tp_shard=False))
    variables = numpy_variables(jmodel, BATCHES[family](0)[0])
    model = spec.create_model(params_str(cfg), device="cpu")
    model.load_state_dict(zoo_params_from_flax(unflat(variables["params"])),
                          strict=True)
    return jmodel, variables, model


def check_names(model, variables):
    """The port's flax paths are flax's, and flax -> port -> flax is bit
    for bit."""
    sd = model.state_dict()
    assert sorted(zoo_flax_param_path(k) for k in sd) == sorted(
        variables["params"])
    back = flatten_params(zoo_params_to_flax(sd))
    for key, arr in variables["params"].items():
        np.testing.assert_array_equal(back[key], arr)


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("gen", ["gen_tokens_like", "gen_docs_like"])
def test_generators_write_the_jax_records(gen, tmp_path):
    kwargs = dict(num_files=2, records_per_file=3, seed=3, vocab_size=50)
    paths = getattr(recordio_gen, gen)(str(tmp_path / "p"), **kwargs)
    jpaths = getattr(jrecordio_gen, gen)(str(tmp_path / "j"), **kwargs)
    assert [os.path.basename(p) for p in paths] == [
        os.path.basename(p) for p in jpaths]
    for p, j in zip(paths, jpaths):
        with open(p, "rb") as a, open(j, "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_dataset_fn_matches_jax_bit_for_bit(family, tmp_path):
    """bert's static masking (crc32-seeded numpy) gives JAX's masked
    tokens and labels exactly; vit's image records parse as JAX's."""
    jspec, spec = specs(family)
    if family == "bert":
        recordio_gen.gen_tokens_like(str(tmp_path), num_files=1,
                                     records_per_file=6, seed=4,
                                     seq_len=64, vocab_size=30522)
    else:
        recordio_gen.gen_imagenet_like(str(tmp_path), num_files=1,
                                       records_per_file=6, seed=4,
                                       image_size=8, num_classes=10)
    (fname,) = os.listdir(str(tmp_path))
    records = list(Scanner(os.path.join(str(tmp_path), fname)))
    labels = []
    for mode in (Mode.TRAINING, Mode.EVALUATION, Mode.PREDICTION):
        got = list(spec.dataset_fn(Dataset.from_list(records), mode, None))
        want = list(jspec.dataset_fn(JDataset.from_list(records), mode,
                                     None))
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            if mode != Mode.PREDICTION:
                assert g[1].dtype == w[1].dtype
                np.testing.assert_array_equal(g[1], w[1])
                labels.append(w[1])
                g, w = g[0], w[0]
            assert sorted(g) == sorted(w)
            for key in w:
                assert g[key].dtype == w[key].dtype
                np.testing.assert_array_equal(g[key], w[key])
    if family == "bert":
        assert 0.1 < (np.stack(labels) != pbert.IGNORE_LABEL).mean() < 0.2


# --------------------------------------------------------------- models


@pytest.mark.parametrize("case", sorted(BERT_CASES))
def test_bert_logits_match_flax(case):
    cfg = dict(BERT, **BERT_CASES[case])
    jmodel, variables, model = models("bert", cfg)
    check_names(model, variables)
    features, _ = bert_batch(1, cfg=cfg)
    if case == "packed":
        # three documents a row, attention confined to each
        features["segment_ids"] = np.repeat(
            np.array([[0] * 5 + [1] * 7 + [2] * 4]), 3, axis=0).astype(
                np.int32)
    ref = jmodel.apply({"params": unflat(variables["params"])}, features)
    with torch.no_grad():
        out = model({k: torch.as_tensor(v) for k, v in features.items()},
                    training=True)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    if case == "packed":
        # each packed document equals the document alone (positions
        # restart, no attention across a boundary)
        for lo, hi in ((0, 5), (5, 12), (12, 16)):
            with torch.no_grad():
                alone = model({"tokens": torch.as_tensor(
                    features["tokens"][:, lo:hi])})
            np.testing.assert_allclose(out[:, lo:hi].numpy(),
                                       alone.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("training", [False, True])
def test_vit_logits_match_flax(training):
    jmodel, variables, model = models("vit", VIT)
    check_names(model, variables)
    features, _ = vit_batch(1)
    with no_jax_dropout():
        ref = jmodel.apply({"params": unflat(variables["params"])}, features,
                           training=training,
                           rngs={"dropout": jax.random.PRNGKey(1)})
    with torch.no_grad(), no_port_dropout(model):
        out = model({"image": torch.as_tensor(features["image"])},
                    training=training)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def trainers(family):
    """The JAX Trainer and the port's, from the JAX Trainer's own initial
    state, on the spec's own optimizer (adamw)."""
    jspec, spec = specs(family)
    ps = params_str(FAMILIES[family][1])
    mesh = mesh_lib.build_mesh({"dp": 1}, devices=jax.devices()[:1])
    jtrainer = JTrainer(jspec, mesh=mesh, model_params=ps)
    with no_jax_dropout():
        jstate = jtrainer.init_state(BATCHES[family](0))
    trainer = Trainer(spec, model_params=ps, device="cpu")
    state = trainer.init_state(None, params=zoo_params_from_flax(
        jax.tree.map(np.asarray, jstate.params)))
    return jtrainer, jstate, trainer, state


def assert_params_close(trainer, jstate):
    ours = flatten_params(zoo_params_to_flax(trainer.model.state_dict()))
    ref = flatten_params(jax.tree.map(np.asarray, jstate.params))
    assert sorted(ours) == sorted(ref)
    diffs = []
    for key in ref:
        np.testing.assert_allclose(ours[key], ref[key], atol=PARAM_TOL_WORST,
                                   rtol=0, err_msg=key)
        diffs.append(np.abs(ours[key] - ref[key]).ravel())
    diffs = np.concatenate(diffs)
    assert (diffs > PARAM_TOL).mean() <= 1e-3, np.sort(diffs)[-10:]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_trainer_steps_match_jax(family):
    jtrainer, jstate, trainer, state = trainers(family)
    with no_port_dropout(trainer.model):
        for step, n in ((0, None), (1, 2), (2, None)):
            batch = BATCHES[family](10 + step)
            with no_jax_dropout():
                jstate, jloss = jtrainer.train_step(jstate, batch, n)
            state, loss = trainer.train_step(state, batch, n)
            np.testing.assert_allclose(loss, float(jloss), rtol=LOSS_RTOL,
                                       atol=0)
    assert state.step == int(jstate.step) == 3
    assert_params_close(trainer, jstate)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_checkpoint_and_export_round_trip(family, tmp_path):
    """Two steps in each package; each checkpoint's leaves carry the
    JAX names in the JAX order, the JAX checkpoint restores into the
    port bit for bit, the port's into a fresh port Trainer bit for bit,
    and the port's export loads in the JAX loader with the JAX tree."""
    jtrainer, jstate, trainer, state = trainers(family)
    with no_port_dropout(trainer.model):
        for step in range(2):
            batch = BATCHES[family](20 + step)
            with no_jax_dropout():
                jstate, _ = jtrainer.train_step(jstate, batch)
            state, _ = trainer.train_step(state, batch)
    CheckpointSaver(trainer, str(tmp_path / "port")).save(state, 2)
    JSaver(str(tmp_path / "jax")).save(jstate, 2)
    port_flat, jax_flat = flatten_state(trainer, state), jflatten_state(
        jstate)
    assert list(port_flat) == list(jax_flat)
    fresh = Trainer(specs(family)[1], device="cpu", seed=1,
                    model_params=params_str(FAMILIES[family][1]))
    fresh_state = fresh.init_state(None)
    fresh_state, version = restore_state_from_checkpoint(
        fresh, fresh_state, str(tmp_path / "port"))
    assert version == 2
    for key, value in flatten_state(fresh, fresh_state).items():
        np.testing.assert_array_equal(np.asarray(value),
                                      np.asarray(port_flat[key]))
    state, version = restore_state_from_checkpoint(trainer, state,
                                                   str(tmp_path / "jax"))
    assert version == 2
    for key, value in flatten_state(trainer, state).items():
        np.testing.assert_array_equal(np.asarray(value), jax_flat[key])
    exporter.export_model(trainer.model, state, str(tmp_path / "ex"))
    payload, meta = jexporter.load_exported(str(tmp_path / "ex"))
    assert meta["version"] == 2
    want = flatten_params(jax.tree.map(np.asarray, jstate.params))
    got = flatten_params(payload["params"])
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


# ------------------------------------------------------------ the entry


STRINGS = {
    # tests/test_bert.py's strings, and the flags every sequence family
    # takes
    "transformer_lm": (None, "vocab_size=64;seq_len=32;embed_dim=32;"
                       "num_heads=2;num_layers=1;attn_impl=xla"),
    "bert": (BERT_DEF, "vocab_size=64;seq_len=33;embed_dim=32;num_heads=2;"
             "num_layers=1;attn_impl=xla"),
    "vit": (VIT_DEF, "image_size=8; patch_size=4; embed_dim=16; "
            "num_heads=2; num_layers=1; attn_impl='jax_flash'; tp_shard=0"),
    "transformer_lm_tp": (None, "vocab_size=64; seq_len=32; embed_dim=32; "
                          "num_heads=2; num_layers=1; tp_shard=0; "
                          "attn_impl='auto'"),
}


@pytest.mark.parametrize("name", sorted(STRINGS))
def test_jax_model_strings_build_the_port(name):
    model_def, params = STRINGS[name]
    spec = (load_model_spec_from_module(tzoo) if model_def is None
            else get_model_spec(PORT_ZOO, model_def))
    model = spec.create_model(params, device="cpu")
    kwargs = get_dict_from_params_str(params)
    assert model.attn_impl == kwargs["attn_impl"]
    assert model.tp_shard == bool(kwargs.get("tp_shard", True))
    if name.startswith("transformer_lm"):
        features = {"tokens": np.zeros((2, 32), np.int32)}
    elif name == "bert":
        features = {"tokens": np.zeros((2, 33), np.int32)}
    else:
        features = vit_batch(0)[0]
    with torch.no_grad():
        assert torch.isfinite(model(features)).all()


def test_local_executor_trains_bert_on_token_records(tmp_path):
    """tests/test_bert.py's executor run on the port: 4 steps of 8 over
    gen_tokens_like records, then the masked-token accuracy."""
    train, valid = str(tmp_path / "train"), str(tmp_path / "valid")
    recordio_gen.gen_tokens_like(train, num_files=1, records_per_file=32)
    recordio_gen.gen_tokens_like(valid, num_files=1, records_per_file=16,
                                 seed=7)
    executor = LocalExecutor(
        get_model_spec(PORT_ZOO, BERT_DEF), training_data=train,
        validation_data=valid, minibatch_size=8, records_per_task=32,
        model_params=STRINGS["bert"][1], device="cpu")
    state, metrics = executor.run()
    assert state.step == 4 and np.isfinite(executor.losses).all()
    assert 0.0 <= metrics["masked_token_accuracy"] <= 1.0


# ------------------------------------------------------------ refusals


def _message(fn):
    with pytest.raises((ValueError, NotImplementedError)) as info:
        fn()
    return str(info.value)


def test_decoding_refuses_the_bidirectional_encoder():
    """api/generation refuses bert as the JAX package does, and a Block
    built with causal=False refuses prefill and decode with flax's
    messages."""
    bert = pbert.custom_model(device="cpu", **BERT)
    jbert = specs("bert")[0].model_fn(**BERT)
    prompt = np.zeros((1, 4), np.int64)
    jtrainer = types.SimpleNamespace(model=jbert)
    for port_call, jax_call in (
            (lambda: generation.autoregressive_generate(bert, prompt, 3),
             lambda: jgeneration.autoregressive_generate(
                 jtrainer, None, prompt, 3)),
            (lambda: generation.beam_search_generate(bert, prompt, 3),
             lambda: jgeneration.beam_search_generate(
                 jtrainer, None, prompt, 3)),
            (lambda: generation.beam_search_generate(bert, prompt, 3,
                                                     use_cache=True),
             lambda: jgeneration.beam_search_generate(
                 jtrainer, None, prompt, 3, use_cache=True)),
            (lambda: generation.speculative_generate(bert, bert, prompt, 3),
             None)):
        msg = _message(port_call)
        assert "causal" in msg
        if jax_call is not None:
            assert msg == _message(jax_call)
    block = tzoo.Block(16, 2, 8, causal=False, device="cpu")
    x = torch.zeros((1, 4, 16))
    pos = torch.arange(4)
    jblock = JBlock(2, 8, causal=False, cache_len=8)
    jx = jnp.zeros((1, 4, 16))
    jvars = jblock.init(jax.random.PRNGKey(0), jx)
    for port_call, jax_call in (
            (lambda: block(x, pos, prefill=True),
             lambda: jblock.apply(jvars, jx, prefill=True,
                                  mutable=["cache"])),
            (lambda: block.decode_dense(x[:, :1], pos[None, :1],
                                        [torch.zeros((1, 2, 8, 8))] * 2),
             lambda: jblock.apply(jvars, jx[:, :1], decode=True,
                                  decode_pos=0, mutable=["cache"]))):
        assert _message(port_call) == _message(jax_call)
    with pytest.raises(ValueError, match="decode mode requires a causal"):
        block.decode_paged(x[:, :1], pos[None, :1], None, None)


def test_argument_and_geometry_refusals(monkeypatch):
    """flax's messages for a ViT whose patches or heads do not tile, an
    unknown attn_impl and jax_flash over packed rows; bert under a tp
    mesh and vit under any mesh raise NotImplementedError naming the
    ROADMAP item (bert under dp x sp: tests/test_torch_dp_sp.py)."""
    jvit = specs("vit")[0].model_fn
    image = {"image": np.zeros((1, 8, 8, 3), np.float32)}
    for kwargs in (dict(VIT, image_size=10), dict(VIT, embed_dim=15)):
        assert _message(lambda: specs("vit")[1].create_model(
            params_str(kwargs), device="cpu")) == _message(
                lambda: jvit(**kwargs).init(jax.random.PRNGKey(0), {
                    "image": np.zeros((1, kwargs["image_size"],
                                       kwargs["image_size"], 3),
                                      np.float32)}))
    tokens = {"tokens": np.zeros((1, 16), np.int32)}
    jbert = specs("bert")[0].model_fn
    assert _message(lambda: pbert.custom_model(
        device="cpu", attn_impl="pallas", **BERT)) == _message(
            lambda: jbert(attn_impl="pallas", **BERT).init(
                jax.random.PRNGKey(0), tokens))
    with pytest.raises(ValueError, match="Unknown attn_impl"):
        tzoo.custom_model(device="cpu", attn_impl="flash")
    packed = dict(tokens, segment_ids=np.zeros((1, 16), np.int32))
    jmodel = jbert(attn_impl="jax_flash", **BERT)
    jvars = jmodel.init(jax.random.PRNGKey(0), tokens)
    model = pbert.custom_model(device="cpu", attn_impl="jax_flash", **BERT)
    assert _message(lambda: model(packed)) == _message(
        lambda: jmodel.apply(jvars, packed))
    vit = specs("vit")[1].create_model(params_str(VIT), device="cpu")
    for shape, call in (({"tp": 2}, lambda: model(tokens)),
                        ({"tp": 2}, lambda: vit(image)),
                        ({"sp": 2}, lambda: vit(image)),
                        ({"dp": 2}, lambda: vit(image))):
        monkeypatch.setattr(tzoo, "current_mesh",
                            lambda: types.SimpleNamespace(size=1,
                                                          shape=shape))
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            call()
