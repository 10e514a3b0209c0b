"""Offline generation in the port against the JAX package, same weights:
beam search (full forwards and KV-cached), speculative decoding with a
draft, draft warm start and distillation, and generation from int8
weights.

Weights are drawn by numpy from a seed in the flax layout and carried
into the port by convert.params_from_flax; fp32 on the CPU (the port
takes its kernels' plain versions there). Tolerances: tokens and the
speculative stats exact; the first distillation loss (before any
update) 1e-5 relative, the later ones 1e-4 and the distilled draft's
parameters by test_torch_training.assert_params_close: Adam divides
each gradient element by its own running scale, so fp32 reassociation
noise in a small gradient (XLA's sum order against PyTorch's) moves
the update at full step size, as test_torch_training explains.
"""

import types

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from elasticdl_tpu.api import distill as jdistill
from elasticdl_tpu.api import generation as jgen
from elasticdl_tpu.api import quantization as jq
from elasticdl_tpu.common.model_utils import (
    load_model_spec_from_module as jax_spec_of,
)
from elasticdl_tpu.parallel import mesh as mesh_lib
from elasticdl_tpu.training.trainer import Trainer as JTrainer
from elasticdl_tpu_torch.api import quantization as q
from elasticdl_tpu_torch.api.distill import distill_draft, warm_start_draft
from elasticdl_tpu_torch.api.generation import (
    autoregressive_generate,
    beam_search_generate,
    speculative_generate,
)
from elasticdl_tpu_torch.convert import (
    flatten_params,
    params_from_flax,
    params_to_flax,
)
from elasticdl_tpu_torch.model_zoo import transformer_lm as tzoo
from model_zoo.transformer_lm import transformer_lm as zoo
from tests import test_torch_training as T

torch.set_num_threads(2)

CFG = dict(vocab_size=64, seq_len=32, embed_dim=64, num_heads=2,
           num_layers=2)
DRAFT = dict(CFG, num_layers=1)
PROMPT = np.asarray([[1, 2, 3, 4, 5], [9, 8, 7, 6, 5]], np.int32)
DISTILL_TOL = (1e-5, 1e-4)  # the first loss, the later ones


def params_str(cfg):
    return "; ".join("%s=%r" % kv for kv in cfg.items())


def jax_rig(cfg, seed):
    """(JAX trainer, state over numpy params, the params)."""
    params = T.numpy_params(cfg, seed)
    spec = jax_spec_of(zoo)
    spec.optimizer = lambda: optax.adam(1e-3)
    mesh = mesh_lib.build_mesh({"dp": 1}, devices=jax.devices()[:1])
    trainer = JTrainer(spec, mesh=mesh, model_params=params_str(cfg))
    toks = np.zeros((1, cfg["seq_len"]), np.int32)
    state = trainer.init_state(({"tokens": toks}, toks))
    return trainer, state.replace(params=jax.tree.map(jnp.asarray,
                                                      params)), params


def port_model(cfg, params):
    model = tzoo.custom_model(device="cpu", **cfg)
    model.load_state_dict(params_from_flax(params))
    return model


@pytest.fixture(scope="module")
def target():
    return jax_rig(CFG, 0)


@pytest.fixture(scope="module")
def draft():
    return jax_rig(DRAFT, 321)


# ------------------------------------------------------------ beam search


@pytest.mark.parametrize("use_cache", [False, True])
@pytest.mark.parametrize("beams", [1, 3])
def test_beam_search_matches_jax(target, use_cache, beams):
    """Both strategies return JAX's tokens (JAX's full-forward ones,
    which its cached strategy equals); one beam is greedy."""
    trainer, state, params = target
    ref = np.asarray(jgen.beam_search_generate(
        trainer, state, PROMPT, 6, num_beams=beams))
    got = beam_search_generate(port_model(CFG, params), PROMPT, 6,
                               num_beams=beams, use_cache=use_cache)
    np.testing.assert_array_equal(got.numpy(), ref)
    if beams == 1:
        greedy = autoregressive_generate(port_model(CFG, params), PROMPT, 6)
        assert torch.equal(got, greedy)


@pytest.mark.parametrize("extra", [{"pos_emb": "rope"},
                                   {"num_kv_heads": 1}])
def test_beam_search_cached_matches_full(extra):
    """The cached strategy's beam gathers keep each beam's own rows: its
    tokens equal the full-forward strategy's and JAX's cached ones."""
    cfg = dict(CFG, **extra)
    trainer, state, params = jax_rig(cfg, 4)
    ref = np.asarray(jgen.beam_search_generate(
        trainer, state, PROMPT, 7, num_beams=4, use_cache=True))
    full = beam_search_generate(port_model(cfg, params), PROMPT, 7,
                                num_beams=4)
    cached = beam_search_generate(port_model(cfg, params), PROMPT, 7,
                                  num_beams=4, use_cache=True)
    assert torch.equal(full, cached)
    np.testing.assert_array_equal(cached.numpy(), ref)


def test_beam_search_validation(target):
    model = port_model(CFG, target[2])
    with pytest.raises(ValueError, match="num_beams"):
        beam_search_generate(model, PROMPT, 4, num_beams=65)
    with pytest.raises(ValueError, match="seq_len"):
        beam_search_generate(model, PROMPT, 28)


# ------------------------------------------------------- speculative


@pytest.mark.parametrize("gamma", [1, 3, 5])
def test_speculative_matches_greedy_and_jax(target, draft, gamma):
    """A mismatched draft: the tokens equal the target's greedy tokens
    and JAX's, and the stats equal JAX's (the draft never accepts all
    its proposals, where the two drafts' caches would part)."""
    trainer, state, params = target
    d_trainer, d_state, d_params = draft
    ref, ref_stats = jgen.speculative_generate(
        trainer, state, d_trainer, d_state, PROMPT, 10, gamma=gamma,
        return_stats=True)
    got, stats = speculative_generate(
        port_model(CFG, params), port_model(DRAFT, d_params), PROMPT, 10,
        gamma=gamma, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    greedy = autoregressive_generate(port_model(CFG, params), PROMPT, 10,
                                     use_cache=True)
    assert torch.equal(got, greedy)
    assert stats == ref_stats
    assert stats["acceptance_rate"] < 1.0 or gamma == 1


def test_speculative_self_draft_rewrites_the_stale_row():
    """The target as its own draft proposes exactly the target's tokens.
    The port's first draft step of a round rewrites the row of the last
    round's last proposal, so every proposal is accepted; the JAX
    package's draft reads that row stale after each full acceptance (past
    the 64-row prefill bucket it is a zero row) and accepts less. The
    tokens are exact on both sides."""
    cfg = dict(CFG, seq_len=128)
    trainer, state, params = jax_rig(cfg, 0)
    prompt = PROMPT[:1]
    ref, ref_stats = jgen.speculative_generate(
        trainer, state, trainer, state, prompt, 96, gamma=4,
        return_stats=True)
    got, stats = speculative_generate(
        port_model(cfg, params), port_model(cfg, params), prompt, 96,
        gamma=4, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert stats == {"verify_calls": 24, "committed_tokens": 95,
                     "acceptance_rate": 1.0}
    assert ref_stats["acceptance_rate"] < 0.6
    assert ref_stats["verify_calls"] > 30


def test_speculative_validation(target):
    model = port_model(CFG, target[2])
    with pytest.raises(ValueError, match="gamma"):
        speculative_generate(model, model, PROMPT, 4, gamma=0)
    with pytest.raises(ValueError, match="verify chunk"):
        speculative_generate(model, model, PROMPT, 25, gamma=4)
    other = tzoo.custom_model(device="cpu", **dict(CFG, vocab_size=32))
    with pytest.raises(ValueError, match="vocabulary"):
        speculative_generate(model, other, PROMPT, 4)


# ------------------------------------------------------------ distill


def assert_losses_close(losses, ref):
    assert len(losses) == len(ref)
    np.testing.assert_allclose(losses[0], ref[0], rtol=DISTILL_TOL[0])
    np.testing.assert_allclose(losses[1:], ref[1:], rtol=DISTILL_TOL[1])


def test_warm_start_and_distill_match_jax(target, draft):
    """warm_start_draft copies the subtrees JAX's copies (wte, wpe, ln_f,
    head, block_0 of the 2-layer target into the 1-layer draft);
    distill_draft's KL losses and the distilled draft equal JAX's, and
    the KL falls."""
    trainer, state, params = target
    d_trainer, d_state, d_params = draft
    rs = np.random.RandomState(3)
    batches = [rs.randint(0, 64, size=(4, 32)).astype(np.int32)
               for _ in range(6)]
    j_warm = jdistill.warm_start_draft(state, d_state)
    j_new, j_losses = jdistill.distill_draft(
        trainer, state, d_trainer, j_warm, batches, lr=3e-3)
    model = port_model(DRAFT, d_params)
    copied = warm_start_draft(port_model(CFG, params), model)
    assert copied == ["block_0", "head", "ln_f", "wpe", "wte"]
    for key, val in flatten_params(jax.tree.map(np.asarray,
                                                j_warm.params)).items():
        np.testing.assert_array_equal(
            flatten_params(params_to_flax(model.state_dict()))[key], val,
            err_msg=key)
    losses = distill_draft(port_model(CFG, params), model, batches,
                           lr=3e-3)
    assert_losses_close(losses, j_losses)
    assert losses[-1] < losses[0]
    T.assert_params_close(types.SimpleNamespace(
        params=dict(model.named_parameters())), j_new)


def test_distill_from_quantized_target(target, draft):
    """A quantized target tree warm-starts the draft from its
    dequantized values (tests/test_quantization.py:157), and the draft
    distills from the target holding those values, as JAX's does."""
    trainer, state, params = target
    d_trainer, d_state, d_params = draft
    qtree = q.quantize_params(params, min_size=64)
    jqstate = state.replace(params=jq.quantize_params(state.params,
                                                      min_size=64))
    model = port_model(DRAFT, d_params)
    assert warm_start_draft(qtree, model)[-1] == "wte"
    deq = q.dequantize_params(qtree)
    assert torch.equal(model.wte.weight, torch.from_numpy(
        deq["wte"]["embedding"]))
    rs = np.random.RandomState(0)
    batches = [rs.randint(0, 64, size=(4, 32)).astype(np.int32)
               for _ in range(3)]
    j_warm = jdistill.warm_start_draft(jqstate, d_state)
    _, j_losses = jdistill.distill_draft(trainer, jqstate, d_trainer,
                                         j_warm, batches)
    losses = distill_draft(port_model(CFG, deq), model, batches)
    assert_losses_close(losses, j_losses)


# ------------------------------------------------------------ int8 weights


@pytest.mark.parametrize("strategy", ["greedy", "greedy_cached", "beam",
                                      "beam_cached", "speculative"])
def test_generation_from_int8_weights(target, draft, strategy):
    """An int8 tree loaded by load_params: the model holds its
    dequantized values, and every strategy returns JAX's tokens for the
    same quantized state."""
    trainer, state, params = target
    d_trainer, d_state, d_params = draft
    qtree = q.quantize_params(params, min_size=1024)
    qstate = state.replace(params=jq.quantize_params(state.params,
                                                     min_size=1024))
    model = q.load_params(tzoo.custom_model(device="cpu", **CFG), qtree)
    if strategy.startswith("greedy"):
        cached = strategy.endswith("cached")
        ref = jgen.autoregressive_generate(trainer, qstate, PROMPT, 8,
                                           use_cache=cached)
        got = autoregressive_generate(model, PROMPT, 8, use_cache=cached)
    elif strategy.startswith("beam"):
        cached = strategy.endswith("cached")
        ref = jgen.beam_search_generate(trainer, qstate, PROMPT, 8,
                                        num_beams=2, use_cache=cached)
        got = beam_search_generate(model, PROMPT, 8, num_beams=2,
                                   use_cache=cached)
    else:
        ref = jgen.speculative_generate(trainer, qstate, d_trainer,
                                        d_state, PROMPT, 8, gamma=3)
        got = speculative_generate(model, port_model(DRAFT, d_params),
                                   PROMPT, 8, gamma=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    want = port_model(CFG, q.dequantize_params(qtree))
    for key, p in model.named_parameters():
        assert torch.equal(p, dict(want.named_parameters())[key]), key
