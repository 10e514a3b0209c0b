"""The port's transformer_lm against the flax model, same weights.

Weights are drawn by numpy from a seed in the flax layout, run through
flax directly and through the port after `params_from_flax`. Both run in
fp32 on the CPU (the port takes its kernels' plain versions there); the
logits agree to 1e-4 (different matmul/reduction order, fp32).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from elasticdl_tpu.api import generation as jgen
from elasticdl_tpu_torch.convert import (
    flatten_params,
    params_from_flax,
    params_to_flax,
)
from elasticdl_tpu_torch.model_zoo.transformer_lm import TransformerLM
from model_zoo.transformer_lm import transformer_lm as zoo

torch.set_num_threads(2)

TOL = 1e-4
CONFIGS = {
    "mha": dict(vocab_size=64, seq_len=32, embed_dim=32, num_heads=2,
                num_layers=2),
    "gqa": dict(vocab_size=64, seq_len=32, embed_dim=32, num_heads=4,
                num_layers=2, num_kv_heads=2),
    "rope": dict(vocab_size=48, seq_len=32, embed_dim=32, num_heads=2,
                 num_layers=1, pos_emb="rope"),
}


def numpy_params(cfg, seed=0):
    """flax-layout params with every leaf (biases and LayerNorm scales
    included) drawn by numpy, so each mapping is exercised."""
    model = zoo.TransformerLM(**cfg)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           {"tokens": jnp.zeros((1, cfg["seq_len"]),
                                                jnp.int32)})
    )["params"]
    rs = np.random.RandomState(seed)

    def draw(leaf):
        shape = leaf.value.shape if hasattr(leaf, "value") else leaf.shape
        scale = 1.0 / np.sqrt(shape[0]) if len(shape) == 2 else 0.1
        base = 1.0 if len(shape) == 1 else 0.0
        return (base + scale * rs.randn(*shape)).astype(np.float32)

    return model, jax.tree.map(
        draw, shapes,
        is_leaf=lambda x: hasattr(x, "value") or hasattr(x, "shape"),
    )


def port_model(cfg, params):
    model = TransformerLM(device="cpu", **cfg)
    model.load_state_dict(params_from_flax(params))
    return model


def test_params_round_trip():
    _model, params = numpy_params(CONFIGS["gqa"])
    sd = params_from_flax(params)
    assert sd["blocks.0.attn.qkv.weight"].shape == (4 * 8 + 2 * 2 * 8, 32)
    assert sd["head.weight"].shape == (64, 32)
    back = flatten_params(params_to_flax(sd))
    orig = flatten_params(params)
    assert sorted(back) == sorted(orig)
    for k in orig:
        np.testing.assert_array_equal(back[k], orig[k])
    # the flat "a/b/c" form (an .npz) converts the same
    flat_sd = params_from_flax(orig)
    for k, v in sd.items():
        assert torch.equal(flat_sd[k], v)
    with pytest.raises(KeyError):
        params_from_flax(dict(orig, **{"block_0/extra/kernel": orig[
            "head/kernel"]}))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_logits_and_rows_match_flax(name):
    cfg = CONFIGS[name]
    model, params = numpy_params(cfg, seed=1)
    rs = np.random.RandomState(2)
    p, p_pad = 11, 16
    tokens = rs.randint(0, cfg["vocab_size"], size=(2, p_pad)).astype(
        np.int32)
    kv_shapes = jgen._kv_shapes_for({}, model, 2)
    cache, _last = jgen._run_prefill(
        model, {"params": params}, kv_shapes,
        jnp.asarray(np.pad(tokens, ((0, 0), (0, cfg["seq_len"] - p_pad)))),
        p, p_pad,
    )
    ref = np.asarray(model.apply({"params": params}, {"tokens": tokens}))
    pm = port_model(cfg, params)
    logits, kv = pm(torch.as_tensor(tokens, dtype=torch.long))
    np.testing.assert_allclose(logits.numpy(), ref, atol=TOL, rtol=TOL)
    for i, (k, v) in enumerate(kv):
        ck = np.asarray(cache["block_%d" % i]["attn"]["k"])[:, :, :p_pad]
        cv = np.asarray(cache["block_%d" % i]["attn"]["v"])[:, :, :p_pad]
        np.testing.assert_allclose(k.numpy(), ck, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(v.numpy(), cv, atol=TOL, rtol=TOL)


def _paged_case(cfg, rs, positions, t, num_blocks=24, block_size=4):
    hkv = cfg.get("num_kv_heads") or cfg["num_heads"]
    d = cfg["embed_dim"] // cfg["num_heads"]
    arenas = [
        (rs.randn(num_blocks, block_size, hkv, d).astype(np.float32),
         rs.randn(num_blocks, block_size, hkv, d).astype(np.float32))
        for _ in range(cfg["num_layers"])
    ]
    m = cfg["seq_len"] // block_size
    tables = np.full((len(positions), m), -1, np.int32)
    perm = rs.permutation(num_blocks)
    used = 0
    for i, pos in enumerate(positions):
        n = -(-(pos + t) // block_size)
        tables[i, :n] = perm[used:used + n]
        used += n
    tokens = rs.randint(0, cfg["vocab_size"],
                        size=(len(positions), t)).astype(np.int32)
    return arenas, tables, tokens


@pytest.mark.parametrize("name,t", [("mha", 1), ("gqa", 1), ("mha", 3),
                                    ("rope", 2)])
def test_paged_decode_logits_match_flax(name, t):
    """A batch of slots at different positions decodes through the
    port's batched paged forward; flax runs each slot alone with its
    scalar counter (as the JAX engine's vmap does)."""
    cfg = CONFIGS[name]
    model, params = numpy_params(cfg, seed=3)
    rs = np.random.RandomState(4)
    positions = [0, 5, 12, 21]
    arenas, tables, tokens = _paged_case(cfg, rs, positions, t)
    pools = {"block_%d" % i: {"attn": {"k": jnp.asarray(k),
                                       "v": jnp.asarray(v)}}
             for i, (k, v) in enumerate(arenas)}
    pm = port_model(cfg, params)
    logits, rows = pm.decode_paged(
        torch.as_tensor(tokens, dtype=torch.long),
        torch.as_tensor(positions),
        [(torch.as_tensor(k), torch.as_tensor(v)) for k, v in arenas],
        torch.as_tensor(tables),
    )
    for i, pos in enumerate(positions):
        ref, aux = model.apply(
            {"params": params, "cache": {"pos": jnp.int32(pos)}},
            {"tokens": jnp.asarray(tokens[i:i + 1])},
            training=False, decode=True, mutable=["cache", "kv_out"],
            paged={"pools": pools, "table": jnp.asarray(tables[i:i + 1])},
        )
        np.testing.assert_allclose(logits[i:i + 1].numpy(), np.asarray(ref),
                                   atol=TOL, rtol=TOL)
        for j, (k, v) in enumerate(rows):
            sown = aux["kv_out"]["block_%d" % j]["attn"]
            np.testing.assert_allclose(k[i:i + 1].numpy(),
                                       np.asarray(sown["k"][0]),
                                       atol=TOL, rtol=TOL)
            np.testing.assert_allclose(v[i:i + 1].numpy(),
                                       np.asarray(sown["v"][0]),
                                       atol=TOL, rtol=TOL)


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TransformerLM(vocab_size=8, seq_len=8, embed_dim=8, num_heads=1,
                      num_layers=1)
    TransformerLM(vocab_size=8, seq_len=8, embed_dim=8, num_heads=1,
                  num_layers=1, device="cpu")
