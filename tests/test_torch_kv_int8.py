"""The port's int8 KV cache against the JAX package's, same inputs.

The quantizer must equal flax's `_kv_quantize_rows` bit for bit (both
round half to even and divide in IEEE fp32). int8 paged attention runs
its plain version here (the CUDA split and tile kernels are held against
it on the card by chip_smoke.py) and must agree with the JAX scan and
the interpreted Pallas kernel to 1e-5 in fp32 (reduction order). The
model's int8 prefill and paged decode must give flax's logits to 1e-4 in
fp32 (matmul order; same tolerance as the float model's tests) and sow
the same int8 rows and scales. The port's engine with int8 arenas must
give the JAX paged engine's greedy token streams.
"""

import flax
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from elasticdl_tpu.api import generation as jgen
from elasticdl_tpu.common.model_utils import load_model_spec_from_module
from elasticdl_tpu.ops import attention as jatt
from elasticdl_tpu.parallel import mesh as mesh_lib
from elasticdl_tpu.serving.admission import ServingRequest as JaxRequest
from elasticdl_tpu.serving.engine import (
    PagedContinuousBatchingEngine as JaxPagedEngine,
)
from elasticdl_tpu.training.trainer import Trainer
from elasticdl_tpu_torch.api.generation import kv_layout
from elasticdl_tpu_torch.convert import params_from_flax
from elasticdl_tpu_torch.model_zoo.transformer_lm import (
    TransformerLM,
    kv_quantize_rows,
)
from elasticdl_tpu_torch.ops import attention as tatt
from elasticdl_tpu_torch.serving import main as port_main
from elasticdl_tpu_torch.serving.admission import ServingRequest
from elasticdl_tpu_torch.serving.engine import PagedContinuousBatchingEngine
from elasticdl_tpu_torch.serving.kv_pool import PagedKVPool
from model_zoo.transformer_lm import transformer_lm as zoo

torch.set_num_threads(2)

ATT_TOL = 1e-5
LOGIT_TOL = 1e-4


@pytest.fixture(autouse=True)
def _opt_into_interpreted_kernels(monkeypatch):
    """Off-TPU the JAX package takes its jnp paths; the attention tests
    hold the port against the Pallas kernel itself, in interpret mode."""
    monkeypatch.setenv("ELASTICDL_TPU_FORCE_INTERPRET", "1")


# ------------------------------------------------------------- quantizer


def _jax_quantize(rows):
    q8, sc = zoo._kv_quantize_rows(jnp.asarray(rows))
    return np.asarray(q8), np.asarray(sc)


def test_kv_quantize_rows_equals_flax_bit_for_bit():
    rs = np.random.RandomState(0)
    rows = (rs.randn(2, 3, 9, 16) * rs.uniform(0.01, 50, (2, 3, 9, 1))
            ).astype(np.float32)
    rows[0, 1, 3] = 0.0  # a zero row keeps scale 1 and stays zero
    rows[1, 2, 4] = -0.0
    # exact ties: amax 127 gives scale 1, amax 254 scale 2, so these land
    # on .5 and must round half to even on both sides
    rows[0, 0, 0] = np.r_[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5,
                          4.5, -126.5, 126.5, 0.0, 1.0, -1.0, 5.5, -5.5]
    rows[0, 0, 1] = np.r_[254.0, 1.0, 3.0, 5.0, -1.0, -3.0, 7.0, 9.0,
                          253.0, -253.0, 0.0, 2.0, 11.0, -11.0, 13.0, 15.0]
    rows[1, 0, 2, 5] = 3e38  # huge amax
    q8, sc = kv_quantize_rows(torch.from_numpy(rows))
    ref_q8, ref_sc = _jax_quantize(rows)
    assert q8.dtype == torch.int8 and sc.dtype == torch.float32
    np.testing.assert_array_equal(q8.numpy(), ref_q8)
    np.testing.assert_array_equal(sc.numpy(), ref_sc)
    assert sc[0, 1, 3, 0] == 1.0 and not q8[0, 1, 3].any()
    np.testing.assert_array_equal(
        q8[0, 0, 0, :11].numpy(), [127, 0, 2, 2, 0, -2, -2, 4, 4, -126, 126])
    # bf16 rows (the card's compute dtype) quantize from their fp32 value
    bf = torch.from_numpy(rows[:, :, :4]).to(torch.bfloat16)
    q8b, scb = kv_quantize_rows(bf)
    ref_q8b, ref_scb = _jax_quantize(bf.float().numpy())
    np.testing.assert_array_equal(q8b.numpy(), ref_q8b)
    np.testing.assert_array_equal(scb.numpy(), ref_scb)


# ------------------------------------------------------- paged attention


def _int8_paged_inputs(seed, b, h, hkv, t, d, bs, nb, m, lengths,
                       holes=False):
    """Random float arenas and tile quantized with the port's quantizer
    (equal to flax's, above), as both sides then read them."""
    rs = np.random.RandomState(seed)
    q = rs.randn(b, h, t, d).astype(np.float32)

    def quant(*shape):
        q8, sc = kv_quantize_rows(torch.from_numpy(
            rs.randn(*shape).astype(np.float32)))
        return q8.numpy(), sc.numpy()

    k_cur, ks_cur = quant(b, hkv, t, d)
    v_cur, vs_cur = quant(b, hkv, t, d)
    k_pool, ks_pool = quant(nb, bs, hkv, d)
    v_pool, vs_pool = quant(nb, bs, hkv, d)
    table = np.full((b, m), -1, np.int32)
    perm = rs.permutation(nb)
    used = 0
    for i, n in enumerate(lengths):
        blocks = -(-n // bs)
        table[i, :blocks] = perm[used:used + blocks]
        used += blocks
    if holes:
        table[0, 0] = -1  # an unallocated slot inside the live range
    arrays = (q, k_cur, v_cur, k_pool, v_pool, table,
              np.asarray(lengths, np.int32))
    scales = dict(k_scale_pool=ks_pool, v_scale_pool=vs_pool,
                  k_cur_scale=ks_cur, v_cur_scale=vs_cur)
    return arrays, scales


@pytest.mark.parametrize("t,h,hkv,holes", [
    (1, 2, 2, False),
    (4, 2, 2, False),
    (1, 4, 2, True),   # GQA + a -1 slot
    (4, 4, 1, True),   # MQA tile + a -1 slot
])
def test_int8_paged_matches_jax_kernel_and_scan(t, h, hkv, holes):
    """Lengths 9, 0 (nothing cached) and 17 over 4-row blocks."""
    arrays, scales = _int8_paged_inputs(
        seed=t * 11 + h, b=3, h=h, hkv=hkv, t=t, d=16, bs=4, nb=24, m=6,
        lengths=[9, 0, 17], holes=holes)
    out = tatt.paged_decode_attention(
        *[torch.from_numpy(x) for x in arrays],
        **{k: torch.from_numpy(v) for k, v in scales.items()})
    assert out.dtype == torch.float32
    for use_kernel in (True, False):
        ref = np.asarray(jatt.paged_decode_attention(
            *[jnp.asarray(x) for x in arrays], use_kernel=use_kernel,
            **{k: jnp.asarray(v) for k, v in scales.items()}))
        np.testing.assert_allclose(out.numpy(), ref, atol=ATT_TOL,
                                   rtol=ATT_TOL)


def test_int8_paged_legacy_shape_and_partials():
    """[b, h, d] queries with [b, hkv, 1] tile scales drop t like the JAX
    op; the plain partials of an int8 pool equal those of its
    dequantized float copy (the scale folding is exact algebra)."""
    arrays, scales = _int8_paged_inputs(
        seed=3, b=2, h=2, hkv=2, t=1, d=8, bs=4, nb=8, m=4, lengths=[0, 6])
    q, k_cur, v_cur, k_pool, v_pool, table, length = arrays
    squeezed = dict(scales, k_cur_scale=scales["k_cur_scale"][:, :, 0],
                    v_cur_scale=scales["v_cur_scale"][:, :, 0])
    targs = [torch.from_numpy(x) for x in
             (q[:, :, 0], k_cur[:, :, 0], v_cur[:, :, 0], k_pool, v_pool,
              table, length)]
    out = tatt.paged_decode_attention(
        *targs, **{k: torch.from_numpy(v) for k, v in squeezed.items()})
    ref = np.asarray(jatt.paged_decode_attention(
        *[jnp.asarray(x.numpy()) for x in targs], use_kernel=False,
        **{k: jnp.asarray(v) for k, v in squeezed.items()}))
    assert out.shape == (2, 2, 8)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATT_TOL, rtol=ATT_TOL)
    qf = torch.from_numpy(q).reshape(2, 2, 1, 8)
    ks, vs = (torch.from_numpy(scales[k]) for k in ("k_scale_pool",
                                                     "v_scale_pool"))
    o, l, mx = tatt.paged_decode_partials(qf, *targs[3:], ks, vs)
    kf = torch.from_numpy(k_pool).float() * ks
    vf = torch.from_numpy(v_pool).float() * vs
    fo, fl, fm = tatt.paged_decode_partials(qf, kf, vf, *targs[5:])
    for a, b_ in ((o, fo), (l, fl), (mx, fm)):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=ATT_TOL,
                                   rtol=ATT_TOL)
    assert torch.all(o[0] == 0) and torch.all(l[0] == 0)
    with pytest.raises(ValueError, match="scale"):
        tatt.paged_decode_partials(qf, *targs[3:])  # int8 without scales
    with pytest.raises(ValueError, match="scale"):
        tatt.paged_decode_partials(qf, kf, vf, *targs[5:], ks, vs)


# ------------------------------------------------------------------ model


CONFIGS = {
    "mha": dict(vocab_size=64, seq_len=32, embed_dim=64, num_heads=4,
                num_layers=2),
    "gqa": dict(vocab_size=64, seq_len=32, embed_dim=64, num_heads=4,
                num_layers=2, num_kv_heads=2),
}


def numpy_params(cfg, seed):
    """flax-layout params, every leaf drawn by numpy."""
    model = zoo.TransformerLM(kv_cache_dtype="int8", **cfg)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), {"tokens": jnp.zeros(
            (1, cfg["seq_len"]), jnp.int32)}))["params"]
    rs = np.random.RandomState(seed)

    def draw(leaf):
        shape = leaf.value.shape if hasattr(leaf, "value") else leaf.shape
        scale = 1.0 / np.sqrt(shape[0]) if len(shape) == 2 else 0.1
        base = 1.0 if len(shape) == 1 else 0.0
        return (base + scale * rs.randn(*shape)).astype(np.float32)

    return model, jax.tree.map(
        draw, shapes,
        is_leaf=lambda x: hasattr(x, "value") or hasattr(x, "shape"))


def port_model(cfg, params, kv_cache_dtype="int8"):
    model = TransformerLM(device="cpu", kv_cache_dtype=kv_cache_dtype, **cfg)
    model.load_state_dict(params_from_flax(params))
    return model


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_int8_prefill_logits_and_rows_match_flax(name):
    cfg = CONFIGS[name]
    model, params = numpy_params(cfg, seed=1)
    rs = np.random.RandomState(2)
    p, p_pad = 11, 16
    tokens = rs.randint(0, cfg["vocab_size"], size=(2, p_pad)).astype(
        np.int32)
    kv_shapes = jgen._kv_shapes_for({}, model, 2)
    kv0 = jax.tree.map(lambda sh: jnp.zeros(sh.shape, sh.dtype), kv_shapes)
    ref, upd = model.apply({"params": params, "cache": kv0},
                           {"tokens": jnp.asarray(tokens)}, training=False,
                           prefill=True, prompt_len=p, mutable=["cache"])
    logits, rows = port_model(cfg, params)(torch.as_tensor(tokens).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    for i, layer in enumerate(rows):
        cache = upd["cache"]["block_%d" % i]["attn"]
        assert [leaf.dtype for leaf in layer] == [torch.int8] * 2 + [
            torch.float32] * 2
        for leaf, key in zip(layer, ("k", "v", "k_scale", "v_scale")):
            ref_leaf = np.asarray(cache[key])[:, :, :p_pad]
            if leaf.dtype == torch.int8:
                np.testing.assert_array_equal(leaf.numpy(), ref_leaf)
            else:
                np.testing.assert_allclose(leaf.numpy(), ref_leaf,
                                           rtol=LOGIT_TOL, atol=0)
    # the float model's prefill on the same weights gives other logits:
    # the int8 prefill attends over the quantize-dequantized rows
    float_logits, _ = port_model(cfg, params, "")(
        torch.as_tensor(tokens).long())
    assert not torch.allclose(float_logits, logits, atol=LOGIT_TOL)


def _int8_arenas(cfg, rs, num_blocks=24, block_size=4):
    hkv = cfg.get("num_kv_heads") or cfg["num_heads"]
    d = cfg["embed_dim"] // cfg["num_heads"]
    arenas = []
    for _ in range(cfg["num_layers"]):
        layer = []
        for _kv in range(2):
            q8, sc = kv_quantize_rows(torch.from_numpy(
                rs.randn(num_blocks, block_size, hkv, d).astype(np.float32)))
            layer += [q8, sc]
        arenas.append((layer[0], layer[2], layer[1], layer[3]))
    return arenas


@pytest.mark.parametrize("name,t", [("mha", 1), ("gqa", 1), ("gqa", 3)])
def test_int8_decode_paged_logits_and_sown_rows_match_flax(name, t):
    """A batch of slots at different positions over int8 arenas; flax
    runs each slot alone with its scalar counter."""
    cfg = CONFIGS[name]
    model, params = numpy_params(cfg, seed=3)
    rs = np.random.RandomState(4)
    positions = [0, 5, 12, 21]
    arenas = _int8_arenas(cfg, rs)
    m = cfg["seq_len"] // 4
    tables = np.full((len(positions), m), -1, np.int32)
    perm = rs.permutation(24)
    used = 0
    for i, pos in enumerate(positions):
        n = -(-(pos + t) // 4)
        tables[i, :n] = perm[used:used + n]
        used += n
    tokens = rs.randint(0, cfg["vocab_size"],
                        size=(len(positions), t)).astype(np.int32)
    pools = {"block_%d" % i: {"attn": {
        key: jnp.asarray(leaf.numpy())
        for key, leaf in zip(("k", "v", "k_scale", "v_scale"), layer)}}
        for i, layer in enumerate(arenas)}
    logits, rows = port_model(cfg, params).decode_paged(
        torch.as_tensor(tokens).long(), torch.as_tensor(positions), arenas,
        torch.as_tensor(tables))
    for i, pos in enumerate(positions):
        ref, aux = model.apply(
            {"params": params, "cache": {"pos": jnp.int32(pos)}},
            {"tokens": jnp.asarray(tokens[i:i + 1])},
            training=False, decode=True, mutable=["cache", "kv_out"],
            paged={"pools": pools, "table": jnp.asarray(tables[i:i + 1])},
        )
        np.testing.assert_allclose(logits[i:i + 1].numpy(), np.asarray(ref),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        for j, layer in enumerate(rows):
            sown = aux["kv_out"]["block_%d" % j]["attn"]
            for leaf, key in zip(layer, ("k", "v", "k_scale", "v_scale")):
                ref_leaf = np.asarray(sown[key][0])
                if leaf.dtype == torch.int8:
                    np.testing.assert_array_equal(leaf[i:i + 1].numpy(),
                                                  ref_leaf)
                else:
                    np.testing.assert_allclose(leaf[i:i + 1].numpy(),
                                               ref_leaf, rtol=LOGIT_TOL,
                                               atol=0)


def test_training_forward_never_quantizes():
    """kv_cache_dtype changes only prefill and decode: the training
    forward of an int8-cache model is the float model's, bit for bit,
    gradients included."""
    cfg = CONFIGS["gqa"]
    _model, params = numpy_params(cfg, seed=5)
    tokens = np.random.RandomState(6).randint(0, 64, size=(2, 16))
    outs = []
    for kv_dtype in ("", "int8"):
        pm = port_model(cfg, params, kv_dtype)
        logits = pm({"tokens": tokens}, training=True)
        logits.square().mean().backward()
        outs.append((logits.detach(), pm.blocks[0].attn.qkv.weight.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        TransformerLM(device="cpu", kv_cache_dtype="fp8", **cfg)


# ----------------------------------------------------------------- pool


def test_pool_carries_scale_leaves_and_counts_bytes_per_leaf():
    """Prompt insertion, row scatter and the CoW copy move int8 rows and
    their scales together; bytes count each leaf at its own dtype, so
    an int8 block at d = 128 costs (d + 4) / 2d = 0.516 of a bf16 one."""
    rs = np.random.RandomState(7)
    layout = (2, 2, 128, torch.bfloat16, "int8")
    pool = PagedKVPool(layout, 32, 2, 8, 4, share_prefix=True, device="cpu")
    bf16 = PagedKVPool(layout[:4] + ("",), 32, 2, 8, 4, device="cpu")
    assert [a.dtype for a in pool.pools[0]] == [torch.int8] * 2 + [
        torch.float32] * 2
    assert pool.pools[0][2].shape == (8, 4, 2, 1)
    # layers x (k, v) x rows x kv heads x (d int8 bytes + a 4-byte scale)
    assert pool.block_bytes == 2 * 2 * 4 * 2 * (128 + 4)
    assert pool.block_bytes / bf16.block_bytes == pytest.approx(0.515625)
    assert pool.stats()["kv_cache_dtype"] == "int8"
    assert bf16.stats()["kv_cache_dtype"] == ""

    prompt = list(range(6))
    pool.seat(0, prompt, 8)
    rows = []
    for _layer in range(2):
        leaves = []
        for _kv in range(2):
            leaves += list(kv_quantize_rows(torch.from_numpy(
                rs.randn(1, 2, 6, 128).astype(np.float32))))
        rows.append((leaves[0], leaves[2], leaves[1], leaves[3]))
    pool.write_prompt(rows, 0, 6)
    table = pool.allocator.table(0)
    for arenas, leaves in zip(pool.pools, rows):
        for arena, leaf in zip(arenas, leaves):
            got = arena[table].reshape(8, 2, -1)[:6].permute(1, 0, 2)
            assert torch.equal(got, leaf[0])
    assert pool.bytes_in_use() == 2 * pool.block_bytes

    # a decode row at position 6: every leaf lands in block 1, offset 2
    step = [tuple(leaf[0, :, 5] for leaf in layer) for layer in rows]
    pool.ensure_blocks(0, 6)
    pool.scatter(step, [table[1]], [2])
    for arenas, leaves in zip(pool.pools, step):
        for arena, leaf in zip(arenas, leaves):
            assert torch.equal(arena[table[1], 2], leaf)

    # a second seat on the same prompt shares its full block; its first
    # write into the shared block copies every leaf of it (CoW)
    pool.register_prefix(0, prompt)
    assert pool.seat(1, prompt[:4], 6) == 4
    old = pool.allocator.table(1)[0]
    moved = pool.cow_for_write(1, 3)
    assert moved is not None and moved[0] == old
    for arenas in pool.pools:
        for arena in arenas:
            assert torch.equal(arena[moved[1]], arena[old])
    assert pool.allocator.cow_copies == 1


# --------------------------------------------------------------- engine


ENGINE_CFG = dict(vocab_size=64, seq_len=32, embed_dim=64, num_heads=4,
                  num_layers=2)
ENGINE_PARAMS = ("vocab_size=64; seq_len=32; embed_dim=64; num_heads=4; "
                 "num_layers=2; kv_cache_dtype='int8'")
BLOCK, SLOTS, NUM_BLOCKS = 4, 3, 24
PREFIX = [5, 9, 14, 3, 22, 7, 41, 18]  # two full blocks
# the mix of tests/test_torch_serving.py: a shared prefix seated by
# incref and a suffix tile, a full-prompt match (the planned CoW), a
# one-token answer, private prompts
REQUESTS = [
    (PREFIX + [11, 2], 6),
    (list(range(30, 43)), 7),
    (PREFIX + [33, 1, 60], 5),
    (PREFIX, 4),
    ([7, 7, 8], 1),
    (PREFIX + [11, 2, 50, 51, 52], 9),
]


@pytest.fixture(scope="module")
def rig():
    mesh = mesh_lib.build_mesh({"dp": 1}, devices=jax.devices()[:1])
    trainer = Trainer(load_model_spec_from_module(zoo), mesh=mesh,
                      model_params=ENGINE_PARAMS, seed=0)
    toks = (np.arange(33)[None, :] % 64).astype(np.int32)
    state = trainer.init_state(({"tokens": toks[:, :-1]}, toks[:, 1:]))
    params = jax.tree.map(np.asarray, flax.core.meta.unbox(state.params))
    return trainer, state, params


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


def test_int8_greedy_streams_match_jax_engine(rig):
    trainer, state, params = rig
    jeng = JaxPagedEngine(trainer, state, SLOTS, block_size=BLOCK,
                          num_blocks=NUM_BLOCKS, share_prefix=True)
    peng = PagedContinuousBatchingEngine(
        port_model(ENGINE_CFG, params), SLOTS, block_size=BLOCK,
        num_blocks=NUM_BLOCKS, share_prefix=True)
    assert kv_layout(peng.model)[4] == "int8"
    ref = drive(jeng, [JaxRequest(p, n) for p, n in REQUESTS])
    got = drive(peng, [ServingRequest(p, n) for p, n in REQUESTS])
    assert got == ref
    assert [len(g) for g in got] == [n for _p, n in REQUESTS]
    jstats, pstats = jeng.kv_stats(), peng.kv_stats()
    for key in ("kv_cache_dtype", "kv_bytes_total", "kv_blocks_total",
                "prefix_hit_tokens", "cow_copies"):
        assert pstats[key] == jstats[key], key
    assert pstats["kv_cache_dtype"] == "int8" and pstats["cow_copies"] == 1
    assert peng.kv.block_bytes == jeng.kv.block_bytes
    assert peng.kv.allocator.blocks_in_use() == 0
    assert peng.kv.allocator.available() == NUM_BLOCKS


def test_main_serves_int8_on_cpu_and_reports_the_format(rig, tmp_path):
    _trainer, state, params = rig
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                flax.core.meta.unbox(state.params))[0]}
    npz = tmp_path / "params.npz"
    np.savez(npz, **flat)
    args = port_main.parse_serving_args([
        "--device", "cpu", "--model_params", ENGINE_PARAMS,
        "--num_slots", "2", "--kv_paged", "1", "--kv_block_size", "4",
        "--params_npz", str(npz),
    ])
    server = port_main.build_server(args).start()
    try:
        answers = port_main.serve_lines(server, [
            '{"prompt": %s, "max_new_tokens": 6}' % REQUESTS[0][0],
            '{"status": true}',
        ])
    finally:
        server.stop(timeout=30)
    offline = drive(
        PagedContinuousBatchingEngine(port_model(ENGINE_CFG, params), SLOTS,
                                      block_size=BLOCK,
                                      num_blocks=NUM_BLOCKS),
        [ServingRequest(*REQUESTS[0])])
    assert answers[0] == {"tokens": REQUESTS[0][0] + offline[0]}
    status = answers[1]["status"]
    assert status["kv_cache_dtype"] == "int8"
    assert status["completed"] == 1 and status["num_slots"] == 2
    assert status["kv_bytes_total"] == server.engine.kv.bytes_total


def test_int8_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = port_main.parse_serving_args(["--model_params", ENGINE_PARAMS])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main.build_server(args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TransformerLM(kv_cache_dtype="int8", **ENGINE_CFG)
