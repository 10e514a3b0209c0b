"""The port's paged decode partials (o, l, m) against the JAX package's,
at the edges of the card's split walk.

On the card, `paged_decode_partials` cuts each sequence's live keys
across the blocks of a cluster; on the CPU it runs the plain version that
the card holds those kernels against. These cases hold that plain
version to the JAX package's partials on the shapes where a walk cut by
length goes wrong first: lengths of whole blocks and one past, a full
table, a sequence 8x longer than its batch mates, 8 and 9 query rows
(the split / tile boundary), a length 0 and a table whose last live slot
is -1; d 64 and 128, blocks of 16, fp32, bf16 and int8 arenas, with and
without a sliding window. The references are `_paged_decode_fused`,
interpreted as tests/test_torch_attention.py runs it, and the carry of
the JAX scan (paged_decode_attention's step with use_kernel=False, built
from the package's `_paged_valid` and `softmax_merge`). Rows that see no
pool row are compared by the port's contract, (0, 0, -1e30): the JAX
partials carry masked junk there, which the tile merge discards.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from elasticdl_tpu.ops import attention as jatt
from elasticdl_tpu_torch.model_zoo.transformer_lm import kv_quantize_rows
from elasticdl_tpu_torch.ops import attention as tatt

torch.set_num_threads(2)

TOL = 1e-5
BS, M, HKV, NUM_BLOCKS = 16, 8, 2, 40


@pytest.fixture(autouse=True)
def _opt_into_interpreted_kernels(monkeypatch):
    """Off-TPU the JAX package takes its jnp paths; these tests hold the
    port against the Pallas kernel itself, in interpret mode."""
    monkeypatch.setenv("ELASTICDL_TPU_FORCE_INTERPRET", "1")


def _inputs(seed, d, lengths, group, t, arena, hole):
    """qf [b, HKV, group * t, d] prescaled; pools as torch and as jnp (bf16
    rounded once from the same fp32 values, int8 quantized by the port's
    quantizer, flax's bit for bit); table with the slot `hole` of
    sequence 0 unallocated; lengths; int8 scale pools or None."""
    rs = np.random.RandomState(seed)
    b = len(lengths)
    qf = (rs.randn(b, HKV, group * t, d) * d ** -0.5).astype(np.float32)
    pools = [torch.from_numpy(rs.randn(NUM_BLOCKS, BS, HKV, d).astype(
        np.float32)) for _ in range(2)]
    table = np.full((b, M), -1, np.int32)
    perm = rs.permutation(NUM_BLOCKS)
    used = 0
    for i, n in enumerate(lengths):
        blocks = -(-n // BS)
        table[i, :blocks] = perm[used:used + blocks]
        used += blocks
    if hole is not None:
        table[0, hole] = -1
    scales = None
    if arena == "int8":
        pools, scales = zip(*(kv_quantize_rows(p) for p in pools))
    elif arena == "bf16":
        pools = [p.to(torch.bfloat16) for p in pools]
    jpools = [jnp.asarray(p.float().numpy()).astype(
        jnp.bfloat16 if arena == "bf16" else jnp.int8 if arena == "int8"
        else jnp.float32) for p in pools]
    return (qf, list(pools), jpools, table, np.asarray(lengths, np.int32),
            scales)


@functools.partial(jax.jit, static_argnames=("t", "window"))
def _scan_carry(qf, k_pool, v_pool, table, length, t, window, ks_pool,
                vs_pool):
    """The carry of the JAX scan over the table's slots: each step's
    scores masked by `_paged_valid` and merged by `softmax_merge`, as
    paged_decode_attention's step does (jitted: one compile a case). The
    row scales fold into the scores and the value weights as the int8
    step folds them; float arenas pass scales of 1, which change no
    bit."""
    b, hkv, rows, d = qf.shape
    group = rows // t
    f32 = jnp.float32
    o = jnp.zeros((b, hkv, rows, d), f32)
    l = jnp.zeros((b, hkv, rows), f32)
    mx = jnp.full((b, hkv, rows), tatt.NEG_INF, f32)
    row_pos = length[:, None] + jnp.arange(t)[None, :]
    for j in range(table.shape[1]):
        bid = table[:, j]
        safe = jnp.maximum(bid, 0)
        s = jnp.einsum("bhqd,bkhd->bhqk", qf, k_pool[safe].astype(f32))
        s = s * ks_pool[safe][..., 0].transpose(0, 2, 1)[:, :, None, :]
        w_scale = vs_pool[safe][..., 0].transpose(0, 2, 1)
        k_pos = j * BS + jnp.arange(BS)[None, None, :]
        valid = jnp.broadcast_to(jatt._paged_valid(
            k_pos, bid[:, None, None], length[:, None, None],
            row_pos[..., None], window), (b, t, BS))
        vt = jnp.broadcast_to(valid[:, None, None],
                              (b, hkv, group, t, BS)).reshape(b, hkv, rows,
                                                               BS)
        s = jnp.where(vt, s, tatt.NEG_INF)
        o, l, mx = jatt.softmax_merge(
            o, l, mx, s, v_pool[safe].astype(f32).transpose(0, 2, 1, 3),
            w_scale=w_scale)
    return o, l, mx


EDGES = [
    # (case, d, lengths, group, t, hole slot of sequence 0, arena, window)
    ("whole-blocks", 64, [32, 33, 48], 1, 1, None, "fp32", None),
    ("whole-blocks", 128, [32, 33, 48], 1, 1, None, "int8", 20),
    ("full-table", 128, [128, 16, 1], 1, 1, None, "bf16", None),
    ("full-table", 64, [128, 16, 1], 2, 1, None, "fp32", 40),
    ("8x-longer", 64, [112, 14, 13], 2, 1, None, "int8", None),
    ("8x-longer", 128, [112, 14, 13], 1, 1, None, "bf16", 50),
    ("8-rows", 128, [77, 128, 31], 8, 1, None, "fp32", None),
    ("8-rows", 64, [77, 128, 31], 4, 2, None, "bf16", 30),
    ("9-rows", 64, [77, 128, 31], 1, 9, None, "bf16", None),
    ("9-rows", 128, [77, 128, 31], 1, 9, None, "int8", 5),
    ("last-slot-hole", 128, [77, 96, 5], 2, 1, 4, "int8", None),
    ("last-slot-hole", 64, [77, 96, 5], 2, 1, 4, "fp32", 30),
    ("length-0", 128, [0, 40, 17], 4, 1, None, "bf16", None),
    ("length-0", 64, [0, 40, 17], 2, 1, None, "int8", 16),
]


@pytest.mark.parametrize(
    "case,d,lengths,group,t,hole,arena,window", EDGES,
    ids=["%s-d%d-%s-%s" % (e[0], e[1], e[6], "w%d" % e[7] if e[7] else
                           "full") for e in EDGES])
def test_paged_partials_match_jax_at_split_edges(case, d, lengths, group, t,
                                                 hole, arena, window):
    qf, pools, jpools, table, length, scales = _inputs(
        len(case) * 31 + d + group * 7 + t, d, lengths, group, t, arena,
        hole)
    tscales = list(scales) if scales is not None else [None, None]
    o, l, mx = tatt.paged_decode_partials(
        torch.from_numpy(qf), *pools, torch.from_numpy(table),
        torch.from_numpy(length), *tscales, window=window, t=t)
    jscales = (None if scales is None
               else tuple(jnp.asarray(x.numpy()) for x in scales))
    fused = jatt._paged_decode_fused(
        jnp.asarray(qf), *jpools, jnp.asarray(table), jnp.asarray(length), t,
        window=window, **({} if jscales is None else dict(
            k_scale_pool=jscales[0], v_scale_pool=jscales[1])))
    ones = jnp.ones(jpools[0].shape[:3] + (1,), jnp.float32)
    carry = _scan_carry(jnp.asarray(qf), *jpools, jnp.asarray(table),
                        jnp.asarray(length), t, window,
                        *(jscales or (ones, ones)))
    o, l, mx = o.numpy(), l.numpy(), mx.numpy()
    # a row sees a pool row iff the scan's running max left the sentinel
    live = np.asarray(carry[2]) > 0.5 * tatt.NEG_INF
    np.testing.assert_array_equal(l > 0, live)
    assert live.any()
    for ref in (fused, carry):
        ro, rl, rm = (np.asarray(x) for x in ref)
        scale = max(1.0, float(np.abs(ro[live]).max()))
        np.testing.assert_allclose(o[live], ro[live], rtol=TOL,
                                   atol=TOL * scale)
        np.testing.assert_allclose(l[live], rl[live], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(mx[live], rm[live], rtol=TOL, atol=TOL)
        assert np.all(rm[~live] < 0.5 * tatt.NEG_INF)
    assert np.all(o[~live] == 0) and np.all(l[~live] == 0)
    assert np.all(mx[~live] == tatt.NEG_INF)
