"""The masks of the port's attention kernels against the JAX package's.

The port's wrappers run their kernels' plain PyTorch versions on the
CPU; the JAX side runs its Pallas kernels in interpret mode (blocks of
16, so a window of 5 or 40 is no multiple of the tile) and its jnp
oracles. Inputs come from a numpy seed; everything is fp32.

* flash forward under window x segments x causal x GQA (1, 2, 4) x d
  (64, 128): out and lse to 1e-5 against the interpreted kernel, the
  blockwise scan and the naive oracle;
* flash backward under the same masks: dq, dk, dv to 1e-5 of each
  output's largest value (at least 1e-5 absolute: under a window of 1
  each row sees one key and dq is 0 in exact arithmetic, so both sides
  hold rounding noise of 1e-6) against jax.grad through the interpreted
  kernels;
* the (q_seg, k_seg) pair form: rows with no visible key are exactly 0
  with exactly zero gradient, as in JAX;
* paged decode with a window: t in {1, 3, 9}, float and int8 arenas, a
  -1 hole, a length-0 sequence, windows shorter than the tile, to 1e-5
  against the interpreted `_paged_kernel` and the lax.scan;
* `packed_positions` and `_tile_causal_mask` exactly.
"""

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
L = 32
BLOCK = 16
# (causal, h, hkv, d, window, packed): every window (1, 2, a window that
# is no multiple of the tile, one wider than the sequence) with and
# without segments, causal and not, across GQA groups 1 / 2 / 4 and d 64
# / 128
FWD_CASES = [
    (causal, h, hkv, d, window, packed)
    for i, (causal, window, packed) in enumerate(
        (c, w, p) for c in (True, False) for w in (None, 1, 2, 5, 40)
        for p in (False, True))
    for h, hkv, d in [((2, 2, 64), (4, 2, 128), (4, 1, 64),
                       (2, 2, 128))[i % 4]]
]
BWD_CASES = [
    (True, 2, 2, 64, 5, False),
    (True, 4, 2, 128, None, True),
    (True, 4, 1, 64, 5, True),
    (True, 2, 2, 64, 1, True),
    (False, 2, 2, 128, 5, False),
    (False, 4, 2, 64, 2, True),
    (False, 4, 1, 64, None, True),
    (True, 4, 2, 64, 40, True),
]


@pytest.fixture(autouse=True)
def _opt_into_interpreted_kernels(monkeypatch):
    """Off-TPU the JAX package takes its jnp paths; these tests hold the
    port against the Pallas kernels themselves, in interpret mode."""
    monkeypatch.setenv("ELASTICDL_TPU_FORCE_INTERPRET", "1")


def _inputs(seed, b, h, hkv, l, d):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, h, l, d).astype(np.float32),
            rs.randn(b, hkv, l, d).astype(np.float32),
            rs.randn(b, hkv, l, d).astype(np.float32),
            rs.randn(b, h, l, d).astype(np.float32))


def _segments(seed, b, l):
    """Packed-row ids: contiguous runs of ragged lengths (a run of 1
    included), ids counting up from 0 per row."""
    rs = np.random.RandomState(seed)
    seg = np.zeros((b, l), np.int32)
    for i in range(b):
        cuts = np.sort(rs.choice(np.arange(1, l), size=4, replace=False))
        cuts[0] = 1  # a one-token first document
        for j, c in enumerate(cuts):
            seg[i, c:] = j + 1
    return seg


def _case_inputs(causal, h, hkv, d, window, packed):
    seed = h * 100 + hkv * 10 + (window or 0) + 7 * packed + 3 * causal
    q, k, v, g = _inputs(seed, 2, h, hkv, L, d)
    seg = _segments(seed, 2, L) if packed else None
    return q, k, v, g, seg


def _jax(x):
    return None if x is None else jnp.asarray(x)


def _torch(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("causal,h,hkv,d,window,packed", FWD_CASES)
def test_flash_forward_masks_match_jax(causal, h, hkv, d, window, packed):
    q, k, v, _g, seg = _case_inputs(causal, h, hkv, d, window, packed)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    masks = dict(causal=causal, window=window, segments=_jax(seg))
    kernel = np.asarray(jatt.flash_attention(
        jq, jk, jv, block_q=BLOCK, block_k=BLOCK, **masks))
    scan = np.asarray(jatt.blockwise_attention(jq, jk, jv, block_size=BLOCK,
                                               **masks))
    _o, jlse = jatt.attention_forward_lse(jq, jk, jv, block_q=BLOCK,
                                          block_k=BLOCK, **masks)
    tq, tk, tv, tseg = (_torch(x) for x in (q, k, v, seg))
    out, lse = tatt.flash_forward(tq, tk, tv, causal=causal, window=window,
                                  q_seg=tseg, k_seg=tseg)
    for ref in (kernel, scan):
        np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=TOL,
                               rtol=TOL)
    naive = tatt.naive_attention(tq, tk, tv, causal=causal, window=window,
                                 segments=tseg)
    np.testing.assert_allclose(naive.numpy(), kernel, atol=TOL, rtol=TOL)
    # the public op takes the single-array form and gives the same
    assert torch.equal(tatt.flash_attention(tq, tk, tv, causal=causal,
                                            window=window, segments=tseg),
                       out)


@pytest.mark.parametrize("causal,h,hkv,d,window,packed", BWD_CASES)
def test_flash_backward_masks_match_jax_grad(causal, h, hkv, d, window,
                                             packed):
    q, k, v, g, seg = _case_inputs(causal, h, hkv, d, window, packed)
    jseg = _jax(seg)

    def f(q_, k_, v_):
        out = jatt.flash_attention(q_, k_, v_, causal=causal, window=window,
                                   segments=jseg, block_q=BLOCK,
                                   block_k=BLOCK)
        return (out * jnp.asarray(g)).sum()

    ref = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tatt.flash_attention(*leaves, causal=causal, window=window,
                               segments=_torch(seg))
    assert "FlashAttention" in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(g))
    for name, leaf, r in zip(("dq", "dk", "dv"), leaves, ref):
        r = np.asarray(r)
        err = np.abs(leaf.grad.numpy() - r).max()
        assert err <= _grad_tol(r), (name, err)
    # the plain backward halves agree with the JAX dense recompute too
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    o, lse = tatt.flash_forward(tq, tk, tv, causal=causal, window=window,
                                q_seg=_torch(seg), k_seg=_torch(seg))
    jref = jatt.attention_backward_lse(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(o.numpy()),
        jnp.asarray(lse.numpy()), jnp.asarray(g), causal=causal,
        window=window, segments=jseg, block_q=BLOCK, block_k=BLOCK)
    got = tatt.flash_backward(tq, tk, tv, o, lse, tg, causal=causal,
                              window=window, q_seg=_torch(seg),
                              k_seg=_torch(seg))
    for a, r in zip(got, jref):
        r = np.asarray(r)
        assert np.abs(a.numpy() - r).max() <= _grad_tol(r)


def _grad_tol(ref):
    return TOL * max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("causal,window", [(True, None), (False, 3)])
def test_pair_form_masks_empty_rows_to_zero_with_zero_grad(causal, window):
    """Rectangular-style ids where some query ids appear in no key: those
    rows are exactly 0 and get exactly zero gradient, as in JAX; the
    kernel convention gives them lse +1e30 and P = 0."""
    q, k, v, g = _inputs(17, 2, 4, 2, L, 64)
    q_seg = _segments(3, 2, L)
    k_seg = _segments(3, 2, L)
    q_seg[0, 20:] = 9  # ids no key carries
    q_seg[1, :5] = 8
    pair = (q_seg, k_seg)
    jpair = tuple(jnp.asarray(x) for x in pair)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))

    def f(q_, k_, v_):
        out = jatt.flash_attention(q_, k_, v_, causal=causal, window=window,
                                   segments=jpair, block_q=BLOCK,
                                   block_k=BLOCK)
        return (out * jnp.asarray(g)).sum(), out

    (_, ref), jgrads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                          has_aux=True)(jq, jk, jv)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tatt.flash_attention(*leaves, causal=causal, window=window,
                               segments=tuple(torch.from_numpy(x)
                                              for x in pair))
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=TOL, rtol=TOL)
    assert torch.all(out[0, :, 20:] == 0) and torch.all(out[1, :, :5] == 0)
    assert torch.all(leaves[0].grad[0, :, 20:] == 0)
    assert torch.all(leaves[0].grad[1, :, :5] == 0)
    for leaf, r in zip(leaves, jgrads):
        r = np.asarray(r)
        assert np.abs(leaf.grad.numpy() - r).max() <= _grad_tol(r)
    _o, lse = tatt.flash_forward(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal=causal, window=window,
                                 q_seg=torch.from_numpy(q_seg),
                                 k_seg=torch.from_numpy(k_seg))
    assert torch.all(lse[0, :, 20:] == 1e30)


def test_backward_zeroes_rows_with_a_negative_lse_sentinel():
    """The TPU forward leaves a fully masked row an lse of the -1e30
    class; the backward kernels zero its P (attention.py:1277, :1332),
    and so do the plain versions, whatever its scores."""
    q, k, v, g = _inputs(23, 1, 2, 2, 16, 64)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = tatt.flash_forward(tq, tk, tv, causal=True)
    lse[:, :, 4] = -6.9e29
    dq, dk, dv = tatt.flash_backward_plain(tq, tk, tv, out, lse, tg,
                                           causal=True)
    assert torch.all(dq[:, :, 4] == 0)
    lse_ok = lse.clone()
    lse_ok[:, :, 4] = 1e30
    ref = tatt.flash_backward_plain(tq, tk, tv, out, lse_ok, tg, causal=True)
    for a, b in zip((dq, dk, dv), ref):
        assert torch.equal(a, b)


def test_window_and_segment_arguments_are_checked():
    q, k, v, _g = (torch.from_numpy(x) for x in _inputs(1, 1, 2, 2, 8, 64))
    with pytest.raises(ValueError, match="window must be >= 1"):
        tatt.flash_attention(q, k, v, causal=True, window=0)
    with pytest.raises(ValueError, match="square"):
        tatt.flash_attention(q, k[:, :, :4], v[:, :, :4], window=2)
    with pytest.raises(ValueError, match="single segments array"):
        tatt.flash_attention(q, k[:, :, :4], v[:, :, :4],
                             segments=torch.zeros(1, 8))
    with pytest.raises(ValueError, match="segments must be"):
        tatt.flash_attention(q, k, v, segments=torch.zeros(1, 7))
    with pytest.raises(ValueError, match="pair must be"):
        tatt.flash_attention(q, k, v, segments=(torch.zeros(1, 8),))
    # pos_offset (ring attention's rotations) is taken: a causal rotation
    # over a kv shard newer than every query leaves each row empty (out 0)
    out = tatt.flash_attention(q, k, v, causal=True, pos_offset=-8)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packed_positions_match_jax(seed):
    seg = _segments(seed, 3, 24)
    seg[2] = 0  # one document fills the row
    got = tatt.packed_positions(torch.from_numpy(seg))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jatt.packed_positions(seg)))
    np.testing.assert_array_equal(
        tatt.packed_positions(torch.from_numpy(seg[0])).numpy(),
        np.asarray(jatt.packed_positions(seg[0])))


@pytest.mark.parametrize("group,t,window", [(1, 5, None), (2, 5, 2),
                                            (4, 9, 4), (1, 3, 1)])
def test_tile_causal_mask_matches_jax(group, t, window):
    np.testing.assert_array_equal(
        tatt._tile_causal_mask(group, t, window).numpy(),
        np.asarray(jatt._tile_causal_mask(group, t, window)))


# ----------------------------------------------------------- paged decode


def _paged_case(seed, h, hkv, t, int8, d=16, bs=4, nb=24, m=7,
                lengths=(21, 0, 9)):
    """q, the tile's k/v, pools, a table with a -1 hole inside sequence
    0's live range, lengths with a 0; int8 cases quantize the float
    arenas and the tile with the port's quantizer (flax's bit for bit,
    tests/test_torch_kv_int8.py)."""
    rs = np.random.RandomState(seed)
    b = len(lengths)
    arrays = [rs.randn(b, h, t, d), rs.randn(b, hkv, t, d),
              rs.randn(b, hkv, t, d), rs.randn(nb, bs, hkv, d),
              rs.randn(nb, bs, hkv, d)]
    arrays = [a.astype(np.float32) for a in arrays]
    table = np.full((b, m), -1, np.int32)
    perm = rs.permutation(nb)
    used = 0
    for i, n in enumerate(lengths):
        blocks = -(-n // bs)
        table[i, :blocks] = perm[used:used + blocks]
        used += blocks
    table[0, 1] = -1
    arrays += [table, np.asarray(lengths, np.int32)]
    scales = {}
    if int8:
        for i, name in ((1, "k_cur_scale"), (2, "v_cur_scale"),
                        (3, "k_scale_pool"), (4, "v_scale_pool")):
            q8, sc = kv_quantize_rows(torch.from_numpy(arrays[i]))
            arrays[i], scales[name] = q8.numpy(), sc.numpy()
    return arrays, scales


PAGED_CASES = [
    # (t, h, hkv, int8, window)
    (1, 2, 2, False, 6),
    (1, 4, 2, True, 6),
    (3, 2, 2, False, 2),   # window < t: late rows see no pool row
    (3, 4, 1, True, 5),
    (9, 2, 2, False, 5),   # window < t, past the split kernel's rows
    (9, 4, 2, True, 12),
    (9, 2, 1, False, 40),  # window past every length
    (3, 2, 2, True, 1),    # each row sees only itself
]


@pytest.mark.parametrize("t,h,hkv,int8,window", PAGED_CASES)
def test_paged_window_matches_jax_kernel_and_scan(t, h, hkv, int8, window):
    arrays, scales = _paged_case(t * 13 + h + window, h, hkv, t, int8)
    out = tatt.paged_decode_attention(
        *[torch.from_numpy(x) for x in arrays], window=window,
        **{k: torch.from_numpy(v) for k, v in scales.items()})
    for use_kernel in (True, False):
        ref = np.asarray(jatt.paged_decode_attention(
            *[jnp.asarray(x) for x in arrays], window=window,
            use_kernel=use_kernel,
            **{k: jnp.asarray(v) for k, v in scales.items()}))
        np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    # the pool partials: rows that see a pool row match the interpreted
    # kernel's; rows that see none are (0, 0, -1e30)
    q, length = arrays[0], arrays[6]
    b, d = q.shape[0], q.shape[3]
    qf = (q * d ** -0.5).reshape(b, hkv, (h // hkv) * t, d)
    pools = [torch.from_numpy(x) for x in arrays[3:7]]
    extra = [torch.from_numpy(scales[k])
             for k in ("k_scale_pool", "v_scale_pool")] if int8 else []
    o, l, mx = tatt.paged_decode_partials(torch.from_numpy(qf), *pools,
                                          *extra, window=window, t=t)
    jo, jl, jm = (np.asarray(x) for x in jatt._paged_decode_fused(
        jnp.asarray(qf), *(jnp.asarray(x) for x in arrays[3:7]), t,
        window=window, **({k: jnp.asarray(scales[k])
                           for k in ("k_scale_pool", "v_scale_pool")}
                          if int8 else {})))
    live = l.numpy() > 0
    # tile token r sees min(length, window - r - 1) positions (the hole
    # in sequence 0's slot 1 lies outside every window here)
    rows = np.arange(qf.shape[2]) % t
    seen = np.minimum(length[:, None], window - rows[None, :] - 1)
    np.testing.assert_array_equal(live, np.broadcast_to(
        (seen > 0)[:, None, :], live.shape))
    np.testing.assert_allclose(o.numpy()[live], jo[live], atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(l.numpy()[live], jl[live], atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(mx.numpy()[live], jm[live], atol=TOL,
                               rtol=TOL)
    assert np.all(o.numpy()[~live] == 0) and np.all(l.numpy()[~live] == 0)
    assert np.all(mx.numpy()[~live] == tatt.NEG_INF)


def test_paged_partials_check_the_tile_length():
    arrays, _ = _paged_case(1, 2, 2, 3, False)
    qf = torch.zeros(3, 2, 3, 16)
    pools = [torch.from_numpy(x) for x in arrays[3:7]]
    with pytest.raises(ValueError, match="whole tiles"):
        tatt.paged_decode_partials(qf, *pools, window=2, t=2)
    with pytest.raises(ValueError, match="window must be >= 1"):
        tatt.paged_decode_partials(qf, *pools, window=0, t=3)
