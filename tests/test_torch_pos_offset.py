"""Ring attention's per-rotation entry points in the port against the JAX
package's, same numpy-seeded inputs: `pos_offset` (the query rows at
positions row + pos_offset in the causal and window tests), the lse
entries and `lse_merge`, and the rotation helpers of the ring.

The port runs its kernels' plain versions on the CPU. JAX runs its
Pallas kernels in interpret mode (ELASTICDL_TPU_FORCE_INTERPRET=1, as
tests/test_attention.py does) and, without it, its blockwise / dense
jnp paths. Offsets 0, -lq, lq (= lk: windows need square shapes) as in
tests/test_attention.py's clamp sweep, and lk + 1 (fully masked
rotations included), causal or not, windows 8 / 24 / 64 or none, the
(q_seg, k_seg) pair form of a ring rotation, GQA group 2. Tolerances, fp32: 1e-5 for out, lse and the gradients
(the two sum in another order); the snapped empty-row lse exactly
-1e30 in both; helpers and merges exact or 1e-6.

The backward takes the lse a ring hands it, the finite global lse of
the row (here: this rotation's lse merged with that of a second, full
kv shard), not the rotation's own, so a row that sees no key of the
rotation still has a finite lse and must contribute nothing.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticdl_tpu.ops import attention as jatt
from elasticdl_tpu.parallel import context_parallel as jcp
from elasticdl_tpu_torch.ops import attention as tatt
from elasticdl_tpu_torch.parallel import context_parallel as tcp

TOL = 1e-5
L, D = 64, 8
OFFSETS = (0, -L, L, L + 1)  # 0, -lq, lq = lk, lk + 1
WINDOWS = (None, 8, 24, 64)


def _inputs(seed, b=2, h=2, hkv=1, l=L, d=D):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, h, l, d).astype(np.float32)
    k = rs.randn(b, hkv, l, d).astype(np.float32)
    v = rs.randn(b, hkv, l, d).astype(np.float32)
    g = rs.randn(b, h, l, d).astype(np.float32)
    out = rs.randn(b, h, l, d).astype(np.float32)
    return q, k, v, g, out


def _pair_segments(seed, b=2, l=L):
    """Ragged runs on the query side and on the key side (a rotation's
    own ids and the held shard's), sharing some ids, so some rows see
    no key."""
    rs = np.random.RandomState(seed)
    q_seg = np.sort(rs.randint(0, 4, size=(b, l)), axis=1).astype(np.int32)
    k_seg = np.sort(rs.randint(2, 6, size=(b, l)), axis=1).astype(np.int32)
    return q_seg, k_seg


# (causal, window, pos_offset, pair-form segments): every offset and
# window, causal or not; segments on half of the cases
CASES = [(causal, window, off, (i + j) % 2 == 1)
         for causal in (False, True)
         for i, window in enumerate(WINDOWS)
         for j, off in enumerate(OFFSETS)]


def _jax_lse(q, k, v, interpret, monkeypatch, **kw):
    monkeypatch.setenv("ELASTICDL_TPU_FORCE_INTERPRET",
                       "1" if interpret else "")
    out, lse = jatt.attention_forward_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    return np.asarray(out), np.asarray(lse)


@pytest.mark.parametrize("causal,window,pos_offset,packed", CASES)
def test_forward_lse_matches_jax(causal, window, pos_offset, packed,
                                 monkeypatch):
    q, k, v, _g, _out = _inputs(window or 7)
    segs = _pair_segments(pos_offset + 100) if packed else None
    kw = dict(causal=causal, window=window, pos_offset=pos_offset,
              segments=segs)
    t_seg = None if segs is None else tuple(torch.from_numpy(s)
                                            for s in segs)
    out, lse = tatt.attention_forward_lse(
        *(torch.from_numpy(x) for x in (q, k, v)),
        **dict(kw, segments=t_seg))
    out, lse = out.numpy(), lse.numpy()
    empty = lse == tatt.NEG_INF
    # rows that see no key: out exactly 0, lse exactly -1e30
    assert np.all(out[empty] == 0.0)
    assert np.all((lse == tatt.NEG_INF) | (np.abs(lse) < 1e3))
    for interpret in (True, False):
        jout, jlse = _jax_lse(q, k, v, interpret, monkeypatch, **kw)
        np.testing.assert_array_equal(empty, jlse == tatt.NEG_INF)
        np.testing.assert_allclose(lse, jlse, atol=TOL, rtol=TOL)
        live = ~empty
        np.testing.assert_allclose(out[live], jout[live], atol=TOL,
                                   rtol=TOL)
    if pos_offset == -L and causal:
        assert empty.all()  # a newer kv shard: the rotation sees nothing


@pytest.mark.parametrize("causal,window,pos_offset,packed", CASES)
def test_backward_lse_matches_jax(causal, window, pos_offset, packed,
                                  monkeypatch):
    q, k, v, g, out = _inputs((window or 7) + 50)
    segs = _pair_segments(pos_offset + 200) if packed else None
    kw = dict(causal=causal, window=window, pos_offset=pos_offset,
              segments=segs)
    t_seg = None if segs is None else tuple(torch.from_numpy(s)
                                            for s in segs)
    tq, tk, tv, tg, tout = (torch.from_numpy(x) for x in (q, k, v, g, out))
    # the ring's global lse: this rotation's merged with a full shard's
    _o, lse_rot = tatt.attention_forward_lse(tq, tk, tv,
                                             **dict(kw, segments=t_seg))
    k2, v2 = (torch.from_numpy(x) for x in _inputs(9)[1:3])
    _o2, lse_full = tatt.attention_forward_lse(tq, k2, v2)
    lse_g = torch.logaddexp(lse_rot, lse_full)
    grads = tatt.attention_backward_lse(
        tq, tk, tv, tout, lse_g, tg, grad_dtype=torch.float32,
        **dict(kw, segments=t_seg))
    assert all(x.dtype == torch.float32 for x in grads)
    for interpret in (True, False):
        monkeypatch.setenv("ELASTICDL_TPU_FORCE_INTERPRET",
                           "1" if interpret else "")
        ref = jatt.attention_backward_lse(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(out),
            jnp.asarray(lse_g.numpy()), jnp.asarray(g),
            grad_dtype=jnp.float32, **kw)
        for name, a, b in zip(("dq", "dk", "dv"), grads, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL,
                                       rtol=TOL, err_msg=name)
    if pos_offset == -L and causal:
        assert all(float(x.abs().max()) == 0.0 for x in grads)


def test_empty_rows_snap_to_neg_inf_and_backward_skips_them():
    """The port's flash forward gives an empty row lse +1e30 (the pair
    form's contract); the lse entry snaps it to exactly -1e30 whenever
    an offset or segments are given, so a merge weighs it 0; the
    backward with that sentinel gives the row zero gradient."""
    q, k, v, g, out = (torch.from_numpy(x) for x in _inputs(3))
    raw_out, raw_lse = tatt.flash_forward(q, k, v, causal=True,
                                          pos_offset=-L)
    assert torch.all(raw_lse == -tatt.NEG_INF)
    assert torch.all(raw_out == 0)
    o, lse = tatt.attention_forward_lse(q, k, v, causal=True, pos_offset=-L)
    assert torch.all(lse == tatt.NEG_INF) and torch.all(o == 0)
    # window 8, not causal, queries at i + L - 4: rows 0..10 reach a key
    o, lse = tatt.attention_forward_lse(q, k, v, window=8, pos_offset=L - 4)
    assert torch.all(lse[..., :11] > tatt.NEG_INF)
    assert torch.all(lse[..., 11:] == tatt.NEG_INF)
    assert torch.all(o[..., 11:, :] == 0)
    dq, dk, dv = tatt.attention_backward_lse(
        q, k, v, out, lse, g, causal=True, pos_offset=-L)
    for x in (dq, dk, dv):
        assert float(x.abs().max()) == 0.0
    # merging an all-empty partial changes nothing, bit for bit
    o_f, lse_f = tatt.attention_forward_lse(q, k, v)
    o_e, lse_e = tatt.attention_forward_lse(q, k, v, causal=True,
                                            pos_offset=-L)
    o_m, lse_m = tatt.lse_merge(o_f.float(), lse_f, o_e.float(), lse_e)
    assert torch.equal(o_m, o_f) and torch.equal(lse_m, lse_f)


def test_flash_attention_takes_pos_offset_with_its_backward():
    """flash_attention's pair form and its autograd path at an offset:
    the same values and gradients as the plain versions composed by
    hand (FlashAttentionFunction's backward runs flash_backward at the
    offset)."""
    q, k, v, g, _out = _inputs(4)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    segs = tuple(torch.from_numpy(s) for s in _pair_segments(5))
    out = tatt.flash_attention(*leaves, causal=False, window=24,
                               segments=segs, pos_offset=-L // 2)
    out.backward(torch.from_numpy(g))
    o_ref, lse_ref = tatt.flash_attention_plain(
        *(x.detach() for x in leaves), window=24, q_seg=segs[0],
        k_seg=segs[1], pos_offset=-L // 2)
    np.testing.assert_allclose(out.detach().numpy(), o_ref.numpy(), atol=0,
                               rtol=0)
    ref = tatt.flash_backward_plain(
        *(x.detach() for x in leaves), o_ref, lse_ref, torch.from_numpy(g),
        window=24, q_seg=segs[0], k_seg=segs[1], pos_offset=-L // 2)
    for leaf, r in zip(leaves, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), r.numpy(), atol=0,
                                   rtol=0)


def test_lse_merge_matches_jax():
    rs = np.random.RandomState(6)
    o, o_i = (rs.randn(2, 3, 16, 8).astype(np.float32) for _ in range(2))
    lse, lse_i = (rs.randn(2, 3, 16).astype(np.float32) * 4
                  for _ in range(2))
    lse_i[:, :, :5] = tatt.NEG_INF  # rows the second partial never saw
    lse[:, 0] = tatt.NEG_INF  # and rows the first never saw
    got = tatt.lse_merge(*(torch.from_numpy(x) for x in (o, lse, o_i,
                                                         lse_i)))
    ref = jatt.lse_merge(*(jnp.asarray(x) for x in (o, lse, o_i, lse_i)))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-6)


def test_ring_helpers_match_jax():
    """_win_live, _win_offsets, _win_case and _ring_case over a grid of
    shard lengths, windows, ring sizes and (src, my) pairs."""
    n = 0
    for size in (1, 2, 3, 4, 8):
        for shard_len in (1, 4, 16, 64):
            for window in (1, 3, 16, 17, 40, 64, 200, 1000):
                assert tcp._win_live(shard_len, window, size) == int(
                    jcp._win_live(shard_len, window, size))
                for causal in (False, True):
                    assert tcp._win_offsets(shard_len, window, size,
                                            causal) == list(
                        jcp._win_offsets(shard_len, window, size, causal))
                    for src in range(size):
                        for my in range(size):
                            assert tcp._win_case(
                                src, my, shard_len, window, size,
                                causal) == int(jcp._win_case(
                                    jnp.int32(src), jnp.int32(my),
                                    shard_len, window, size, causal))
                            n += 1
    for src in range(4):
        for my in range(4):
            assert tcp._ring_case(src, my) == int(jcp._ring_case(
                jnp.int32(src), jnp.int32(my)))
    assert n > 2000


def test_rotation_calls_of_the_windowed_flagship_ring():
    """The launches the windowed ring makes per layer at sp 4 with
    1024-token shards and window 1536 (chip_smoke.py counts them): 9
    rotations run, 5 of them at a nonzero offset, and 0, 1 and 2 shards
    back only."""
    calls = [tcp.rotation_call(src, my, 4, 1024, True, 1536)
             for my in range(4) for src in range(4)]
    run = [c for c in calls if c is not None]
    assert len(run) == 9
    assert sum(1 for c in run if c["pos_offset"]) == 5
    assert sorted({c["pos_offset"] for c in run}) == [0, 1024, 2048]
    # the unwindowed causal ring: r + 1 rotations on rank r
    assert sum(tcp.rotation_call(src, my, 4, 1024, True, None) is not None
               for my in range(4) for src in range(4)) == 10
