"""The port's attention against the JAX package's, same inputs.

On the CPU the port's wrappers run their kernels' plain PyTorch
versions; the JAX side runs its Pallas kernels in interpret mode (as
tests/test_attention.py does) and its jnp oracles. Inputs come from a
numpy seed; everything is fp32 and agrees to 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticdl_tpu.ops import attention as jatt
from elasticdl_tpu_torch.ops import attention as tatt

torch.set_num_threads(2)

TOL = 1e-5


@pytest.fixture(autouse=True)
def _opt_into_interpreted_kernels(monkeypatch):
    """Off-TPU the JAX package takes its jnp paths; these tests hold the
    port against the Pallas kernels themselves, in interpret mode."""
    monkeypatch.setenv("ELASTICDL_TPU_FORCE_INTERPRET", "1")


def _qkv(seed, b, h, hkv, lq, lk, d):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, h, lq, d).astype(np.float32),
            rs.randn(b, hkv, lk, d).astype(np.float32),
            rs.randn(b, hkv, lk, d).astype(np.float32))


@pytest.mark.parametrize("causal,h,hkv,l", [
    (True, 2, 2, 32),
    (False, 2, 2, 32),
    (True, 4, 2, 24),   # GQA
    (True, 2, 1, 20),   # MQA, ragged against every 8/64 tile
    (False, 4, 2, 13),  # ragged, non-causal
])
def test_flash_matches_jax_kernel_and_naive(causal, h, hkv, l):
    q, k, v = _qkv(h * 10 + l, 2, h, hkv, l, l, 16)
    ref = np.asarray(jatt.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = tatt.flash_forward(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    naive = tatt.naive_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(out.numpy(), naive.numpy(), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(
        tatt.flash_attention(tq, tk, tv, causal=causal).numpy(),
        out.numpy(), atol=0, rtol=0)
    # lse: the kernel-side residual, against the JAX forward's
    _out, jlse = jatt.attention_forward_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=TOL,
                               rtol=TOL)


def test_flash_unported_options_raise():
    """Windows and segments are ported (tests/test_torch_masked_attention.py),
    and so is ring attention's pos_offset (tests/test_torch_pos_offset.py):
    each is taken."""
    q, k, v = (torch.zeros(1, 1, 8, 8) for _ in range(3))
    for kwargs in ({"window": 4}, {"segments": torch.zeros(1, 8)},
                   {"pos_offset": 2}):
        assert tatt.flash_attention(q, k, v, causal=True, **kwargs).shape == (
            1, 1, 8, 8)


def _paged_inputs(seed, b, h, hkv, t, d, bs, nb, m, lengths, holes=False):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, h, t, d).astype(np.float32)
    k_cur = rs.randn(b, hkv, t, d).astype(np.float32)
    v_cur = rs.randn(b, hkv, t, d).astype(np.float32)
    k_pool = rs.randn(nb, bs, hkv, d).astype(np.float32)
    v_pool = rs.randn(nb, bs, hkv, d).astype(np.float32)
    table = np.full((b, m), -1, np.int32)
    perm = rs.permutation(nb)
    used = 0
    for i, n in enumerate(lengths):
        blocks = -(-n // bs)
        table[i, :blocks] = perm[used:used + blocks]
        used += blocks
    if holes:
        # an unallocated slot inside the live range: both sides must
        # mask it (the JAX side clamps the gather, the port skips it)
        table[0, 0] = -1
    return q, k_cur, v_cur, k_pool, v_pool, table, np.asarray(lengths,
                                                              np.int32)


@pytest.mark.parametrize("t,h,hkv,holes", [
    (1, 2, 2, False),
    (4, 2, 2, False),
    (1, 4, 2, True),   # GQA + a -1 slot
    (4, 4, 1, False),  # MQA tile
])
def test_paged_matches_jax_kernel_and_scan(t, h, hkv, holes):
    args = _paged_inputs(
        seed=t * 7 + h, b=3, h=h, hkv=hkv, t=t, d=16, bs=4, nb=24, m=6,
        lengths=[9, 0, 17], holes=holes)
    jargs = [jnp.asarray(x) for x in args]
    targs = [torch.from_numpy(x) for x in args]
    out = tatt.paged_decode_attention(*targs)
    for use_kernel in (True, False):
        ref = np.asarray(jatt.paged_decode_attention(
            *jargs, use_kernel=use_kernel))
        np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


def test_paged_legacy_shape_and_partials_contract():
    """[b, h, d] queries drop t like the JAX op; partials of a length-0
    sequence are (0, 0, -1e30) and never read the pool."""
    q, k_cur, v_cur, k_pool, v_pool, table, length = _paged_inputs(
        seed=5, b=2, h=2, hkv=2, t=1, d=8, bs=4, nb=8, m=4, lengths=[0, 6])
    targs = [torch.from_numpy(x) for x in
             (q[:, :, 0], k_cur[:, :, 0], v_cur[:, :, 0], k_pool, v_pool,
              table, length)]
    out = tatt.paged_decode_attention(*targs)
    ref = np.asarray(jatt.paged_decode_attention(
        *[jnp.asarray(x.numpy()) for x in targs], use_kernel=False))
    assert out.shape == (2, 2, 8)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
    qf = torch.from_numpy(q).reshape(2, 2, 1, 8)
    o, l, mx = tatt.paged_decode_partials(qf, *targs[3:])
    assert torch.all(o[0] == 0) and torch.all(l[0] == 0)
    assert torch.all(mx[0] == tatt.NEG_INF)
    assert torch.all(l[1] > 0)


def test_paged_unported_options_raise():
    args = [torch.from_numpy(x) for x in _paged_inputs(
        seed=1, b=1, h=1, hkv=1, t=1, d=8, bs=4, nb=4, m=2, lengths=[3])]
    # sliding windows are ported; a window below 1 is refused, as the
    # JAX op's _check_window refuses it
    with pytest.raises(ValueError, match="window must be >= 1"):
        tatt.paged_decode_attention(*args, window=0)
    # int8 arenas are ported; a partial set of scale operands is refused,
    # as the JAX op refuses it
    with pytest.raises(ValueError, match="all four scale operands"):
        tatt.paged_decode_attention(*args, k_scale_pool=args[3])


def test_cpu_tensors_take_the_plain_path_without_launches():
    """The policy is by tensor: a CPU tensor runs the plain version, and
    no launch is counted; mixed devices raise."""
    tatt.reset_launch_counts()
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 1, 1, 1, 8, 8, 8))
    tatt.flash_forward(q, k, v, causal=True)
    assert set(tatt.KERNEL_LAUNCHES.values()) == {0}
    meta = torch.empty(1, 1, 8, 8, device="meta")
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        tatt.flash_forward(q, meta, meta)
