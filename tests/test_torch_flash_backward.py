"""The port's flash backward against the JAX package's, same inputs.

On the CPU the port's wrappers run the kernels' plain PyTorch versions;
the JAX side runs `attention_backward_lse` through its Pallas backward
kernels in interpret mode (blocks of 16, as tests/test_attention.py
does). Inputs come from a numpy seed; fp32 throughout, agreement to
1e-5. Torch autograd through `naive_attention` is the second oracle.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticdl_tpu.ops import attention as jatt
from elasticdl_tpu_torch.ops import attention as tatt

torch.set_num_threads(2)

TOL = 1e-5
CASES = [
    # (causal, h, hkv, l)
    (True, 2, 2, 32),
    (False, 2, 2, 32),
    (True, 4, 2, 48),   # GQA 4/2
    (False, 4, 2, 32),
    (True, 2, 1, 32),   # MQA 2/1
    (False, 2, 1, 48),
]


@pytest.fixture(autouse=True)
def _opt_into_interpreted_kernels(monkeypatch):
    """Off-TPU the JAX package takes its jnp paths; these tests hold the
    port against the Pallas kernels themselves, in interpret mode."""
    monkeypatch.setenv("ELASTICDL_TPU_FORCE_INTERPRET", "1")


def _inputs(seed, b, h, hkv, l, d=16):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, h, l, d).astype(np.float32),
            rs.randn(b, hkv, l, d).astype(np.float32),
            rs.randn(b, hkv, l, d).astype(np.float32),
            rs.randn(b, h, l, d).astype(np.float32))


@pytest.mark.parametrize("causal,h,hkv,l", CASES)
def test_backward_matches_interpreted_pallas_kernels(causal, h, hkv, l):
    q, k, v, g = _inputs(h * 100 + hkv * 10 + l, 2, h, hkv, l)
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    out, lse = jatt.attention_forward_lse(jq, jk, jv, causal=causal,
                                          block_q=16, block_k=16)
    ref = jatt.attention_backward_lse(jq, jk, jv, out, lse, jg,
                                      causal=causal, block_q=16,
                                      block_k=16)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    tout = torch.tensor(np.asarray(out))
    tlse = torch.tensor(np.asarray(lse))
    got = tatt.flash_backward_plain(tq, tk, tv, tout, tlse, tg,
                                    causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL,
                                   rtol=TOL, err_msg=name)
    # the wrapper (CPU tensors -> plain version) and its two halves
    wrapped = tatt.flash_backward(tq, tk, tv, tout, tlse, tg, causal=causal)
    dq, delta = tatt.flash_backward_dq(tq, tk, tv, tout, tlse, tg,
                                       causal=causal)
    dk, dv = tatt.flash_backward_dkv(tq, tk, tv, tg, tlse, delta,
                                     causal=causal)
    for a, b in zip(wrapped, got):
        assert torch.equal(a, b)
    for a, b in zip((dq, dk, dv), got):
        assert torch.equal(a, b)
    np.testing.assert_allclose(
        delta.numpy(), (g * np.asarray(out)).sum(-1), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal,h,hkv,l", [
    (True, 2, 2, 13),   # ragged against every tile
    (False, 4, 2, 20),
    (True, 2, 1, 9),
])
def test_backward_matches_autograd_and_function(causal, h, hkv, l):
    q, k, v, g = _inputs(7 + l, 2, h, hkv, l)

    def leaves():
        return [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]

    nq, nk, nv = leaves()
    tatt.naive_attention(nq, nk, nv, causal=causal).backward(
        torch.from_numpy(g))
    fq, fk, fv = leaves()
    out = tatt.flash_attention(fq, fk, fv, causal=causal)
    assert out.grad_fn is not None and "FlashAttention" in type(
        out.grad_fn).__name__
    out.backward(torch.from_numpy(g))
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    o, lse = tatt.flash_forward(tq, tk, tv, causal=causal)
    plain = tatt.flash_backward_plain(tq, tk, tv, o, lse, tg, causal=causal)
    for name, auto, func, p in zip(("dq", "dk", "dv"),
                                   (nq.grad, nk.grad, nv.grad),
                                   (fq.grad, fk.grad, fv.grad), plain):
        np.testing.assert_allclose(p.numpy(), auto.numpy(), atol=TOL,
                                   rtol=TOL, err_msg=name)
        assert torch.equal(func, p), name


def test_no_grad_calls_skip_the_function():
    q, k, v, _g = _inputs(3, 1, 2, 2, 8)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    with torch.no_grad():
        out = tatt.flash_attention(tq, tk, tv, causal=True)
    assert out.grad_fn is None
    ref, _lse = tatt.flash_forward(tq.detach(), tk.detach(), tv.detach(),
                                   causal=True)
    assert torch.equal(out, ref)


def test_empty_rows_get_zero_gradient():
    """A row with no visible key (lse = +1e30, out = 0) contributes
    nothing: P = 0 there, as in the kernels."""
    q, k, v, g = _inputs(5, 1, 2, 2, 8)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = tatt.flash_forward(tq, tk, tv, causal=True)
    lse[:, :, 3] = 1e30
    out[:, :, 3] = 0.0
    dq, dk, dv = tatt.flash_backward_plain(tq, tk, tv, out, lse, tg,
                                           causal=True)
    assert torch.all(dq[:, :, 3] == 0)
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()


def test_bf16_inputs_give_bf16_gradients():
    q, k, v, g = _inputs(11, 1, 4, 2, 16)
    tq, tk, tv, tg = (torch.from_numpy(x).to(torch.bfloat16)
                      for x in (q, k, v, g))
    out, lse = tatt.flash_forward(tq, tk, tv, causal=True)
    dq, dk, dv = tatt.flash_backward(tq, tk, tv, out, lse, tg, causal=True)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert dk.shape == tk.shape and dv.shape == tv.shape
    f32 = [x.float() for x in (tq, tk, tv, out, tg)]
    ref = tatt.flash_backward_plain(f32[0], f32[1], f32[2], f32[3], lse,
                                    f32[4], causal=True)
    for a, b in zip((dq, dk, dv), ref):
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), atol=2e-2,
                                   rtol=2e-2)
