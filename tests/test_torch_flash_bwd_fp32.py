"""The port's fp32 flash backward against the JAX package's Pallas
backward kernels, at the geometry of the card's fp32 kernels.

On the card, fp32 inputs run csrc/flash_bwd.cu's fp32 kernels, which are
held there to `flash_backward_dq_plain` / `flash_backward_dkv_plain`;
here those plain versions are held to `attention_backward_lse` run
through the Pallas kernels in interpret mode
(ELASTICDL_TPU_FORCE_INTERPRET=1, blocks of 16, or 8 where l is not a
multiple of 16). The cases reach what the card kernels' tiles meet:
head_dim 64 and 128, lengths ragged against their 64-row tiles and
spanning several (80 and 136), ViT-Base's case (not causal, h = hkv),
causal GQA 4/2, and at d 64 one window, one packed-segments and one
shifted (pos_offset) case. Inputs are fp32 values made by numpy from a
seed; `out` is random and the lse is the port's forward's (the shifted
case takes a ring's global lse, merged with a second, unmasked kv
shard's, so every row is finite), both handed to both sides. Limit:
|err| <= 1e-5 of max |ref| per gradient and for delta, since the two sum
in another order and round nothing (_mxu_cast leaves fp32 operands).
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
    # (causal, h, hkv, l, d, window, packed, pos_offset)
    (False, 2, 2, 80, 64, None, False, 0),    # ViT's case, ragged
    (False, 2, 2, 136, 64, None, False, 0),   # three tiles
    (True, 4, 2, 136, 64, None, False, 0),    # causal GQA 4/2
    (False, 2, 2, 80, 128, None, False, 0),
    (True, 4, 2, 80, 128, None, False, 0),
    (True, 2, 2, 136, 64, 37, False, 0),      # window 37
    (False, 2, 2, 80, 64, None, True, 0),     # packed segments
    (True, 2, 2, 80, 64, None, False, 17),    # shifted query positions
]


@pytest.fixture(autouse=True)
def _opt_into_interpreted_kernels(monkeypatch):
    """Off-TPU the JAX package takes its jnp paths; these tests hold the
    port against the Pallas kernels themselves, in interpret mode."""
    monkeypatch.setenv("ELASTICDL_TPU_FORCE_INTERPRET", "1")


def _segments(rs, b, l):
    """Ragged runs of 2-5 ids per row."""
    cuts = np.sort(rs.randint(1, l, size=(b, 4)), axis=1)
    ids = np.zeros((b, l), np.int32)
    for i in range(b):
        for c in cuts[i]:
            ids[i, c:] += 1
    return torch.from_numpy(ids)


@pytest.mark.parametrize("causal,h,hkv,l,d,window,packed,pos_offset",
                         CASES)
def test_fp32_plain_backward_matches_interpreted_pallas(
        causal, h, hkv, l, d, window, packed, pos_offset):
    rs = np.random.RandomState(1000 * h + 100 * hkv + l + d
                               + (window or 0) + 7 * pos_offset)
    b = 2 if packed else 1

    def mk(heads):
        return torch.from_numpy(rs.randn(b, heads, l, d).astype(np.float32))

    q, g, out = mk(h), mk(h), mk(h)
    k, v, k2, v2 = mk(hkv), mk(hkv), mk(hkv), mk(hkv)
    seg = _segments(rs, b, l) if packed else None
    masks = dict(causal=causal, window=window, pos_offset=pos_offset)
    _o, lse = tatt.attention_forward_lse(q, k, v, segments=seg, **masks)
    if pos_offset:
        _o2, lse_full = tatt.attention_forward_lse(q, k2, v2)
        lse = torch.logaddexp(lse, lse_full)

    block = 16 if l % 16 == 0 else 8
    ref = jatt.attention_backward_lse(
        *(jnp.asarray(x.numpy()) for x in (q, k, v, out)),
        jnp.asarray(lse.numpy()), jnp.asarray(g.numpy()),
        block_q=block, block_k=block,
        segments=None if seg is None else jnp.asarray(seg.numpy()),
        **masks)

    plain = dict(masks, q_seg=seg, k_seg=seg)
    dq, delta = tatt.flash_backward_dq_plain(q, k, v, out, lse, g, **plain)
    dk, dv = tatt.flash_backward_dkv_plain(q, k, v, g, lse, delta, **plain)
    for name, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        r = np.asarray(r)
        assert a.dtype == torch.float32 and a.shape == r.shape, name
        err = np.abs(a.numpy() - r).max()
        assert err <= TOL * np.abs(r).max(), "%s: %.3g of %.3g" % (
            name, err, np.abs(r).max())
    want = (g * out).sum(-1).numpy()
    assert np.abs(delta.numpy() - want).max() <= TOL * np.abs(want).max()
    # the wrappers take the plain versions for CPU tensors
    wq, wdelta = tatt.flash_backward_dq(q, k, v, out, lse, g, **plain)
    wk, wv = tatt.flash_backward_dkv(q, k, v, g, lse, wdelta, **plain)
    for a, p in zip((wq, wdelta, wk, wv), (dq, delta, dk, dv)):
        assert torch.equal(a, p)
