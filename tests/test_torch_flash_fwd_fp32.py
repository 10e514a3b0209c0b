"""The port's fp32 flash forward against the JAX package's Pallas forward
kernel, at the geometry of the card's fp32 kernel.

On the card, fp32 inputs run csrc/flash_fwd.cu's fp32 kernel, which is
held there to `flash_attention_plain`; here that plain version is held
to `attention_forward_lse` run through the Pallas kernel in interpret
mode (ELASTICDL_TPU_FORCE_INTERPRET=1, blocks of 16, or 8 where l is not
a multiple of 16). The cases reach what the card kernel's 64-row tiles
meet: head_dim 64 and 128, lengths ragged against the tiles and spanning
several (80 and 136), ViT-Base's case (not causal, h = hkv), causal GQA
4/2, and at d 64 one window, one packed-segments and one shifted
(pos_offset 17, and -17, whose first rows see no key) case. Inputs are
fp32 values made by numpy from a seed. Limit: |err| <= 1e-5 of max |ref|
for out and for lse on the rows that see a key, since the two sum in
another order and round nothing (_mxu_cast leaves fp32 operands); a row
that sees no key gives out 0 and lse +1e30 (the port's contract, where
JAX's lse is -1e30). The CPU wrapper `flash_forward` must equal the
plain version bit for bit.
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
    port against the Pallas kernel itself, in interpret mode."""
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
def test_fp32_plain_forward_matches_interpreted_pallas(
        causal, h, hkv, l, d, window, packed, pos_offset):
    rs = np.random.RandomState(1000 * h + 100 * hkv + l + d
                               + (window or 0) + 7 * pos_offset)
    b = 2 if packed else 1

    def mk(heads):
        return torch.from_numpy(rs.randn(b, heads, l, d).astype(np.float32))

    q, k, v = mk(h), mk(hkv), mk(hkv)
    seg = _segments(rs, b, l) if packed else None
    block = 16 if l % 16 == 0 else 8
    empty_rows = 0
    for offset in sorted({pos_offset, -pos_offset}):
        masks = dict(causal=causal, window=window, pos_offset=offset)
        ref_out, ref_lse = (np.asarray(x) for x in jatt.attention_forward_lse(
            *(jnp.asarray(x.numpy()) for x in (q, k, v)),
            block_q=block, block_k=block,
            segments=None if seg is None else jnp.asarray(seg.numpy()),
            **masks))
        plain = dict(masks, q_seg=seg, k_seg=seg)
        out, lse = tatt.flash_attention_plain(q, k, v, **plain)
        assert out.dtype == lse.dtype == torch.float32
        assert out.shape == ref_out.shape and lse.shape == ref_lse.shape
        seen = np.abs(ref_lse) < 0.5e30
        empty_rows += int((~seen).sum())
        out, lse = out.numpy(), lse.numpy()
        o_err = np.abs(out - ref_out)[seen].max()
        assert o_err <= TOL * np.abs(ref_out[seen]).max(), (offset, o_err)
        l_err = np.abs(lse - ref_lse)[seen].max()
        assert l_err <= TOL * np.abs(ref_lse[seen]).max(), (offset, l_err)
        # rows that see no key: out 0 and lse +1e30 (JAX's lse is -1e30)
        assert (out[~seen] == 0).all() and (lse[~seen] == 1e30).all()
        assert (ref_lse[~seen] == -1e30).all()
        # the wrapper takes the plain version for CPU tensors
        w_out, w_lse = tatt.flash_forward(q, k, v, **plain)
        assert torch.equal(w_out, torch.from_numpy(out))
        assert torch.equal(w_lse, torch.from_numpy(lse))
    # the shift -17 leaves the first 17 rows of every head without a key
    assert empty_rows == (17 * b * h if pos_offset else 0)
