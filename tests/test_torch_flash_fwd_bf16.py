"""The port's plain flash forward with the TPU kernel's bf16 rounding
against the JAX package's Pallas forward kernel, bf16 inputs.

For bf16 inputs `_flash_kernel` scales q in bf16 by the constant
scale * log2 e, which JAX's weak typing rounds to bf16 (0.12792969 for
0.12751743 at d = 128), and rounds P to bf16 before P V (`_mxu_cast`);
the card's bf16 kernel does the same, and
`flash_attention_plain(..., bf16_operands=True)` is the plain version
of that arithmetic. JAX runs `attention_forward_lse` through its kernel
in interpret mode (ELASTICDL_TPU_FORCE_INTERPRET=1) with q blocks of 16
(8 where l is not a multiple of 16) and ONE key block spanning lk: the
kernel's running max then equals the plain version's row max. Over
several key blocks it rounds P against the running max and rescales it
afterwards, so an element rounds on another grid than the plain
version's (measured: 2438 of 16384 bf16 outputs one unit apart with
four key blocks of 16, none with one block); no plain version without
the tiles can follow that. Inputs are bf16 values made by numpy from a
seed. Limits, on the rows that see a key: lse within 1e-5 of max |lse|
(2e-7 of it measured: the two sum q k^T in another order); out, bf16 in
both, within 1e-5 of max |out| plus, per element, what rounding
boundaries can move it: the two form P in fp32 a few last bits apart,
so a P element within MIDPOINT_ULPS fp32 units of a bf16 midpoint may
round to the neighbouring bf16 value on one side (one bf16 unit of it
times |v|, over l), and an output whose fp32 value lies within
MIDPOINT_ULPS units of a bf16 midpoint, or within that P slack of one,
may round the other way (one bf16 unit of it; measured: 0-4 outputs a
case one unit apart, each inside that slack). Rows that see no key
carry the port's contract (out 0, lse +1e30) where JAX snaps the lse to
-1e30. The unrounded default must lie more than 1e-4 of max |lse|
away in each case (9.1e-4 to 3.8e-3 measured), so the test tells the
two apart.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticdl_tpu.ops import attention as jatt
from elasticdl_tpu_torch.ops import attention as tatt

torch.set_num_threads(2)

TOL = 1e-5
APART = 1e-4
MIDPOINT_ULPS = 8
CASES = [
    # (causal, h, hkv, l, d, window, segments, pos_offset, block_q)
    (True, 2, 2, 64, 128, None, None, 0, 16),
    (False, 2, 2, 64, 128, None, None, 0, 16),
    (True, 4, 2, 80, 64, None, None, 0, 16),       # GQA 4/2, ragged
    (False, 4, 1, 40, 64, None, None, 0, 8),       # MQA 4/1, ragged
    (True, 4, 2, 48, 128, None, None, 0, 16),
    (True, 2, 2, 48, 128, 1, None, 0, 16),         # window 1
    (False, 2, 1, 48, 64, 7, None, 0, 16),         # window 7
    (True, 4, 2, 80, 128, 37, None, 0, 16),        # window 37
    (True, 2, 2, 48, 64, None, "single", 0, 16),   # packed, one array
    (False, 4, 2, 64, 128, None, "single", 0, 16),
    (True, 2, 2, 48, 64, None, "pair", 0, 16),     # (q_seg, k_seg) pair
    (False, 2, 1, 64, 128, None, "pair", 0, 16),
    (True, 2, 2, 48, 64, None, None, -16, 16),     # ring offsets
    (True, 2, 2, 48, 128, None, None, -40, 16),
    (False, 2, 2, 48, 128, None, None, 16, 16),
    (True, 4, 2, 48, 64, None, None, 17, 16),
    (False, 2, 1, 48, 64, 8, None, -16, 16),       # window and offset
    (True, 2, 2, 64, 64, 16, "pair", 16, 16),      # every mask
    (True, 2, 2, 72, 128, None, "single", 0, 8),   # ragged against 16
]


@pytest.fixture(autouse=True)
def _opt_into_interpreted_kernels(monkeypatch):
    """Off-TPU the JAX package takes its blockwise path, which keeps P in
    fp32; these tests hold the port against the Pallas kernel itself, in
    interpret mode."""
    monkeypatch.setenv("ELASTICDL_TPU_FORCE_INTERPRET", "1")


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _bf16_unit(x):
    """One bf16 unit (2^-7 of the binade) of each element of fp32 `x`."""
    return torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 8)


def _midpoint_distance(x):
    """|x - the nearest bf16 rounding midpoint| of each fp32 element."""
    bits = x.contiguous().view(torch.int32)
    # x lies between the two bf16 values of its upper 16 bits and the
    # next; their midpoint has the same upper bits and bit 15 set
    return (x - ((bits & ~0xFFFF) | 0x8000).view(torch.float32)).abs()


def _ulp(x):
    return torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 24)


def _out_slack(out32, p, l, v, h):
    """Per output element, what rounding boundaries can move the bf16
    output: one bf16 unit of each P element within MIDPOINT_ULPS fp32
    units of a midpoint, times |v|, over l; plus one bf16 unit of the
    output where its fp32 value lies within MIDPOINT_ULPS units, or
    that P slack, of a midpoint."""
    near_p = _midpoint_distance(p) <= MIDPOINT_ULPS * _ulp(p)
    units_p = torch.where(near_p & (p != 0), _bf16_unit(p),
                          torch.zeros_like(p))
    vf = tatt.expand_kv(v, h).to(torch.float32).abs()
    slack_p = (units_p @ vf) / torch.clamp(l, min=1e-30)[..., None]
    near_out = (_midpoint_distance(out32)
                <= MIDPOINT_ULPS * _ulp(out32) + slack_p)
    return slack_p + torch.where(near_out & (out32 != 0),
                                 _bf16_unit(out32), torch.zeros_like(out32))


def _segments(rs, b, l):
    """Ragged runs of 2-5 ids per row."""
    cuts = np.sort(rs.randint(1, l, size=(b, 4)), axis=1)
    ids = np.zeros((b, l), np.int32)
    for i in range(b):
        for c in cuts[i]:
            ids[i, c:] += 1
    return torch.from_numpy(ids)


@pytest.mark.parametrize(
    "causal,h,hkv,l,d,window,segments,pos_offset,block_q", CASES)
def test_rounded_plain_forward_matches_interpreted_pallas_bf16(
        causal, h, hkv, l, d, window, segments, pos_offset, block_q):
    seed = 1000 * h + 100 * hkv + l + d + (window or 0) + 7 * pos_offset
    rs = np.random.RandomState(seed % 2 ** 31)
    b = 2 if segments else 1
    tq = _bf16(rs.randn(b, h, l, d).astype(np.float32))
    tk, tv = (_bf16(rs.randn(b, hkv, l, d).astype(np.float32))
              for _ in range(2))
    q_seg = k_seg = jseg = None
    if segments == "single":
        q_seg = k_seg = _segments(rs, b, l)
        jseg = jnp.asarray(q_seg.numpy())
    elif segments == "pair":
        # other cuts on the two sides: some rows meet no key of their id
        q_seg, k_seg = _segments(rs, b, l), _segments(rs, b, l) + 1
        jseg = (jnp.asarray(q_seg.numpy()), jnp.asarray(k_seg.numpy()))
    masks = dict(causal=causal, window=window, pos_offset=pos_offset)

    j = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
         for x in (tq, tk, tv)]
    ref_out, ref_lse = jatt.attention_forward_lse(
        *j, block_q=block_q, block_k=l, segments=jseg, **masks)
    ref_out = torch.from_numpy(np.array(ref_out.astype(jnp.float32)))
    ref_lse = torch.from_numpy(np.array(ref_lse))

    plain = dict(masks, q_seg=q_seg, k_seg=k_seg)
    out, lse = tatt.flash_attention_plain(tq, tk, tv, bf16_operands=True,
                                          **plain)
    _eo, exact_lse = tatt.flash_attention_plain(tq, tk, tv, **plain)
    out32, lse32, p, lsum = tatt._flash_plain_f32(
        tq, tk, tv, causal, d ** -0.5, window, q_seg, k_seg, pos_offset,
        True)
    assert out.dtype == torch.bfloat16 and torch.equal(lse, lse32)
    assert torch.equal(out, out32.to(torch.bfloat16))

    empty = lse > 0.5e30
    if segments or pos_offset:
        # JAX snaps a row with no key to lse -1e30; the port's contract
        # gives it out 0 and lse +1e30
        assert torch.equal(empty, ref_lse < -0.5e30)
    else:
        assert not empty.any()
    assert (out[empty.unsqueeze(-1).expand_as(out)] == 0).all()
    live = ~empty
    assert live.any()

    lse_size = ref_lse[live].abs().max()
    lse_err = (lse - ref_lse)[live].abs().max()
    assert lse_err <= TOL * lse_size, "lse: %.3g of %.3g" % (lse_err,
                                                             lse_size)
    rows = live.unsqueeze(-1).expand_as(out)
    out_size = ref_out[rows].abs().max()
    slack = _out_slack(out32, p, lsum, tv, h)
    err = ((out.float() - ref_out).abs() - slack)[rows]
    assert err.max() <= TOL * out_size, "out: %.3g of %.3g" % (err.max(),
                                                               out_size)
    apart = (exact_lse - ref_lse)[live].abs().max() / lse_size
    assert apart > APART, apart


def test_rounding_applies_to_bf16_inputs_only():
    """fp32 inputs are left unrounded, as `_mxu_cast` leaves them; the
    default keeps the fp32 scale and P for bf16 inputs (the CPU path of
    the models), and the rounded constant is JAX's."""
    rs = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rs.randn(1, 2, 32, 64).astype(np.float32))
               for _ in range(3))
    for causal in (True, False):
        a = tatt.flash_attention_plain(q, k, v, causal=causal,
                                       bf16_operands=True)
        b = tatt.flash_attention_plain(q, k, v, causal=causal)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    r = tatt.flash_attention_plain(qb, kb, vb, causal=True,
                                   bf16_operands=True)
    e = tatt.flash_attention_plain(qb, kb, vb, causal=True)
    assert not torch.equal(r[1], e[1])
    for d in (64, 128):
        scale = d ** -0.5
        jax_const = float(jnp.asarray(scale * 1.4426950408889634,
                                      jnp.bfloat16))
        port = torch.tensor(scale * tatt._LOG2E).to(torch.bfloat16).item()
        assert port == jax_const
    assert jax_const == pytest.approx(0.12792969, abs=1e-8)
