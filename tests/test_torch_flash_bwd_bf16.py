"""The port's plain flash backward with bf16 operand rounding against the
JAX package's Pallas backward kernels, bf16 inputs.

The Pallas kernels round P and dS to bf16 before the second products
when the other operand is bf16 (`_mxu_cast`), as the port's card
kernels do; `flash_backward_plain(..., bf16_operands=True)` is the
plain version of that arithmetic. JAX runs `attention_backward_lse`
through its kernels in interpret mode (ELASTICDL_TPU_FORCE_INTERPRET=1,
blocks of 16, or 8 where l is not a multiple of 16), fp32 gradients.
Inputs are bf16 values made by numpy from a seed; `out` is random, so
dS = P (dP - delta) is of the inputs' size under every mask (the
backward is a function of out as of the rest; a window of 1 with the
forward's own out would leave dS at rounding noise). The lse is the
forward's over the bf16 values, fp32; a shifted case takes the ring's
global lse (its own merged with that of a second, unmasked kv shard),
so every row is finite. Limit: |err| <= 1e-5 of max |ref| per
gradient (the two sum in another order; 2e-7 measured), plus, per
element, what rounding-boundary cases can move it: the two sides form
P and dS in fp32 a few last bits apart (another summation order in
q k^T, another exp2), so an element that lies within MIDPOINT_ULPS fp32
units of a bf16 rounding midpoint may round to the neighbouring bf16
value on one side (one such P element, within 4 units of a midpoint,
moved dv by 1.8e-4 of its largest value at l = 80).
Each such element is allowed one bf16 unit of its own, carried through
its product with the other operand's magnitudes; every other element is
held to 1e-5. The unrounded plain version must be more than 1e-4 away in
each case, so the test tells the two roundings apart.
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
D = 16
CASES = [
    # (causal, h, hkv, l, window, packed, pos_offset, block)
    (True, 2, 2, 32, None, False, 0, 16),
    (False, 2, 2, 32, None, False, 0, 16),
    (True, 4, 2, 32, None, False, 0, 16),     # GQA 4/2
    (False, 4, 2, 48, None, False, 0, 16),
    (True, 2, 1, 32, None, False, 0, 16),     # MQA 2/1
    (False, 2, 1, 48, None, False, 0, 16),
    (True, 2, 2, 32, 1, False, 0, 16),        # window 1
    (False, 4, 2, 48, 1, False, 0, 16),
    (True, 4, 2, 48, 37, False, 0, 16),       # window 37
    (False, 2, 1, 48, 37, False, 0, 16),
    (True, 2, 2, 48, None, True, 0, 16),      # packed segments
    (False, 4, 2, 32, None, True, 0, 16),
    (True, 4, 2, 48, 37, True, 0, 16),
    (True, 2, 2, 32, None, False, -16, 16),   # ring offsets
    (False, 2, 1, 32, None, False, 16, 16),
    (True, 4, 2, 32, None, False, 17, 16),
    (False, 2, 1, 48, 37, True, -16, 16),
    (True, 2, 2, 80, None, False, 0, 16),     # ragged against 64-row tiles
    (False, 4, 2, 80, 37, True, 16, 16),
    (True, 2, 2, 40, None, False, 0, 8),      # ragged against 16
]


@pytest.fixture(autouse=True)
def _opt_into_interpreted_kernels(monkeypatch):
    """Off-TPU the JAX package takes its jnp paths (the dense recompute
    keeps P and dS in fp32); these tests hold the port against the
    Pallas kernels themselves, in interpret mode."""
    monkeypatch.setenv("ELASTICDL_TPU_FORCE_INTERPRET", "1")


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _boundary_units(x):
    """One bf16 unit of each element of the fp32 `x` that lies within
    MIDPOINT_ULPS fp32 units of a bf16 rounding midpoint, else 0."""
    low = x.contiguous().view(torch.int32) & 0xFFFF
    near = (low - 0x8000).abs() <= MIDPOINT_ULPS
    unit = torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 8)
    return torch.where(near & (x != 0), unit, torch.zeros_like(x))


def _boundary_slack(q, k, v, out, lse, do, plain):
    """Per gradient element (dq, dk, dv), the most that rounding P or dS
    to the other bf16 neighbour at its boundary elements can move it:
    unit(dS) |K|, unit(dS)^T |Q| and unit(P)^T |dO|, group-summed."""
    f32 = torch.float32
    b, h, _lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    scale = d ** -0.5
    masks = {n: plain[n] for n in ("window", "q_seg", "k_seg",
                                   "pos_offset")}
    p = tatt._recompute_probs(q, k, lse, plain["causal"], scale,
                              exp2=True, **masks)
    g = do.to(f32)
    delta = (g * out.to(f32)).sum(-1)
    dp = g @ tatt.expand_kv(v, h).to(f32).transpose(-1, -2)
    units_ds = _boundary_units(p * (dp - delta[..., None]) * scale)
    units_p = _boundary_units(p)
    slack_q = units_ds @ tatt.expand_kv(k, h).to(f32).abs()
    slack_k = units_ds.transpose(-1, -2) @ q.to(f32).abs()
    slack_v = units_p.transpose(-1, -2) @ g.abs()
    return [slack_q] + [x.reshape(b, hkv, h // hkv, lk, d).sum(2)
                        for x in (slack_k, slack_v)]


def _segments(rs, b, l):
    """Ragged runs of 2-5 ids per row."""
    cuts = np.sort(rs.randint(1, l, size=(b, 4)), axis=1)
    ids = np.zeros((b, l), np.int32)
    for i in range(b):
        for c in cuts[i]:
            ids[i, c:] += 1
    return torch.from_numpy(ids)


@pytest.mark.parametrize(
    "causal,h,hkv,l,window,packed,pos_offset,block", CASES)
def test_rounded_plain_matches_interpreted_pallas_bf16(
        causal, h, hkv, l, window, packed, pos_offset, block):
    seed = 1000 * h + 100 * hkv + l + (window or 0) + 7 * pos_offset
    rs = np.random.RandomState(seed % 2 ** 31)
    b = 2 if packed else 1
    tq = _bf16(rs.randn(b, h, l, D).astype(np.float32))
    tk, tv, tk2, tv2 = (_bf16(rs.randn(b, hkv, l, D).astype(np.float32))
                        for _ in range(4))
    tg, tout = (_bf16(rs.randn(b, h, l, D).astype(np.float32))
                for _ in range(2))
    seg = _segments(rs, b, l) if packed else None
    masks = dict(causal=causal, window=window, pos_offset=pos_offset)
    f32 = [x.float() for x in (tq, tk, tv)]
    _o, lse = tatt.attention_forward_lse(*f32, segments=seg, **masks)
    if pos_offset:
        _o2, lse_full = tatt.attention_forward_lse(f32[0], tk2.float(),
                                                   tv2.float())
        lse = torch.logaddexp(lse, lse_full)

    j = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
         for x in (tq, tk, tv, tout, tg)]
    ref = jatt.attention_backward_lse(
        j[0], j[1], j[2], j[3], jnp.asarray(lse.numpy()), j[4],
        block_q=block, block_k=block, grad_dtype=jnp.float32,
        segments=None if seg is None else jnp.asarray(seg.numpy()),
        **masks)
    ref = [np.asarray(x) for x in ref]

    plain = dict(masks, q_seg=seg, k_seg=seg, grad_dtype=torch.float32)
    rounded = tatt.flash_backward_plain(tq, tk, tv, tout, lse, tg,
                                        bf16_operands=True, **plain)
    exact = tatt.flash_backward_plain(tq, tk, tv, tout, lse, tg, **plain)
    slack = _boundary_slack(tq, tk, tv, tout, lse, tg, plain)
    apart = 0.0
    for name, a, e, r, sl in zip(("dq", "dk", "dv"), rounded, exact, ref,
                                 slack):
        assert a.dtype == torch.float32 and a.shape == r.shape, name
        size = np.abs(r).max()
        err = np.abs(a.numpy() - r) - sl.numpy()
        assert err.max() <= TOL * size, "%s: %.3g of %.3g" % (
            name, err.max(), size)
        apart = max(apart, np.abs(e.numpy() - r).max() / size)
    assert apart > APART, apart


def test_rounding_applies_to_bf16_operands_only():
    """fp32 inputs are left unrounded, as `_mxu_cast` leaves them, and
    the default keeps P and dS fp32 for bf16 inputs too."""
    rs = np.random.RandomState(3)
    q, k, v, g, out = (torch.from_numpy(rs.randn(1, 2, 32, D).astype(
        np.float32)) for _ in range(5))
    _o, lse = tatt.attention_forward_lse(q, k, v, causal=True)
    a = tatt.flash_backward_plain(q, k, v, out, lse, g, causal=True,
                                  bf16_operands=True)
    b = tatt.flash_backward_plain(q, k, v, out, lse, g, causal=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    qb, kb, vb, gb, ob = (x.to(torch.bfloat16) for x in (q, k, v, g, out))
    grad = dict(causal=True, grad_dtype=torch.float32)
    r = tatt.flash_backward_plain(qb, kb, vb, ob, lse, gb,
                                  bf16_operands=True, **grad)
    e = tatt.flash_backward_plain(qb, kb, vb, ob, lse, gb, **grad)
    assert not torch.equal(r[0], e[0])
