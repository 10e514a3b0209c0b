"""Attention for the PyTorch port: plain helpers, and the kernels of the
serving and training paths with their plain PyTorch versions.

Counterpart of elasticdl_tpu/ops/attention.py. Layout convention as
there: [batch, heads, seq, head_dim]; k/v may carry fewer heads than q
(grouped-query attention, q head j reads kv head j // group).

Kernels (hand-written CUDA for sm_90a, elasticdl_tpu_torch/csrc/):

* `flash_forward` -> csrc/flash_fwd.cu, the port of `_flash_kernel`
  (wgmma on tensor cores for bf16, with q scaled in bf16 and P rounded
  to bf16 as the TPU kernel does; for fp32 a kernel on the CUDA cores'
  FMAs, with register blocks fed by 16-byte shared-memory loads and
  whole query rows a warp);
* `flash_backward_dq` / `flash_backward_dkv` -> csrc/flash_bwd.cu, the
  ports of `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel` (wgmma on
  tensor cores for bf16, with P and dS rounded to bf16 before the
  second products as the TPU kernels' `_mxu_cast` does; fp32 kernels on
  the CUDA cores' FMAs for fp32), joined by `flash_backward` and
  wrapped with the forward in `FlashAttentionFunction` (the JAX
  package's `jax.custom_vjp`);
* `paged_decode_partials` -> csrc/paged_decode.cu, the port of
  `_paged_kernel`: its split kernel for up to SPLIT_MAX_ROWS query rows
  per (sequence, kv head), its tile kernel (32-key tiles staged by
  cp.async, register micro tiles) for larger query tiles; each cuts a
  sequence's live keys across the blocks of one thread-block cluster,
  which merges their partials in one launch; fp32 or bf16 arenas, or
  int8 arenas with fp32 per-row scale pools (the TPU kernel's quantized
  branch).

The flash kernels take the TPU kernels' masks: causal, a sliding
`window` (key tiles outside every row's window are never read, so the
work grows with the window, not the sequence), packed `segments`
(per-row ids; a query sees keys of its own id only) and ring
attention's `pos_offset` (the query rows sit at positions row +
pos_offset in the causal and window tests, as a rotation that holds an
older or newer kv shard sees them). The paged kernels take the `window`
of a sliding-window model: tile row j (token j % t of the group-major
query axis) sees pool rows k_pos > length + j - window.

`attention_forward_lse` / `attention_backward_lse` and `lse_merge` are
the per-rotation entry points of ring attention
(elasticdl_tpu_torch/parallel/context_parallel.py): the forward's empty
rows come back with lse exactly -1e30 there, so a merge gives them no
weight, and the backward takes the ring's global lse and can write its
gradients in fp32.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs
its plain version (`flash_attention_plain`, `flash_backward_dq_plain`,
`flash_backward_dkv_plain`, `paged_decode_partials_plain`) for CPU
tensors. `KERNEL_LAUNCHES` counts kernel launches per wrapper and
variant.
"""

import ctypes

import torch

from elasticdl_tpu_torch.ops import _build
from elasticdl_tpu_torch.ops.dispatch import on_kernel_path

# Finite masking sentinel, as in the JAX package: -inf would turn
# exp(m - m_new) into NaN for a row that has seen no key yet.
_NEG_INF = -1e30
NEG_INF = _NEG_INF
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453


def _variant(base, window=None, segments=False, offset=False):
    """The launch-count name of a kernel variant: "flash_fwd",
    "flash_fwd_window", "flash_fwd_segments", "flash_fwd_window_segments",
    each with "_offset" appended for a nonzero pos_offset (the paged
    names take "_window" only)."""
    return base + ("_window" if window else "") + (
        "_segments" if segments else "") + ("_offset" if offset else "")


_FLASH_BASES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
_PAGED_BASES = ("paged_decode", "paged_decode_tile", "paged_decode_int8",
                "paged_decode_tile_int8")
#: kernel launches per wrapper and variant; chip_smoke.py resets and
#: reads these to show that the serving and training paths went through
#: the kernels (paged decode over int8 arenas counts under its own
#: "_int8" names, a windowed, packed or shifted launch under "_window" /
#: "_segments" / "_offset")
KERNEL_LAUNCHES = dict.fromkeys(
    [_variant(n, w, s, o) for n in _FLASH_BASES for w in (0, 1)
     for s in (False, True) for o in (False, True)]
    + [_variant(n, w) for n in _PAGED_BASES for w in (0, 1)], 0)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PAGED_DTYPE_CODES = {**_DTYPE_CODES, torch.int8: 2}
_HEAD_DIMS = (64, 128)
# query rows per (sequence, kv head) up to which paged decode takes the
# split kernel; larger tiles take the shared-memory tile kernel
SPLIT_MAX_ROWS = 8


def reset_launch_counts():
    for name in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[name] = 0


# ------------------------------------------------------------ plain helpers


def softmax_merge(o, l, m, s, v_blk, w_scale=None):
    """One online-softmax accumulation step: merge scores `s`
    [b,h,q,k_blk] and values `v_blk` [b,h,k_blk,d] into the running
    (output, denominator, rowmax) triple. `w_scale` [b,h,k_blk]
    (int8 values' per-row scales) multiplies the weights in the value
    product only: the denominator `l` normalizes probabilities, which
    the dequantize does not change."""
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1)
    pv = p if w_scale is None else p * w_scale[..., None, :]
    o_new = o * corr[..., None] + torch.matmul(pv, v_blk)
    return o_new, l_new, m_new


def softmax_finalize(o, l):
    return o / torch.clamp(l, min=1e-30)[..., None]


def group_size(q, k):
    """Grouped-query group size: q heads per kv head."""
    h, hkv = q.shape[1], k.shape[1]
    if h % hkv:
        raise ValueError(
            "grouped-query attention needs num_heads %% num_kv_heads "
            "== 0, got %d q heads / %d kv heads" % (h, hkv)
        )
    return h // hkv


def expand_kv(kv, num_heads):
    """Broadcast grouped-query K/V [b, hkv, l, d] to the full q head
    count (head j reads kv head j // group)."""
    hkv = kv.shape[1]
    if hkv == num_heads:
        return kv
    if num_heads % hkv:
        raise ValueError(
            "cannot expand %d kv heads to %d q heads" % (hkv, num_heads)
        )
    return kv.repeat_interleave(num_heads // hkv, dim=1)


def _check_window(window, lq, lk):
    """Sliding windows are defined for square self-attention and window
    >= 1, where every row sees at least its own key (the JAX package's
    `_check_window`)."""
    if window is None:
        return
    if window < 1:
        raise ValueError("window must be >= 1, got %r" % (window,))
    if lq != lk:
        raise ValueError(
            "sliding-window attention requires square self-attention "
            "(lq == lk), got lq=%d lk=%d" % (lq, lk)
        )


def _check_segments(segments, b, lq, lk, device=None):
    """The packing mask argument as (q_seg [b, lq], k_seg [b, lk]) int32
    on `device`, or None (the JAX package's `_check_segments`). One [b,
    l] id array is square self-attention, where every row sees itself; a
    (q_seg, k_seg) pair may leave rows with no visible key."""
    if segments is None:
        return None
    if isinstance(segments, (tuple, list)):
        if len(segments) != 2:
            raise ValueError(
                "segments pair must be (q_seg, k_seg), got %d items"
                % len(segments)
            )
        q_seg, k_seg = segments
    else:
        if lq != lk:
            raise ValueError(
                "a single segments array requires square self-attention "
                "(lq == lk), got lq=%d lk=%d; pass a (q_seg, k_seg) pair "
                "for rectangular shapes" % (lq, lk)
            )
        q_seg = k_seg = segments
    q_seg, k_seg = (torch.as_tensor(x).to(device=device, dtype=torch.int32)
                    for x in (q_seg, k_seg))
    if q_seg.shape != (b, lq) or k_seg.shape != (b, lk):
        raise ValueError(
            "segments must be [batch, seq]: q side (%d, %d), k side (%d, "
            "%d); got %r / %r" % (b, lq, b, lk, tuple(q_seg.shape),
                                  tuple(k_seg.shape))
        )
    return q_seg, k_seg


def packed_positions(segments):
    """Per-token positions that restart at each segment boundary:
    segments [..., l] of contiguous same-id runs -> int32 of the same
    shape, each token's offset within its own run (what RoPE and the
    learned position table see for packed rows)."""
    seg = torch.as_tensor(segments)
    l = seg.shape[-1]
    idx = torch.arange(l, device=seg.device).expand(seg.shape)
    is_start = torch.ones_like(seg, dtype=torch.bool)
    is_start[..., 1:] = seg[..., 1:] != seg[..., :-1]
    starts = torch.cummax(torch.where(is_start, idx, torch.zeros_like(idx)),
                          dim=-1).values
    return (idx - starts).to(torch.int32)


def _visible(lq, lk, causal, window, q_seg=None, k_seg=None, device=None,
             pos_offset=0):
    """[b or 1, 1, lq, lk] bool: the (query, key) pairs the causal,
    window and segment masks keep, query row i at position i +
    `pos_offset` (the JAX package's `_block_mask_apply` and segment
    compare)."""
    q_pos = torch.arange(lq, device=device)[:, None] + pos_offset
    k_pos = torch.arange(lk, device=device)[None, :]
    keep = torch.ones((lq, lk), dtype=torch.bool, device=device)
    if causal:
        keep &= q_pos >= k_pos
    if window is not None:
        keep &= q_pos - k_pos < window
        if not causal:
            keep &= k_pos - q_pos < window
    keep = keep[None, None]
    if q_seg is not None:
        keep = keep & (q_seg[:, :, None] == k_seg[:, None, :])[:, None]
    return keep


def naive_attention(q, k, v, causal=False, scale=None, window=None,
                    segments=None):
    """Reference softmax(q k^T) v, O(L^2) memory: the test oracle.
    `window`: a query at p sees keys in (p - window, p] when causal,
    |p - k| < window otherwise. `segments` [b, l] (or a (q_seg, k_seg)
    pair): attention stays within same-id runs."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    lq, lk = q.shape[2], k.shape[2]
    _check_window(window, lq, lk)
    segs = _check_segments(segments, q.shape[0], lq, lk, q.device)
    k = expand_kv(k, q.shape[1])
    v = expand_kv(v, q.shape[1])
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    keep = _visible(lq, lk, causal, window, *(segs or ()), device=q.device)
    scores = torch.where(keep, scores, torch.full_like(scores, _NEG_INF))
    return torch.matmul(torch.softmax(scores, dim=-1), v)


def apply_rope(x, positions, theta=10000.0):
    """Rotary position embedding over the head dimension. x: [b, h, l,
    d]; positions: [l] or [b, l]. Rotates feature pairs (i, i + d/2) by
    positions * theta^(-2i/d); math in fp32, result in x.dtype; an odd
    tail feature passes through."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    angles = positions.to(torch.float32)[..., :, None] * freqs
    if positions.dim() == 1:
        cos, sin = torch.cos(angles)[None, None], torch.sin(angles)[None, None]
    else:
        cos, sin = torch.cos(angles)[:, None], torch.sin(angles)[:, None]
    xf = x.to(torch.float32)
    x1, x2 = xf[..., :half], xf[..., half:2 * half]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if d % 2:
        rot = torch.cat([rot, xf[..., 2 * half:]], dim=-1)
    return rot.to(x.dtype)


def _check_launch(err, name):
    if err != 0:
        raise RuntimeError(
            "%s kernel launch failed: cudaError %d" % (name, err)
        )


def _check_kernel_args(name, tensors, dtypes, d):
    for t in tensors:
        if t.dtype not in dtypes:
            raise TypeError(
                "%s kernel takes %s, got %s"
                % (name, [str(x) for x in dtypes], t.dtype)
            )
        if not t.is_contiguous():
            raise ValueError("%s kernel takes contiguous tensors" % name)
    if d not in _HEAD_DIMS:
        raise ValueError(
            "%s kernel supports head_dim %s, got %d" % (name, _HEAD_DIMS, d)
        )
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("%s kernel takes tensors on one device" % name)


# ------------------------------------------------------------------ flash


def flash_attention_plain(q, k, v, causal=False, scale=None, window=None,
                          q_seg=None, k_seg=None, pos_offset=0,
                          bf16_operands=False):
    """Plain PyTorch version of the flash kernel: (out in q.dtype, lse
    fp32 [b, h, lq]). Scores and softmax in fp32; masked scores (causal,
    `window`, segment ids `q_seg` [b, lq] / `k_seg` [b, lk], query rows
    at positions row + `pos_offset`) contribute exactly 0, an empty row
    gives out 0 and lse +1e30 (the kernel's convention,
    attention.py:1000-1004 in the JAX package).

    `bf16_operands`: with bf16 inputs, the arithmetic of the Pallas
    kernel (`_flash_kernel`, :964-981) and of the card's bf16 kernel:
    q is scaled in bf16 by the bf16-rounded constant scale * log2 e
    (JAX's weak typing rounds the Python float to q's dtype), S = q_s
    K^T in fp32 is in log2 units, P = exp2(S - m) with the row max m,
    l = rowsum(P) from the unrounded P, and P is rounded to bf16 before
    P V (`_mxu_cast`); lse = (m + log2 l) ln 2. The default keeps the
    scale and P in fp32, as the CPU paths of the models run it; fp32
    inputs are never rounded."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    group_size(q, k)
    out, lse, _p, _l = _flash_plain_f32(
        q, k, v, causal, scale, window, q_seg, k_seg, pos_offset,
        bf16_operands and q.dtype == torch.bfloat16)
    return out.to(q.dtype), lse


def _flash_plain_f32(q, k, v, causal, scale, window, q_seg, k_seg,
                     pos_offset, rounded):
    """`flash_attention_plain`'s arithmetic, `rounded` its bf16 branch:
    (out fp32 before the cast to q.dtype, lse, P fp32 [b, h, lq, lk]
    before any rounding, l = rowsum(P))."""
    f32 = torch.float32
    kf = expand_kv(k, q.shape[1]).to(f32)
    vf = expand_kv(v, q.shape[1]).to(f32)
    if rounded:
        const = torch.tensor(scale * _LOG2E).to(torch.bfloat16).to(f32)
        qs = (q.to(f32) * const).to(torch.bfloat16).to(f32)
        s = torch.matmul(qs, kf.transpose(-1, -2))
    else:
        s = torch.matmul(q.to(f32), kf.transpose(-1, -2)) * scale
    valid = _visible(q.shape[2], k.shape[2], causal, window, q_seg, k_seg,
                     device=q.device, pos_offset=pos_offset)
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    mx = s.amax(-1, keepdim=True)
    exp = torch.exp2 if rounded else torch.exp
    p = torch.where(valid, exp(s - mx), torch.zeros_like(s))
    l = p.sum(-1)
    l_safe = torch.clamp(l, min=1e-30)
    out = torch.matmul(_operand_round(p, v.dtype, rounded), vf) / l_safe[
        ..., None]
    lse = ((mx[..., 0] + torch.log2(l_safe)) * _LN2 if rounded
           else mx[..., 0] + torch.log(l_safe))
    lse = torch.where(l > 0, lse, torch.full_like(l, -_NEG_INF))
    return out, lse, p, l


def _seg_args(q, k, q_seg, k_seg):
    """(q_seg [b, lq], k_seg [b, lk]) as contiguous int32 on q's device,
    or (None, None); both or neither."""
    if (q_seg is None) != (k_seg is None):
        raise ValueError("segment ids need both q_seg and k_seg")
    if q_seg is None:
        return None, None
    segs = _check_segments((q_seg, k_seg), q.shape[0], q.shape[2],
                           k.shape[2], q.device)
    return tuple(x.contiguous() for x in segs)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _window_arg(window, lq, lk):
    """The kernels' window int (0 = none), validated."""
    _check_window(window, lq, lk)
    return 0 if window is None else int(window)


def flash_forward(q, k, v, causal=False, scale=None, window=None,
                  q_seg=None, k_seg=None, pos_offset=0):
    """(out [b, h, lq, d] in q.dtype, lse fp32 [b, h, lq]) of tiled
    online-softmax attention under the causal, `window` and segment
    masks, query rows at positions row + `pos_offset`: the
    csrc/flash_fwd.cu kernel for CUDA tensors, `flash_attention_plain`
    for CPU tensors. For bf16 inputs the kernel multiplies on tensor
    cores with q scaled in bf16 and P rounded to bf16, as the TPU
    kernel does (`flash_attention_plain(..., bf16_operands=True)`);
    fp32 inputs run the fp32 kernel with no such rounding."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    group_size(q, k)
    win = _window_arg(window, q.shape[2], k.shape[2])
    q_seg, k_seg = _seg_args(q, k, q_seg, k_seg)
    pos_offset = int(pos_offset)
    if not on_kernel_path(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     window=window, q_seg=q_seg, k_seg=k_seg,
                                     pos_offset=pos_offset)
    b, h, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    q, k, v = (_aligned16(t.contiguous()) for t in (q, k, v))
    _check_kernel_args("flash_fwd", (q, k, v), tuple(_DTYPE_CODES), d)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_fwd kernel takes q, k, v of one dtype")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = _flash_lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.edl_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _ptr(q_seg), _ptr(k_seg), b, h, hkv, lq, lk, d,
        float(scale), int(causal), win, pos_offset, _DTYPE_CODES[q.dtype],
        stream,
    )
    name = _variant("flash_fwd", win, q_seg is not None, pos_offset != 0)
    _check_launch(err, name)
    KERNEL_LAUNCHES[name] += 1
    return out, lse


def _flash_lib():
    lib = _build.load("flash_fwd")
    fn = lib.edl_flash_fwd
    if not fn.argtypes:
        fn.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
            + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def _fully_masked_rows(q_seg, k_seg, causal, window, lq, lk, chunk=2048,
                       pos_offset=0):
    """[b, lq] bool: rows with no visible key under the segment, causal
    and window masks, query row i at position i + `pos_offset` (the JAX
    package's `_fully_masked_rows`), reduced over key chunks so the pair
    mask never exceeds [b, lq, chunk]."""
    q_pos = torch.arange(lq, device=q_seg.device)[:, None] + pos_offset
    seen = torch.zeros(q_seg.shape, dtype=torch.bool, device=q_seg.device)
    for k_lo in range(0, lk, chunk):
        k_pos = torch.arange(k_lo, min(lk, k_lo + chunk),
                             device=q_seg.device)[None, :]
        keep = q_seg[:, :, None] == k_seg[:, None, k_lo:k_lo + chunk]
        if causal:
            keep = keep & (q_pos >= k_pos)
        if window is not None:
            keep = keep & (q_pos - k_pos < window)
            if not causal:
                keep = keep & (k_pos - q_pos < window)
        seen |= keep.any(-1)
    return ~seen


def flash_attention(q, k, v, causal=False, scale=None, window=None,
                    segments=None, pos_offset=0):
    """Tiled online-softmax attention, [b, h, lq, d] in q.dtype: the JAX
    package's `flash_attention`. `window`: sliding-window attention
    (see naive_attention), square shapes only. `segments`: one [b, l]
    id array (square) or a (q_seg, k_seg) pair; attention stays within
    same-id keys in the forward and the backward, and under the pair
    form a row with no visible key returns exactly 0 with zero gradient.
    `pos_offset` shifts the query positions (row + pos_offset) in the
    causal and window tests, as a ring rotation sees them; a row it
    leaves with no visible key returns exactly 0 with zero gradient (the
    kernels' empty-row contract).
    When autograd records (grad mode on and an input requires grad) it
    runs through `FlashAttentionFunction`, whose backward is the flash
    backward; otherwise (serving, under no_grad) it calls
    `flash_forward` alone."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    pos_offset = int(pos_offset)
    pair_form = isinstance(segments, (tuple, list))
    lq, lk = q.shape[2], k.shape[2]
    group_size(q, k)
    _check_window(window, lq, lk)
    segs = _check_segments(segments, q.shape[0], lq, lk, q.device)
    q_seg, k_seg = segs or (None, None)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out = FlashAttentionFunction.apply(q, k, v, bool(causal),
                                           float(scale), window, q_seg,
                                           k_seg, pos_offset)
    else:
        out = flash_forward(q, k, v, causal=causal, scale=scale,
                            window=window, q_seg=q_seg, k_seg=k_seg,
                            pos_offset=pos_offset)[0]
    if pair_form:
        masked = _fully_masked_rows(q_seg, k_seg, causal, window, lq, lk,
                                    pos_offset=pos_offset)
        out = torch.where(masked[:, None, :, None], torch.zeros_like(out),
                          out)
    return out


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its flash backward: the port of the JAX
    package's `_flash` custom_vjp (`_flash_fwd` saves q, k, v, out and
    the lse; `_flash_bwd` runs the two backward kernels). Inputs are
    made contiguous once here, so the backward's kernels read the saved
    tensors as they are. The window and the segment ids are not
    differentiable (the JAX side returns float0 for the ids)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window=None, q_seg=None,
                k_seg=None, pos_offset=0):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_forward(q, k, v, causal=causal, scale=scale,
                                 window=window, q_seg=q_seg, k_seg=k_seg,
                                 pos_offset=pos_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.window = causal, scale, window
        ctx.segs = (q_seg, k_seg)
        ctx.pos_offset = pos_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        q_seg, k_seg = ctx.segs
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout.contiguous(),
                                    causal=ctx.causal, scale=ctx.scale,
                                    window=ctx.window, q_seg=q_seg,
                                    k_seg=k_seg, pos_offset=ctx.pos_offset)
        return dq, dk, dv, None, None, None, None, None, None


# --------------------------------------------------------- flash backward


def _recompute_probs(q, k, lse, causal, scale, window=None, q_seg=None,
                     k_seg=None, pos_offset=0, exp2=False):
    """P = exp(q k^T * scale - lse) in fp32 over the expanded kv heads,
    exactly 0 at masked pairs and on rows whose lse is a sentinel: the
    +1e30 of an empty row, or the -1e30 class the TPU kernels give a row
    the pair form masks fully (their backward zeroes it, :1277).
    `exp2`: as the Pallas kernels and the card's bf16 kernels form it,
    exp2(q k^T * (scale * log2 e) - lse * log2 e), so that P rounds to
    the same bf16 value where it is rounded (the two forms can differ
    in the last bits of fp32)."""
    f32 = torch.float32
    kf = expand_kv(k, q.shape[1]).to(f32)
    s = torch.matmul(q.to(f32), kf.transpose(-1, -2))
    lse = lse.to(f32)[..., None]
    if exp2:
        p = torch.exp2(s * (scale * _LOG2E) - lse * _LOG2E)
    else:
        p = torch.exp(s * scale - lse)
    keep = _visible(q.shape[2], k.shape[2], causal, window, q_seg, k_seg,
                    device=q.device, pos_offset=pos_offset) & (
                        lse > 0.5 * _NEG_INF)
    return torch.where(keep, p, torch.zeros_like(s))


def _operand_round(x, operand_dtype, bf16_operands):
    """The JAX package's `_mxu_cast` (:927) with `bf16_operands`: an fp32
    P or dS rounded to bf16 (and read back as fp32) when the other
    operand of its product is bf16, as the TPU kernels and the card's
    bf16 kernels multiply them; unchanged otherwise."""
    if bf16_operands and operand_dtype == torch.bfloat16:
        return x.to(torch.bfloat16).to(torch.float32)
    return x


def flash_backward_dq_plain(q, k, v, out, lse, do, causal=False, scale=None,
                            window=None, q_seg=None, k_seg=None,
                            pos_offset=0, grad_dtype=None,
                            bf16_operands=False):
    """Plain PyTorch version of the dq kernel: (dq in `grad_dtype` or
    q.dtype, delta fp32 [b, h, lq]). delta = rowsum(dO * O) in fp32 (the
    JAX package's `_flash_backward` :1383), dS = P * (dP - delta) *
    scale with dP = dO V^T, dQ = dS K (the dense recompute at
    :1731-1769). `bf16_operands`: with bf16 inputs, dS is rounded to
    bf16 before dS K, as the Pallas kernel and the card's kernel do;
    the default keeps it fp32, as the dense recompute does."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    f32 = torch.float32
    p = _recompute_probs(q, k, lse, causal, scale, window, q_seg, k_seg,
                         pos_offset,
                         exp2=bf16_operands and q.dtype == torch.bfloat16)
    gf = do.to(f32)
    delta = (gf * out.to(f32)).sum(-1)
    dp = torch.matmul(gf, expand_kv(v, q.shape[1]).to(f32).transpose(-1, -2))
    ds = _operand_round(p * (dp - delta[..., None]) * scale, k.dtype,
                        bf16_operands)
    dq = torch.matmul(ds, expand_kv(k, q.shape[1]).to(f32))
    return dq.to(grad_dtype or q.dtype), delta


def flash_backward_dkv_plain(q, k, v, do, lse, delta, causal=False,
                             scale=None, window=None, q_seg=None,
                             k_seg=None, pos_offset=0, grad_dtype=None,
                             bf16_operands=False):
    """Plain PyTorch version of the dk/dv kernel: (dk, dv) in
    `grad_dtype` or the k/v dtypes, group-summed to the kv head count
    under GQA. dV = P^T dO, dK = dS^T Q, with `delta` as the dq kernel
    returns it. `bf16_operands`: with bf16 inputs, P and dS are rounded
    to bf16 before those two products (dS formed from the unrounded P),
    as the Pallas kernel and the card's kernel do."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    b, h, _lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    f32 = torch.float32
    p = _recompute_probs(q, k, lse, causal, scale, window, q_seg, k_seg,
                         pos_offset,
                         exp2=bf16_operands and q.dtype == torch.bfloat16)
    gf = do.to(f32)
    dv = torch.matmul(
        _operand_round(p, do.dtype, bf16_operands).transpose(-1, -2), gf)
    dp = torch.matmul(gf, expand_kv(v, h).to(f32).transpose(-1, -2))
    ds = _operand_round(p * (dp - delta.to(f32)[..., None]) * scale,
                        q.dtype, bf16_operands)
    dk = torch.matmul(ds.transpose(-1, -2), q.to(f32))
    if h != hkv:
        dk = dk.reshape(b, hkv, h // hkv, lk, d).sum(2)
        dv = dv.reshape(b, hkv, h // hkv, lk, d).sum(2)
    return dk.to(grad_dtype or k.dtype), dv.to(grad_dtype or v.dtype)


def flash_backward_plain(q, k, v, out, lse, do, causal=False, scale=None,
                         window=None, q_seg=None, k_seg=None, pos_offset=0,
                         grad_dtype=None, bf16_operands=False):
    """Plain PyTorch version of the flash backward: (dq, dk, dv) in
    `grad_dtype` or the input dtypes; the counterpart of
    `attention_backward_lse`'s dense recompute in the JAX package, or,
    with `bf16_operands`, of its Pallas kernels' rounding (P and dS
    rounded to bf16 before the second products for bf16 inputs)."""
    group_size(q, k)
    masks = dict(window=window, q_seg=q_seg, k_seg=k_seg,
                 pos_offset=pos_offset, grad_dtype=grad_dtype,
                 bf16_operands=bf16_operands)
    dq, delta = flash_backward_dq_plain(q, k, v, out, lse, do, causal=causal,
                                        scale=scale, **masks)
    dk, dv = flash_backward_dkv_plain(q, k, v, do, lse, delta, causal=causal,
                                      scale=scale, **masks)
    return dq, dk, dv


def flash_backward(q, k, v, out, lse, do, causal=False, scale=None,
                   window=None, q_seg=None, k_seg=None, pos_offset=0,
                   grad_dtype=None):
    """(dq, dk, dv) of flash attention from its saved lse, in
    `grad_dtype` (None or torch.float32) or the input dtypes; under GQA
    dk and dv come back group-summed in the kv head count. CUDA tensors
    run the two csrc/flash_bwd.cu kernels (dq first: it also writes
    delta, which the dk/dv kernel reads), CPU tensors the plain
    version. For bf16 inputs the kernels multiply on tensor cores with P
    and dS rounded to bf16 before the second products, as the TPU
    kernels do (`flash_backward_plain(..., bf16_operands=True)`); fp32
    inputs run fp32 kernels with no such rounding."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    group_size(q, k)
    masks = dict(window=window, q_seg=q_seg, k_seg=k_seg,
                 pos_offset=pos_offset, grad_dtype=grad_dtype)
    if not on_kernel_path(q, k, v, out, lse, do):
        return flash_backward_plain(q, k, v, out, lse, do, causal=causal,
                                    scale=scale, **masks)
    dq, delta = flash_backward_dq(q, k, v, out, lse, do, causal=causal,
                                  scale=scale, **masks)
    dk, dv = flash_backward_dkv(q, k, v, do, lse, delta, causal=causal,
                                scale=scale, **masks)
    return dq, dk, dv


def _bwd_args(name, q, k, v, do, lse, extra=()):
    b, h, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, lk, d) or v.shape != k.shape:
        raise ValueError("%s: k/v %s / %s do not match q %s" % (
            name, tuple(k.shape), tuple(v.shape), tuple(q.shape)))
    if do.shape != q.shape or lse.shape != (b, h, lq):
        raise ValueError("%s: dO must be like q and lse [b, h, lq]" % name)
    _check_kernel_args(name, (q, k, v, do, *extra), tuple(_DTYPE_CODES), d)
    if any(t.dtype != q.dtype for t in (k, v, do, *extra)):
        raise TypeError("%s kernel takes q, k, v, out, dO of one dtype"
                        % name)
    _check_kernel_args(name, (lse,), (torch.float32,), d)
    return b, h, hkv, lq, lk, d


def _aligned16(t):
    """`t`, or a copy of it where its data does not start on a 16-byte
    boundary (the flash kernels copy rows 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _grad_f32(grad_dtype, dtype):
    """The kernels' grad_f32 flag: gradients in fp32 (1) or in the
    input dtype (0); they write no other dtype."""
    if grad_dtype is None or grad_dtype == dtype:
        return 0
    if grad_dtype == torch.float32:
        return 1
    raise TypeError("flash backward kernels write gradients in the input "
                    "dtype or float32, not %s" % grad_dtype)


def flash_backward_dq(q, k, v, out, lse, do, causal=False, scale=None,
                      window=None, q_seg=None, k_seg=None, pos_offset=0,
                      grad_dtype=None):
    """(dq in `grad_dtype` or q.dtype, delta fp32 [b, h, lq]): the
    csrc/flash_bwd.cu dq kernel for CUDA tensors,
    `flash_backward_dq_plain` for CPU tensors."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    win = _window_arg(window, q.shape[2], k.shape[2])
    q_seg, k_seg = _seg_args(q, k, q_seg, k_seg)
    pos_offset = int(pos_offset)
    if not on_kernel_path(q, k, v, out, lse, do):
        return flash_backward_dq_plain(q, k, v, out, lse, do, causal=causal,
                                       scale=scale, window=window,
                                       q_seg=q_seg, k_seg=k_seg,
                                       pos_offset=pos_offset,
                                       grad_dtype=grad_dtype)
    q, k, v, out, do = (_aligned16(t.contiguous())
                        for t in (q, k, v, out, do))
    lse = lse.contiguous()
    b, h, hkv, lq, lk, d = _bwd_args("flash_bwd_dq", q, k, v, do, lse,
                                     (out,))
    f32 = _grad_f32(grad_dtype, q.dtype)
    dq = torch.empty_like(q, dtype=torch.float32 if f32 else q.dtype)
    delta = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    if dq.numel() == 0:
        return dq, delta
    err = _bwd_lib().edl_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dq.data_ptr(), delta.data_ptr(),
        _ptr(q_seg), _ptr(k_seg), b, h, hkv, lq, lk, d, float(scale),
        int(causal), win, pos_offset, _DTYPE_CODES[q.dtype], f32,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    name = _variant("flash_bwd_dq", win, q_seg is not None, pos_offset != 0)
    _check_launch(err, name)
    KERNEL_LAUNCHES[name] += 1
    return dq, delta


def flash_backward_dkv(q, k, v, do, lse, delta, causal=False, scale=None,
                       window=None, q_seg=None, k_seg=None, pos_offset=0,
                       grad_dtype=None):
    """(dk, dv) in `grad_dtype` or the k/v dtype, group-summed under
    GQA: the csrc/flash_bwd.cu dk/dv kernel for CUDA tensors (one block
    per key tile and kv head walks every q head of its group, so the sum
    needs no atomics), `flash_backward_dkv_plain` for CPU tensors."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    win = _window_arg(window, q.shape[2], k.shape[2])
    q_seg, k_seg = _seg_args(q, k, q_seg, k_seg)
    pos_offset = int(pos_offset)
    if not on_kernel_path(q, k, v, do, lse, delta):
        return flash_backward_dkv_plain(q, k, v, do, lse, delta,
                                        causal=causal, scale=scale,
                                        window=window, q_seg=q_seg,
                                        k_seg=k_seg, pos_offset=pos_offset,
                                        grad_dtype=grad_dtype)
    q, k, v, do = (_aligned16(t.contiguous()) for t in (q, k, v, do))
    lse, delta = lse.contiguous(), delta.contiguous()
    b, h, hkv, lq, lk, d = _bwd_args("flash_bwd_dkv", q, k, v, do, lse)
    if delta.shape != lse.shape or delta.dtype != torch.float32:
        raise ValueError("flash_bwd_dkv: delta must be fp32 like lse")
    f32 = _grad_f32(grad_dtype, q.dtype)
    dk = torch.empty_like(k, dtype=torch.float32 if f32 else k.dtype)
    dv = torch.empty_like(v, dtype=dk.dtype)
    if dk.numel() == 0:
        return dk, dv
    err = _bwd_lib().edl_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _ptr(q_seg), _ptr(k_seg), b, h, hkv, lq, lk, d, float(scale),
        int(causal), win, pos_offset, _DTYPE_CODES[q.dtype], f32,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    name = _variant("flash_bwd_dkv", win, q_seg is not None,
                    pos_offset != 0)
    _check_launch(err, name)
    KERNEL_LAUNCHES[name] += 1
    return dk, dv


def _bwd_lib():
    lib = _build.load("flash_bwd")
    for name in ("edl_flash_bwd_dq", "edl_flash_bwd_dkv"):
        fn = getattr(lib, name)
        if not fn.argtypes:
            fn.argtypes = (
                [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
    return lib


# ------------------------------------------------ ring attention's entries


def lse_merge(o, lse, o_i, lse_i):
    """Merge two normalized attention partials (o [b, h, lq, d], lse [b,
    h, lq]) over the same queries and disjoint key sets: the combine step
    of ring attention (the JAX package's `lse_merge`). A partial with
    lse_i = -1e30 (a row that saw no key) gets weight 0. fp32."""
    lse_new = torch.logaddexp(lse, lse_i)
    w = torch.exp(lse - lse_new)[..., None]
    w_i = torch.exp(lse_i - lse_new)[..., None]
    return o * w + o_i * w_i, lse_new


def attention_forward_lse(q, k, v, causal=False, scale=None, segments=None,
                          pos_offset=0, window=None):
    """(out [b, h, lq, d] in q.dtype, lse fp32 [b, h, lq]) through
    `flash_forward` (the kernel on CUDA): the JAX package's
    `attention_forward_lse`. `segments`: one [b, l] id array or a
    (q_seg, k_seg) pair (a ring rotation's). Whenever segments or an
    offset are given, a row can see no key; its out is 0 and its lse
    comes back exactly -1e30 (every |lse| > 0.5e30 is snapped, as JAX
    snaps its kernel's sentinels), so `lse_merge` gives it no weight."""
    lq, lk = q.shape[2], k.shape[2]
    _check_window(window, lq, lk)
    segs = _check_segments(segments, q.shape[0], lq, lk, q.device)
    q_seg, k_seg = segs or (None, None)
    out, lse = flash_forward(q, k, v, causal=causal, scale=scale,
                             window=window, q_seg=q_seg, k_seg=k_seg,
                             pos_offset=pos_offset)
    if segs is not None or pos_offset:
        lse = torch.where(lse.abs() > -0.5 * _NEG_INF,
                          torch.full_like(lse, _NEG_INF), lse)
    return out, lse


def attention_backward_lse(q, k, v, out, lse, g, causal=False, scale=None,
                           grad_dtype=None, segments=None, pos_offset=0,
                           window=None):
    """(dq, dk, dv) of attention given a saved lse, through the two
    flash backward kernels on CUDA (the JAX package's
    `attention_backward_lse`). `lse` may be a ring's global lse while
    k/v are one shard: P = exp(q k^T * scale - lse) is then this shard's
    slice of the global softmax, and `out` / `g` (the global output and
    its cotangent) enter through delta = rowsum(g * out). A row that
    sees no key of the shard gets P = 0 and contributes nothing.
    `grad_dtype` (None or torch.float32) overrides the input dtypes of
    the results; under GQA dk and dv come back group-summed."""
    lq, lk = q.shape[2], k.shape[2]
    _check_window(window, lq, lk)
    segs = _check_segments(segments, q.shape[0], lq, lk, q.device)
    q_seg, k_seg = segs or (None, None)
    return flash_backward(q, k, v, out, lse, g, causal=causal, scale=scale,
                          window=window, q_seg=q_seg, k_seg=k_seg,
                          pos_offset=pos_offset, grad_dtype=grad_dtype)


# ----------------------------------------------------------- paged decode


def _paged_valid(k_pos, bid, length, row_pos, window):
    """The paged-decode visibility predicate (the JAX package's
    `_paged_valid`), all operands broadcasting: a pool row at absolute
    position `k_pos` in block `bid` (-1 = unallocated) is visible to a
    query row at `row_pos` iff k_pos < length, bid >= 0 and, under a
    sliding window, k_pos > row_pos - window."""
    valid = (k_pos < length) & (bid >= 0)
    if window is not None:
        valid = valid & (k_pos > row_pos - window)
    return valid


def _tile_causal_mask(group, t, window=None, device=None):
    """[group*t, t] visibility of the query tile's own keys: tile key j'
    is visible to tile row j iff j' <= j and, under a window,
    j - j' < window (the diagonal is inside any window >= 1)."""
    tile = torch.arange(t, device=device)
    tri = tile[:, None] >= tile[None, :]
    if window is not None:
        tri = tri & (tile[:, None] - tile[None, :] < window)
    return tri[None].expand(group, t, t).reshape(group * t, t)


def paged_decode_partials_plain(qf, k_pool, v_pool, block_table, length,
                                k_scale_pool=None, v_scale_pool=None,
                                window=None, t=1):
    """Plain PyTorch version of the paged decode kernel.

    qf: [b, hkv, n_rows, d] fp32 query rows, already multiplied by the
    softmax scale, group-major over the tile: row r is tile token r % t,
    at position length + r % t; k_pool/v_pool: [num_blocks, bs, hkv, d];
    block_table: [b, m] int32 (-1 = unallocated); length: [b] int32. For
    int8 arenas, k_scale_pool/v_scale_pool [num_blocks, bs, hkv, 1] fp32
    hold each row's scale: k-scales multiply the scores, v-scales the
    weights of the value product (the JAX scan's deferred dequantize).
    Returns the online-softmax partials over the pool rows that
    `_paged_valid` keeps (k_pos < length, and k_pos > length + r % t -
    window under a `window`): o [b, hkv, n_rows, d], l and m [b, hkv,
    n_rows], fp32, m in natural-log units. Masked rows contribute
    exactly 0; a query row with no visible pool row gives (0, 0,
    -1e30)."""
    b, hkv, n_rows, d = qf.shape
    bs = k_pool.shape[1]
    m = block_table.shape[1]
    f32 = torch.float32
    table = block_table.long()
    safe = table.clamp(min=0)
    kb = k_pool[safe].reshape(b, m * bs, hkv, d).permute(0, 2, 1, 3)
    vb = v_pool[safe].reshape(b, m * bs, hkv, d).permute(0, 2, 1, 3)
    s = torch.matmul(qf.to(f32), kb.to(f32).transpose(-1, -2))
    if k_scale_pool is not None:
        ks = k_scale_pool[safe].reshape(b, m * bs, hkv).permute(0, 2, 1)
        s = s * ks[:, :, None, :]
    length = length.long()
    row_pos = (length[:, None, None]
               + (torch.arange(n_rows, device=qf.device) % t)[None, :, None])
    valid = _paged_valid(
        torch.arange(m * bs, device=qf.device)[None, None, :],
        table.repeat_interleave(bs, dim=1)[:, None, :],
        length[:, None, None], row_pos, window)[:, None]
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    mx = s.amax(-1)
    p = torch.where(valid, torch.exp(s - mx[..., None]), torch.zeros_like(s))
    l = p.sum(-1)
    if v_scale_pool is not None:
        vs = v_scale_pool[safe].reshape(b, m * bs, hkv).permute(0, 2, 1)
        p = p * vs[:, :, None, :]
    o = torch.matmul(p, vb.to(f32))
    mx = torch.where(l > 0, mx, torch.full_like(mx, _NEG_INF))
    return o, l, mx


def paged_decode_partials(qf, k_pool, v_pool, block_table, length,
                          k_scale_pool=None, v_scale_pool=None, window=None,
                          t=1):
    """Online-softmax partials of paged decode attention (see
    `paged_decode_partials_plain` for the contract): a
    csrc/paged_decode.cu kernel for CUDA tensors (split up to
    SPLIT_MAX_ROWS query rows, tile beyond; the launch counts under
    "paged_decode" / "paged_decode_tile", with "_int8" for int8 arenas
    and "_window" under a window), the plain version for CPU tensors.
    int8 arenas need both scale pools, float arenas take none. `t` is
    the tile length: n_rows must be a multiple of it."""
    quantized = k_pool.dtype == torch.int8
    scales = [s for s in (k_scale_pool, v_scale_pool) if s is not None]
    if len(scales) != (2 if quantized else 0):
        raise ValueError(
            "paged_decode: int8 arenas need k_scale_pool and v_scale_pool, "
            "float arenas take neither"
        )
    b, hkv, n_rows, d = qf.shape
    if t < 1 or n_rows % t:
        raise ValueError("paged_decode: %d query rows are not whole tiles of "
                         "%d" % (n_rows, t))
    if window is not None and window < 1:
        raise ValueError("window must be >= 1, got %r" % (window,))
    if not on_kernel_path(qf, k_pool, v_pool, block_table, length, *scales):
        return paged_decode_partials_plain(
            qf, k_pool, v_pool, block_table, length, k_scale_pool,
            v_scale_pool, window=window, t=t
        )
    nb, bs, pool_hkv, pool_d = k_pool.shape
    m = block_table.shape[1]
    if (pool_hkv, pool_d) != (hkv, d) or v_pool.shape != k_pool.shape:
        raise ValueError(
            "paged_decode: pools %s / %s do not match q rows %s"
            % (tuple(k_pool.shape), tuple(v_pool.shape), tuple(qf.shape))
        )
    if block_table.shape[0] != b or length.shape != (b,):
        raise ValueError("paged_decode: table [b, m] and length [b] needed")
    qf = qf.to(torch.float32).contiguous()
    table = block_table.to(torch.int32).contiguous()
    length = length.to(torch.int32).contiguous()
    _check_kernel_args("paged_decode", (k_pool, v_pool),
                       tuple(_PAGED_DTYPE_CODES), d)
    if v_pool.dtype != k_pool.dtype:
        raise TypeError("paged_decode kernel takes pools of one dtype")
    scale_ptrs = [None, None]
    if quantized:
        _check_kernel_args("paged_decode", scales, (torch.float32,), d)
        if any(s.shape != (nb, bs, hkv, 1) for s in scales):
            raise ValueError("paged_decode: scale pools must be [%d, %d, %d, "
                             "1]" % (nb, bs, hkv))
        scale_ptrs = [s.data_ptr() for s in scales]
    if any(t_.data_ptr() % 16 for t_ in (k_pool, v_pool)):
        # the kernels read every row 16 bytes at a time
        raise ValueError("paged_decode: arenas must be 16-byte aligned")
    win = 0 if window is None else int(window)
    suffix = ("_int8" if quantized else "") + ("_window" if win else "")
    o = torch.empty((b, hkv, n_rows, d), dtype=torch.float32,
                    device=qf.device)
    l = torch.empty((b, hkv, n_rows), dtype=torch.float32, device=qf.device)
    mx = torch.empty_like(l)
    if o.numel() == 0 or m == 0:
        o.zero_()
        l.zero_()
        mx.fill_(_NEG_INF)
        return o, l, mx
    tile = n_rows > SPLIT_MAX_ROWS
    name = ("paged_decode_tile" if tile else "paged_decode") + suffix
    entry = "edl_paged_decode_tile" if tile else "edl_paged_decode_split"
    err = getattr(_paged_lib(), entry)(
        qf.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *scale_ptrs,
        table.data_ptr(), length.data_ptr(), o.data_ptr(), l.data_ptr(),
        mx.data_ptr(), b, hkv, n_rows, m, bs, d,
        _PAGED_DTYPE_CODES[k_pool.dtype], win, t,
        torch.cuda.current_stream(qf.device).cuda_stream,
    )
    _check_launch(err, name)
    KERNEL_LAUNCHES[name] += 1
    return o, l, mx


def _paged_lib():
    lib = _build.load("paged_decode")
    for name in ("edl_paged_decode_tile", "edl_paged_decode_split"):
        fn = getattr(lib, name)
        if not fn.argtypes:
            fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


def paged_decode_attention(q, k_cur, v_cur, k_pool, v_pool, block_table,
                           length, scale=None, window=None,
                           k_scale_pool=None, v_scale_pool=None,
                           k_cur_scale=None, v_cur_scale=None):
    """Decode attention over a block-paged KV pool for a tile of t >= 1
    new query tokens per sequence (the JAX package's
    `paged_decode_attention`).

    q: [b, h, t, d] ([b, h, d] for t = 1, the result then drops t);
    k_cur/v_cur: [b, hkv, t, d], the tile's own keys/values at positions
    length + j (not in the pool yet); k_pool/v_pool: [num_blocks, bs,
    hkv, d]; block_table: [b, m] int32, -1 padded; length: [b] int32.
    Tile row j sees pool rows k_pos < length and tile keys j' <= j.
    Returns [b, h, t, d] in float32. The pool stream runs through
    `paged_decode_partials`; the tile merge and the finalize are plain
    PyTorch, as in the JAX package.

    int8 arenas: the pools hold symmetric per-row int8 rows and
    k_scale_pool/v_scale_pool [num_blocks, bs, hkv, 1] their fp32
    scales; k_cur/v_cur are then int8 too, with k_cur_scale/v_cur_scale
    [b, hkv, t, 1] ([b, hkv, 1] for t = 1). All four scale operands or
    none. The tile's own keys fold their scales into the scores and its
    values into the weights, as the pool rows do.

    `window`: a sliding-window model's window; tile row j sees pool rows
    k_pos > length + j - window and tile keys j - window < j' <= j."""
    scales = (k_scale_pool, v_scale_pool, k_cur_scale, v_cur_scale)
    quantized = k_scale_pool is not None
    if any(x is not None for x in scales) and any(x is None for x in scales):
        raise ValueError(
            "int8 paged attention needs all four scale operands "
            "(k_scale_pool, v_scale_pool, k_cur_scale, v_cur_scale)"
        )
    squeeze = q.dim() == 3
    if squeeze:
        q, k_cur, v_cur = q[:, :, None], k_cur[:, :, None], v_cur[:, :, None]
        if quantized:
            k_cur_scale = k_cur_scale[:, :, None]
            v_cur_scale = v_cur_scale[:, :, None]
    b, h, t, d = q.shape
    hkv = k_cur.shape[1]
    if h % hkv:
        raise ValueError(
            "paged decode needs num_heads %% num_kv_heads == 0, got "
            "%d q heads / %d kv heads" % (h, hkv)
        )
    group = h // hkv
    scale = scale if scale is not None else d ** -0.5
    f32 = torch.float32
    qf = (q.to(f32) * scale).reshape(b, hkv, group * t, d)
    o, l, mx = paged_decode_partials(qf, k_pool, v_pool, block_table, length,
                                     k_scale_pool, v_scale_pool,
                                     window=window, t=t)
    s_cur = torch.matmul(qf, k_cur.to(f32).transpose(-1, -2))
    cur_w_scale = None
    if quantized:
        s_cur = s_cur * k_cur_scale[..., 0][:, :, None, :]
        cur_w_scale = v_cur_scale[..., 0]
    tri = _tile_causal_mask(group, t, window, q.device)
    s_cur = torch.where(tri, s_cur, torch.full_like(s_cur, _NEG_INF))
    o, l, mx = softmax_merge(o, l, mx, s_cur, v_cur.to(f32),
                             w_scale=cur_w_scale)
    out = softmax_finalize(o, l).reshape(b, h, t, d)
    return out[:, :, 0] if squeeze else out
