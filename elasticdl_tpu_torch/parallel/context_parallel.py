"""Sequence / context parallelism over the sp ranks of a Mesh: ring
attention and Ulysses, the counterpart of
elasticdl_tpu/parallel/context_parallel.py on torch.distributed.

Each rank holds one sequence shard of q, k and v, [b, h, l_local, d];
shard r covers positions r * l_local .. (r + 1) * l_local - 1.

* Ring (`ring_attention_local`): kv shards rotate around the ring
  (`Mesh.ring_shift`) while each rotation's partial (out, lse) from the
  flash kernel is merged online (`lse_merge`); the full sequence never
  sits on one rank. The backward is a second ring: each rotation
  recomputes its shard's slice of the global softmax from the saved
  global lse (`attention_backward_lse`, the two flash backward kernels,
  fp32 results), and the dk / dv accumulators travel with their kv shard
  and arrive home after the last hop.
* Ulysses (`ulysses_attention_local`): one all-to-all turns sequence
  shards of all heads into full sequences of h / sp heads, the flash
  kernel runs over the whole sequence, and the inverse all-to-all
  restores the shards. Segment ids are all-gathered.

Which kernel call a rotation makes is decided per rotation from the
query shard `my` and the held kv shard `src` (`rotation_call`): without
a window, causal rotations are full (src older), diagonal (src == my) or
skipped (src newer); with a window, the rotation whose shard sits r
shards back runs the window mask at pos_offset = r * l_local (negative r
in the non-causal band), and rotations wholly outside the band are
skipped. `ring_rotation_forward` / `ring_rotation_backward` are the
per-rotation steps the ring calls.
"""

import torch

from elasticdl_tpu_torch.ops.attention import (
    NEG_INF,
    attention_backward_lse,
    attention_forward_lse,
    flash_attention,
    lse_merge,
)


def _win_live(shard_len, window, size):
    """Number of reachable windowed-rotation offsets: offset r is live
    iff its closest pair (first query row, last key) is inside the
    window, r * shard_len - (shard_len - 1) < window."""
    return min(size, (window + shard_len - 2) // shard_len + 1)


def _win_offsets(shard_len, window, size, causal):
    """The live shard offsets in _win_case's order: causal [0, live),
    non-causal [-(live - 1), live); the skip comes last."""
    live = _win_live(shard_len, window, size)
    if causal:
        return list(range(live))
    return list(range(-(live - 1), live))


def _win_case(src, my, shard_len, window, size, causal):
    """Index into _win_offsets for query shard `my` holding kv shard
    `src` under a window; len(_win_offsets(...)) means skip. Causal:
    offset my - src, skipped when negative or outside the band;
    non-causal: the signed offset, skipped outside the band."""
    off = my - src
    live = _win_live(shard_len, window, size)
    if causal:
        if off < 0 or off * shard_len - (shard_len - 1) >= window:
            return live
        return off
    if abs(off) * shard_len - (shard_len - 1) >= window:
        return 2 * live - 1
    return off + live - 1


def _ring_case(src, my):
    """Causal visibility of kv shard `src` from query shard `my` with
    equal shard lengths: 0 = fully visible (src older), 1 = diagonal
    (the local causal mask), 2 = fully masked (src newer, skipped)."""
    if src == my:
        return 1
    return 0 if src < my else 2


def rotation_call(src, my, size, shard_len, causal, window):
    """The kernel call of the rotation where query shard `my` holds kv
    shard `src`: None (skipped) or {"causal", "pos_offset", "window"}
    for attention_forward_lse / attention_backward_lse."""
    if window is not None:
        offsets = _win_offsets(shard_len, window, size, causal)
        idx = _win_case(src, my, shard_len, window, size, causal)
        if idx == len(offsets):
            return None
        r = offsets[idx]
        return {"causal": causal and r == 0, "pos_offset": r * shard_len,
                "window": window}
    if causal:
        case = _ring_case(src, my)
        if case == 2:
            return None
        return {"causal": case == 1, "pos_offset": 0, "window": None}
    return {"causal": False, "pos_offset": 0, "window": None}


def _pair(seg, k_seg):
    return None if seg is None else (seg, k_seg)


def ring_rotation_forward(q, k, v, seg, k_seg, src, my, size, causal, scale,
                          window):
    """One rotation of the ring forward: query shard `my` against kv
    shard `src` (k, v and its ids `k_seg`). Returns None for a skipped
    rotation, else the partial (out fp32, lse), lse exactly -1e30 on
    rows that see no key of the shard."""
    call = rotation_call(src, my, size, q.shape[2], causal, window)
    if call is None:
        return None
    out, lse = attention_forward_lse(q, k, v, scale=scale,
                                     segments=_pair(seg, k_seg), **call)
    return out.float(), lse


def ring_rotation_backward(q, k, v, out, lse, g, seg, k_seg, src, my, size,
                           causal, scale, window):
    """One rotation of the ring backward from the global `out`, `lse`
    and cotangent `g`: None for a skipped rotation, else this shard's
    (dq, dk, dv) in fp32."""
    call = rotation_call(src, my, size, q.shape[2], causal, window)
    if call is None:
        return None
    return attention_backward_lse(q, k, v, out, lse, g, scale=scale,
                                  grad_dtype=torch.float32,
                                  segments=_pair(seg, k_seg), **call)


def _ring_forward(q, k, v, seg, mesh, causal, scale, window):
    size, my = mesh.size, mesh.rank
    b, h, lq, _ = q.shape
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, lq), NEG_INF, dtype=torch.float32,
                     device=q.device)
    held = [k, v] + ([seg] if seg is not None else [])
    for i in range(size):
        # after i hops this rank holds the shard born on rank my + i
        nxt = mesh.ring_shift(held) if i < size - 1 else None
        part = ring_rotation_forward(q, held[0], held[1], seg,
                                     held[2] if seg is not None else None,
                                     (my + i) % size, my, size, causal,
                                     scale, window)
        if part is not None:
            o, lse = lse_merge(o, lse, *part)
        held = nxt
    return o.to(q.dtype), lse


def _ring_backward(q, k, v, seg, out, lse, g, mesh, causal, scale, window):
    size, my = mesh.size, mesh.rank
    f32 = torch.float32
    dq = torch.zeros(q.shape, dtype=f32, device=q.device)
    dk = torch.zeros(k.shape, dtype=f32, device=k.device)
    dv = torch.zeros(v.shape, dtype=f32, device=v.device)
    held = [k, v] + ([seg] if seg is not None else [])
    for i in range(size):
        nxt = mesh.ring_shift(held) if i < size - 1 else None
        grads = ring_rotation_backward(
            q, held[0], held[1], out, lse, g, seg,
            held[2] if seg is not None else None, (my + i) % size, my, size,
            causal, scale, window)
        if grads is not None:
            dq += grads[0]
            dk += grads[1]
            dv += grads[2]
        # the accumulators belong to the held shard and travel with it:
        # after `size` hops each is back on the rank that owns its shard
        dk, dv = mesh.ring_shift([dk, dv])
        held = nxt
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class RingAttentionFunction(torch.autograd.Function):
    """Ring attention with the ring backward: the port of the JAX
    package's `_ring_attention` custom_vjp. Saves q, k, v, the output
    and the global lse."""

    @staticmethod
    def forward(ctx, q, k, v, seg, mesh, causal, scale, window):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _ring_forward(q, k, v, seg, mesh, causal, scale, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.seg, ctx.mesh = seg, mesh
        ctx.causal, ctx.scale, ctx.window = causal, scale, window
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, ctx.seg, out, lse,
                                    g.contiguous(), ctx.mesh, ctx.causal,
                                    ctx.scale, ctx.window)
        return dq, dk, dv, None, None, None, None, None


def ring_attention_local(q, k, v, mesh, causal=False, scale=None,
                         segments=None, window=None):
    """Ring attention over the sp ranks of `mesh` (the JAX package's
    `ring_attention_local`): q, k, v are this rank's sequence shards
    [b, h, l_local, d] (k/v may carry fewer heads); returns this rank's
    output shard in q.dtype. `segments`: this rank's [b, l_local]
    packed-sequence ids (the k-side ids travel with their kv shard).
    `window`: sliding-window attention over global positions."""
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if causal and q.shape[2] != k.shape[2]:
        # the rotation classification relies on equal-length shards, so
        # that diagonal offsets cancel
        raise ValueError(
            "causal ring attention requires equal q/kv sequence lengths "
            "per shard, got lq=%d lk=%d" % (q.shape[2], k.shape[2]))
    if window is not None:
        window = int(window)
        if window < 1:
            raise ValueError("window must be >= 1, got %r" % (window,))
    if segments is not None:
        segments = torch.as_tensor(segments, device=q.device).to(
            torch.int32).contiguous()
    return RingAttentionFunction.apply(q, k, v, segments, mesh, bool(causal),
                                       scale, window)


class _AllToAll(torch.autograd.Function):
    """Mesh.all_to_all with its transpose as the backward."""

    @staticmethod
    def forward(ctx, x, mesh, split_dim, cat_dim):
        ctx.mesh, ctx.dims = mesh, (split_dim, cat_dim)
        return mesh.all_to_all(x, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, cat_dim = ctx.dims
        return ctx.mesh.all_to_all(g, cat_dim, split_dim), None, None, None


def ulysses_attention_local(q, k, v, mesh, causal=False, scale=None,
                            segments=None, window=None):
    """Ulysses attention over the sp ranks of `mesh` (the JAX package's
    `ulysses_attention_local`): q, k, v are this rank's sequence shards
    [b, h, l_local, d]; one all-to-all makes them [b, h / sp, l, d]
    (rank i holds head block i), `flash_attention` runs over the whole
    sequence, and the inverse all-to-all returns this rank's output
    shard. `segments`: this rank's [b, l_local] ids, all-gathered to the
    full sequence. Needs the head counts divisible by sp."""
    sp = mesh.size
    if q.shape[1] % sp or k.shape[1] % sp:
        raise ValueError(
            "ulysses_attention needs num_heads (%d) and kv heads (%d) "
            "divisible by the sp axis (%d); use ring attention for this "
            "config" % (q.shape[1], k.shape[1], sp))
    full_seg = None
    if segments is not None:
        full_seg = mesh.all_gather(
            torch.as_tensor(segments, device=q.device).to(torch.int32),
            dim=1)

    def to_heads(x):
        return _AllToAll.apply(x, mesh, 1, 2)

    out = flash_attention(to_heads(q), to_heads(k), to_heads(v),
                          causal=causal, scale=scale, window=window,
                          segments=full_seg)
    return _AllToAll.apply(out, mesh, 2, 1)
