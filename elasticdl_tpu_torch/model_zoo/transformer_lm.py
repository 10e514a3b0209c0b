"""Causal transformer language model: the PyTorch twin of the flagship
model_zoo/transformer_lm/transformer_lm.py, for training and serving,
and the zoo spec around it (loss, optimizer, dataset_fn,
eval_metrics_fn, feature_shapes).

Four forwards, all over the same parameters:

* `model(features, training=...)` with a feature dict: the flax
  `__call__`, grad-enabled. Returns fp32 logits [b, l, vocab], or
  {"lm_hidden", "lm_head_kernel"} ([embed, vocab], as flax hands it
  over) when `fused_head` is set and training. Attention runs through
  `ops.attention.flash_attention`, whose backward is the flash backward
  (the kernels on CUDA). Packed rows carry `segment_ids` [b, l]:
  attention stays inside each run and positions restart per run
  (`packed_positions`), as in flax.
* `model(tokens)` with a token tensor (`prefill`): the causal
  eval/prefill forward of serving, under no_grad. Returns fp32 logits
  and every layer's (k, v) rows [b, hkv, l, d], which the serving engine
  writes into its block pool.
* `decode_paged(tokens, positions, pools, tables)`: a tile of t >= 1
  tokens per sequence at its OWN positions (`positions` [b]: tokens
  already cached), attending over each sequence's block table through
  `ops.attention.paged_decode_attention` (the paged decode kernel on
  CUDA). The flax model vmaps a scalar cache counter per slot; here the
  batch carries a position vector. Returns fp32 logits and the tile's
  (k, v) rows for the engine to scatter.
* `decode_dense(tokens, positions, caches)`: flax's `decode=True` step
  against per-sequence dense caches [n, hkv, seq_len, d] (`dense_cache`),
  a chunk of t >= 1 tokens per sequence at its own position; the rows
  are written in place and attention is two plain matmuls, as flax's
  einsums are (no Pallas kernel there either). The dense serving
  engine, a speculative draft and `api.generation` decode through it.

`attn_window` > 0 makes every layer sliding-window attention (the flax
`attn_window`): a token sees the `attn_window` newest positions up to
its own, in the training forward, the prefill and paged decode alike.
Prefill and decode take no segments (flax refuses them there too).

Sequence parallelism: inside a `parallel.mesh.Mesh` with sp > 1 (the
Trainer enters it), the training forward takes this rank's sequence
shard of the feature dict (tokens and segment_ids [b, l / sp]). Its
positions are global (rank * l_local + i, or the packed positions of the
whole row, computed from the all-gathered ids and sliced, since a
document can cross a shard boundary), grouped-query kv expands to the
full head count, and attention runs through ring attention or Ulysses
by `sp_impl` ("ring" | "ulysses", parallel/context_parallel.py), as the
flax model's attention routes under an sp mesh. Prefill and decode stay
single-shard, as in flax; `fused_head` under sp is not ported.

With `kv_cache_dtype="int8"` the rows that reach the pool are symmetric
per-row int8 (`kv_quantize_rows`), quantized once where they are
produced: prefill and `decode_paged` return per layer (k8, v8, k_scale,
v_scale) in place of (k, v), and `decode_paged` reads the layer's
4-tuple of arenas (k, v, k_scale, v_scale). Prefill attends over the
quantize-dequantized rows, so its logits come from the rows decode will
read back (flax's `prefill` branch). The training forward never
quantizes.

LoRA (`lora_rank` r > 0, `lora_alpha`): every attention layer carries
adapters `qkv_lora_a` [embed, r], `qkv_lora_b` [r, (h + 2 hkv) d],
`proj_lora_a` [h d, r] and `proj_lora_b` [r, embed] in the flax layout
(A lecun-normal, B zeros), and adds ((x @ A) @ B) * alpha / r, in the
compute dtype, to the qkv and proj products (flax `_lora_branch`). The
one place qkv and proj are computed (`_split`, `_out`) adds them, so
every forward takes the adapters: training, prefill, paged and dense
decode, the verify tile.

`remat` ("" | "full" | "dots") recomputes each block's activations in
the backward of the training/eval forward (flax `nn.remat` per block),
never in prefill or decode: "full" saves only the block's input
(non-reentrant `torch.utils.checkpoint`); "dots" also saves the
outputs of the products without batch dimensions (qkv, proj, mlp_up,
mlp_down and the adapters' products: aten.mm / addmm), as JAX's
`dots_with_no_batch_dims_saveable`. The flash forward's launch is no
aten op, so under either mode it runs again in the recompute, as the
Pallas call does under JAX's policy. The parameters, losses and
gradients are those of remat "".

Numerics follow flax: LayerNorm epsilon 1e-6, tanh-approximate GELU,
matmul and embedding weights used in the compute dtype (`dtype`), the
LayerNorms computed in fp32, the head's logits cast to fp32. Parameters
are created in fp32 (the flax param dtype) and cast at use, so training
keeps fp32 parameters under bf16 compute. Serving calls
`use_compute_weights()` once, which casts the matmul and embedding
weights to the compute dtype in place (what flax's cast-at-use computes
on every call); training never does.
"""

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint as torch_checkpoint
from torch import nn

from elasticdl_tpu_torch.common.constants import Mode
from elasticdl_tpu_torch.convert import flax_param_path  # noqa: F401 - spec
from elasticdl_tpu_torch.data.example_codec import decode_example
from elasticdl_tpu_torch.ops.attention import (
    NEG_INF,
    apply_rope,
    expand_kv,
    flash_attention,
    packed_positions,
    paged_decode_attention,
)
from elasticdl_tpu_torch.ops.dispatch import resolve_device
from elasticdl_tpu_torch.ops.losses import chunked_softmax_xent, softmax_xent
from elasticdl_tpu_torch.parallel.context_parallel import (
    ring_attention_local,
    ulysses_attention_local,
)
from elasticdl_tpu_torch.parallel.mesh import current_mesh
from elasticdl_tpu_torch.training.optimizers import adamw

_DTYPES = {
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "fp32": torch.float32, "float32": torch.float32,
    "fp16": torch.float16, "float16": torch.float16,
}

LN_EPS = 1e-6  # flax nn.LayerNorm's default


def resolve_dtype(kwargs, family):
    """"dtype": "bf16" -> torch dtype, for custom_model kwargs."""
    dtype = kwargs.get("dtype")
    if isinstance(dtype, str):
        if dtype.lower() not in _DTYPES:
            raise ValueError(
                "Unknown dtype %r for %s (valid: %s)"
                % (dtype, family, sorted(_DTYPES))
            )
        kwargs["dtype"] = _DTYPES[dtype.lower()]
    return kwargs


def _layer_norm(ln, x):
    """flax LayerNorm(dtype=compute): statistics and affine in fp32,
    result in the input's dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps).to(x.dtype)


def _linear(layer, x):
    w = layer.weight.to(x.dtype)
    b = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, w, b)


KV_CACHE_DTYPES = ("", "int8")
SP_IMPLS = ("ring", "ulysses")
REMAT_MODES = ("", "full", "dots")
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """remat "dots": keep the outputs of products without batch
    dimensions, recompute everything else."""
    if op in _SAVED_DOTS:
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_block(blk, remat, x, positions, segments):
    """One block of the training/eval forward under `remat`."""
    def run(x):
        return blk(x, positions, segments=segments)[0]

    if remat == "dots":
        return torch_checkpoint.checkpoint(
            run, x, use_reentrant=False, context_fn=functools.partial(
                torch_checkpoint.create_selective_checkpoint_contexts,
                _dots_policy))
    return torch_checkpoint.checkpoint(run, x, use_reentrant=False)


def _sp_mesh():
    """The current mesh when its sp axis is above 1, else None."""
    mesh = current_mesh()
    return mesh if mesh is not None and mesh.size > 1 else None


def kv_quantize_rows(rows):
    """Symmetric per-row int8 for the KV cache (flax's
    `_kv_quantize_rows`): rows [..., d] -> (int8 rows, fp32 scales [...,
    1]) with scale = amax / 127, a zero row keeping scale 1 so it stays
    exactly zero, round half to even and clip to +-127. Both divisions
    are elementwise fp32 (a Python-scalar divisor may become a multiply
    by its reciprocal on the card), so the result is JAX's bit for
    bit."""
    r32 = rows.float()
    amax = r32.abs().amax(-1, keepdim=True)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q8 = torch.clamp(torch.round(r32 / scale), -127, 127).to(torch.int8)
    return q8, scale


def _dequantize(q8, scale, dtype):
    return (q8.float() * scale).to(dtype)


class CausalSelfAttention(nn.Module):
    def __init__(self, embed_dim, num_heads, head_dim, num_kv_heads=0,
                 use_rope=False, kv_cache_dtype="", window=0, sp_impl="ring",
                 lora_rank=0, lora_alpha=16.0, device=None):
        super().__init__()
        self.kv_int8 = kv_cache_dtype == "int8"
        self.window = int(window) or None
        self.sp_impl = sp_impl
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.num_kv_heads = num_kv_heads or num_heads
        if num_heads % self.num_kv_heads:
            raise ValueError(
                "num_heads (%d) must be a multiple of num_kv_heads (%d)"
                % (num_heads, self.num_kv_heads)
            )
        self.use_rope = use_rope
        h, hkv, d = num_heads, self.num_kv_heads, head_dim
        self.qkv = nn.Linear(embed_dim, (h + 2 * hkv) * d, bias=False,
                             device=device)
        self.proj = nn.Linear(h * d, embed_dim, bias=False, device=device)
        self.lora_rank = int(lora_rank)
        self.lora_scale = float(lora_alpha) / max(1, self.lora_rank)
        if self.lora_rank:
            for name, fan_in, out in (("qkv", embed_dim, (h + 2 * hkv) * d),
                                      ("proj", h * d, embed_dim)):
                self.register_parameter(name + "_lora_a", nn.Parameter(
                    torch.empty(fan_in, self.lora_rank, device=device)))
                self.register_parameter(name + "_lora_b", nn.Parameter(
                    torch.zeros(self.lora_rank, out, device=device)))

    def _dense(self, name, x):
        """The `name` product (qkv or proj) of x in its dtype, with the
        LoRA branch ((x @ A) @ B) * alpha / rank added when adapters
        exist (flax `_lora_branch`)."""
        y = _linear(getattr(self, name), x)
        if self.lora_rank:
            a = getattr(self, name + "_lora_a").to(x.dtype)
            b = getattr(self, name + "_lora_b").to(x.dtype)
            y = y + torch.matmul(torch.matmul(x, a), b) * self.lora_scale
        return y

    def _split(self, x):
        b, l, _ = x.shape
        h, hkv, d = self.num_heads, self.num_kv_heads, self.head_dim
        qkv = self._dense("qkv", x)
        q = qkv[..., :h * d].reshape(b, l, h, d).transpose(1, 2)
        k = qkv[..., h * d:(h + hkv) * d].reshape(b, l, hkv, d).transpose(1, 2)
        v = qkv[..., (h + hkv) * d:].reshape(b, l, hkv, d).transpose(1, 2)
        return q, k, v

    def _out(self, out, x):
        b, l, _ = x.shape
        out = out.to(x.dtype).transpose(1, 2).reshape(b, l, -1)
        return self._dense("proj", out)

    def forward(self, x, positions, prefill=False, segments=None):
        """Causal attention over x [b, l, e]; positions [l], or [b, l]
        for packed rows, whose `segments` [b, l] confine it to each run.
        Returns (y, rows): rows (k, v) [b, hkv, l, d] (rotated when
        RoPE), or, for an int8 cache's `prefill`, (k8, v8, k_scale,
        v_scale) with the attention over their dequantized values.
        Under an sp mesh, x and segments are this rank's sequence shard
        and attention runs over the whole sequence through ring
        attention or Ulysses."""
        q, k, v = self._split(x)
        if self.use_rope:
            q, k = apply_rope(q, positions), apply_rope(k, positions)
        rows = (k, v)
        if prefill and self.kv_int8:
            (k8, ks), (v8, vs) = kv_quantize_rows(k), kv_quantize_rows(v)
            rows = (k8, v8, ks, vs)
            k, v = _dequantize(k8, ks, q.dtype), _dequantize(v8, vs, q.dtype)
        mesh = _sp_mesh()
        if mesh is None:
            out = flash_attention(q, k, v, causal=True, window=self.window,
                                  segments=segments)
            return self._out(out, x), rows
        if prefill:
            raise NotImplementedError(
                "prefill is single-shard (like decode); drop the sp axis "
                "for generation")
        # ring merges partials per kv rotation and Ulysses all-to-alls
        # the head axis over sp: both want the full head count
        k, v = expand_kv(k, self.num_heads), expand_kv(v, self.num_heads)
        sp_attention = (ulysses_attention_local if self.sp_impl == "ulysses"
                        else ring_attention_local)
        out = sp_attention(q, k, v, mesh, causal=True, segments=segments,
                           window=self.window)
        return self._out(out, x), rows

    def decode_paged(self, x, positions, pool, table):
        """A tile x [b, t, e] at positions [b, t] over this layer's
        arenas `pool` through `table` [b, m]: (k_pool, v_pool), or for an
        int8 cache (k_pool, v_pool, k_scale_pool, v_scale_pool). Returns
        (y, the tile's rows in the pool's format)."""
        q, k, v = self._split(x)
        if self.use_rope:
            q, k = apply_rope(q, positions), apply_rope(k, positions)
        length = positions[:, 0].to(torch.int32)
        scale = self.head_dim ** -0.5
        if not self.kv_int8:
            out = paged_decode_attention(q, k, v, pool[0], pool[1], table,
                                         length, scale=scale,
                                         window=self.window)
            return self._out(out, x), (k, v)
        (k8, ks), (v8, vs) = kv_quantize_rows(k), kv_quantize_rows(v)
        out = paged_decode_attention(
            q, k8, v8, pool[0], pool[1], table, length, scale=scale,
            window=self.window, k_scale_pool=pool[2], v_scale_pool=pool[3],
            k_cur_scale=ks, v_cur_scale=vs,
        )
        return self._out(out, x), (k8, v8, ks, vs)

    def decode_dense(self, x, positions, cache, slots=None, span=None):
        """A chunk x [b, t, e] at positions [b, t] against this layer's
        dense cache `cache`: (k, v) [S, hkv, seq_len, d], or for an int8
        cache (k8, v8, k_scale, v_scale), the scales [S, hkv, seq_len,
        1]. Sequence i of the chunk owns cache row `slots[i]` (None:
        row i). The chunk's rows are written at their positions first
        (quantized for int8; a position past the cache clamps to its
        last row, as flax's dynamic_update_slice does), then each query
        attends over rows k_pos <= its position (and k_pos > position -
        window) among the first `span` (None: all) rows. The int8
        dequantize folds into the scores and the weights (flax
        `_decode_step`, :443-460). Returns y [b, t, e]."""
        q, k, v = self._split(x)
        if self.use_rope:
            q, k = apply_rope(q, positions), apply_rope(k, positions)
        b, h, t, d = q.shape
        hkv = k.shape[1]
        group = h // hkv
        dtype = q.dtype
        rows = (k, v)
        if self.kv_int8:
            (k8, ks), (v8, vs) = kv_quantize_rows(k), kv_quantize_rows(v)
            rows = (k8, v8, ks, vs)
        cache_len = cache[0].shape[2]
        sl = (torch.arange(b, device=x.device) if slots is None
              else slots)[:, None]
        wpos = positions.clamp(max=cache_len - 1)
        for leaf, new in zip(cache, rows):
            leaf[sl, :, wpos] = new.transpose(1, 2).to(leaf.dtype)
        span = cache_len if span is None else int(span)
        read = [leaf[:b, :, :span] if slots is None else leaf[slots, :, :span]
                for leaf in cache]
        qg = (q * self.head_dim ** -0.5).reshape(b, hkv, group * t, d)
        s = torch.matmul(qg, read[0].to(dtype).transpose(-1, -2)).float()
        if self.kv_int8:
            s = s * read[2][..., 0][:, :, None, :]
        k_pos = torch.arange(span, device=x.device)
        row_pos = positions.repeat(1, group)[:, None, :, None]
        valid = k_pos <= row_pos
        if self.window:
            valid = valid & (k_pos > row_pos - self.window)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        w = torch.softmax(s, dim=-1)
        if self.kv_int8:
            w = w * read[3][..., 0][:, :, None, :]
        out = torch.matmul(w.to(dtype), read[1].to(dtype))
        return self._out(out.reshape(b, h, t, d), x)


class Block(nn.Module):
    def __init__(self, embed_dim, num_heads, head_dim, num_kv_heads=0,
                 use_rope=False, kv_cache_dtype="", window=0, sp_impl="ring",
                 lora_rank=0, lora_alpha=16.0, device=None):
        super().__init__()
        self.ln_0 = nn.LayerNorm(embed_dim, eps=LN_EPS, device=device)
        self.attn = CausalSelfAttention(
            embed_dim, num_heads, head_dim, num_kv_heads=num_kv_heads,
            use_rope=use_rope, kv_cache_dtype=kv_cache_dtype, window=window,
            sp_impl=sp_impl, lora_rank=lora_rank, lora_alpha=lora_alpha,
            device=device,
        )
        self.ln_1 = nn.LayerNorm(embed_dim, eps=LN_EPS, device=device)
        self.mlp_up = nn.Linear(embed_dim, 4 * embed_dim, device=device)
        self.mlp_down = nn.Linear(4 * embed_dim, embed_dim, device=device)

    def _mlp(self, x):
        y = _linear(self.mlp_up, _layer_norm(self.ln_1, x))
        return x + _linear(self.mlp_down, F.gelu(y, approximate="tanh"))

    def forward(self, x, positions, prefill=False, segments=None):
        y, kv = self.attn(_layer_norm(self.ln_0, x), positions,
                          prefill=prefill, segments=segments)
        return self._mlp(x + y), kv

    def decode_paged(self, x, positions, pool, table):
        y, kv = self.attn.decode_paged(_layer_norm(self.ln_0, x), positions,
                                       pool, table)
        return self._mlp(x + y), kv

    def decode_dense(self, x, positions, cache, slots=None, span=None):
        y = self.attn.decode_dense(_layer_norm(self.ln_0, x), positions,
                                   cache, slots=slots, span=span)
        return self._mlp(x + y)


class TransformerLM(nn.Module):
    def __init__(self, vocab_size=256, seq_len=128, embed_dim=128,
                 num_heads=4, num_layers=2, dtype=None, pos_emb="learned",
                 num_kv_heads=0, attn_window=0, fused_head=False, remat="",
                 lora_rank=0, lora_alpha=16.0, kv_cache_dtype="",
                 sp_impl="ring", device="cuda", seed=0):
        super().__init__()
        if sp_impl not in SP_IMPLS:
            raise ValueError(
                "Unknown sp_impl %r (valid: 'ring', 'ulysses')" % (sp_impl,))
        if pos_emb not in ("learned", "rope"):
            raise ValueError(
                "Unknown pos_emb %r (valid: 'learned', 'rope')" % (pos_emb,)
            )
        if kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(
                "Unknown kv_cache_dtype %r (valid: '', 'int8')"
                % (kv_cache_dtype,)
            )
        if remat not in REMAT_MODES:
            raise ValueError(
                "Unknown remat %r (valid: '', 'full', 'dots')" % (remat,))
        if lora_rank < 0:
            raise ValueError("lora_rank must be >= 0, got %r" % (lora_rank,))
        if attn_window < 0:
            raise ValueError("attn_window must be >= 0, got %r"
                             % (attn_window,))
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be a multiple of num_heads")
        device = resolve_device(device)
        self.vocab_size = int(vocab_size)
        self.seq_len = int(seq_len)
        self.embed_dim = int(embed_dim)
        self.num_heads = int(num_heads)
        self.num_layers = int(num_layers)
        self.head_dim = self.embed_dim // self.num_heads
        self.num_kv_heads = int(num_kv_heads) or self.num_heads
        self.dtype = dtype or torch.float32
        self.pos_emb = pos_emb
        self.fused_head = bool(fused_head)
        self.kv_cache_dtype = kv_cache_dtype
        self.attn_window = int(attn_window)
        self.remat = remat
        self.lora_rank = int(lora_rank)
        self.lora_alpha = float(lora_alpha)
        self.wte = nn.Embedding(vocab_size, embed_dim, device=device)
        self.wpe = (nn.Embedding(seq_len, embed_dim, device=device)
                    if pos_emb == "learned" else None)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, self.head_dim,
                  num_kv_heads=num_kv_heads, use_rope=pos_emb == "rope",
                  kv_cache_dtype=kv_cache_dtype, window=self.attn_window,
                  sp_impl=sp_impl, lora_rank=self.lora_rank,
                  lora_alpha=self.lora_alpha, device=device)
            for _ in range(num_layers)
        )
        self.ln_f = nn.LayerNorm(embed_dim, eps=LN_EPS, device=device)
        self.head = nn.Linear(embed_dim, vocab_size, bias=False,
                              device=device)
        self.init_weights(seed)

    @property
    def device(self):
        return self.wte.weight.device

    @torch.no_grad()
    def init_weights(self, seed):
        """Seeded init in the flax scheme: fan-in-scaled normal matmul
        kernels (lecun) and LoRA A, zero LoRA B,
        unit-variance-over-fan-in embeddings, zero biases, unit LayerNorm
        scales."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.in_features),
                                   generator=gen)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.embedding_dim),
                                   generator=gen)
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, CausalSelfAttention) and mod.lora_rank:
                for name in ("qkv", "proj"):
                    a = getattr(mod, name + "_lora_a")
                    a.normal_(0.0, 1.0 / math.sqrt(a.shape[0]), generator=gen)
                    getattr(mod, name + "_lora_b").zero_()

    @torch.no_grad()
    def use_compute_weights(self):
        """Cast matmul, adapter and embedding weights to the compute
        dtype in place (LayerNorm parameters stay fp32). Numerically the
        same as the per-call cast flax does; returns self."""
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.to(self.dtype)
            elif isinstance(mod, CausalSelfAttention) and mod.lora_rank:
                for name in ("qkv", "proj"):
                    for ab in ("_lora_a", "_lora_b"):
                        p = getattr(mod, name + ab)
                        p.data = p.data.to(self.dtype)
        return self

    def _embed(self, tokens, wpe_idx):
        x = self.wte.weight[tokens].to(self.dtype)
        if self.wpe is not None:
            x = x + self.wpe.weight[wpe_idx].to(self.dtype)
        return x

    def _logits(self, x):
        x = _layer_norm(self.ln_f, x)
        return F.linear(x, self.head.weight.to(x.dtype)).float()

    def forward(self, inputs, training=False):
        """A feature dict {"tokens": [b, l]}: the training/eval forward
        (see `lm_forward`). A token tensor [b, l]: the serving prefill
        (see `prefill`)."""
        if isinstance(inputs, dict):
            return self.lm_forward(inputs, training=training)
        return self.prefill(inputs)

    def _check_length(self, l):
        if l > self.seq_len:
            raise ValueError(
                "length %d exceeds seq_len %d" % (l, self.seq_len)
            )

    def lm_forward(self, features, training=False):
        """The flax model's training/eval `__call__`, grad-enabled:
        features["tokens"] [b, l] -> fp32 logits [b, l, vocab], or, when
        `fused_head` and training, {"lm_hidden": [b, l, e] in the compute
        dtype, "lm_head_kernel": [e, vocab]} for the chunked loss.
        Packed rows: features["segment_ids"] [b, l] int ids of
        contiguous runs; attention stays within each run and the
        positions (learned table and RoPE) restart at each run. Under an
        sp mesh the features are this rank's sequence shard (see the
        module docstring)."""
        tokens = torch.as_tensor(features["tokens"], device=self.device)
        tokens = tokens.long()
        l = tokens.shape[1]
        mesh = _sp_mesh()
        sp, start = (1, 0) if mesh is None else (mesh.size, mesh.rank * l)
        self._check_length(l * sp)
        if mesh is not None and self.fused_head and training:
            raise NotImplementedError(
                "fused_head under an sp mesh is not ported (ROADMAP)")
        segments = features.get("segment_ids")
        if segments is None:
            positions = torch.arange(start, start + l, device=tokens.device)
            wpe_idx = positions[None]
        else:
            segments = torch.as_tensor(segments, device=self.device).to(
                torch.int32)
            full = segments if mesh is None else mesh.all_gather(segments, 1)
            positions = wpe_idx = packed_positions(full)[
                :, start:start + l].long()
        x = self._embed(tokens, wpe_idx)
        remat = self.remat if torch.is_grad_enabled() else ""
        for blk in self.blocks:
            if remat:
                x = _remat_block(blk, remat, x, positions, segments)
            else:
                x, _kv = blk(x, positions, segments=segments)
        if self.fused_head and training:
            return {"lm_hidden": _layer_norm(self.ln_f, x),
                    "lm_head_kernel": self.head.weight.t()}
        return self._logits(x)

    @torch.no_grad()
    def prefill(self, tokens):
        """Causal forward over tokens [b, l] (l <= seq_len): fp32 logits
        [b, l, vocab] and per-layer (k, v) rows [b, hkv, l, d], or (k8,
        v8, k_scale, v_scale) for an int8 cache."""
        l = tokens.shape[1]
        self._check_length(l)
        positions = torch.arange(l, device=tokens.device)
        x = self._embed(tokens, positions[None])
        kv = []
        for blk in self.blocks:
            x, rows = blk(x, positions, prefill=True)
            kv.append(rows)
        return self._logits(x), kv

    @torch.no_grad()
    def decode_paged(self, tokens, positions, pools, tables):
        """A tile of tokens [b, t] at positions [b] + [0, t) over the
        block-paged pool: `pools` is a list of (k_pool, v_pool) arenas
        [num_blocks, block_size, hkv, d] per layer (int8 cache: (k, v,
        k_scale, v_scale), the scales [num_blocks, block_size, hkv, 1]),
        `tables` [b, m] int32 block tables (-1 padded). Returns fp32
        logits [b, t, vocab] and per-layer tile rows [b, hkv, t, d] in
        the pool's format ((k8, v8, k_scale, v_scale) for int8)."""
        t = tokens.shape[1]
        pos = positions.long()[:, None] + torch.arange(
            t, device=tokens.device)[None, :]
        # pad rows of a suffix tile may sit past seq_len: clamp the table
        # lookup as flax does; their outputs are never read
        x = self._embed(tokens, pos.clamp(max=self.seq_len - 1))
        rows = []
        for blk, pool in zip(self.blocks, pools):
            x, kv = blk.decode_paged(x, pos, pool, tables)
            rows.append(kv)
        return self._logits(x), rows

    def dense_cache(self, n):
        """Zeroed dense KV caches for `n` sequences, one tuple a layer:
        (k, v) [n, hkv, seq_len, d] in the compute dtype, or for an int8
        cache (k8, v8, k_scale, v_scale) with fp32 scales [n, hkv,
        seq_len, 1] (flax `_cache_vars`)."""
        shape = (n, self.num_kv_heads, self.seq_len, self.head_dim)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        if self.kv_cache_dtype == "int8":
            sshape = shape[:3] + (1,)
            return [(zeros(shape, torch.int8), zeros(shape, torch.int8),
                     zeros(sshape, torch.float32),
                     zeros(sshape, torch.float32))
                    for _ in range(self.num_layers)]
        return [(zeros(shape, self.dtype), zeros(shape, self.dtype))
                for _ in range(self.num_layers)]

    @torch.no_grad()
    def decode_dense(self, tokens, positions, caches, slots=None, span=None):
        """The flax `decode=True` step against dense caches (from
        `dense_cache`): a chunk of tokens [b, t] at positions [b] + [0,
        t), every sequence at its own position (flax keeps one counter
        per sequence; here the batch carries a position vector).
        Sequence i owns row `slots[i]` of every cache (None: row i);
        its rows are written in place, then attention reads the first
        `span` rows (None: all; the caller's bound on position + t).
        Returns fp32 logits [b, t, vocab]."""
        t = tokens.shape[1]
        pos = positions.long()[:, None] + torch.arange(
            t, device=tokens.device)[None, :]
        x = self._embed(tokens, pos.clamp(max=self.seq_len - 1))
        for blk, cache in zip(self.blocks, caches):
            x = blk.decode_dense(x, pos, cache, slots=slots, span=span)
        return self._logits(x)


def custom_model(**kwargs):
    return TransformerLM(**resolve_dtype(kwargs, "transformer_lm"))


def loss(labels, predictions, sample_weights=None):
    """The zoo loss (model_zoo/transformer_lm/transformer_lm.py:770-794):
    negative labels (-100 marks) are ignored, each row is the mean of its
    valid tokens' cross entropy, rows are weighted by
    sum(ce * w) / max(sum(w), 1). `predictions` are fp32 logits or the
    fused {"lm_hidden", "lm_head_kernel"} dict."""
    fused = isinstance(predictions, dict) and "lm_hidden" in predictions
    device = (predictions["lm_hidden"] if fused else predictions).device
    labels = torch.as_tensor(labels, device=device)
    valid = labels >= 0
    safe = labels.clamp(min=0).long()
    if fused:
        tok_ce = chunked_softmax_xent(predictions["lm_hidden"],
                                      predictions["lm_head_kernel"], safe)
    else:
        tok_ce = softmax_xent(predictions, safe)
    tok_ce = torch.where(valid, tok_ce, torch.zeros_like(tok_ce))
    ce = tok_ce.sum(-1) / valid.sum(-1).clamp(min=1)
    if sample_weights is None:
        return ce.mean()
    w = torch.as_tensor(sample_weights, device=device, dtype=ce.dtype)
    return (ce * w).sum() / w.sum().clamp(min=1.0)


def optimizer(lr=3e-4):
    return adamw(lr, weight_decay=0.01)


def dataset_fn(dataset, mode, metadata):
    def _parse(record):
        tokens = decode_example(record)["tokens"].astype(np.int32)
        features = {"tokens": tokens[:-1]}
        if mode == Mode.PREDICTION:
            return features
        return features, tokens[1:]

    dataset = dataset.map(_parse)
    if mode == Mode.TRAINING:
        dataset = dataset.shuffle(buffer_size=1024, seed=0)
    return dataset


def eval_metrics_fn():
    return {
        "token_accuracy": lambda labels, predictions: (
            np.argmax(predictions, axis=-1) == np.asarray(labels)
        ).astype(np.float32).reshape(len(labels), -1).mean(axis=1)
    }


def feature_shapes(seq_len=128):
    return {"tokens": (seq_len,)}
