"""Prefill, token selection and offline decoding: the port of
elasticdl_tpu/api/generation.py's serving helpers,
`autoregressive_generate` (recompute or KV-cached),
`beam_search_generate` (full forwards or KV-cached) and
`speculative_generate` (a draft model's greedy proposals verified in one
target chunk). Each takes the port model (the JAX package takes a
trainer and a state); an export's or a checkpoint's flax-named tree,
float or int8, goes into the model first through
`api.quantization.load_params`, which dequantizes int8 leaves once, as
the JAX package dequantizes a quantized state before it decodes.

Token-selection contract. Greedy (temperature 0) is the argmax of the
fp32 logits, first index on ties, exactly as in the JAX package.
Sampling applies the same pipeline (scale by temperature, top-k, then
nucleus filter, then a categorical draw) but cannot reproduce
`jax.random` bits: the draw comes from a CPU `torch.Generator` seeded
from (seed, position) alone, so a request's sampled tokens depend on
its own seed and logits and never on its batch mates, and a CPU run and
a CUDA run that produce the same logits draw the same token.
"""

import torch


def _prefill_bucket(p, seq_len):
    """Prefill width: the smallest 64-multiple covering the prompt,
    clamped to the model's capacity. Rows in [p, p_pad) hold pad
    junk; decode masks them by length and overwrites each before it is
    read."""
    return min(seq_len, -(-p // 64) * 64)


def kv_layout(model):
    """The KV row layout a block pool must hold for `model`: (num_layers,
    kv_heads, head_dim, dtype, kv_cache_dtype). The port's counterpart
    of the JAX package's `kv_row_leaf` convention: every layer
    contributes one K and one V arena of rows [kv_heads, head_dim], and
    with kv_cache_dtype "int8" their int8 rows plus one fp32 scale arena
    each."""
    return (model.num_layers, model.num_kv_heads, model.head_dim,
            model.dtype, model.kv_cache_dtype)


def run_prefill(model, prompt, p_pad=None):
    """One causal forward over `prompt` (a list of token ids) padded to
    its 64-bucket (or to `p_pad`): returns (per-layer rows [1, hkv,
    p_pad, d] in the pool's format, fp32 logits [vocab] at the last
    prompt position)."""
    p = len(prompt)
    if p_pad is None:
        p_pad = _prefill_bucket(p, model.seq_len)
    buf = torch.zeros((1, p_pad), dtype=torch.long)
    buf[0, :p] = torch.as_tensor(prompt, dtype=torch.long)
    logits, kv = model(buf.to(model.device))
    return kv, logits[0, p - 1]


def _filter_logits(logits, top_k, top_p):
    """top-k keeps the k highest logits per row (every logit equal to
    the k-th survives); nucleus keeps the smallest set whose cumulative
    probability reaches p (always at least the argmax). Filtered
    entries drop to -inf."""
    neg = torch.tensor(float("-inf"), dtype=logits.dtype,
                       device=logits.device)
    if top_k and top_k > 0:
        k = min(int(top_k), logits.shape[-1])
        kth = torch.sort(logits, dim=-1).values[..., -k, None]
        logits = torch.where(logits < kth, neg, logits)
    if top_p < 1.0:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        thr = torch.where(keep, sorted_desc,
                          torch.full_like(sorted_desc, float("inf")))
        thr = thr.amin(dim=-1, keepdim=True)
        logits = torch.where(logits < thr, neg, logits)
    return logits


def sampling_generator(seed, position):
    """The CPU generator a sampled token at `position` draws from: a
    function of (seed, position) only. The CPU generator keeps 32 bits
    of its seed, so the pair is mixed (splitmix64) before truncation."""
    mask = (1 << 64) - 1
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(position)) & mask
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & mask
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & mask
    x ^= x >> 31
    return torch.Generator(device="cpu").manual_seed(x & 0xFFFFFFFF)


def serving_next_token(step_logits, seed, position, temperature, top_k=0,
                       top_p=1.0):
    """The token for `position` from one slot's fp32 logits [vocab]:
    argmax when temperature <= 0, else a draw from the filtered,
    temperature-scaled distribution with `sampling_generator(seed,
    position)`. Returns an int."""
    if temperature <= 0.0:
        return int(torch.argmax(step_logits).item())
    scaled = step_logits.detach().to("cpu", torch.float32) / temperature
    probs = torch.softmax(_filter_logits(scaled, top_k, top_p), dim=-1)
    gen = sampling_generator(seed, position)
    return int(torch.multinomial(probs, 1, generator=gen).item())


def next_tokens(logits, seeds, positions, temperatures, top_k=0, top_p=1.0):
    """`serving_next_token` over a batch of slots: logits [n, vocab];
    one host transfer for the greedy rows, one CPU draw per sampled
    row. Returns a list of ints."""
    greedy = torch.argmax(logits, dim=-1).tolist()
    out = []
    for i, temp in enumerate(temperatures):
        if temp <= 0.0:
            out.append(int(greedy[i]))
        else:
            out.append(serving_next_token(logits[i], seeds[i], positions[i],
                                          temp, top_k, top_p))
    return out


def write_dense_rows(caches, rows, slot, n):
    """Copy the first `n` rows of a batch-1 prefill's per-layer `rows`
    ([1, hkv, l, d] leaves, as `run_prefill` returns them) into row
    `slot` of dense caches (`model.dense_cache`), and zero the rest of
    that row's positions: what flax's prefill leaves in a fresh cache
    (a slot's stale rows from an earlier occupant are never read, but a
    speculative draft attends over positions it has not written)."""
    for layer, new in zip(caches, rows):
        for leaf, r in zip(layer, new):
            leaf[slot, :, :n] = r[0, :, :n]
            leaf[slot, :, n:] = 0


def _check_lengths(p, max_new_tokens, seq_len):
    total = p + int(max_new_tokens)
    if max_new_tokens < 1 or p < 1 or total > seq_len:
        raise ValueError(
            "need prompt length >= 1 and max_new_tokens >= 1 with prompt "
            "%d + new %d <= the model's seq_len %d"
            % (p, max_new_tokens, seq_len))
    return total


def _prefill_dense(model, prompt, n):
    """Prefill `prompt` [b, p] (bucketed to 64) into fresh dense caches
    for b * n rows, each prompt row repeated n times. Returns (caches,
    fp32 logits [b, vocab] at the last prompt position)."""
    b, p = prompt.shape
    p_pad = _prefill_bucket(p, model.seq_len)
    buf = torch.zeros((b, p_pad), dtype=torch.long)
    buf[:, :p] = prompt
    logits, rows = model(buf.to(model.device))
    caches = model.dense_cache(b * n)
    for layer, new in zip(caches, rows):
        for leaf, r in zip(layer, new):
            leaf[:, :, :p_pad] = r.repeat_interleave(n, dim=0)
    return caches, logits[:, p - 1]


def autoregressive_generate(model, prompt, max_new_tokens, temperature=0.0,
                            seed=0, use_cache=False, top_k=0, top_p=1.0):
    """Continue `prompt` (int [b, p]) by `max_new_tokens` tokens with the
    port's TransformerLM; returns int64 [b, p + max_new_tokens] on the
    CPU. The JAX package's argument checks and two strategies: the
    default recomputes the causal forward over the tokens so far for
    each position; `use_cache` prefills the prompt once (bucketed to
    64) into dense KV caches and then decodes one token a step
    (`decode_dense`). Greedy (temperature 0) equals the JAX package's;
    sampled tokens follow the port's (seed, position) contract, every
    row of the batch with the same seed."""
    prompt = torch.as_tensor(prompt, dtype=torch.long)
    if prompt.dim() != 2:
        raise ValueError("prompt must be [b, p], got %s"
                         % (tuple(prompt.shape),))
    b, p = prompt.shape
    seq_len = model.seq_len
    if not 0.0 < top_p <= 1.0:
        raise ValueError("top_p must be in (0, 1], got %r (use "
                         "temperature=0 for greedy)" % (top_p,))
    if top_k < 0:
        raise ValueError("top_k must be >= 0, got %r" % (top_k,))
    if temperature <= 0.0:
        top_k, top_p = 0, 1.0
    total = _check_lengths(p, max_new_tokens, seq_len)
    dev = model.device
    out = torch.zeros((b, total), dtype=torch.long)
    out[:, :p] = prompt
    seeds, temps = [seed] * b, [temperature] * b
    with torch.no_grad():
        if not use_cache:
            for i in range(p, total):
                logits, _kv = model(out[:, :i].to(dev))
                out[:, i] = torch.as_tensor(next_tokens(
                    logits[:, i - 1], seeds, [i] * b, temps, top_k, top_p))
            return out
        caches, last = _prefill_dense(model, prompt, 1)
        out[:, p] = torch.as_tensor(next_tokens(
            last, seeds, [p] * b, temps, top_k, top_p))
        for i in range(p, total - 1):
            step = model.decode_dense(
                out[:, i:i + 1].to(dev),
                torch.full((b,), i, dtype=torch.long, device=dev), caches,
                span=i + 1)
            out[:, i + 1] = torch.as_tensor(next_tokens(
                step[:, 0], seeds, [i + 1] * b, temps, top_k, top_p))
    return out


def _expand(tokens, scores, step_logits, i):
    """One beam expansion writing position i: log-softmax of each beam's
    fp32 logits, the k best (beam, token) candidates per row, the
    surviving beams' tokens gathered. tokens [b, k, L], scores [b, k],
    step_logits [b * k, vocab]. Returns (tokens, scores, flat source
    beam [b * k])."""
    b, k = scores.shape
    step = torch.log_softmax(step_logits.float().reshape(b, k, -1), dim=-1)
    cand = (scores[:, :, None] + step.cpu()).reshape(b, -1)
    vocab = step.shape[-1]
    vals, idx = torch.topk(cand, k, dim=-1)
    src = idx // vocab
    tokens = torch.gather(tokens, 1, src[:, :, None].expand_as(tokens))
    tokens[:, :, i] = idx % vocab
    flat_src = (torch.arange(b)[:, None] * k + src).reshape(-1)
    return tokens, vals, flat_src


def beam_search_generate(model, prompt, max_new_tokens, num_beams=4,
                         use_cache=False):
    """Beam search: keep the `num_beams` highest-log-probability
    continuations of each prompt row and return the best one, int64 [b,
    p + max_new_tokens] on the CPU. Initial beam scores are [0, -inf,
    ...], so the first expansion takes k distinct tokens of beam 0.
    Deterministic.

    The default runs the causal forward over every beam's tokens so far
    for each position. `use_cache` prefills the prompt once for the b
    rows (bucketed to 64), tiles the dense caches to b * num_beams rows
    and decodes one token a step (`decode_dense`), gathering the
    surviving beams' cache rows along the batch axis after each step;
    both return the same tokens, as in the JAX package."""
    prompt = torch.as_tensor(prompt, dtype=torch.long)
    b, p = prompt.shape
    total = _check_lengths(p, max_new_tokens, model.seq_len)
    k = int(num_beams)
    if k < 1 or k > model.vocab_size:
        raise ValueError("num_beams must be in [1, vocab_size], got %d" % k)
    dev = model.device
    tokens = torch.zeros((b, k, total), dtype=torch.long)
    tokens[:, :, :p] = prompt[:, None, :]
    scores = torch.full((b, k), float("-inf"))
    scores[:, 0] = 0.0
    with torch.no_grad():
        if not use_cache:
            for i in range(p, total):
                logits, _kv = model(tokens[:, :, :i].reshape(b * k, i).to(
                    dev))
                tokens, scores, _src = _expand(tokens, scores,
                                               logits[:, i - 1], i)
        else:
            caches, last = _prefill_dense(model, prompt, k)
            tokens, scores, _src = _expand(
                tokens, scores, last.repeat_interleave(k, dim=0), p)
            for i in range(p + 1, total):
                step = model.decode_dense(
                    tokens[:, :, i - 1].reshape(b * k, 1).to(dev),
                    torch.full((b * k,), i - 1, dtype=torch.long,
                               device=dev), caches, span=i)
                tokens, scores, src = _expand(tokens, scores, step[:, 0], i)
                src = src.to(dev)
                caches = [tuple(leaf.index_select(0, src) for leaf in layer)
                          for layer in caches]
    best = torch.argmax(scores, dim=-1)
    return tokens[torch.arange(b), best]


def speculative_generate(model, draft, prompt, max_new_tokens, gamma=4,
                         return_stats=False):
    """Speculative greedy decoding: the `draft` model proposes gamma - 1
    tokens a round and `model` (the target) verifies them in ONE
    gamma-token `decode_dense` chunk from position pos - 1. The round
    commits c = min over the batch of (accepted prefix + 1) tokens, the
    target's own argmax at each, so the output equals plain greedy
    decoding of the target; both models roll back by position only
    (rows past it are rewritten before they are read). Returns int64 [b,
    p + max_new_tokens] on the CPU, and with `return_stats` the JAX
    package's stats: verify_calls (target chunks after the prefill),
    committed_tokens and acceptance_rate (accepted proposals over gamma
    - 1 per verify).

    The draft's first step of a round feeds the two newest committed
    tokens (positions pos - 2 and pos - 1), so it rewrites row pos - 2:
    after a full acceptance no step of the last round fed the last
    proposal, and that row would stay stale (the JAX package feeds only
    the newest token and reads it stale; its tokens are exact all the
    same, but a perfect draft accepts less than it could). With a draft
    that never fully accepts, the stats equal the JAX package's."""
    prompt = torch.as_tensor(prompt, dtype=torch.long)
    b, p = prompt.shape
    if model.vocab_size != draft.vocab_size:
        raise ValueError("target and draft must share a vocabulary, got "
                         "%r vs %r" % (model.vocab_size, draft.vocab_size))
    gamma = int(gamma)
    if gamma < 1:
        raise ValueError("gamma must be >= 1, got %d" % gamma)
    total = p + int(max_new_tokens)
    seq_len = min(model.seq_len, draft.seq_len)
    if max_new_tokens < 1 or p < 1 or total + gamma - 1 > seq_len:
        raise ValueError(
            "need prompt %d + new %d + gamma %d - 1 <= min seq_len %d (the "
            "verify chunk must fit the cache)"
            % (p, max_new_tokens, gamma, seq_len))
    dev = model.device
    tokens = torch.zeros((b, total + gamma), dtype=torch.long)
    tokens[:, :p] = prompt
    n = acc = 0
    with torch.no_grad():
        t_caches, last = _prefill_dense(model, prompt, 1)
        d_caches, _ = _prefill_dense(draft, prompt, 1)
        tokens[:, p] = torch.argmax(last, dim=-1).cpu()
        pos = p + 1
        while pos < total:
            # draft: gamma - 1 greedy proposals for pos .. pos + gamma - 2
            tok = tokens[:, pos - 2:pos].to(dev)
            proposals = []
            for j in range(gamma - 1):
                start = pos - 1 + j - (tok.shape[1] - 1)
                lg = draft.decode_dense(
                    tok, torch.full((b,), start, dtype=torch.long,
                                    device=dev), d_caches, span=pos + j)
                tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
                proposals.append(tok)
            d_toks = (torch.cat(proposals, dim=1) if proposals
                      else torch.zeros((b, 0), dtype=torch.long, device=dev))
            # target: one chunk over pos - 1 .. pos + gamma - 2
            chunk = torch.cat([tokens[:, pos - 1:pos].to(dev), d_toks], 1)
            logits = model.decode_dense(
                chunk, torch.full((b,), pos - 1, dtype=torch.long,
                                  device=dev), t_caches, span=pos + gamma - 1)
            g = torch.argmax(logits, dim=-1)
            match = torch.cumprod((d_toks == g[:, :gamma - 1]).long(), dim=1)
            a = int(match.sum(dim=1).min().item()) if gamma > 1 else 0
            c = a + 1
            tokens[:, pos:pos + c] = g[:, :c].cpu()
            pos += c
            n += 1
            acc += a
    out = tokens[:, :total]
    if not return_stats:
        return out
    stats = {
        "verify_calls": n,
        "committed_tokens": int(max_new_tokens) - 1,
        "acceptance_rate": (float(acc) / max(1, (gamma - 1) * n)
                            if gamma > 1 else 0.0),
    }
    return out, stats
