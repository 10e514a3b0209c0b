"""Continuous-batching decode engine over the block-paged KV pool: the
port of elasticdl_tpu/serving/engine.py's PagedContinuousBatchingEngine.

* insert = one prefill forward (bucketed to 64 like the JAX engine)
  whose rows land block by block in blocks drawn from the pool, with the
  request's full token budget reserved up front;
* with prefix sharing, a prompt whose full-block prefix is resident
  seats those blocks by incref and runs only the unshared suffix, as ONE
  decode tile over the resident prefix (a full-prompt match re-runs its
  last token; that row's write into the shared tail block is the
  planned copy-on-write);
* step = ONE batched paged-decode forward over the active slots, each at
  its own position through its own block table, then one scatter of the
  new rows into the arenas;
* evict returns a slot's blocks (shared ones survive under their other
  owners).

With a model whose kv_cache_dtype is "int8" the arenas hold int8 rows
and fp32 per-row scales; the engine scatters the quantized rows the
model returns as they are.

Token parity with the JAX engine: greedy streams are identical; sampled
tokens follow the port's own (seed, position) contract
(api/generation.py). Single-threaded by design: only the scheduler
thread calls insert/step/evict. Speculative decode, chunked prefill, the
dense engine and the step profiler are not ported yet.
"""

import numpy as np
import torch

from elasticdl_tpu_torch.api.generation import (
    kv_layout,
    next_tokens,
    run_prefill,
    serving_next_token,
)
from elasticdl_tpu_torch.model_zoo.transformer_lm import KV_CACHE_DTYPES
from elasticdl_tpu_torch.serving.kv_pool import PagedKVPool


class _Slot(object):
    __slots__ = ("request", "max_total")

    def __init__(self, request, max_total):
        self.request = request
        self.max_total = max_total


class PagedContinuousBatchingEngine(object):
    """The decode pool over block-paged KV storage for `model` (the
    port's TransformerLM, on its device). `top_k`/`top_p` are
    server-level sampling filters; temperature and seed ride per
    request. Freezes the model (no parameter requires grad) and casts its
    matmul weights to its compute dtype once
    (model.use_compute_weights)."""

    def __init__(self, model, num_slots, top_k=0, top_p=1.0, block_size=16,
                 num_blocks=0, share_prefix=True):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if not 0.0 < top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1], got %r" % (top_p,))
        if model.kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(
                "paged KV supports the plain-dtype and int8 cache formats "
                "(kv_cache_dtype=%r)" % (model.kv_cache_dtype,)
            )
        self.model = model.requires_grad_(False).use_compute_weights()
        self.device = model.device
        self.num_slots = int(num_slots)
        self.seq_len = int(model.seq_len)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.block_size = int(block_size)
        # 0 = the dense-equivalent budget for this slot count
        self.num_blocks = int(num_blocks) or (
            self.num_slots * -(-self.seq_len // self.block_size)
        )
        self.kv = PagedKVPool(
            kv_layout(model), self.seq_len, self.num_slots,
            self.num_blocks, self.block_size, share_prefix=share_prefix,
            device=self.device,
        )
        self._slots = [None] * self.num_slots
        self._positions = np.zeros(self.num_slots, np.int64)
        self._last_tokens = np.zeros(self.num_slots, np.int64)
        self._seeds = np.zeros(self.num_slots, np.int64)
        self._temps = np.zeros(self.num_slots, np.float64)

    # ------------------------------------------------------------- slots

    def free_slots(self):
        return [i for i, s in enumerate(self._slots) if s is None]

    def active_count(self):
        return sum(1 for s in self._slots if s is not None)

    def active_requests(self):
        return [s.request for s in self._slots if s is not None]

    def can_seat(self, request):
        if request.max_new_tokens <= 1:
            return True  # one-token answer; never touches the pool
        cached = len(request.prompt) + request.max_new_tokens - 1
        return self.kv.can_seat(request.prompt, len(request.prompt), cached)

    def max_cached_tokens(self):
        """A request must fit both one slot's table and the whole pool."""
        return min(self.seq_len, self.num_blocks * self.block_size)

    def kv_stats(self):
        return self.kv.stats()

    def insert(self, request):
        """Seat `request` in a free slot: prefill (or the shared-prefix
        suffix tile) produces the FIRST generated token. Returns (slot,
        first_token, finished); a one-token request skips the pool."""
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slot")
        slot = free[0]
        p = len(request.prompt)
        total = p + request.max_new_tokens
        if total > self.seq_len:
            raise ValueError(
                "request needs %d positions > seq_len %d"
                % (total, self.seq_len)
            )
        decoding = request.max_new_tokens > 1
        shared = 0
        if decoding:
            # reserve-or-raise before any compute (the scheduler checks
            # can_seat first, so raising here is a bug guard)
            shared = self.kv.seat(slot, request.prompt,
                                  p + request.max_new_tokens - 1)
        if shared:
            first = self._insert_shared(slot, request, shared)
        else:
            kv, last = run_prefill(self.model, request.prompt)
            first = serving_next_token(last, request.seed, p,
                                       request.temperature, self.top_k,
                                       self.top_p)
            if decoding:
                self.kv.write_prompt(kv, slot, p)
        request.generated.append(first)
        if not decoding:
            return slot, first, True
        self.kv.register_prefix(slot, request.prompt)
        self._slots[slot] = _Slot(request, total)
        self._positions[slot] = p
        self._last_tokens[slot] = first
        self._seeds[slot] = request.seed
        self._temps[slot] = request.temperature
        return slot, first, False

    def _insert_shared(self, slot, request, shared):
        """Seat on a prefix match: decode `prompt[start:]` as ONE tile
        over the resident prefix blocks through the slot's table, write
        its rows into the slot's blocks, sample the first token from the
        last real row."""
        p = len(request.prompt)
        if shared >= p:
            self.kv.cow_for_write(slot, p - 1)
            start = p - 1
        else:
            start = shared
        t = p - start
        t_pad = self._suffix_bucket(t)
        chunk = torch.zeros((1, t_pad), dtype=torch.long)
        chunk[0, :t] = torch.as_tensor(request.prompt[start:])
        table = self.kv.tables_device()[slot:slot + 1]
        logits, rows = self.model.decode_paged(
            chunk.to(self.device),
            torch.tensor([start], device=self.device),
            self.kv.pools, table,
        )
        pos = np.arange(start, start + t)
        bids = self.kv.tables[slot, pos // self.block_size]
        self.kv.scatter(
            [tuple(leaf[0, :, :t].transpose(0, 1) for leaf in layer)
             for layer in rows],
            bids, pos % self.block_size,
        )
        return serving_next_token(logits[0, t - 1], request.seed, p,
                                  request.temperature, self.top_k,
                                  self.top_p)

    def _suffix_bucket(self, t):
        """Suffix tile widths in steps of 8 (the JAX engine's buckets)."""
        return min(self.seq_len, -(-int(t) // 8) * 8)

    def evict(self, slot):
        """Free the slot and drop its block references."""
        self._slots[slot] = None
        self._positions[slot] = 0
        self.kv.release(slot)

    def evict_expired(self, now):
        """Evict every active request whose deadline has passed; returns
        the evicted requests."""
        out = []
        for i, st in enumerate(self._slots):
            if st is not None and st.request.expired(now):
                self.evict(i)
                out.append(st.request)
        return out

    def step(self):
        """One batched paged decode step over the active slots: each
        advances one token at its own position through its own table,
        and its new row is written into its block. Returns [(slot,
        request, [token], finished)]; finished slots are freed."""
        active = [(i, s) for i, s in enumerate(self._slots) if s is not None]
        if not active:
            return []
        idx = np.array([i for i, _ in active])
        for i in idx:
            # the block this step writes, drawn from the reservation
            self.kv.ensure_blocks(int(i), int(self._positions[i]))
        dev = self.device
        positions = self._positions[idx]
        tables = self.kv.tables_device()[torch.as_tensor(idx, device=dev)]
        logits, rows = self.model.decode_paged(
            torch.as_tensor(self._last_tokens[idx], device=dev)[:, None],
            torch.as_tensor(positions, device=dev),
            self.kv.pools, tables,
        )
        self.kv.scatter(
            [tuple(leaf[:, :, 0] for leaf in layer) for layer in rows],
            self.kv.tables[idx, positions // self.block_size],
            positions % self.block_size,
        )
        toks = next_tokens(
            logits[:, 0], self._seeds[idx].tolist(), (positions + 1).tolist(),
            self._temps[idx].tolist(), self.top_k, self.top_p,
        )
        out = []
        for (slot, st), token in zip(active, toks):
            self._positions[slot] += 1
            st.request.generated.append(token)
            self._last_tokens[slot] = token
            finished = (len(st.request.prompt) + len(st.request.generated)
                        >= st.max_total)
            if finished:
                self.evict(slot)
            out.append((slot, st.request, [token], finished))
        return out
