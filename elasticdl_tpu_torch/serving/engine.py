"""Continuous-batching decode engines: the port of
elasticdl_tpu/serving/engine.py's ContinuousBatchingEngine (the dense
pool), PagedContinuousBatchingEngine (the block-paged pool) and
StepProfiler.

Both engines share one scheduler surface (insert / step / evict /
evict_expired / kv_stats / set_params):

* ContinuousBatchingEngine: every slot owns a dense stripe [hkv,
  seq_len, d] of a per-layer pool (`model.dense_cache`). insert = one
  prefill forward (bucketed to 64, kernel A on the card) whose rows are
  copied into the slot's stripe; step = ONE batched `decode_dense` over
  the active slots, each at its own position, its new row written in
  place. The dense pool is what `serving/main.py` serves by default, as
  in the JAX package.
* PagedContinuousBatchingEngine: KV rows live in shared block arenas
  (serving/kv_pool.py), slots hold block tables, admission works
  against the block budget, and a prompt whose full-block prefix is
  resident seats those blocks by incref and runs only its suffix, as
  ONE decode tile over the prefix (a full-prompt match re-runs its last
  token; that row's write is the planned copy-on-write). step = ONE
  batched `decode_paged` (kernel B's split kernel) over the active
  slots, then one scatter of the new rows.
  - Chunked prefill (`prefill_chunk_tokens` > 0): `begin_insert` seats a
    prompt and `advance_prefill` runs it as tiles of that many tokens,
    each the suffix-tile path pointed at a window [pos, pos + t) (B's
    tile kernel for tiles of more than SPLIT_MAX_ROWS rows), between
    decode steps; the final tile samples the first token.
  - Host spill tier (`host_bytes` > 0; None resolves from
    EDL_KV_HOST_BYTES): evicted prefix chains demote to host memory and a
    prompt that matches one seats by upload (serving/kv_pool.py), then
    runs only its suffix through the same tile as a resident match.
  - Prefill-only requests (`request.prefill_only`, the disaggregated
    prefill replica's cache warming, serving/disagg.py): seat, prefill,
    register the chain, release; the chain parks refcount-0 cached,
    matchable and exportable.
  - Speculative decode (`draft` model, `draft_k` = k): the draft holds a
    dense per-slot pool, prefilled with the full prompt at seat time;
    each tick it proposes k greedy tokens (k steps, the first fed the
    two newest committed tokens) and the target verifies them in ONE
    `decode_paged` over a (k + 1)-token tile. Acceptance is the longest
    greedy-matching prefix (0 for a sampled slot), c = min(accepted + 1,
    max(budget, 1)) tokens commit, rows past c are dropped before the
    scatter, and the draft rolls back by position only. Its tokens equal
    the plain step's. The JAX engine feeds only the newest token, so
    after a full acceptance its draft never writes the row of its k-th
    proposal and reads it stale from then on; the port's first step
    rewrites it (a perfect draft then accepts all its budget allows).

Weight-only int8 checkpoints (api/quantization): `set_params` dequantizes
their int8 leaves once, at the load, and the engine serves float weights
in the compute dtype, the JAX engines' default. Their in-jit variant
(EDL_SERVING_FUSED_DEQUANT=1, the int8 weights dequantized inside every
step) is not ported and raises.

Only active slots run, and only their rows are written (the JAX engine
runs every slot and drops the free lanes' writes). `set_params` swaps
the weights between steps: the checkpoint's values are copied into the
model's live tensors, cast to each one's dtype (bf16 for the matmul and
embedding weights after `use_compute_weights`), and in-flight sequences
keep their caches, positions and pending tokens. With a profiler
(`StepProfiler`) the engine synchronizes the card around each phase and
records its wall ms; without one it does no timing work.

Token parity with the JAX engines: greedy streams are identical; sampled
tokens follow the port's own (seed, position) contract
(api/generation.py), and a speculative tick commits exactly the token
the plain step would sample. Single-threaded by design: only the
scheduler thread calls the engine.
"""

import os
import threading
import time

import numpy as np
import torch

from elasticdl_tpu_torch.api.generation import (
    _prefill_bucket,
    kv_layout,
    next_tokens,
    run_prefill,
    serving_next_token,
    write_dense_rows,
)
from elasticdl_tpu_torch.api.quantization import (
    dequantize_params,
    is_quantized,
)
from elasticdl_tpu_torch.checkpoint.saver import (
    params_tree_from_flat,
    params_tree_leaves,
    restore_params_from_flat,
)
from elasticdl_tpu_torch.model_zoo.transformer_lm import (
    KV_CACHE_DTYPES,
    flax_param_path,
)
from elasticdl_tpu_torch.observability.histogram import LogLinearHistogram
from elasticdl_tpu_torch.serving.kv_pool import PagedKVPool


def kv_paged_default():
    """EDL_KV_PAGED resolves the pool layout when the config leaves it
    unset: the dense pool unless it is set to something but 0."""
    return os.environ.get("EDL_KV_PAGED", "") not in ("", "0")


def kv_host_bytes_default():
    """EDL_KV_HOST_BYTES resolves the paged pool's host spill-tier budget
    when the config leaves it unset (0 = eviction forgets)."""
    try:
        return int(os.environ.get("EDL_KV_HOST_BYTES", "") or 0)
    except ValueError:
        return 0


def role_default():
    """EDL_SERVING_ROLE resolves the replica's disaggregation role when
    the config leaves it unset: "prefill" | "decode" | "unified" (the
    default, serving both phases)."""
    role = os.environ.get("EDL_SERVING_ROLE", "") or "unified"
    if role not in ("prefill", "decode", "unified"):
        raise ValueError(
            "EDL_SERVING_ROLE must be prefill|decode|unified, got %r" % role)
    return role


def prefill_chunk_default():
    """EDL_PREFILL_CHUNK_TOKENS resolves the chunked-prefill tile width
    when the config leaves it unset (0 = monolithic prefill)."""
    try:
        return int(os.environ.get("EDL_PREFILL_CHUNK_TOKENS", "") or 0)
    except ValueError:
        return 0


def prefill_budget_default():
    """EDL_PREFILL_BUDGET_MS resolves the scheduler's per-tick budget of
    chunked-prefill tiles while decode slots wait (default 8 ms; <= 0 =
    unbounded). At least one tile runs per tick."""
    try:
        return float(os.environ.get("EDL_PREFILL_BUDGET_MS", "") or 8.0)
    except ValueError:
        return 8.0


def float_weights(flat):
    """A checkpoint's flat leaves with int8 weights dequantized, once:
    what the engines serve (the `.params` leaves rebuilt as a tree,
    dequantized and named again; the other leaves as they were). The
    in-step dequantize of the JAX engines' EDL_SERVING_FUSED_DEQUANT=1
    is not ported."""
    tree = params_tree_from_flat(flat)
    if not is_quantized(tree):
        return flat
    if os.environ.get("EDL_SERVING_FUSED_DEQUANT", "") not in ("", "0"):
        raise NotImplementedError(
            "EDL_SERVING_FUSED_DEQUANT=1 (int8 weights dequantized inside "
            "each step) is not ported; unset it to serve the weights "
            "dequantized once at load")
    out = {k: v for k, v in flat.items() if not k.startswith(".params[")}
    out.update(params_tree_leaves(dequantize_params(tree)))
    return out


def profile_default():
    """EDL_PROFILE resolves the step profiler when the config leaves it
    unset (off by default)."""
    return os.environ.get("EDL_PROFILE", "") not in ("", "0")


class StepProfiler(object):
    """Per-phase wall ms of the engine's work, each phase into a
    log-linear histogram (the JAX package's bucket scheme). The engine
    synchronizes the card before it reads the clock at each end of a
    phase, where JAX blocks on the phase's outputs. The phase set is
    closed; `observe` raises on any other name:

        prefill        full-prompt prefill forward + cache/block write
        suffix_tile    shared-prefix suffix tile over resident blocks
        prefill_tile   one chunked-prefill tile
        decode         the plain step (model + sample; paged: minus the
                       row scatter)
        draft          draft prefill at seat time and the k draft steps
                       of a speculative tick
        verify_commit  the (k + 1)-tile verify and the accept / commit
        scatter        row scatter into the paged arenas
        revive_upload  the host tier's batched upload of revived or
                       imported blocks (timed by the paged pool)
        reload_swap    a hot checkpoint swap (set_params)

    The scheduler thread records and any thread may snapshot: one
    lock."""

    PHASES = ("prefill", "suffix_tile", "prefill_tile", "decode",
              "draft", "verify_commit", "scatter", "revive_upload",
              "reload_swap")

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._lock = threading.Lock()
        self.hists = {p: LogLinearHistogram() for p in self.PHASES}

    def t(self):
        return self._clock()

    def observe(self, phase, secs):
        with self._lock:
            if phase not in self.hists:
                raise ValueError(
                    "unknown profiler phase %r (declared: %s)"
                    % (phase, ", ".join(self.PHASES)))
            self.hists[phase].record(secs * 1000.0)

    def snapshot(self):
        """{phase: {count, p50_ms, p99_ms, total_ms}} for the phases that
        recorded anything."""
        with self._lock:
            out = {}
            for phase in self.PHASES:
                h = self.hists[phase]
                if not h.count:
                    continue
                out[phase] = {
                    "count": h.count,
                    "p50_ms": round(h.percentile(50), 3),
                    "p99_ms": round(h.percentile(99), 3),
                    "total_ms": round(h.sum, 3),
                }
            return out


class _Slot(object):
    __slots__ = ("request", "max_total")

    def __init__(self, request, max_total):
        self.request = request
        self.max_total = max_total


class _PrefillJob(object):
    """One chunked prefill in flight (paged engine): the slot is seated,
    its full block budget reserved, and the prompt's rows land tile by
    tile through advance_prefill. `first` is the first generated token,
    set when the final tile lands; `finished` mirrors insert()'s."""

    __slots__ = ("slot", "request", "pos", "prompt_len", "first",
                 "finished", "tiles")

    def __init__(self, slot, request, pos):
        self.slot = slot
        self.request = request
        self.pos = int(pos)  # next prompt position to prefill
        self.prompt_len = len(request.prompt)
        self.first = None
        self.finished = False
        self.tiles = 0

    def done(self):
        return self.first is not None


def _cache_bytes(caches):
    return int(sum(t.numel() * t.element_size() for layer in caches
                   for t in layer))


class ContinuousBatchingEngine(object):
    """The dense decode pool for `model` (the port's TransformerLM, on
    its device). `top_k`/`top_p` are server-level sampling filters;
    temperature and seed ride per request. Freezes the model and casts
    its matmul weights to the compute dtype once
    (model.use_compute_weights)."""

    def __init__(self, model, num_slots, top_k=0, top_p=1.0):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if not 0.0 < top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1], got %r" % (top_p,))
        self.model = model.requires_grad_(False).use_compute_weights()
        self.device = model.device
        self.num_slots = int(num_slots)
        self.seq_len = int(model.seq_len)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.profiler = None
        # a ServingTelemetry the server attaches: the engine counts what
        # only it sees (prefix hits, copy-on-write faults, drafts)
        self.telemetry = None
        self.model_version = 0
        self.draft_k = 0  # speculative decode off (the paged engine's)
        self.draft_proposed = 0
        self.draft_accepted = 0
        self.prefill_chunk_tokens = 0  # the dense pool never chunks
        self._init_pool()
        self._slots = [None] * self.num_slots
        self._positions = np.zeros(self.num_slots, np.int64)
        self._last_tokens = np.zeros(self.num_slots, np.int64)
        self._prev_tokens = np.zeros(self.num_slots, np.int64)
        self._seeds = np.zeros(self.num_slots, np.int64)
        self._temps = np.zeros(self.num_slots, np.float64)

    def _init_pool(self):
        self._pool = self.model.dense_cache(self.num_slots)
        self._kv_bytes_total = _cache_bytes(self._pool)

    # ------------------------------------------------------------ timing

    def _tick(self):
        """The profiler's clock after the card's queued work, or None
        without a profiler."""
        if self.profiler is None:
            return None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.profiler.t()

    def _observe(self, phase, t0):
        if t0 is not None:
            t1 = self._tick()
            self.profiler.observe(phase, t1 - t0)

    # ------------------------------------------------------------ params

    def set_params(self, flat, version):
        """Swap the serving weights (hot reload) between decode steps:
        the `.params` leaves of a checkpoint's flat dict (checkpoint/
        saver.load_checkpoint) are copied in place into the model's
        tensors, each cast to that tensor's dtype; parameters the
        checkpoint lacks keep their values. In-flight sequences keep
        their caches, positions and pending tokens. Int8 weights
        (a quantized checkpoint) are dequantized here, once."""
        t0 = self._tick()
        restore_params_from_flat(self.model, flax_param_path,
                                 float_weights(flat), strict=False)
        self.model_version = int(version)
        self._observe("reload_swap", t0)

    # ------------------------------------------------------------- slots

    def free_slots(self):
        return [i for i, s in enumerate(self._slots) if s is None]

    def active_count(self):
        return sum(1 for s in self._slots if s is not None)

    def active_requests(self):
        return [s.request for s in self._slots if s is not None]

    def can_seat(self, request):
        """The dense pool has no resource besides a free slot."""
        return True

    def max_cached_tokens(self):
        return self.seq_len

    def kv_stats(self):
        """The JAX dense engine's keys: the whole pool is resident; in
        use are the stripes live requests pin."""
        per_slot = self._kv_bytes_total // max(1, self.num_slots)
        return {
            "kv_paged": False,
            "kv_shared": False,
            "kv_cache_dtype": self.model.kv_cache_dtype,
            "kv_block_size": 0,
            "kv_blocks_total": 0,
            "kv_blocks_free": 0,
            "kv_blocks_cached": 0,
            "kv_blocks_shared": 0,
            "kv_bytes_total": self._kv_bytes_total,
            "kv_bytes_in_use": self.active_count() * per_slot,
            "prefix_hit_tokens": 0,
            "cow_copies": 0,
            "kv_host_blocks": 0,
            "kv_host_bytes": 0,
            "kv_host_bytes_budget": 0,
            "revive_uploads": 0,
            "prefill_tokens_revived": 0,
            "host_drops": 0,
        }

    def _check_fits(self, request):
        total = len(request.prompt) + request.max_new_tokens
        if total > self.seq_len:
            raise ValueError("request needs %d positions > seq_len %d"
                             % (total, self.seq_len))
        return total

    def _seat(self, slot, request, total, first):
        self._slots[slot] = _Slot(request, total)
        self._positions[slot] = len(request.prompt)
        self._prev_tokens[slot] = request.prompt[-1]
        self._last_tokens[slot] = first
        self._seeds[slot] = request.seed
        self._temps[slot] = request.temperature

    def _sample_first(self, logits, request, position):
        return serving_next_token(logits, request.seed, position,
                                  request.temperature, self.top_k,
                                  self.top_p)

    def insert(self, request):
        """Seat `request` in a free slot: one prefill forward fills the
        slot's stripe for the prompt and gives the FIRST generated
        token. Returns (slot, first_token, finished)."""
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slot")
        slot = free[0]
        total = self._check_fits(request)
        p = len(request.prompt)
        t0 = self._tick()
        kv, last = run_prefill(self.model, request.prompt)
        write_dense_rows(self._pool, kv, slot, kv[0][0].shape[2])
        first = self._sample_first(last, request, p)
        self._observe("prefill", t0)
        request.generated.append(first)
        request.model_version = self.model_version
        finished = request.max_new_tokens <= 1
        if not finished:
            self._seat(slot, request, total, first)
        return slot, first, finished

    def evict(self, slot):
        """Free a slot; its stale rows stay until the next insert."""
        self._slots[slot] = None

    def evict_expired(self, now):
        """Evict every active request whose deadline has passed; returns
        the evicted requests."""
        out = []
        for i, st in enumerate(self._slots):
            if st is not None and st.request.expired(now):
                self.evict(i)
                out.append(st.request)
        return out

    def _active(self):
        return [(i, s) for i, s in enumerate(self._slots) if s is not None]

    def _lanes(self, idx):
        """The pool rows of the active slots `idx` for a dense read:
        None when every slot is active (the pool itself, no gather)."""
        if len(idx) == self.num_slots:
            return None
        return torch.as_tensor(idx, device=self.device)

    def _commit(self, active, tokens):
        """Append each active slot's committed tokens, advance it, free
        finished slots; returns the step's [(slot, request, tokens,
        finished)]."""
        out = []
        for (slot, st), toks in zip(active, tokens):
            st.request.generated.extend(toks)
            st.request.model_version = self.model_version
            self._positions[slot] += len(toks)
            self._prev_tokens[slot] = ([self._last_tokens[slot]] + toks)[-2]
            self._last_tokens[slot] = toks[-1]
            finished = (len(st.request.prompt) + len(st.request.generated)
                        >= st.max_total)
            if finished:
                self.evict(slot)
            out.append((slot, st.request, toks, finished))
        return out

    def step(self):
        """One batched dense decode step over the active slots: each
        advances one token at its own position, its row written into
        its stripe. Returns [(slot, request, [token], finished)]."""
        active = self._active()
        if not active:
            return []
        idx = np.array([i for i, _ in active])
        positions = self._positions[idx]
        dev = self.device
        t0 = self._tick()
        logits = self.model.decode_dense(
            torch.as_tensor(self._last_tokens[idx], device=dev)[:, None],
            torch.as_tensor(positions, device=dev), self._pool,
            slots=self._lanes(idx), span=int(positions.max()) + 1)
        toks = next_tokens(
            logits[:, 0], self._seeds[idx].tolist(),
            (positions + 1).tolist(), self._temps[idx].tolist(), self.top_k,
            self.top_p)
        self._observe("decode", t0)
        return self._commit(active, [[t] for t in toks])


class PagedContinuousBatchingEngine(ContinuousBatchingEngine):
    """The decode pool over block-paged KV storage for `model`, with
    prefix sharing (`share_prefix`), chunked prefill
    (`prefill_chunk_tokens`; None resolves from EDL_PREFILL_CHUNK_TOKENS)
    and speculative decode (a `draft` TransformerLM with `draft_k` >=
    1; the target itself may be its own draft). Same scheduler surface
    and token streams as the dense engine; see the module docstring.
    With a model whose kv_cache_dtype is "int8" the arenas hold int8
    rows and fp32 per-row scales. `host_bytes` (None resolves from
    EDL_KV_HOST_BYTES) is the host spill tier's byte budget."""

    #: the pool's monotone host-tier counters the telemetry mirrors
    _HOST_COUNTERS = ("revive_uploads", "prefill_tokens_revived",
                      "host_drops")

    def __init__(self, model, num_slots, top_k=0, top_p=1.0, block_size=16,
                 num_blocks=0, share_prefix=True, draft=None, draft_k=0,
                 prefill_chunk_tokens=None, host_bytes=None):
        if model.kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(
                "paged KV supports the plain-dtype and int8 cache formats "
                "(kv_cache_dtype=%r)" % (model.kv_cache_dtype,))
        self.block_size = int(block_size)
        # 0 = the dense-equivalent budget for this slot count
        self.num_blocks = int(num_blocks) or (
            int(num_slots) * -(-int(model.seq_len) // self.block_size))
        self._share = bool(share_prefix)
        self.host_bytes = (kv_host_bytes_default() if host_bytes is None
                           else int(host_bytes))
        super().__init__(model, num_slots, top_k=top_k, top_p=top_p)
        self.prefill_chunk_tokens = (
            prefill_chunk_default() if prefill_chunk_tokens is None
            else int(prefill_chunk_tokens))
        self._prefilling = {}  # slot -> _PrefillJob
        # the pool's monotone host-tier counters as last forwarded to the
        # telemetry, which mirrors them by delta
        self._host_counters_seen = dict.fromkeys(self._HOST_COUNTERS, 0)
        self._init_draft(draft, draft_k)

    def _init_pool(self):
        self.kv = PagedKVPool(
            kv_layout(self.model), self.seq_len, self.num_slots,
            self.num_blocks, self.block_size, share_prefix=self._share,
            device=self.device, host_bytes=self.host_bytes)
        self.kv.profiler = self.profiler
        self._kv_bytes_total = self.kv.bytes_total

    @property
    def profiler(self):
        return self._profiler

    @profiler.setter
    def profiler(self, value):
        # the pool times its own revive uploads
        self._profiler = value
        if hasattr(self, "kv"):
            self.kv.profiler = value

    def _init_draft(self, draft, draft_k):
        """Seat the draft for speculative decode: its own dense per-slot
        pool beside the paged target pool. It must share the target's
        vocabulary and cover its seq_len."""
        self._draft = None
        if draft is None or int(draft_k) < 1:
            return
        if draft.vocab_size != self.model.vocab_size:
            raise ValueError(
                "draft and target must share a vocabulary, got %r vs %r"
                % (draft.vocab_size, self.model.vocab_size))
        if int(draft.seq_len) < self.seq_len:
            raise ValueError("draft seq_len %d must cover the target's %d"
                             % (draft.seq_len, self.seq_len))
        if draft.device != self.device:
            raise ValueError("draft on %s, target on %s"
                             % (draft.device, self.device))
        self.draft_k = int(draft_k)
        self._draft = draft.requires_grad_(False).use_compute_weights()
        self._d_pool = self._draft.dense_cache(self.num_slots)

    def set_params(self, flat, version):
        """Hot reload, plus the prefix index flush: cached prefix rows
        were computed under the superseded weights, so no new request
        may seat on them (in-flight sequences keep theirs)."""
        super().set_params(flat, version)
        self.kv.flush_prefix_cache()

    # ------------------------------------------------------------- slots

    def free_slots(self):
        # a seated slot still prefilling is occupied
        return [i for i, s in enumerate(self._slots)
                if s is None and i not in self._prefilling]

    def active_requests(self):
        reqs = [s.request for s in self._slots if s is not None]
        reqs.extend(j.request for j in self._prefilling.values())
        return reqs

    def prefilling_count(self):
        return len(self._prefilling)

    def can_seat(self, request):
        if request.max_new_tokens <= 1 and not request.prefill_only:
            return True  # one-token answer; never touches the pool
        cached = len(request.prompt) + request.max_new_tokens - 1
        return self.kv.can_seat(request.prompt, len(request.prompt), cached)

    def max_cached_tokens(self):
        """A request must fit both one slot's table and the whole pool."""
        return min(self.seq_len, self.num_blocks * self.block_size)

    def kv_stats(self):
        return self.kv.stats()

    def _sync_host_telemetry(self):
        """Forward the pool's monotone host-tier counters (revival
        uploads, tokens revived instead of prefilled, host drops) to the
        telemetry by delta: the pool is the one source, so the mirror
        cannot drift whichever path (seat, extend, CoW) spilled."""
        if self.telemetry is None:
            return
        stats = self.kv.stats()
        for name in self._HOST_COUNTERS:
            delta = stats[name] - self._host_counters_seen[name]
            if delta:
                self.telemetry.count(name, delta)
                self._host_counters_seen[name] = stats[name]

    def _seat_blocks(self, slot, request):
        """Reserve the request's full block budget (reserve-or-raise
        before any compute; the scheduler checks can_seat first).
        Returns the shared prefix tokens."""
        return self.kv.seat(slot, request.prompt,
                            len(request.prompt) + request.max_new_tokens - 1)

    def insert(self, request):
        """Seat `request` in a free slot: prefill (or the shared-prefix
        suffix tile) produces the FIRST generated token. Returns (slot,
        first_token, finished); a one-token request skips the pool. A
        prefill-only request registers its chain and releases its slot
        (finished)."""
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slot")
        slot = free[0]
        total = self._check_fits(request)
        p = len(request.prompt)
        prefill_only = request.prefill_only
        decoding = request.max_new_tokens > 1 or prefill_only
        shared = self._seat_blocks(slot, request) if decoding else 0
        if shared:
            first = self._insert_shared(slot, request, shared)
        else:
            t0 = self._tick()
            kv, last = run_prefill(self.model, request.prompt)
            first = self._sample_first(last, request, p)
            if decoding:
                self.kv.write_prompt(kv, slot, p)
            self._observe("prefill", t0)
        request.generated.append(first)
        request.model_version = self.model_version
        if decoding:
            self.kv.register_prefix(slot, request.prompt)
            if self.draft_k and not prefill_only:
                self._prefill_draft(slot, request)
        self._sync_host_telemetry()
        if prefill_only:
            # the chain parks refcount-0 cached: matchable, exportable
            self.kv.release(slot)
        if not decoding or prefill_only:
            return slot, first, True
        self._seat(slot, request, total, first)
        return slot, first, False

    def _tile(self, slot, request, start, t, phase, final=True):
        """Decode prompt[start:start + t] as ONE tile over the slot's
        resident blocks through its table, scatter the tile's rows into
        the slot's blocks and, when `final`, sample the token at
        position start + t from the last real row."""
        t0 = self._tick()
        t_pad = self._suffix_bucket(t)
        chunk = torch.zeros((1, t_pad), dtype=torch.long)
        chunk[0, :t] = torch.as_tensor(request.prompt[start:start + t])
        table = self.kv.tables_device()[slot:slot + 1]
        logits, rows = self.model.decode_paged(
            chunk.to(self.device),
            torch.tensor([start], device=self.device),
            self.kv.pools, table)
        pos = np.arange(start, start + t)
        self.kv.scatter(
            [tuple(leaf[0, :, :t].transpose(0, 1) for leaf in layer)
             for layer in rows],
            self.kv.tables[slot, pos // self.block_size],
            pos % self.block_size)
        first = (self._sample_first(logits[0, t - 1], request, start + t)
                 if final else None)
        self._observe(phase, t0)
        return first

    def _insert_shared(self, slot, request, shared):
        """Seat on a prefix match: only the suffix `prompt[start:]`
        runs, as one tile; a full-prompt match re-runs its last token,
        whose write into the shared tail block is the planned
        copy-on-write."""
        p = len(request.prompt)
        if shared >= p:
            if (self.kv.cow_for_write(slot, p - 1) is not None
                    and self.telemetry is not None):
                self.telemetry.count("cow_copies")
            start = p - 1
        else:
            start = shared
        first = self._tile(slot, request, start, p - start, "suffix_tile")
        if self.telemetry is not None:
            # the allocator's shared tokens (a full match's re-run row
            # included), in step with its prefix_hit_tokens
            self.telemetry.count("prefix_hit_tokens", shared)
        return first

    def _suffix_bucket(self, t):
        """Tile widths in steps of 8 (the JAX engine's buckets)."""
        return min(self.seq_len, -(-int(t) // 8) * 8)

    # --------------------------------------------------- chunked prefill

    def begin_insert(self, request):
        """Chunked admission: seat `request` (the same full-budget
        reservation as insert) and return a _PrefillJob whose tiles
        advance_prefill runs between decode steps. A prompt that needs
        no chunking (chunking off, a one-token answer, a full-prompt
        prefix match) completes here: job.done() is True and job.first /
        job.finished carry insert()'s result."""
        if not self.prefill_chunk_tokens or (request.max_new_tokens <= 1
                                             and not request.prefill_only):
            slot, first, finished = self.insert(request)
            job = _PrefillJob(slot, request, len(request.prompt))
            job.first, job.finished = first, finished
            return job
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slot")
        slot = free[0]
        self._check_fits(request)
        p = len(request.prompt)
        shared = self._seat_blocks(slot, request)
        if shared >= p:
            # the one-token re-run tile is the whole prefill
            job = _PrefillJob(slot, request, p)
            self._finish_prefill(job,
                                 self._insert_shared(slot, request, shared))
            return job
        if shared and self.telemetry is not None:
            self.telemetry.count("prefix_hit_tokens", shared)
        job = _PrefillJob(slot, request, shared)
        self._prefilling[slot] = job
        return job

    def advance_prefill(self, job):
        """Run ONE tile of `job`'s pending prompt: up to
        prefill_chunk_tokens tokens at [pos, pos + t) over the slot's
        resident blocks, rows scattered. The final tile's sample
        (position = prompt length) is the first generated token. Returns
        True when the job completed in this call."""
        if job.done():
            return True
        t = min(self.prefill_chunk_tokens, job.prompt_len - job.pos)
        final = job.pos + t >= job.prompt_len
        first = self._tile(job.slot, job.request, job.pos, t, "prefill_tile",
                           final=final)
        job.pos += t
        job.tiles += 1
        if not final:
            return False
        self._finish_prefill(job, first)
        return True

    def _finish_prefill(self, job, first):
        """The chunked path's insert() epilogue: index the prompt, seat
        the draft, commit the first token, activate the slot."""
        slot, request = job.slot, job.request
        self._prefilling.pop(slot, None)
        self.kv.register_prefix(slot, request.prompt)
        if self.draft_k and not request.prefill_only:
            self._prefill_draft(slot, request)
        request.generated.append(first)
        request.model_version = self.model_version
        self._sync_host_telemetry()
        job.first = first
        if request.prefill_only or request.max_new_tokens <= 1:
            self.kv.release(slot)
            job.finished = True
            return
        self._seat(slot, request, job.prompt_len + request.max_new_tokens,
                   first)

    def abort_prefill(self, job):
        """Abandon a pending chunked prefill (deadline expiry between
        tiles): release the seat; shared ancestors survive under their
        other owners."""
        if self._prefilling.pop(job.slot, None) is None:
            return
        job.finished = True
        self.kv.release(job.slot)

    def _prefill_draft(self, slot, request):
        """Fill the draft's dense stripe for this prompt: the full
        prompt's prefill (kernel A on the card), the target's bucket."""
        t0 = self._tick()
        p_pad = _prefill_bucket(len(request.prompt), self.seq_len)
        kv, _last = run_prefill(self._draft, request.prompt, p_pad=p_pad)
        write_dense_rows(self._d_pool, kv, slot, p_pad)
        self._observe("draft", t0)

    def evict(self, slot):
        """Free the slot and drop its block references."""
        self._slots[slot] = None
        self._positions[slot] = 0
        self.kv.release(slot)

    # -------------------------------------------------------------- steps

    def step(self):
        """One batched paged decode step over the active slots: each
        advances one token at its own position through its own table,
        its new row written into its block. With a draft the step is the
        speculative tick, committing 1..k+1 tokens a slot. Returns
        [(slot, request, tokens, finished)]; finished slots are freed."""
        active = self._active()
        if not active:
            return []
        if self.draft_k:
            return self._spec_step(active)
        idx = np.array([i for i, _ in active])
        for i in idx:
            # the block this step writes, drawn from the reservation
            self.kv.ensure_blocks(int(i), int(self._positions[i]))
        # an extend's pop can spill under pressure
        self._sync_host_telemetry()
        dev = self.device
        positions = self._positions[idx]
        tables = self.kv.tables_device()[torch.as_tensor(idx, device=dev)]
        t0 = self._tick()
        logits, rows = self.model.decode_paged(
            torch.as_tensor(self._last_tokens[idx], device=dev)[:, None],
            torch.as_tensor(positions, device=dev),
            self.kv.pools, tables)
        toks = next_tokens(
            logits[:, 0], self._seeds[idx].tolist(), (positions + 1).tolist(),
            self._temps[idx].tolist(), self.top_k, self.top_p)
        self._observe("decode", t0)
        t0 = self._tick()
        self.kv.scatter(
            [tuple(leaf[:, :, 0] for leaf in layer) for layer in rows],
            self.kv.tables[idx, positions // self.block_size],
            positions % self.block_size)
        self._observe("scatter", t0)
        return self._commit(active, [[t] for t in toks])

    def _spec_step(self, active):
        """One speculative tick: k drafted tokens per active slot,
        verified in ONE (k + 1)-token paged decode, greedy-exact accept
        and rollback. Committed rows scatter; rows past the commit are
        dropped."""
        k = self.draft_k
        idx = np.array([i for i, _ in active])
        budgets = np.zeros(len(active), np.int64)
        for n, (i, st) in enumerate(active):
            pos = int(self._positions[i])
            # every block this tick might write (rows pos..pos+k, capped
            # at the slot's last needed row): the reservation's
            self.kv.ensure_blocks(i, min(pos + k, st.max_total - 2))
            budgets[n] = st.max_total - (len(st.request.prompt)
                                         + len(st.request.generated))
        self._sync_host_telemetry()  # ensure_blocks' pops can spill
        dev = self.device
        positions = self._positions[idx]
        pos_dev = torch.as_tensor(positions, device=dev)
        last = torch.as_tensor(self._last_tokens[idx], device=dev)
        # draft: k greedy steps from the committed position (its
        # rollback is this position: rows past it are never read). The
        # first step feeds the two newest committed tokens, rewriting
        # the row at pos - 1: after a full acceptance no draft step has
        # fed the k-th proposal, and its row would stay stale.
        t0 = self._tick()
        lanes, top = self._lanes(idx), int(positions.max())
        prev = torch.as_tensor(self._prev_tokens[idx], device=dev)
        tok, proposals = torch.stack([prev, last], dim=1), []
        for j in range(k):
            lg = self._draft.decode_dense(
                tok, pos_dev + j - tok.shape[1] + 1, self._d_pool,
                slots=lanes, span=min(top + j + 1, self._draft.seq_len))
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
            proposals.append(tok[:, 0])
        d_toks = torch.stack(proposals, dim=1)
        self._observe("draft", t0)
        # verify: row j of the tile predicts position pos + j + 1
        t0 = self._tick()
        tables = self.kv.tables_device()[torch.as_tensor(idx, device=dev)]
        logits, rows = self.model.decode_paged(
            torch.cat([last[:, None], d_toks], dim=1), pos_dev,
            self.kv.pools, tables)
        g = torch.argmax(logits, dim=-1)
        match = torch.cumprod((d_toks == g[:, :k]).long(), dim=1).sum(1)
        g, match = g.cpu().numpy(), match.cpu().numpy()
        temps = self._temps[idx]
        accepted = np.where(temps > 0.0, 0, match)
        counts = np.minimum(accepted + 1, np.maximum(budgets, 1))
        committed = []
        for n, (i, _st) in enumerate(active):
            a = int(accepted[n])
            toks = [int(x) for x in g[n, :a]]
            if temps[n] > 0.0:
                bonus = serving_next_token(
                    logits[n, a], int(self._seeds[i]), int(positions[n]) + 1
                    + a, float(temps[n]), self.top_k, self.top_p)
            else:
                bonus = int(g[n, a])
            committed.append((toks + [bonus])[:int(counts[n])])
        self._observe("verify_commit", t0)
        # scatter only the committed rows j < c
        t0 = self._tick()
        lane = np.repeat(np.arange(len(active)), counts)
        j = np.concatenate([np.arange(c) for c in counts])
        wpos = positions[lane] + j
        sel_lane = torch.as_tensor(lane, device=dev)
        sel_j = torch.as_tensor(j, device=dev)
        self.kv.scatter(
            [tuple(leaf[sel_lane, :, sel_j] for leaf in layer)
             for layer in rows],
            self.kv.tables[idx[lane], wpos // self.block_size],
            wpos % self.block_size)
        self._observe("scatter", t0)
        accepted_total = int((counts - 1).sum())
        self.draft_proposed += k * len(active)
        self.draft_accepted += accepted_total
        if self.telemetry is not None:
            self.telemetry.count("draft_proposed", k * len(active))
            if accepted_total:
                self.telemetry.count("draft_accepted", accepted_total)
        return self._commit(active, committed)
