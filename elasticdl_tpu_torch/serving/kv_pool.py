"""Block-paged KV storage for the serving engine: the port of
elasticdl_tpu/serving/kv_pool.py without its host spill tier and chain
export/import.

* KV rows live in per-layer block ARENAS, torch tensors on the device
  shaped `[num_blocks, block_size, kv_heads, head_dim]`, shared by every
  sequence on the server;
* a sequence's logical cache is its BLOCK TABLE, the ordered block ids
  covering positions `[j*block_size, (j+1)*block_size)`;
* `BlockAllocator` is the host-side accounting: a LIFO free list,
  refcounts, per-slot tables, a reservation ledger that guarantees a
  seated request can always extend to its full token budget, and (with
  share_prefix) the content-addressed prefix trie keyed
  `(parent block id, block token tuple)` with its reclaimable LRU and
  the planned copy-on-write credit. Same invariants as the JAX package:
  only FULL prompt blocks are indexed; a block is freed only at
  refcount 0; refcount-0 indexed blocks stay revivable until evicted
  leaf-first; out-of-blocks is an admission-time condition;
* `PagedKVPool` owns the arenas and the write paths: block-granular
  prompt insertion, per-step row scatter and the device-side CoW copy.

A layer's arenas are a tuple: (k, v) in the compute dtype, or for an
int8 cache (`kv_cache_dtype="int8"`) (k, v, k_scale, v_scale): int8 rows
and their fp32 per-row scales `[num_blocks, block_size, kv_heads, 1]`.
Every write path carries each leaf of the tuple the same way, with no
int8 case of its own (the JAX package's `kv_row_leaf` convention): rows
arrive quantized from the model, and the arenas only ever receive them.
The allocator and the prefix trie key on token ids, so sharing and CoW
do not depend on the format. Byte counts sum each leaf at its own dtype.

Writes go through plain tensor indexing. Where the JAX package drops
out-of-range writes (`mode="drop"` on a `num_blocks` sentinel id), the
port never builds such an index: callers pass only the rows to write.
"""

import collections

import numpy as np
import torch


class OutOfBlocks(Exception):
    """The pool cannot cover a request's block budget right now. The
    scheduler treats this as backpressure: the request stays queued
    until completions free blocks."""


def blocks_for(tokens, block_size):
    """Blocks covering `tokens` cache rows (0 tokens -> 0 blocks)."""
    return -(-int(tokens) // int(block_size))


class BlockAllocator(object):
    """Host-side block accounting: free list, refcounts, per-slot block
    tables, the reservation ledger, and (share_prefix=True) the
    content-addressed prefix index with its reclaimable LRU.

    `alloc(slot, tokens, commit_tokens, prompt)` materializes the blocks
    for `tokens` rows (seating the prompt's matched full blocks by
    incref) and RESERVES enough for `commit_tokens`; `extend` draws the
    growth from that reservation. `available()` is what admission may
    promise to new work: free + reclaimable - reserved."""

    def __init__(self, num_blocks, block_size, share_prefix=False):
        if num_blocks < 1:
            raise ValueError("num_blocks must be >= 1, got %d" % num_blocks)
        if block_size < 1:
            raise ValueError("block_size must be >= 1, got %d" % block_size)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.share_prefix = bool(share_prefix)
        # LIFO: the most recently freed block is reused first
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._tables = {}      # slot -> [block ids]
        self._committed = {}   # slot -> total blocks promised
        self._cow_credit = {}  # slot -> reserved CoW copies (0 or 1)
        self._reserved = 0     # promised-but-unmaterialized, all slots
        self._refcount = {}    # bid -> live references
        # prefix index: (parent id, block token tuple) -> bid; -1 is
        # the root parent. The key IS the content path.
        self._index = {}
        self._index_key = {}   # bid -> its index key
        self._children = {}    # bid -> set of indexed child bids
        # indexed children per parent: a cached block is evictable only
        # when it has none (leaf-first), kept incrementally
        self._rkids = {}
        # refcount-0 blocks still indexed, oldest first
        self._cached = collections.OrderedDict()
        # the subset of _cached with no indexed children, in the order
        # each became evictable
        self._evictable = collections.OrderedDict()
        self.cow_copies = 0         # monotone: CoW faults served
        self.prefix_hit_tokens = 0  # monotone: tokens seated by incref

    # ------------------------------------------------------------ queries

    def num_free(self):
        return len(self._free)

    def num_cached(self):
        """Reclaimable blocks: refcount 0 but still in the prefix index."""
        return len(self._cached)

    def blocks_in_use(self):
        """Blocks pinned by live references (refcount > 0)."""
        return self.num_blocks - len(self._free) - len(self._cached)

    def shared_blocks(self):
        """Blocks currently referenced by more than one table."""
        return sum(1 for c in self._refcount.values() if c > 1)

    def available(self):
        return len(self._free) + len(self._cached) - self._reserved

    def table(self, slot):
        return list(self._tables.get(slot, ()))

    # ----------------------------------------------------- prefix index

    def _full_block_tuples(self, prompt):
        bs = self.block_size
        return [tuple(int(t) for t in prompt[j * bs:(j + 1) * bs])
                for j in range(len(prompt) // bs)]

    def match_prefix(self, prompt):
        """Longest resident chain of full blocks covering a prefix of
        `prompt`, root-first. Read-only."""
        if not self.share_prefix:
            return []
        chain = []
        parent = -1
        for toks in self._full_block_tuples(prompt):
            bid = self._index.get((parent, toks))
            if bid is None:
                break
            chain.append(bid)
            parent = bid
        return chain

    def _plan(self, prompt, tokens, commit_tokens=None):
        """(chain, needed, cow) for seating `prompt` with `tokens` rows
        now and `commit_tokens` promised. `needed` counts the fresh
        blocks, the CoW credit of a full-prompt match whose shared tail
        is live, and the reclaimable chain blocks the seat would revive
        (incref pops them out of what available() counts). can_seat and
        alloc both run through here, so they cannot disagree."""
        now = blocks_for(tokens, self.block_size)
        commit = max(
            now, blocks_for(commit_tokens or tokens, self.block_size)
        )
        chain = self.match_prefix(prompt) if prompt is not None else []
        chain = chain[:now]
        cow = 1 if (chain and len(chain) * self.block_size >= int(tokens)
                    and chain[-1] not in self._cached) else 0
        revived = sum(1 for b in chain if b in self._cached)
        return chain, commit - len(chain) + cow + revived, cow

    def can_seat(self, prompt, tokens, commit_tokens=None):
        return self._plan(prompt, tokens, commit_tokens)[1] <= self.available()

    def register_prefix(self, slot, prompt):
        """Index `slot`'s FULL prompt blocks so later prompts can seat
        on them; levels already indexed keep their existing block."""
        if not self.share_prefix:
            return
        table = self._tables.get(slot)
        if table is None:
            return
        parent = -1
        for j, toks in enumerate(self._full_block_tuples(prompt)):
            if j >= len(table):
                break
            key = (parent, toks)
            bid = self._index.get(key)
            if bid is None:
                bid = table[j]
                if bid in self._index_key:
                    break  # indexed under another path: never re-key
                self._index[key] = bid
                self._index_key[bid] = key
                self._children.setdefault(parent, set()).add(bid)
                if parent >= 0:
                    self._rkids[parent] = self._rkids.get(parent, 0) + 1
                    self._evictable.pop(parent, None)
            parent = bid

    def flush_index(self):
        """Drop the whole prefix index (hot reload: the cached rows were
        computed under superseded weights, and no new request may seat
        on them). Reclaimable blocks return to the free list; live
        blocks only lose their index entry and free at refcount 0."""
        for bid in list(self._cached):
            self._free.append(bid)
            self._refcount.pop(bid, None)
        self._cached.clear()
        self._evictable.clear()
        self._index.clear()
        self._index_key.clear()
        self._children.clear()
        self._rkids.clear()

    # -------------------------------------------------------- refcounts

    def incref(self, bid):
        """Add a live reference, reviving `bid` from the reclaimable
        cache when its refcount was 0."""
        self._refcount[bid] = self._refcount.get(bid, 0) + 1
        self._cached.pop(bid, None)
        self._evictable.pop(bid, None)

    def decref(self, bid):
        """Drop a live reference; at refcount 0 the block becomes
        reclaimable (still indexed) or free (not indexed)."""
        rc = self._refcount.get(bid, 0) - 1
        if rc > 0:
            self._refcount[bid] = rc
            return
        self._refcount.pop(bid, None)
        if bid in self._index_key:
            self._cached[bid] = None
            if not self._rkids.get(bid):
                self._evictable[bid] = None
        else:
            self._free.append(bid)

    def _unindex(self, bid):
        """Remove index leaf `bid` from the prefix index."""
        key = self._index_key.pop(bid)
        del self._index[key]
        parent = key[0]
        kids = self._children.get(parent)
        if kids is not None:
            kids.discard(bid)
            if not kids:
                del self._children[parent]
        self._children.pop(bid, None)
        self._rkids.pop(bid, None)
        if parent >= 0:
            n = self._rkids.get(parent, 0) - 1
            if n > 0:
                self._rkids[parent] = n
            else:
                self._rkids.pop(parent, None)
                if parent in self._cached:
                    self._evictable[parent] = None

    def _pop_block(self):
        if self._free:
            return self._free.pop()
        try:
            bid = next(iter(self._evictable))
        except StopIteration:
            raise OutOfBlocks(
                "no evictable cached block (allocator invariant broken)"
            ) from None
        del self._evictable[bid]
        del self._cached[bid]
        self._unindex(bid)
        return bid

    # ------------------------------------------------------------- churn

    def alloc(self, slot, tokens, commit_tokens=None, prompt=None):
        """Materialize blocks for `tokens` rows under `slot` and reserve
        up to `commit_tokens`; raises OutOfBlocks (taking nothing) when
        the commitment is not coverable. Returns the SHARED token count
        (0 without a prefix match)."""
        if slot in self._tables:
            raise ValueError("slot %r already holds blocks" % (slot,))
        now = blocks_for(tokens, self.block_size)
        commit = max(
            now, blocks_for(commit_tokens or tokens, self.block_size)
        )
        chain, needed, cow = self._plan(prompt, tokens, commit_tokens)
        if needed > self.available():
            raise OutOfBlocks(
                "need %d new blocks (%d now, %d shared), %d available"
                % (needed, now, len(chain), self.available())
            )
        table_ids = []
        for bid in chain:
            self.incref(bid)
            table_ids.append(bid)
        while len(table_ids) < now:
            bid = self._pop_block()
            self.incref(bid)
            table_ids.append(bid)
        self._tables[slot] = table_ids
        self._committed[slot] = commit
        self._cow_credit[slot] = cow
        self._reserved += (commit - now) + cow
        self.prefix_hit_tokens += len(chain) * self.block_size
        return len(chain) * self.block_size

    def extend(self, slot, total_tokens):
        """Grow `slot`'s table to cover `total_tokens` rows, drawing the
        slot's reservation first. Returns the appended block ids."""
        table = self._tables.get(slot)
        if table is None:
            raise ValueError("slot %r holds no blocks" % (slot,))
        need = blocks_for(total_tokens, self.block_size) - len(table)
        added = []
        for _ in range(max(0, need)):
            if len(table) < self._committed[slot]:
                self._reserved -= 1
            elif self.available() < 1:
                raise OutOfBlocks(
                    "slot %r grew past its commitment and no block is "
                    "available" % (slot,)
                )
            else:
                self._committed[slot] += 1
            bid = self._pop_block()
            self.incref(bid)
            table.append(bid)
            added.append(bid)
        return added

    def cow(self, slot, block_index):
        """Copy-on-write fault before `slot` writes into
        table[block_index]: when that block is shared, a fresh block
        replaces it (drawing the slot's CoW credit) and the original is
        decref'd. Returns (old, new) when a copy is needed, else None."""
        table = self._tables.get(slot)
        if table is None:
            raise ValueError("slot %r holds no blocks" % (slot,))
        old = table[block_index]
        if self._refcount.get(old, 0) <= 1:
            return None
        if self._cow_credit.get(slot, 0) > 0:
            self._cow_credit[slot] -= 1
            self._reserved -= 1
        elif self.available() < 1:
            raise OutOfBlocks(
                "CoW fault on slot %r with no block available" % (slot,)
            )
        new = self._pop_block()
        self.incref(new)
        table[block_index] = new
        self.decref(old)
        self.cow_copies += 1
        return old, new

    def free(self, slot):
        """Release `slot`'s references and its remaining reservation;
        returns how many table entries were dropped."""
        table = self._tables.pop(slot, None)
        if table is None:
            return 0
        self._reserved -= (
            self._committed.pop(slot) - len(table)
            + self._cow_credit.pop(slot, 0)
        )
        for bid in table:
            self.decref(bid)
        return len(table)


# --------------------------------------------------------- arena writes


def build_pools(num_layers, kv_heads, head_dim, dtype, num_blocks,
                block_size, device, kv_cache_dtype=""):
    """Per-layer arenas of zeros on `device`: (k, v) [num_blocks,
    block_size, kv_heads, head_dim] in `dtype`, or for kv_cache_dtype
    "int8" (k, v) in int8 and (k_scale, v_scale) [num_blocks,
    block_size, kv_heads, 1] in fp32."""
    shape = (num_blocks, block_size, kv_heads, head_dim)
    if kv_cache_dtype == "int8":
        leaves = [(shape, torch.int8)] * 2 + [(shape[:3] + (1,),
                                               torch.float32)] * 2
    else:
        leaves = [(shape, dtype)] * 2
    return [tuple(torch.zeros(s, dtype=dt, device=device)
                  for s, dt in leaves) for _ in range(num_layers)]


def write_prompt_blocks(pools, kv, first_block, bids, block_size):
    """Insert blocks [first_block, first_block + len(bids)) of a
    prefilled sequence's rows into the arenas at block ids `bids`.
    `kv` holds per-layer rows [1, hkv, p_pad, last], one per arena of
    the layer; rows past p_pad (a block wider than the prefill bucket)
    are written as zeros. Rows past the true prompt length are junk that
    attention masks by length and decode overwrites before reading."""
    n = len(bids)
    lo, hi = first_block * block_size, (first_block + n) * block_size
    idx = torch.as_tensor(bids, dtype=torch.long, device=pools[0][0].device)
    for arenas, leaves in zip(pools, kv):
        for arena, rows in zip(arenas, leaves):
            rows = rows[0, :, lo:hi]  # [hkv, <= n*bs, last]
            if rows.shape[1] < hi - lo:
                rows = torch.nn.functional.pad(
                    rows, (0, 0, 0, hi - lo - rows.shape[1]))
            hkv, _, last = rows.shape
            arena[idx] = rows.reshape(hkv, n, block_size, last).permute(
                1, 2, 0, 3).to(arena.dtype)


def copy_block(pools, src, dst):
    """Device-side CoW: duplicate block `src` into `dst` in every arena
    (int8 rows and their scales alike)."""
    for arenas in pools:
        for arena in arenas:
            arena[dst] = arena[src]


def scatter_rows(pools, rows, bids, offs):
    """Write decode rows into the arenas: `rows` holds per layer one
    [n, hkv, last] tensor per arena, one row per (bids[i], offs[i])
    pair. Callers pass only live rows, and distinct live rows target
    distinct (block, offset) pairs."""
    for arenas, leaves in zip(pools, rows):
        for arena, leaf in zip(arenas, leaves):
            arena[bids, offs] = leaf.to(arena.dtype)


class PagedKVPool(object):
    """The device arenas + host tables for one serving engine: owns the
    BlockAllocator and the `[num_slots, cache_len / block_size]` int32
    table mirror (-1 = unallocated). The device copy of the tables is
    cached and re-uploaded only after a mutation."""

    def __init__(self, layout, cache_len, num_slots, num_blocks, block_size,
                 share_prefix=False, device="cuda"):
        num_layers, kv_heads, head_dim, dtype, kv_cache_dtype = layout
        self.kv_cache_dtype = kv_cache_dtype
        cache_len, block_size = int(cache_len), int(block_size)
        if cache_len % block_size:
            raise ValueError(
                "seq_len %d must be a multiple of kv_block_size %d"
                % (cache_len, block_size)
            )
        self.cache_len = cache_len
        self.block_size = block_size
        self.num_blocks = int(num_blocks)
        self.max_blocks_per_slot = cache_len // block_size
        self.device = torch.device(device)
        self.allocator = BlockAllocator(num_blocks, block_size,
                                        share_prefix=share_prefix)
        self.pools = build_pools(num_layers, kv_heads, head_dim, dtype,
                                 self.num_blocks, block_size, self.device,
                                 kv_cache_dtype)
        self.tables = np.full(
            (int(num_slots), self.max_blocks_per_slot), -1, np.int32
        )
        self._tables_dev = None
        # each leaf at its own dtype: int8 rows and fp32 scales
        self.bytes_total = int(sum(
            a.numel() * a.element_size() for arenas in self.pools
            for a in arenas
        ))
        self.block_bytes = self.bytes_total // max(1, self.num_blocks)

    def can_seat(self, prompt, prompt_tokens, commit_tokens):
        return self.allocator.can_seat(prompt, prompt_tokens, commit_tokens)

    def seat(self, slot, prompt, commit_tokens):
        """Reserve the request's full block budget and materialize the
        prompt's blocks (shared prefix blocks by incref); raises
        OutOfBlocks with nothing taken. Returns the shared token count."""
        shared = self.allocator.alloc(slot, len(prompt),
                                      commit_tokens=commit_tokens,
                                      prompt=prompt)
        self._sync_row(slot)
        return shared

    def register_prefix(self, slot, prompt):
        self.allocator.register_prefix(slot, prompt)

    def write_prompt(self, kv, slot, prompt_tokens, start_block=0):
        """Write the prefilled rows' blocks [start_block, ...) into the
        slot's allocated blocks (shared blocks below start_block are
        resident already)."""
        table = self.allocator.table(slot)
        end = blocks_for(prompt_tokens, self.block_size)
        if end > start_block:
            write_prompt_blocks(self.pools, kv, start_block,
                                table[start_block:end], self.block_size)

    def scatter(self, rows, bids, offs):
        """Write per-layer decode rows [n, hkv, last], one per arena, at
        (bids, offs)."""
        dev = self.device
        scatter_rows(self.pools, rows,
                     torch.as_tensor(bids, dtype=torch.long, device=dev),
                     torch.as_tensor(offs, dtype=torch.long, device=dev))

    def ensure_blocks(self, slot, pos):
        """Make sure the block covering cache position `pos` exists;
        draws the slot's reservation, so it cannot fail for a seated
        request."""
        if self.allocator.extend(slot, pos + 1):
            self._sync_row(slot)

    def cow_for_write(self, slot, pos):
        """Copy-on-write guard before `slot` writes cache position
        `pos`. Returns the (old, new) ids or None."""
        moved = self.allocator.cow(slot, pos // self.block_size)
        if moved is None:
            return None
        copy_block(self.pools, moved[0], moved[1])
        self._sync_row(slot)
        return moved

    def flush_prefix_cache(self):
        """Hot reload: forget every indexed prefix (BlockAllocator.
        flush_index)."""
        self.allocator.flush_index()

    def release(self, slot):
        freed = self.allocator.free(slot)
        if freed:
            self.tables[slot, :] = -1
            self._tables_dev = None
        return freed

    def _sync_row(self, slot):
        table = self.allocator.table(slot)
        row = np.full(self.max_blocks_per_slot, -1, np.int32)
        row[:len(table)] = table
        self.tables[slot] = row
        self._tables_dev = None

    def tables_device(self):
        """The block tables as one cached device tensor."""
        if self._tables_dev is None:
            self._tables_dev = torch.as_tensor(self.tables, device=self.device)
        return self._tables_dev

    def bytes_in_use(self):
        return self.allocator.blocks_in_use() * self.block_bytes

    def stats(self):
        alloc = self.allocator
        return {
            "kv_paged": True,
            "kv_shared": alloc.share_prefix,
            "kv_cache_dtype": self.kv_cache_dtype,
            "kv_block_size": self.block_size,
            "kv_blocks_total": self.num_blocks,
            "kv_blocks_free": alloc.num_free() + alloc.num_cached(),
            "kv_blocks_cached": alloc.num_cached(),
            "kv_blocks_shared": alloc.shared_blocks(),
            "kv_bytes_total": self.bytes_total,
            "kv_bytes_in_use": self.bytes_in_use(),
            "prefix_hit_tokens": alloc.prefix_hit_tokens,
            "cow_copies": alloc.cow_copies,
        }
