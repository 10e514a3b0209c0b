"""Block-paged KV storage for the serving engine: the port of
elasticdl_tpu/serving/kv_pool.py.

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

TIERED HOST SPILL (host_bytes > 0): eviction demotes a refcount-0
indexed block instead of forgetting it. Its rows (every leaf, scales
included) are copied into host tensors and its trie entry is re-keyed
onto a negative VIRTUAL id (<= -2, minted monotonically, never reused),
so the index keeps resolving the chain. A prompt that matches a spilled
chain revives it by UPLOAD into freshly allocated blocks (one batched
write per leaf) instead of re-running its prefill; the planner charges a
fresh block for each spilled chain entry, so admission and allocation
cannot disagree. Eviction is leaf-first in both tiers (a block spills
only when its indexed children are all spilled; a spilled entry drops
only when it has no indexed children), so every trie path stays
complete: a resident prefix, a spilled suffix, never a hole. The host
tier never exceeds its budget (LRU drop of the oldest childless spilled
entry), and `flush_index` (hot reload) empties both tiers. Both host
copies are synchronous: the spill copies a block's rows out before its
id is handed to a new owner, and an upload's source is never freed
before the copy ends.

CHAIN EXPORT / IMPORT (disaggregated prefill/decode, serving/disagg.py):
`export_chain` copies a prompt's indexed chain out as dense bytes
(resident blocks through the spill tier's gather, spilled ones from the
host store), `import_chain` lands a sibling replica's chain in fresh
blocks re-keyed into this trie. The row leaves travel in the JAX
package's `jax.tree.leaves` order of its pool tree: layers by the name
`block_%d` sorted as strings (block_10 before block_2), and in a layer
k, k_scale, v, v_scale (`wire_order`); dtypes are named as numpy names
them (`bfloat16`, `int8`, `float32`).

Writes go through plain tensor indexing. Where the JAX package drops
out-of-range writes (`mode="drop"` on a `num_blocks` sentinel id) and
pads uploads to power-of-two buckets, the port never builds such an
index: callers pass only the rows to write, and nothing is compiled.
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
    content-addressed prefix index with its reclaimable LRU and, with
    `host_blocks` > 0, its host spill tier.

    `alloc(slot, tokens, commit_tokens, prompt)` materializes the blocks
    for `tokens` rows (seating the prompt's matched full blocks by
    incref, reviving spilled ones onto fresh blocks) and RESERVES enough
    for `commit_tokens`; `extend` draws the growth from that
    reservation. `available()` is what admission may promise to new
    work: free + reclaimable - reserved."""

    def __init__(self, num_blocks, block_size, share_prefix=False,
                 host_blocks=0):
        if num_blocks < 1:
            raise ValueError("num_blocks must be >= 1, got %d" % num_blocks)
        if block_size < 1:
            raise ValueError("block_size must be >= 1, got %d" % block_size)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.share_prefix = bool(share_prefix)
        # host-spill tier capacity, in blocks (0 = eviction forgets)
        self.host_blocks = int(host_blocks)
        # LIFO: the most recently freed block is reused first
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._tables = {}      # slot -> [block ids]
        self._committed = {}   # slot -> total blocks promised
        self._cow_credit = {}  # slot -> reserved CoW copies (0 or 1)
        self._reserved = 0     # promised-but-unmaterialized, all slots
        self._refcount = {}    # bid -> live references
        # prefix index: (parent id, block token tuple) -> id; -1 is the
        # root parent. Ids >= 0 are device blocks (resident), ids <= -2
        # virtual ids of spilled entries whose rows live on the host.
        self._index = {}
        self._index_key = {}   # id -> its index key
        self._children = {}    # id -> set of indexed child ids
        # resident indexed children per parent: a cached block is
        # device-evictable only when it has none (leaf-first), kept
        # incrementally
        self._rkids = {}
        # refcount-0 blocks still indexed, oldest first
        self._cached = collections.OrderedDict()
        # the subset of _cached with no resident indexed children, in
        # the order each became evictable
        self._evictable = collections.OrderedDict()
        # spilled entries: vid -> None, oldest spill first (host LRU)
        self._spilled = collections.OrderedDict()
        # droppable spilled entries (no indexed children), oldest first
        self._spill_leaves = collections.OrderedDict()
        self._next_vid = -2
        # the data path's hooks (PagedKVPool wires them): the spill sink
        # copies a dying block's rows out, the drop sink discards a host
        # entry. Accounting here, bytes there.
        self._spill_sink = None  # fn(bid, vid)
        self._drop_sink = None   # fn(vid)
        self._revived = []       # [(vid, new bid)] drained by the seat
        self.cow_copies = 0         # monotone: CoW faults served
        self.prefix_hits = 0        # monotone: seats that matched
        self.prefix_hit_tokens = 0  # monotone: tokens seated by incref
        self.spills = 0             # monotone: blocks demoted to host
        self.host_drops = 0         # monotone: spilled entries dropped
        self.blocks_revived = 0     # monotone: spilled blocks uploaded

    # ------------------------------------------------------------ queries

    def num_free(self):
        return len(self._free)

    def num_cached(self):
        """Reclaimable blocks: refcount 0 but still in the prefix index."""
        return len(self._cached)

    def num_spilled(self):
        """Spilled entries: chains demoted to the host tier, still
        resolvable by the prefix index, revivable by upload."""
        return len(self._spilled)

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
        """Longest indexed chain of full blocks covering a prefix of
        `prompt`, root-first: device ids, then (host tier) virtual ids
        of spilled entries. Read-only."""
        if not self.share_prefix:
            return []
        chain = []
        parent = -1
        for toks in self._full_block_tuples(prompt):
            node = self._index.get((parent, toks))
            if node is None:
                break
            chain.append(node)
            parent = node
        return chain

    def _plan(self, prompt, tokens, commit_tokens=None):
        """(chain, needed, cow) for seating `prompt` with `tokens` rows
        now and `commit_tokens` promised. `needed` counts the fresh
        blocks, the CoW credit of a full-prompt match whose shared tail
        is resident and live, the reclaimable chain blocks the seat
        would revive (incref pops them out of what available() counts)
        and one fresh block for every spilled chain entry (its upload
        lands in a new block). A reclaimable or spilled tail takes no
        CoW credit: the seat owns it alone and the re-run row lands in
        place. can_seat and alloc both run through here, so they cannot
        disagree."""
        now = blocks_for(tokens, self.block_size)
        commit = max(
            now, blocks_for(commit_tokens or tokens, self.block_size)
        )
        chain = self.match_prefix(prompt) if prompt is not None else []
        chain = chain[:now]
        cow = 1 if (chain and len(chain) * self.block_size >= int(tokens)
                    and chain[-1] >= 0
                    and chain[-1] not in self._cached) else 0
        revived = sum(1 for b in chain if b in self._cached)
        resident = len(chain) - sum(1 for b in chain if b < 0)
        return chain, commit - resident + cow + revived, cow

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
                self._index_key[bid] = key
                self._link(key, bid)
            parent = bid

    def _link(self, key, bid):
        """Index resident block `bid` under `key`: its parent gains a
        resident child and leaves the eviction frontier."""
        parent = key[0]
        self._index[key] = bid
        self._children.setdefault(parent, set()).add(bid)
        if parent >= 0:
            self._rkids[parent] = self._rkids.get(parent, 0) + 1
            self._evictable.pop(parent, None)

    def flush_index(self):
        """Drop the whole prefix index, both tiers (hot reload: the
        cached rows were computed under superseded weights, and no new
        request may seat on them). Reclaimable blocks return to the free
        list, spilled entries drop their host rows; live blocks only
        lose their index entry and free at refcount 0."""
        for bid in list(self._cached):
            self._free.append(bid)
            self._refcount.pop(bid, None)
        self._cached.clear()
        self._evictable.clear()
        for vid in list(self._spilled):
            if self._drop_sink is not None:
                self._drop_sink(vid)
            self.host_drops += 1
        self._spilled.clear()
        self._spill_leaves.clear()
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

    def _dec_resident_kid(self, parent):
        """A resident indexed child of `parent` left the device tier
        (forgotten or spilled); at zero resident children a cached
        parent becomes device-evictable."""
        if parent < 0:
            return
        n = self._rkids.get(parent, 0) - 1
        if n > 0:
            self._rkids[parent] = n
            return
        self._rkids.pop(parent, None)
        if parent in self._cached:
            self._evictable[parent] = None

    def _unindex(self, node):
        """Remove index leaf `node` (a bid or a vid) from the index."""
        key = self._index_key.pop(node)
        del self._index[key]
        parent = key[0]
        kids = self._children.get(parent)
        if kids is not None:
            kids.discard(node)
            if not kids:
                del self._children[parent]
                if parent in self._spilled:
                    # the parent just became a host-droppable leaf
                    self._spill_leaves[parent] = None
        self._children.pop(node, None)
        self._rkids.pop(node, None)
        if node >= 0:
            self._dec_resident_kid(parent)

    def _rekey(self, old, new):
        """Move index entry `old` onto id `new` (spill: bid -> vid,
        revive: vid -> bid): its own key, its place among its parent's
        children, and its children's keys (only the parent-id half of a
        key moves; the token tuples are the content path). Returns
        (parent id, whether `old` had indexed children)."""
        key = self._index_key.pop(old)
        self._index[key] = new
        self._index_key[new] = key
        kids = self._children.get(key[0])
        if kids is not None:
            kids.discard(old)
            kids.add(new)
        sub = self._children.pop(old, None)
        if sub:
            self._children[new] = sub
            for child in sub:
                ckey = self._index_key.pop(child)
                del self._index[ckey]
                nkey = (new, ckey[1])
                self._index[nkey] = child
                self._index_key[child] = nkey
        return key[0], bool(sub)

    def _drop_spilled(self):
        """Drop the oldest CHILDLESS spilled entry (leaf-first in the
        host tier too). A spilled entry always has a childless
        descendant, since device eviction is leaf-first."""
        try:
            vid = next(iter(self._spill_leaves))
        except StopIteration:
            raise OutOfBlocks(
                "no droppable spilled entry (host tier invariant broken)"
            ) from None
        del self._spill_leaves[vid]
        del self._spilled[vid]
        self._unindex(vid)
        if self._drop_sink is not None:
            self._drop_sink(vid)
        self.host_drops += 1

    def _spill(self, bid):
        """Demote evicted block `bid` to the host tier under a fresh
        virtual id: its rows copy out through the spill sink BEFORE the
        block id is reused, its entry and its (already spilled)
        children re-key onto the vid, and the host LRU drops its oldest
        leaves to stay inside the budget."""
        while len(self._spilled) >= self.host_blocks:
            self._drop_spilled()
        vid = self._next_vid
        self._next_vid -= 1
        if self._spill_sink is not None:
            self._spill_sink(bid, vid)
        parent, has_kids = self._rekey(bid, vid)
        if not has_kids:
            self._spill_leaves[vid] = None
        self._rkids.pop(bid, None)
        self._spilled[vid] = None
        self._dec_resident_kid(parent)
        self.spills += 1

    def _revive(self, vid, bid):
        """Promote spilled entry `vid` onto device block `bid` (the pool
        uploads its rows): the entry and its spilled children re-key
        onto the bid, and the move is logged for the batched upload."""
        del self._spilled[vid]
        self._spill_leaves.pop(vid, None)
        parent, _ = self._rekey(vid, bid)
        if parent >= 0:
            self._rkids[parent] = self._rkids.get(parent, 0) + 1
            self._evictable.pop(parent, None)
        self._revived.append((vid, bid))
        self.blocks_revived += 1

    def take_revived(self):
        """Drain the (vid, bid) moves the last alloc revived."""
        out = self._revived
        self._revived = []
        return out

    def _evict_cached(self):
        """Reclaim the oldest device-evictable block: it spills with a
        host tier, else it is forgotten."""
        try:
            bid = next(iter(self._evictable))
        except StopIteration:
            raise OutOfBlocks(
                "no evictable cached block (allocator invariant broken)"
            ) from None
        del self._evictable[bid]
        del self._cached[bid]
        if self.host_blocks > 0:
            self._spill(bid)
        else:
            self._unindex(bid)
        return bid

    def _pop_block(self):
        if self._free:
            return self._free.pop()
        return self._evict_cached()

    # ------------------------------------------------------------- churn

    def alloc(self, slot, tokens, commit_tokens=None, prompt=None):
        """Materialize blocks for `tokens` rows under `slot` and reserve
        up to `commit_tokens`; raises OutOfBlocks (taking nothing) when
        the commitment is not coverable. Returns the SHARED token count
        (resident and revived chain blocks; 0 without a match)."""
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
        # resident entries by incref, spilled ones by revival onto a
        # fresh block. A pop's own spill cascade can drop a spilled
        # entry not yet revived: the chain ends there and the rest draws
        # fresh (the plan charged a fresh block for each spilled entry
        # either way, so only the shared count shrinks)
        table_ids = []
        shared_blocks = 0
        for node in chain:
            if node >= 0:
                self.incref(node)
                table_ids.append(node)
                shared_blocks += 1
                continue
            if node not in self._spilled:
                break  # dropped since plan time
            bid = self._pop_block()
            self.incref(bid)
            table_ids.append(bid)
            if node not in self._spilled:
                break  # this pop's cascade dropped it: a plain draw
            self._revive(node, bid)
            shared_blocks += 1
        while len(table_ids) < now:
            bid = self._pop_block()
            self.incref(bid)
            table_ids.append(bid)
        self._tables[slot] = table_ids
        self._committed[slot] = commit
        self._cow_credit[slot] = cow
        self._reserved += (commit - now) + cow
        if shared_blocks:
            self.prefix_hits += 1
            self.prefix_hit_tokens += shared_blocks * self.block_size
        return shared_blocks * self.block_size

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


def wire_order(num_layers, int8):
    """(layer, leaf) pairs of a pool's row leaves in the JAX package's
    `jax.tree.leaves` order of its pool tree: layers as their names
    `block_%d` sort, and a layer's leaves as k, k_scale, v, v_scale
    (the port's tuple is (k, v, k_scale, v_scale))."""
    leaves = (0, 2, 1, 3) if int8 else (0, 1)
    return [(layer, j) for layer in sorted(range(num_layers),
                                           key=lambda i: "block_%d" % i)
            for j in leaves]


def dtype_name(dtype):
    """A torch dtype named as numpy (and the JAX package) name it."""
    return str(dtype).replace("torch.", "")


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


def _settle_chain_refs(alloc, bids):
    """Drop an import walk's keep-alive references root-first, so the
    chain parks refcount-0 cached. Called from a finally: it runs even
    when the walk or the upload failed."""
    for bid in bids:
        alloc.decref(bid)


class PagedKVPool(object):
    """The device arenas + host tables for one serving engine: owns the
    BlockAllocator and the `[num_slots, cache_len / block_size]` int32
    table mirror (-1 = unallocated). The device copy of the tables is
    cached and re-uploaded only after a mutation. `host_bytes` > 0 arms
    the host spill tier: `host_bytes // block_bytes` spilled blocks, each
    costing exactly block_bytes of host memory."""

    def __init__(self, layout, cache_len, num_slots, num_blocks, block_size,
                 share_prefix=False, device="cuda", host_bytes=0):
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
        self._order = wire_order(num_layers, kv_cache_dtype == "int8")
        # ---- the host spill tier: the budget is bytes, the allocator
        # counts blocks
        self.host_bytes_budget = int(host_bytes)
        self.allocator.host_blocks = (
            self.host_bytes_budget // self.block_bytes
            if self.block_bytes else 0)
        self.allocator._spill_sink = self._spill_block
        self.allocator._drop_sink = self._drop_host_block
        self._host_rows = {}   # vid -> [CPU rows per leaf, wire order]
        self.revive_uploads = 0  # monotone: batched revival writes
        # the disaggregated handoff's economy (serving/disagg.py)
        self.chain_exports = 0
        self.chain_imports = 0
        self.chain_import_tokens = 0
        # a StepProfiler the engine forwards: the pool times its revive
        # uploads, the one phase only it sees
        self.profiler = None

    def can_seat(self, prompt, prompt_tokens, commit_tokens):
        return self.allocator.can_seat(prompt, prompt_tokens, commit_tokens)

    def seat(self, slot, prompt, commit_tokens):
        """Reserve the request's full block budget and materialize the
        prompt's blocks: shared prefix blocks by incref, spilled chain
        blocks by revival upload, the rest fresh; raises OutOfBlocks
        with nothing taken. Returns the shared token count (revived
        tokens count as shared: neither re-runs its prefill)."""
        shared = self.allocator.alloc(slot, len(prompt),
                                      commit_tokens=commit_tokens,
                                      prompt=prompt)
        self._apply_revivals()
        self._sync_row(slot)
        return shared

    # ------------------------------------------------- host spill tier

    def _gather_rows(self, bid):
        """One block's rows as CPU tensors, every leaf (int8 rows and
        fp32 scales alike) in wire order. The spill sink and the chain
        export both read through here, so an exported chain holds the
        bytes the host tier would hold for the same blocks."""
        # copy=True: on a CPU pool .to("cpu") would alias the arena
        return [self.pools[layer][j][bid].to("cpu", copy=True)
                for layer, j in self._order]

    def _spill_block(self, bid, vid):
        """Allocator spill sink: copy block `bid`'s rows to the host
        under `vid`, BEFORE the bid is reused."""
        self._host_rows[vid] = self._gather_rows(bid)

    def _drop_host_block(self, vid):
        """Allocator drop sink: the host LRU (or a flush) discarded a
        spilled entry; its rows are gone."""
        self._host_rows.pop(vid, None)

    def _upload_rows(self, staged):
        """Write staged `(bid, [CPU rows per leaf, wire order])` row sets
        into their device blocks: one batched write per leaf over the
        block axis. Revival and chain import both land here."""
        prof = self.profiler
        t0 = self._tick()
        idx = torch.as_tensor([bid for bid, _rows in staged],
                              dtype=torch.long, device=self.device)
        for n, (layer, j) in enumerate(self._order):
            arena = self.pools[layer][j]
            arena[idx] = torch.stack(
                [rows[n] for _bid, rows in staged]).to(self.device)
        self.revive_uploads += 1
        if prof is not None:
            prof.observe("revive_upload", self._tick() - t0)

    def _tick(self):
        if self.profiler is None:
            return None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.profiler.t()

    def _apply_revivals(self):
        """Upload the rows of every chain entry the last seat revived
        into its fresh block. The host copies are consumed: revival is a
        move, not a copy."""
        moves = self.allocator.take_revived()
        if moves:
            self._upload_rows(
                [(bid, self._host_rows.pop(vid)) for vid, bid in moves])

    def host_bytes_in_use(self):
        """Host-tier bytes: a spilled block holds every row leaf of one
        block at its own dtype, block_bytes exactly."""
        return len(self._host_rows) * self.block_bytes

    # ------------------------------------------- disaggregated handoff

    def leaf_dtypes(self):
        """Row-leaf dtype names in wire order: the arena format a chain
        transfer carries so an importer can refuse a mismatch."""
        return [dtype_name(self.pools[layer][j].dtype)
                for layer, j in self._order]

    def leaf_shapes(self):
        """Row-leaf shapes of one block, in wire order."""
        return [tuple(self.pools[layer][j].shape[1:])
                for layer, j in self._order]

    def export_chain(self, prompt):
        """The longest indexed chain covering `prompt` as a dense copy:
        `[(block token tuple, [CPU rows per leaf])]` root-first, resident
        blocks through the spill tier's gather and spilled ones from the
        host store (copied, not consumed). Runs on the scheduler thread,
        so nothing evicts an entry mid-gather. An empty list: no full
        prompt block is indexed."""
        alloc = self.allocator
        chain = alloc.match_prefix(prompt)
        tuples = alloc._full_block_tuples(prompt)[:len(chain)]
        blocks = []
        for node, toks in zip(chain, tuples):
            if node >= 0:
                rows = self._gather_rows(node)
            else:
                host = self._host_rows.get(node)
                if host is None:
                    break
                rows = [r.clone() for r in host]
            blocks.append((toks, rows))
        if blocks:
            self.chain_exports += 1
        return blocks

    def import_chain(self, blocks, leaf_dtypes=None):
        """Import an exported chain: walk its `(parent, tokens)` keys
        root-first, keep the levels the trie already resolves (resident
        or spilled), give each missing level a fresh block indexed as a
        refcount-0 reclaimable entry, then land the new blocks' rows in
        one batched upload. Stops early (a usable partial prefix) when
        the pool runs out of blocks, or under a spilled level (a
        resident child of a spilled parent would break leaf-first
        eviction). Returns (blocks added, tokens added)."""
        alloc = self.allocator
        if not alloc.share_prefix:
            raise ValueError(
                "chain import requires a prefix-shared pool "
                "(kv_shared=True)"
            )
        if leaf_dtypes is not None:
            mine = self.leaf_dtypes()
            if list(leaf_dtypes) != mine:
                raise ValueError(
                    "chain leaf dtypes %r do not match this pool's %r"
                    % (list(leaf_dtypes), mine)
                )
        # validate the whole payload before allocating anything
        blocks = [(tuple(int(t) for t in toks), rows)
                  for toks, rows in blocks]
        for toks, _ in blocks:
            if len(toks) != self.block_size:
                raise ValueError(
                    "chain block carries %d tokens, block_size is %d"
                    % (len(toks), self.block_size)
                )
        parent = -1
        staged = []  # (bid, rows) for the batched upload
        fresh = []   # bids held live until the walk finishes
        try:
            for toks, rows in blocks:
                key = (parent, toks)
                node = alloc._index.get(key)
                if node is not None:
                    parent = node  # deduped: walk under the existing id
                    continue
                if parent < -1:
                    break  # the chain continues under a spilled level
                try:
                    bid = alloc._pop_block()
                except OutOfBlocks:
                    break
                # live while the walk continues, so a later pop's
                # eviction cannot reclaim the chain under it
                alloc.incref(bid)
                alloc._index_key[bid] = key
                alloc._link(key, bid)
                staged.append((bid, rows))
                fresh.append(bid)
                parent = bid
            if staged:
                self._upload_rows(staged)
        finally:
            _settle_chain_refs(alloc, fresh)
        added = len(staged)
        if added:
            self.chain_imports += 1
            self.chain_import_tokens += added * self.block_size
        return added, added * self.block_size

    # ------------------------------------------------------- slot paths

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
        """Hot reload: forget every indexed prefix in both tiers
        (BlockAllocator.flush_index drops each spilled entry through the
        drop sink, emptying the host store)."""
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
            # the host tier: occupancy (gauges) and its economy
            # (counters); spilled blocks are always full, so revived
            # tokens are blocks x block_size exactly
            "kv_host_blocks": alloc.num_spilled(),
            "kv_host_bytes": self.host_bytes_in_use(),
            "kv_host_bytes_budget": self.host_bytes_budget,
            "revive_uploads": self.revive_uploads,
            "prefill_tokens_revived": alloc.blocks_revived * self.block_size,
            "host_drops": alloc.host_drops,
            "chain_exports": self.chain_exports,
            "chain_imports": self.chain_imports,
            "chain_import_tokens": self.chain_import_tokens,
        }
