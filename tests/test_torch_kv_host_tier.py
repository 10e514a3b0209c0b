"""The paged pool's host spill tier and chain export / import in the port,
against the JAX package.

The port's BlockAllocator with a host tier against JAX's, operation for
operation (seeded churn, and the JAX tests' named cases); the port's
PagedKVPool against JAX's on the same seeded rows: exported chains byte
for byte on the wire (fp32, bf16 and int8 arenas, 2 and 11 layers, where
`block_10` sorts before `block_2`), each package's payload imported by
the other, spill and revival bit-exact within the byte budget; the
port's paged engine with a host tier against the same engine with every
chain resident and against the JAX engine's counters; a hot reload
flushing both tiers. CPU, tiny widths, fp32 compute.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.common.model_utils import load_model_spec_from_module
from elasticdl_tpu.parallel import mesh as mesh_lib
from elasticdl_tpu.proto import elasticdl_pb2 as jpb
from elasticdl_tpu.serving import disagg as jdisagg
from elasticdl_tpu.serving.admission import ServingRequest as JaxRequest
from elasticdl_tpu.serving.engine import (
    PagedContinuousBatchingEngine as JaxPagedEngine,
)
from elasticdl_tpu.serving.kv_pool import BlockAllocator as JaxAllocator
from elasticdl_tpu.serving.kv_pool import OutOfBlocks as JaxOutOfBlocks
from elasticdl_tpu.serving.kv_pool import PagedKVPool as JaxPool
from elasticdl_tpu.training.trainer import Trainer
from elasticdl_tpu_torch.convert import params_from_flax
from elasticdl_tpu_torch.model_zoo.transformer_lm import TransformerLM
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.serving import disagg
from elasticdl_tpu_torch.serving.admission import ServingRequest
from elasticdl_tpu_torch.serving.engine import (
    PagedContinuousBatchingEngine,
    StepProfiler,
)
from elasticdl_tpu_torch.serving.kv_pool import (
    BlockAllocator,
    OutOfBlocks,
    PagedKVPool,
)
from elasticdl_tpu_torch.serving.telemetry import ServingTelemetry
from model_zoo.transformer_lm import transformer_lm as zoo

torch.set_num_threads(2)

# ------------------------------------------------------------ allocator


def _state(alloc, slots):
    """Everything the two allocators must agree on after an operation."""
    return (
        [alloc.table(s) for s in slots], list(alloc._free),
        sorted(alloc._index.items()), list(alloc._cached),
        list(alloc._evictable), list(alloc._spilled),
        list(alloc._spill_leaves), alloc.available(), alloc.spills,
        alloc.host_drops, alloc.blocks_revived, alloc.prefix_hits,
        alloc.prefix_hit_tokens, alloc.cow_copies,
    )


def _pair(num_blocks, block_size, host_blocks):
    """(port, JAX) allocators with sinks that log what they are told."""
    pair = []
    for cls in (BlockAllocator, JaxAllocator):
        a = cls(num_blocks, block_size, share_prefix=True,
                host_blocks=host_blocks)
        a.events = []
        a._spill_sink = (lambda log: lambda bid, vid: log.append(
            ("spill", bid, vid)))(a.events)
        a._drop_sink = (lambda log: lambda vid: log.append(
            ("drop", vid)))(a.events)
        pair.append(a)
    return pair


def _same(pair, op):
    """Run `op` on both allocators: the same result or the same refusal,
    then the same state, sink events and revival log."""
    outcomes = []
    for alloc, refused in zip(pair, (OutOfBlocks, JaxOutOfBlocks)):
        try:
            outcomes.append(("ok", op(alloc), alloc.take_revived()))
        except refused:
            outcomes.append(("out", None, alloc.take_revived()))
    assert outcomes[0] == outcomes[1]
    assert pair[0].events == pair[1].events
    return outcomes[0][0] == "ok"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_with_host_tier_tracks_jax_op_for_op(seed):
    """Seeded seat / extend / CoW / release / flush on both allocators
    with a host tier under pool pressure: tables, free lists, the index
    (virtual ids included), both LRUs, every counter and available()
    equal after every operation, and the sinks see the same spills and
    drops in the same order."""
    rs = np.random.RandomState(seed)
    bs, slots = 4, range(5)
    pair = _pair(14, bs, host_blocks=5)
    stems = [rs.randint(0, 40, size=16).tolist() for _ in range(4)]
    live = {}
    for i in range(400):
        slot = int(rs.randint(len(slots)))
        action = rs.rand()
        if action < 0.03:
            _same(pair, lambda a: a.flush_index())
        elif slot in live and action < 0.35:
            grown = live[slot] + int(rs.randint(1, 6))
            if _same(pair, lambda a: a.extend(slot, grown)):
                live[slot] = grown
        elif slot in live and action < 0.5:
            pos = int(rs.randint(live[slot]))
            _same(pair, lambda a: a.cow(slot, pos // bs))
        elif slot in live:
            _same(pair, lambda a: a.free(slot))
            del live[slot]
        else:
            stem = stems[int(rs.randint(len(stems)))]
            prompt = stem[:int(rs.randint(4, 17))] + rs.randint(
                0, 40, size=int(rs.randint(0, 3))).tolist()
            commit = len(prompt) + int(rs.randint(0, 8))
            _same(pair, lambda a: a.can_seat(prompt, len(prompt), commit))
            if _same(pair, lambda a: a.alloc(slot, len(prompt), commit,
                                             prompt)):
                _same(pair, lambda a: a.register_prefix(slot, prompt))
                live[slot] = len(prompt)
        states = [_state(a, slots) for a in pair]
        assert states[0] == states[1], i
        assert pair[0].num_spilled() <= 5
    assert pair[0].spills > 5 and pair[0].host_drops > 0
    assert pair[0].blocks_revived > 0


def _case_leaf_first_spill(a):
    prompt = list(range(16))
    a.alloc("r0", tokens=16, prompt=prompt)
    a.register_prefix("r0", prompt)
    a.free("r0")
    out = []
    for k in range(1, 5):
        a.alloc("p%d" % k, tokens=4)  # one eviction each
        chain = a.match_prefix(prompt)
        assert [b < 0 for b in chain] == [False] * (4 - k) + [True] * k
        out.append(chain)
    return out


def _case_host_budget_drops_leaf_first(a):
    prompt = list(range(8))
    a.alloc("r0", tokens=8, prompt=prompt)
    a.register_prefix("r0", prompt)
    a.free("r0")
    a.alloc("r1", tokens=8)  # leaf spills, root spills, the leaf drops
    assert a.spills == 2 and a.host_drops == 1 and a.num_spilled() == 1
    chain = a.match_prefix(prompt)
    a.free("r1")
    shared = a.alloc("r2", tokens=8, prompt=prompt)
    assert shared == 4 and a.blocks_revived == 1
    return chain, shared, a.take_revived()


def _case_sinks_before_reuse(a):
    prompt = list(range(8))
    a.alloc("r0", tokens=8, prompt=prompt)
    a.register_prefix("r0", prompt)
    chain_bids = a.table("r0")
    a.free("r0")
    a.alloc("r1", tokens=8)
    assert a.events == [("spill", chain_bids[1], -2),
                        ("spill", chain_bids[0], -3)]
    a.free("r1")
    shared = a.alloc("r2", tokens=8, prompt=prompt)
    moves = a.take_revived()
    assert shared == 8 and [vid for vid, _ in moves] == [-3, -2]
    return moves, a.table("r2")


def _case_revived_charge(a):
    prompt = list(range(16))
    a.alloc("r0", tokens=16, prompt=prompt)
    a.register_prefix("r0", prompt)
    a.free("r0")
    a.alloc("r1", tokens=4)  # pressure: evicts one block, the leaf
    chain = a.match_prefix(prompt)
    assert len(chain) == 4 and chain[-1] < -1
    # 3 reclaimable revivals + 1 spilled upload; no CoW credit
    assert a._plan(prompt, 16, 16)[1] == 4
    a.free("r1")
    assert a.alloc("r2", tokens=16, prompt=prompt) == 16
    assert a.num_spilled() == 0 and a.blocks_revived == 1
    return chain, a.take_revived(), a.table("r2")


@pytest.mark.parametrize("case,geometry", [
    (_case_leaf_first_spill, (4, 4, 8)),
    (_case_host_budget_drops_leaf_first, (2, 4, 1)),
    (_case_sinks_before_reuse, (2, 4, 4)),
    (_case_revived_charge, (4, 4, 8)),
], ids=["leaf_first_spill", "host_budget_drops_leaf_first",
        "sinks_before_reuse", "revived_charge"])
def test_allocator_named_cases_match_jax(case, geometry):
    """tests/test_kv_pool.py's host-tier cases (:705 leaf-first spill,
    :723 the budget drops leaf-first, :769 sinks fire before an id is
    reused, :602 the charge for revived blocks), each run on both
    allocators: the JAX test's assertions hold on each, and the results,
    states and sink events are equal."""
    pair = _pair(*geometry)
    results = [case(a) for a in pair]
    assert results[0] == results[1]
    assert _state(pair[0], ["r0", "r1", "r2"]) == _state(
        pair[1], ["r0", "r1", "r2"])
    assert pair[0].events == pair[1].events


# ----------------------------------------------------------------- pools

HKV, D, CACHE, BS, NB = 2, 8, 16, 4, 6


def _pools(layers, kind, host_bytes=0, num_blocks=NB):
    """(port pool, JAX pool) of the same geometry: `kind` "float32",
    "bfloat16" or "int8" arenas over `layers` layers. The JAX pool's tree
    is the model's cache tree: block_%d / attn / k, v (+ scales)."""
    dt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
          "int8": jnp.int8}[kind]
    int8 = kind == "int8"
    layer = {"k": jnp.zeros((1, HKV, CACHE, D), dt),
             "v": jnp.zeros((1, HKV, CACHE, D), dt)}
    if int8:
        layer.update(k_scale=jnp.zeros((1, HKV, CACHE, 1), jnp.float32),
                     v_scale=jnp.zeros((1, HKV, CACHE, 1), jnp.float32))
    shapes = {"block_%d" % i: {"attn": dict(layer)} for i in range(layers)}
    shapes["pos"] = jnp.zeros((), jnp.int32)
    jpool = JaxPool(shapes, CACHE, 2, num_blocks, BS, share_prefix=True,
                    host_bytes=host_bytes)
    layout = (layers, HKV, D, torch.float32 if int8 else
              getattr(torch, kind), "int8" if int8 else "")
    ppool = PagedKVPool(layout, CACHE, 2, num_blocks, BS, share_prefix=True,
                        device="cpu", host_bytes=host_bytes)
    return ppool, jpool


def _fill(ppool, jpool, seed):
    """The same seeded rows in both pools' arenas, leaf by leaf in the
    JAX tree's order."""
    rs = np.random.RandomState(seed)
    flat, treedef = jax.tree_util.tree_flatten(jpool.pools)
    rows = []
    for layer, j in ppool._order:
        arena = ppool.pools[layer][j]
        if arena.dtype == torch.int8:
            vals = rs.randint(-127, 128, size=arena.shape).astype(np.int8)
            ppool.pools[layer][j].copy_(torch.from_numpy(vals))
            rows.append(jnp.asarray(vals))
        else:
            vals = rs.randn(*arena.shape).astype(np.float32)
            ppool.pools[layer][j].copy_(torch.from_numpy(vals))
            rows.append(jnp.asarray(vals).astype(
                {torch.float32: jnp.float32,
                 torch.bfloat16: jnp.bfloat16}[arena.dtype]))
    it = iter(rows)
    jpool.pools = jax.tree_util.tree_unflatten(
        treedef, [next(it) if leaf.ndim == 4 else leaf for leaf in flat])


def _warm(pool, prompt):
    pool.seat(0, prompt, len(prompt))
    pool.register_prefix(0, prompt)
    pool.release(0)


def _jax_rows(jpool, bid):
    return [np.asarray(leaf[bid]) for leaf in jax.tree.leaves(jpool.pools)
            if leaf.ndim == 4]


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("layers", [2, 11])
def test_exported_chains_are_byte_equal_and_import_across(kind, layers):
    """Filled from the same seeded rows, the two pools export the same
    chain: leaf_dtypes equal and chain_to_proto(...).SerializeToString()
    equal byte for byte (the JAX pool tree's leaf order, block_10 before
    block_2 at 11 layers). A JAX payload parsed by the port's
    TransferChainRequest and imported lands byte-equal rows; the port's
    payload parsed by elasticdl_pb2 and imported by JAX does too."""
    prompt = list(range(100, 112))  # 3 full blocks
    ppool, jpool = _pools(layers, kind)
    _fill(ppool, jpool, seed=layers)
    for pool in (ppool, jpool):
        _warm(pool, prompt)
    assert ppool.leaf_dtypes() == jpool.leaf_dtypes()
    ours = disagg.chain_to_proto(ppool.export_chain(prompt), BS,
                                 ppool.leaf_dtypes(), "xfer-1")
    theirs = jdisagg.chain_to_proto(jpool.export_chain(prompt), BS,
                                    jpool.leaf_dtypes(), "xfer-1")
    wire = ours.SerializeToString()
    assert wire == theirs.SerializeToString() and len(ours.blocks) == 3
    assert ppool.chain_exports == jpool.chain_exports == 1

    # JAX -> port
    dst, _ = _pools(layers, kind)
    blocks, dtypes = disagg.proto_to_blocks(
        pb.TransferChainRequest.FromString(theirs.SerializeToString()), dst)
    assert dst.import_chain(blocks, leaf_dtypes=dtypes) == (3, 12)
    chain = dst.allocator.match_prefix(prompt)
    src_chain = jpool.allocator.match_prefix(prompt)
    for bid, sbid in zip(chain, src_chain):
        got = [r.contiguous().view(torch.uint8).numpy().tobytes()
               for r in dst._gather_rows(bid)]
        assert got == [np.ascontiguousarray(r).tobytes()
                       for r in _jax_rows(jpool, sbid)]
    assert dst.stats()["chain_imports"] == 1
    assert dst.stats()["chain_import_tokens"] == 12

    # port -> JAX
    _, jdst = _pools(layers, kind)
    jblocks, jdtypes = jdisagg.proto_to_blocks(
        jpb.TransferChainRequest.FromString(wire), jdst)
    assert jdst.import_chain(jblocks, leaf_dtypes=jdtypes) == (3, 12)
    for bid, sbid in zip(jdst.allocator.match_prefix(prompt),
                         ppool.allocator.match_prefix(prompt)):
        assert [r.tobytes() for r in _jax_rows(jdst, bid)] == [
            r.contiguous().view(torch.uint8).numpy().tobytes()
            for r in ppool._gather_rows(sbid)]


@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_spill_and_revive_round_trip_bit_exact(kind):
    """A chain evicted by pressure spills to the host tier (rows and
    scales), revives by one upload into other blocks bit for bit, and
    the host copy is consumed (tests/test_kv_pool.py:852); the stats
    equal the JAX pool's after the same operations."""
    prompt = list(range(100, 116))  # 4 full blocks
    pools = _pools(2, kind, host_bytes=10 ** 6, num_blocks=4)
    ppool, jpool = pools
    _fill(ppool, jpool, seed=31)
    for pool in pools:
        _warm(pool, prompt)
    before = [ppool._gather_rows(b) for b in ppool.allocator.match_prefix(
        prompt)]
    for pool in pools:
        pool.seat(1, list(range(16)), 16)  # evicts all four: all spill
    assert ppool.allocator.num_spilled() == 4
    assert ppool.host_bytes_in_use() == 4 * ppool.block_bytes
    assert ppool.stats() == jpool.stats()
    for pool in pools:
        pool.release(1)
        assert pool.seat(0, prompt, 16) == 16
    assert ppool.revive_uploads == 1 and ppool.host_bytes_in_use() == 0
    after = [ppool._gather_rows(b) for b in ppool.allocator.table(0)]
    for rows_a, rows_b in zip(before, after):
        for a, b in zip(rows_a, rows_b):
            assert torch.equal(a, b)
    assert ppool.stats() == jpool.stats()
    assert ppool.stats()["prefill_tokens_revived"] == 16


def test_host_budget_is_never_exceeded():
    """Sustained eviction pressure against a two-block host budget: the
    host bytes stay within it at every step (tests/test_kv_pool.py:897),
    and the allocators and stats equal JAX's throughout."""
    ppool, jpool = _pools(1, "float32", num_blocks=4)
    budget = 2 * ppool.block_bytes
    ppool, jpool = _pools(1, "float32", host_bytes=budget, num_blocks=4)
    assert ppool.allocator.host_blocks == jpool.allocator.host_blocks == 2
    rs = np.random.RandomState(7)
    for i in range(40):
        prompt = [int(x) for x in rs.randint(0, 9, size=12)]
        for pool in (ppool, jpool):
            if pool.can_seat(prompt, len(prompt), 16):
                _warm(pool, prompt)
        assert ppool.host_bytes_in_use() <= budget, i
        assert ppool.stats() == jpool.stats(), i
    assert ppool.allocator.spills > 2 and ppool.allocator.host_drops > 0


# ---------------------------------------------------------------- engine

PARAMS = "vocab_size=64; seq_len=32; embed_dim=32; num_heads=2; num_layers=2"
CFG = dict(vocab_size=64, seq_len=32, embed_dim=32, num_heads=2,
           num_layers=2)


def _trainer(extra=""):
    mesh = mesh_lib.build_mesh({"dp": 1}, devices=jax.devices()[:1])
    trainer = Trainer(load_model_spec_from_module(zoo), mesh=mesh,
                      model_params=PARAMS + extra, seed=0)
    toks = (np.arange(33)[None, :] % 64).astype(np.int32)
    state = trainer.init_state(({"tokens": toks[:, :-1]}, toks[:, 1:]))
    params = jax.tree.map(np.asarray, flax.core.meta.unbox(state.params))
    return trainer, state, params_from_flax(params)


@pytest.fixture(scope="module")
def rig():
    return {"": _trainer(), "int8": _trainer("; kv_cache_dtype='int8'")}


def _port_engine(sd, kv="", **kw):
    model = TransformerLM(device="cpu", kv_cache_dtype=kv, **CFG)
    model.load_state_dict(sd)
    return PagedContinuousBatchingEngine(model, 2, block_size=4, **kw)


def _requests(cls):
    """Six 3-block prompts cold with a 2-token suffix, then each again
    whole in reverse order (a full-prompt match whose chain is resident,
    spilled or dropped by then), then three with a 1-token suffix."""
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, 64, size=12).tolist() for _ in range(6)]
    specs = [(p + [7, 8], 4) for p in prompts]
    specs += [(p, 5) for p in reversed(prompts)]
    specs += [(p + [9], 3) for p in prompts[:3]]
    return [cls(p, n) for p, n in specs]


def _drive(engine, reqs, chunked=False):
    """One request at a time (the seat order and the pool's pressure are
    then the same on every engine), the host tier within its budget after
    each; returns the generated tokens."""
    kv = engine.kv
    for req in reqs:
        if chunked:
            job = engine.begin_insert(req)
            while not job.done():
                engine.advance_prefill(job)
        else:
            engine.insert(req)
        while engine.active_count():
            engine.step()
            assert kv.host_bytes_in_use() <= kv.host_bytes_budget
    return [list(r.generated) for r in reqs]


HOST_KEYS = ("kv_host_blocks", "kv_host_bytes", "revive_uploads",
             "prefill_tokens_revived", "host_drops", "prefix_hit_tokens",
             "cow_copies", "kv_blocks_free", "kv_blocks_cached")


@pytest.mark.parametrize("kv,chunk", [("", 0), ("", 3), ("int8", 0),
                                      ("int8", 3)])
def test_engine_with_host_tier_matches_resident(rig, kv, chunk):
    """A 10-block pool whose host tier holds every spilled chain serves
    the request sequence with the greedy tokens of the same engine whose
    64-block pool keeps every chain resident, float and int8 arenas,
    monolithic and chunked (3-token tiles): revived blocks hold the
    bytes the resident ones do. Its host-tier counters, forwarded to the
    telemetry by delta, equal the pool's, and the profiler times each
    revive upload."""
    _trainer_, _state, sd = rig[kv]
    block_bytes = _port_engine(sd, kv, num_blocks=10).kv.block_bytes
    tiered = _port_engine(sd, kv, num_blocks=10,
                          host_bytes=64 * block_bytes,
                          prefill_chunk_tokens=chunk)
    tiered.telemetry = ServingTelemetry()
    tiered.profiler = StepProfiler()
    resident = _port_engine(sd, kv, num_blocks=64, host_bytes=0,
                            prefill_chunk_tokens=chunk)
    got = _drive(tiered, _requests(ServingRequest), chunked=bool(chunk))
    assert got == _drive(resident, _requests(ServingRequest),
                         chunked=bool(chunk))
    stats = tiered.kv_stats()
    assert tiered.kv.allocator.spills > 0 and stats["revive_uploads"] > 0
    assert stats["host_drops"] == 0
    assert stats["prefill_tokens_revived"] == (
        tiered.kv.allocator.blocks_revived * 4)
    for name in ("revive_uploads", "prefill_tokens_revived", "host_drops"):
        assert tiered.telemetry.counters[name] == stats[name]
    assert tiered.profiler.snapshot()["revive_upload"]["count"] == (
        stats["revive_uploads"])


@pytest.mark.parametrize("kv", ["", "int8"])
def test_engine_with_small_host_tier_matches_jax(rig, kv):
    """A 6-block host tier under the same sequence drops chains (they
    prefill again) and never exceeds its budget; the port's tokens and
    pool stats equal the JAX paged engine's with the same pool and host
    tier on the same requests, weights carried by convert.py."""
    trainer, state, sd = rig[kv]
    block_bytes = _port_engine(sd, kv, num_blocks=10).kv.block_bytes
    eng = _port_engine(sd, kv, num_blocks=10, host_bytes=6 * block_bytes)
    got = _drive(eng, _requests(ServingRequest))
    stats = eng.kv_stats()
    assert stats["host_drops"] > 0 and stats["revive_uploads"] > 0
    assert stats["kv_host_bytes"] <= 6 * block_bytes
    jeng = JaxPagedEngine(trainer, state, 2, block_size=4, num_blocks=10,
                          host_bytes=6 * block_bytes)
    assert _drive(jeng, _requests(JaxRequest)) == got
    jstats = jeng.kv_stats()
    assert {k: stats[k] for k in HOST_KEYS} == {k: jstats[k]
                                                 for k in HOST_KEYS}


def test_prefill_only_parks_the_chain_as_jax_does(rig):
    """A prefill-only request seats, prefills, registers its chain and
    releases the slot (finished after one token), in both insert paths;
    the chain parks refcount-0 cached and its export equals the JAX
    engine's chain to fp32 rounding."""
    trainer, state, sd = rig[""]
    prompt = list(range(1, 17))  # 4 full blocks
    for chunk in (0, 3):
        eng = _port_engine(sd, num_blocks=12, prefill_chunk_tokens=chunk)
        req = ServingRequest(prompt, 1, prefill_only=True)
        assert eng.can_seat(req)
        job = eng.begin_insert(req)
        while not job.done():
            eng.advance_prefill(job)
        assert job.finished and len(req.generated) == 1
        assert eng.active_count() == 0 and eng.prefilling_count() == 0
        assert eng.kv.allocator.blocks_in_use() == 0
        assert eng.kv.allocator.num_cached() == 4
        ours = eng.kv.export_chain(prompt)
    jeng = JaxPagedEngine(trainer, state, 2, block_size=4, num_blocks=12)
    jreq = JaxRequest(prompt, 1, prefill_only=True)
    assert jeng.insert(jreq)[2] is True
    assert jreq.generated == req.generated
    theirs = jeng.kv.export_chain(prompt)
    assert [t for t, _ in ours] == [t for t, _ in theirs]
    for (_, rows), (_, jrows) in zip(ours, theirs):
        for r, j in zip(rows, jrows):
            np.testing.assert_allclose(r.numpy(), j, rtol=0, atol=1e-5)


def test_hot_reload_flushes_both_tiers(rig):
    """tests/test_serving_e2e.py:796 on the port: a chain spilled by
    decode growth is gone from both tiers after set_params, and a new
    request with its prompt prefills again."""
    _trainer_, _state, sd = rig[""]
    eng = _port_engine(sd, num_blocks=4, host_bytes=1 << 20)
    prompt = [1, 2, 3, 4, 5, 6, 7, 1]
    _drive(eng, [ServingRequest(prompt, 2)])
    assert eng.kv.allocator.num_cached() == 2
    _drive(eng, [ServingRequest([2, 3], 14)])  # commits all four blocks
    assert eng.kv.allocator.num_spilled() == 2
    eng.set_params({}, version=1)
    assert eng.kv.allocator.num_spilled() == 0
    assert eng.kv.host_bytes_in_use() == 0
    assert eng.kv.allocator.match_prefix(prompt) == []
    assert eng.kv.allocator.host_drops == 2
    _drive(eng, [ServingRequest(prompt, 2)])
    assert eng.kv_stats()["revive_uploads"] == 0
    assert eng.kv.allocator.available() == 4
