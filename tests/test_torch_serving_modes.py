"""The serving engine's other modes in the port, against the JAX package.

The model's dense KV-cache decode against flax `decode=True`; the
offline `autoregressive_generate` and the dense ContinuousBatchingEngine
against JAX's; speculative decode (a mismatched draft and the target as
its own draft) and chunked prefill on the paged engine against the JAX
paged engine; the scheduler's chunked-prefill budget on a fake clock;
the StepProfiler's phase set; `serving/main.py` in each mode. All at
the rig size of tests/test_torch_serving.py, on numpy-seeded or
Trainer-initialised weights shared through params_from_flax, fp32 on
the CPU (the kernels' plain versions). Hot reload is in
tests/test_torch_hot_reload.py.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.api import generation as jgen
from elasticdl_tpu.common.model_utils import load_model_spec_from_module
from elasticdl_tpu.observability.histogram import (
    LogLinearHistogram as JaxHistogram,
)
from elasticdl_tpu.parallel import mesh as mesh_lib
from elasticdl_tpu.serving import engine as jengine
from elasticdl_tpu.serving.admission import ServingRequest as JaxRequest
from elasticdl_tpu.training.trainer import Trainer
from elasticdl_tpu_torch.api.generation import autoregressive_generate
from elasticdl_tpu_torch.convert import params_from_flax
from elasticdl_tpu_torch.model_zoo.transformer_lm import TransformerLM
from elasticdl_tpu_torch.observability.histogram import LogLinearHistogram
from elasticdl_tpu_torch.serving import main as port_main
from elasticdl_tpu_torch.serving.admission import ServingRequest
from elasticdl_tpu_torch.serving.engine import (
    ContinuousBatchingEngine,
    PagedContinuousBatchingEngine,
    StepProfiler,
)
from elasticdl_tpu_torch.serving.server import (
    GenerationServer,
    ServingConfig,
    _Scheduler,
)
from model_zoo.transformer_lm import transformer_lm as zoo

torch.set_num_threads(2)

CFG = dict(vocab_size=64, seq_len=32, embed_dim=32, num_heads=2,
           num_layers=2)
PARAMS = "vocab_size=64; seq_len=32; embed_dim=32; num_heads=2; num_layers=2"
BLOCK, SLOTS, NUM_BLOCKS = 4, 3, 24
PREFIX = [5, 9, 14, 3, 22, 7, 41, 18]  # two full blocks
LOGIT_TOL = 1e-5

# tests/test_torch_serving.py's mix: a shared prefix and a suffix tile,
# a full-prompt match (copy-on-write), a one-token answer, private
# prompts; 6 requests over 3 slots
REQUESTS = [
    (PREFIX + [11, 2], 6),
    (list(range(30, 43)), 7),
    (PREFIX + [33, 1, 60], 5),
    (PREFIX, 4),
    ([7, 7, 8], 1),
    (PREFIX + [11, 2, 50, 51, 52], 9),
]


def _trainer(seed):
    mesh = mesh_lib.build_mesh({"dp": 1}, devices=jax.devices()[:1])
    trainer = Trainer(load_model_spec_from_module(zoo), mesh=mesh,
                      model_params=PARAMS, seed=seed)
    toks = (np.arange(33)[None, :] % 64).astype(np.int32)
    state = trainer.init_state(({"tokens": toks[:, :-1]}, toks[:, 1:]))
    params = jax.tree.map(np.asarray, flax.core.meta.unbox(state.params))
    return trainer, state, params_from_flax(params)


@pytest.fixture(scope="module")
def rig():
    """The target (seed 0) and the mismatched draft (seed 321, as
    tests/test_serving_e2e.py's spec battery), JAX and port weights."""
    return _trainer(0), _trainer(321)


def port_model(state_dict, **kw):
    model = TransformerLM(device="cpu", **dict(CFG, **kw))
    model.load_state_dict(state_dict)
    return model


def drive(engine, reqs, chunked=False):
    """Seat requests in order as slots and blocks allow (begin_insert
    and one tile a tick when `chunked`), step until all finish; returns
    each request's generated tokens."""
    pending, jobs = list(reqs), []
    for _ in range(300):
        while pending and engine.free_slots() and engine.can_seat(
                pending[0]):
            if chunked:
                job = engine.begin_insert(pending.pop(0))
                if not job.done():
                    jobs.append(job)
            else:
                engine.insert(pending.pop(0))
        if jobs and engine.advance_prefill(jobs[0]):
            jobs.pop(0)
        if not pending and not jobs and not engine.active_count():
            break
        engine.step()
    assert not pending and not jobs and not engine.active_count()
    return [list(r.generated) for r in reqs]


# ------------------------------------------------------- dense decode


def _flax_numpy_params(fm, seed):
    shapes = jax.eval_shape(lambda: fm.init(
        jax.random.PRNGKey(0), {"tokens": jnp.zeros((1, 32), jnp.int32)}))
    rs = np.random.RandomState(seed)

    def draw(leaf):
        shape = leaf.value.shape if hasattr(leaf, "value") else leaf.shape
        scale = 1.0 / np.sqrt(shape[0]) if len(shape) == 2 else 0.1
        base = 1.0 if len(shape) == 1 else 0.0
        return (base + scale * rs.randn(*shape)).astype(np.float32)

    return jax.tree.map(draw, shapes["params"], is_leaf=lambda x: hasattr(
        x, "value") or hasattr(x, "shape"))


@pytest.mark.parametrize("kv,window,t,extra", [
    ("", 0, 1, {}), ("", 0, 3, {}), ("", 5, 1, {}), ("", 5, 3, {}),
    ("int8", 0, 1, {}), ("int8", 0, 3, {}), ("int8", 5, 1, {}),
    ("int8", 5, 3, {}), ("", 0, 3, {"num_kv_heads": 1}),
    ("int8", 5, 3, {"num_kv_heads": 1, "pos_emb": "rope"}),
])
def test_dense_decode_matches_flax_decode(kv, window, t, extra):
    """A batch of sequences at different positions (0 included), each
    with its prefilled cache, decodes a t-token chunk; flax runs each
    alone with its scalar counter. Logits within 1e-5, the written rows
    likewise (int8 rows bit for bit)."""
    cfg = dict(CFG, attn_window=window, **extra)
    fm = zoo.TransformerLM(kv_cache_dtype=kv, **cfg)
    params = _flax_numpy_params(fm, seed=1)
    pm = TransformerLM(device="cpu", kv_cache_dtype=kv, **cfg)
    pm.load_state_dict(params_from_flax(params))
    rs = np.random.RandomState(2)
    positions = [3, 9, 17, 0]
    toks = rs.randint(0, 64, size=(len(positions), 32)).astype(np.int32)
    chunk = rs.randint(0, 64, size=(len(positions), t)).astype(np.int32)
    caches = pm.dense_cache(len(positions))
    kv0 = jax.tree.map(lambda sh: jnp.zeros(sh.shape, sh.dtype),
                       jgen._kv_shapes_for({}, fm, 1))
    refs = []
    for i, p in enumerate(positions):
        cache = kv0
        if p:
            _, upd = fm.apply({"params": params, "cache": kv0},
                              {"tokens": jnp.asarray(toks[i:i + 1, :p])},
                              training=False, prefill=True, prompt_len=p,
                              mutable=["cache"])
            cache = upd["cache"]
            _, rows = pm(torch.as_tensor(toks[i:i + 1, :p]).long())
            for layer, new in zip(caches, rows):
                for leaf, r in zip(layer, new):
                    leaf[i, :, :p] = r[0]
        ref, upd = fm.apply({"params": params, "cache": cache},
                            {"tokens": jnp.asarray(chunk[i:i + 1])},
                            training=False, decode=True, mutable=["cache"])
        refs.append((np.asarray(ref), upd["cache"]))
    logits = pm.decode_dense(torch.as_tensor(chunk).long(),
                             torch.as_tensor(positions), caches,
                             span=max(positions) + t)
    for i, (p, (ref, cache)) in enumerate(zip(positions, refs)):
        np.testing.assert_allclose(logits[i:i + 1].numpy(), ref,
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        for j, layer in enumerate(caches):
            flax_rows = cache["block_%d" % j]["attn"]
            for leaf, key in zip(layer, ("k", "v", "k_scale", "v_scale")):
                got = leaf[i, :, p:p + t]
                want = np.asarray(flax_rows[key])[0, :, p:p + t]
                if leaf.dtype == torch.int8:
                    np.testing.assert_array_equal(got.numpy(), want)
                else:
                    np.testing.assert_allclose(got.numpy(), want,
                                               atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("use_cache", [True, False])
def test_autoregressive_generate_greedy_matches_jax(rig, use_cache):
    (trainer, state, sd), _draft = rig
    prompt = np.asarray([[1, 2, 3, 4, 5], [9, 8, 7, 6, 5]], np.int32)
    ref = np.asarray(jgen.autoregressive_generate(
        trainer, state, prompt, 12, use_cache=True))
    got = autoregressive_generate(port_model(sd), prompt, 12,
                                  use_cache=use_cache)
    np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(ValueError, match="seq_len"):
        autoregressive_generate(port_model(sd), prompt, 40)
    sampled = autoregressive_generate(port_model(sd), prompt[:1], 8,
                                      temperature=1.2, seed=3,
                                      use_cache=use_cache)
    assert sampled.shape == (1, 13)
    assert torch.equal(sampled, autoregressive_generate(
        port_model(sd), prompt[:1], 8, temperature=1.2, seed=3,
        use_cache=not use_cache))


# ------------------------------------------------------- dense engine


def test_dense_engine_matches_jax_dense_engine(rig):
    (trainer, state, sd), _draft = rig
    jeng = jengine.ContinuousBatchingEngine(trainer, state, SLOTS)
    peng = ContinuousBatchingEngine(port_model(sd), SLOTS)
    ref = drive(jeng, [JaxRequest(p, n) for p, n in REQUESTS])
    assert peng.kv_stats().keys() == jeng.kv_stats().keys()
    assert peng.kv_stats()["kv_bytes_in_use"] == 0
    got = drive(peng, [ServingRequest(p, n) for p, n in REQUESTS])
    assert got == ref
    assert [len(g) for g in got] == [n for _p, n in REQUESTS]
    stats, jstats = peng.kv_stats(), jeng.kv_stats()
    assert stats["kv_paged"] is False
    assert stats["kv_bytes_total"] == jstats["kv_bytes_total"]
    # paged streams equal dense ones (the JAX package's parity)
    paged = drive(PagedContinuousBatchingEngine(
        port_model(sd), SLOTS, block_size=BLOCK, num_blocks=NUM_BLOCKS),
        [ServingRequest(p, n) for p, n in REQUESTS])
    assert paged == ref


def test_dense_engine_sampled_tokens_match_paged_engine(rig):
    (_trainer, _state, sd), _draft = rig
    specs = [(PREFIX + [1], 8, 1.3, 7), ([9, 9, 9], 6, 0.0, 0),
             ([4, 2], 9, 0.8, 2)]

    def run(engine):
        return drive(engine, [ServingRequest(p, n, temperature=t, seed=s)
                              for p, n, t, s in specs])

    assert run(ContinuousBatchingEngine(port_model(sd), SLOTS)) == run(
        PagedContinuousBatchingEngine(port_model(sd), SLOTS,
                                      block_size=BLOCK,
                                      num_blocks=NUM_BLOCKS))


# -------------------------------------------------- speculative decode


@pytest.mark.parametrize("draft", ["mismatched", "self"])
def test_speculative_decode_matches_jax_paged_engine(rig, draft):
    """k = 2 with a mismatched draft (rollback) and with the target as
    its own draft (acceptance): identical greedy streams against the JAX
    paged engine with the same draft, and equal draft counters for the
    mismatched draft. The self-draft accepts every proposal its budget
    leaves room for, more than the JAX engine's: there, after a full
    acceptance, the draft's row of its k-th proposal is never written
    (its scan feeds only the first k - 1 proposals), so its next
    proposals read a stale row; the port's first draft step rewrites
    that row."""
    (trainer, state, sd), (d_trainer, d_state, d_sd) = rig
    if draft == "self":
        jdraft, pdraft = (trainer, state), None
    else:
        jdraft, pdraft = (d_trainer, d_state), port_model(d_sd)
    jeng = jengine.PagedContinuousBatchingEngine(
        trainer, state, SLOTS, block_size=BLOCK, num_blocks=NUM_BLOCKS,
        draft=jdraft, draft_k=2)
    target = port_model(sd)
    peng = PagedContinuousBatchingEngine(
        target, SLOTS, block_size=BLOCK, num_blocks=NUM_BLOCKS,
        draft=pdraft or target, draft_k=2)
    ref = drive(jeng, [JaxRequest(p, n) for p, n in REQUESTS])
    got = drive(peng, [ServingRequest(p, n) for p, n in REQUESTS])
    assert got == ref
    if draft == "self":
        ticks = [-(-(n - 1) // 3) for _p, n in REQUESTS if n > 1]
        assert peng.draft_proposed == 2 * sum(ticks)
        assert peng.draft_accepted == sum(
            n - 1 for _p, n in REQUESTS) - sum(ticks)
        assert peng.draft_accepted > jeng.draft_accepted
    else:
        assert peng.draft_proposed == jeng.draft_proposed > 0
        assert peng.draft_accepted == jeng.draft_accepted
    assert peng.kv.allocator.blocks_in_use() == 0
    # a sampled request commits exactly the plain step's tokens
    sampled = [(PREFIX + [1], 8, 1.3, 7), (list(range(20, 31)), 7, 0.0, 0)]

    def run(engine):
        return drive(engine, [ServingRequest(p, n, temperature=t, seed=s)
                              for p, n, t, s in sampled])

    plain = run(PagedContinuousBatchingEngine(
        port_model(sd), SLOTS, block_size=BLOCK, num_blocks=NUM_BLOCKS))
    target = port_model(sd)
    assert run(PagedContinuousBatchingEngine(
        target, SLOTS, block_size=BLOCK, num_blocks=NUM_BLOCKS,
        draft=pdraft or target, draft_k=2)) == plain


def test_speculative_decode_refuses_bad_drafts_and_the_dense_pool(rig):
    (_trainer, _state, sd), _draft = rig
    for bad, match in (({"vocab_size": 32}, "vocabulary"),
                       ({"seq_len": 16}, "seq_len")):
        with pytest.raises(ValueError, match=match):
            PagedContinuousBatchingEngine(
                port_model(sd), SLOTS, block_size=BLOCK,
                draft=TransformerLM(device="cpu", **dict(CFG, **bad)),
                draft_k=2)
    with pytest.raises(ValueError, match="paged pool"):
        GenerationServer(port_model(sd), ServingConfig(kv_paged=False,
                                                       draft_k=2),
                         draft=port_model(sd))


# ----------------------------------------------------- chunked prefill


def test_chunked_prefill_tiles_and_streams_match_jax(rig):
    """tests/test_disagg.py's chunked battery (a 7-token prompt under a
    2-token chunk, a repeat on its full-block prefix, a block-aligned
    repeat that collapses to zero tiles) on both engines: the same tile
    counts and tokens; then the mixed requests chunked against the
    monolithic JAX engine."""
    (trainer, state, sd), _draft = rig

    def run(eng, request_cls):
        out = []
        for prompt, n in (([1, 2, 3, 4, 5, 6, 7], 5),
                          ([1, 2, 3, 4, 5, 6, 7], 3),
                          ([1, 2, 3, 4, 5, 6, 7, 0], 3),
                          ([1, 2, 3, 4, 5, 6, 7, 0], 3)):
            req = request_cls(prompt, n)
            job = eng.begin_insert(req)
            tiles = 0
            while not job.done():
                tiles += 1
                eng.advance_prefill(job)
            while req in eng.active_requests():
                eng.step()
            out.append((tiles, job.tiles, list(req.generated)))
        return out

    jeng = jengine.PagedContinuousBatchingEngine(
        trainer, state, 2, block_size=4, num_blocks=12,
        prefill_chunk_tokens=2)
    peng = PagedContinuousBatchingEngine(
        port_model(sd), 2, block_size=4, num_blocks=12,
        prefill_chunk_tokens=2)
    ref = run(jeng, JaxRequest)
    assert run(peng, ServingRequest) == ref
    assert [r[0] for r in ref] == [4, 2, 2, 0]
    mono = drive(jengine.PagedContinuousBatchingEngine(
        trainer, state, SLOTS, block_size=BLOCK, num_blocks=NUM_BLOCKS),
        [JaxRequest(p, n) for p, n in REQUESTS])
    chunked = PagedContinuousBatchingEngine(
        port_model(sd), SLOTS, block_size=BLOCK, num_blocks=NUM_BLOCKS,
        prefill_chunk_tokens=3)
    assert drive(chunked, [ServingRequest(p, n) for p, n in REQUESTS],
                 chunked=True) == mono
    assert chunked.kv.allocator.blocks_in_use() == 0


def test_chunked_prefill_abort_returns_every_block(rig):
    (_trainer, _state, sd), _draft = rig
    eng = PagedContinuousBatchingEngine(port_model(sd), 2, block_size=4,
                                        num_blocks=12,
                                        prefill_chunk_tokens=2)
    a = eng.kv.allocator
    whole = a.num_free() + a.num_cached()
    job = eng.begin_insert(ServingRequest([7, 6, 5, 4, 3, 2, 1], 5))
    assert not job.done()
    eng.advance_prefill(job)
    assert eng.prefilling_count() == 1 and a.blocks_in_use() > 0
    assert eng.free_slots() == [1]
    eng.abort_prefill(job)
    assert eng.prefilling_count() == 0 and a.blocks_in_use() == 0
    assert a.num_free() + a.num_cached() == whole
    assert eng.free_slots() == [0, 1]


class _Clock(object):
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


class _TileEngine(object):
    """A stand-in engine whose tiles cost `tile_ms` of the fake clock;
    `decoding` slots are active."""

    prefill_chunk_tokens = 4

    def __init__(self, clock, tile_ms, decoding):
        self.clock, self.tile_ms, self.decoding = clock, tile_ms, decoding
        self.ran, self.aborted = [], []

    def begin_insert(self, request):
        raise AssertionError("not called")

    def active_count(self):
        return self.decoding

    def advance_prefill(self, job):
        self.clock.now += self.tile_ms / 1000.0
        self.ran.append(job.name)
        job.left -= 1
        if job.left:
            return False
        job.first, job.finished = 7, False
        return True

    def abort_prefill(self, job):
        self.aborted.append(job.name)


class _Job(object):
    def __init__(self, name, tiles, request):
        self.name, self.left, self.request = name, tiles, request
        self.first = self.finished = None
        self.slot = self.tiles = 0  # read by the serve span's events


@pytest.mark.parametrize("decoding,tile_ms,per_tick", [
    (2, 5.0, [1, 1, 1, 1, 1]),   # budget binds: one tile a tick
    (2, 20.0, [1, 1, 1, 1, 1]),  # a tile over budget still runs
    (2, 3.0, [2, 2, 1]),         # 3 ms tiles: two fit in 8 ms
    (0, 5.0, [5]),               # nothing decoding: the budget is off
])
def test_scheduler_prefill_budget_round_robin(decoding, tile_ms, per_tick):
    clock = _Clock()
    eng = _TileEngine(clock, tile_ms, decoding)
    sched = _Scheduler(eng, queue=None, clock=clock, prefill_budget_ms=8.0)
    a = ServingRequest([1] * 9, 4, clock=clock)
    b = ServingRequest([2] * 5, 4, clock=clock)
    sched._pending_prefills = [_Job("a", 3, a), _Job("b", 2, b)]
    ticks = []
    while sched._pending_prefills:
        before = len(eng.ran)
        sched._advance_prefills()
        ticks.append(len(eng.ran) - before)
    assert ticks == per_tick
    assert eng.ran == ["a", "b", "a", "b", "a"]  # round-robin
    assert [ev for ev in a.events] == [("tokens", [7], -1)]
    assert sched.ttft_secs and sched.prefill_tiles == 5


def test_scheduler_aborts_a_prefill_whose_deadline_expires():
    clock = _Clock()
    eng = _TileEngine(clock, 5.0, 1)
    sched = _Scheduler(eng, queue=None, clock=clock, prefill_budget_ms=8.0)
    late = ServingRequest([1] * 9, 4, deadline_ms=12, clock=clock)
    ok = ServingRequest([2] * 5, 4, clock=clock)
    sched._pending_prefills = [_Job("late", 4, late), _Job("ok", 3, ok)]
    for _ in range(6):
        sched._advance_prefills()
    assert eng.aborted == ["late"]
    assert eng.ran == ["late", "ok", "late", "ok", "ok"]
    assert late.events[-1][:2] == ("error", "DEADLINE_EXCEEDED")
    assert ok.events[-1] == ("tokens", [7], -1)


# ------------------------------------------------------------ profiler


def test_step_profiler_phases_and_snapshot_match_jax():
    ours, ref = StepProfiler(), jengine.StepProfiler()
    assert ours.PHASES == ref.PHASES
    rs = np.random.RandomState(0)
    for phase in ("decode", "scatter", "reload_swap"):
        for secs in rs.exponential(0.004, size=50):
            ours.observe(phase, secs)
            ref.observe(phase, secs)
    assert ours.snapshot() == ref.snapshot()
    with pytest.raises(ValueError, match="unknown profiler phase"):
        ours.observe("sample", 0.1)
    h, jh = LogLinearHistogram(), JaxHistogram()
    for v in rs.lognormal(0.0, 3.0, size=500):
        h.record(v)
        jh.record(v)
    assert h.to_counts() == jh.to_counts()
    assert h.snapshot() == jh.snapshot()


def test_profiled_engines_give_the_same_tokens(rig):
    (_trainer, _state, sd), _draft = rig
    reqs = REQUESTS[:4]
    for make in (
            lambda: ContinuousBatchingEngine(port_model(sd), SLOTS),
            lambda: PagedContinuousBatchingEngine(
                port_model(sd), SLOTS, block_size=BLOCK,
                num_blocks=NUM_BLOCKS, prefill_chunk_tokens=3),
            lambda: PagedContinuousBatchingEngine(
                port_model(sd), SLOTS, block_size=BLOCK,
                num_blocks=NUM_BLOCKS, draft=port_model(sd), draft_k=2)):
        plain, profiled = make(), make()
        profiled.profiler = StepProfiler()
        chunked = bool(plain.prefill_chunk_tokens)
        assert drive(profiled, [ServingRequest(p, n) for p, n in reqs],
                     chunked) == drive(
            plain, [ServingRequest(p, n) for p, n in reqs], chunked)
        snap = profiled.profiler.snapshot()
        want = {"decode"} if not plain.draft_k else {"draft",
                                                     "verify_commit"}
        if isinstance(plain, PagedContinuousBatchingEngine):
            want |= {"scatter", "suffix_tile"}
        want |= {"prefill_tile"} if chunked else {"prefill"}
        assert want <= set(snap), (want, snap)
        assert all(v["count"] > 0 for v in snap.values())


# -------------------------------------------------------------- main


@pytest.mark.parametrize("flags", [
    [],
    ["--kv_paged", "0"],
    ["--kv_paged", "1", "--draft_k", "2", "--draft_model_params",
     PARAMS + "; seed=5"],
    ["--kv_paged", "1", "--prefill_chunk_tokens", "8",
     "--prefill_budget_ms", "4", "--profile", "1", "--warmup_tokens", "3"],
])
def test_main_serves_each_mode(rig, tmp_path, flags, monkeypatch):
    monkeypatch.delenv("EDL_KV_PAGED", raising=False)
    (trainer, state, sd), _draft = rig
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                flax.core.meta.unbox(state.params))[0]}
    npz = tmp_path / "params.npz"
    np.savez(npz, **flat)
    args = port_main.parse_serving_args([
        "--device", "cpu", "--model_params", PARAMS, "--num_slots", "2",
        "--kv_block_size", "4", "--params_npz", str(npz)] + flags)
    server = port_main.build_server(args).start()
    try:
        port_main.warmup(server, args.warmup_tokens)
        answers = port_main.serve_lines(server, [
            '{"prompt": %s, "max_new_tokens": 9}' % REQUESTS[5][0],
            '{"prompt": %s, "max_new_tokens": 6}' % REQUESTS[1][0],
            '{"status": true}'])
    finally:
        server.stop(timeout=30)
    for answer, (prompt, n) in zip(answers, (REQUESTS[5], (REQUESTS[1][0],
                                                            6))):
        ref = np.asarray(jgen.autoregressive_generate(
            trainer, state, np.asarray([prompt], np.int32), n,
            use_cache=True))[0]
        assert answer == {"tokens": ref.tolist()}
    status = answers[2]["status"]
    paged = "1" in flags[1:2]
    assert status["kv_paged"] is paged
    assert type(server.engine) is (PagedContinuousBatchingEngine if paged
                                   else ContinuousBatchingEngine)
    assert status["draft_k"] == (2 if "--draft_k" in flags else 0)
    assert (status["draft_proposed"] > 0) == ("--draft_k" in flags)
    if "--profile" in flags:
        assert {"prefill_tile", "decode", "scatter"} <= set(
            status["profile"])
        assert server.scheduler.prefill_tiles > 0
    assert status["completed"] == 2 + ("--warmup_tokens" in flags)
