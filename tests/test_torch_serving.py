"""The port's serving slice against the JAX package's paged engine.

The JAX PagedContinuousBatchingEngine is built as
tests/test_serving_e2e.py builds its rig (Trainer over the zoo spec);
the port's engine serves the same weights (converted with
params_from_flax) on the CPU, where its kernels run their plain
versions. Both engines take the same requests in the same order: greedy
token streams must be identical, and every block must come back when
the work is done. Sampled tokens cannot match jax.random bits; the
port's contract is that a request's sampled tokens depend on its own
(seed, position) and logits only, never on its batch mates.
"""

import threading

import flax
import numpy as np
import pytest
import torch

import jax

from elasticdl_tpu.api import generation as jgen
from elasticdl_tpu.common.model_utils import load_model_spec_from_module
from elasticdl_tpu.parallel import mesh as mesh_lib
from elasticdl_tpu.serving.admission import ServingRequest as JaxRequest
from elasticdl_tpu.serving.engine import (
    PagedContinuousBatchingEngine as JaxPagedEngine,
)
from elasticdl_tpu.serving.kv_pool import BlockAllocator as JaxAllocator
from elasticdl_tpu.serving.kv_pool import OutOfBlocks as JaxOutOfBlocks
from elasticdl_tpu.training.trainer import Trainer
from elasticdl_tpu_torch.api import generation as tgen
from elasticdl_tpu_torch.convert import params_from_flax
from elasticdl_tpu_torch.model_zoo.transformer_lm import TransformerLM
from elasticdl_tpu_torch.serving import main as port_main
from elasticdl_tpu_torch.serving.admission import (
    AdmissionError,
    ServingRequest,
)
from elasticdl_tpu_torch.serving.engine import PagedContinuousBatchingEngine
from elasticdl_tpu_torch.serving.kv_pool import BlockAllocator, OutOfBlocks
from elasticdl_tpu_torch.serving.server import GenerationServer, ServingConfig
from model_zoo.transformer_lm import transformer_lm as zoo

torch.set_num_threads(2)

CFG = dict(vocab_size=64, seq_len=32, embed_dim=32, num_heads=2,
           num_layers=2)
PARAMS = "vocab_size=64; seq_len=32; embed_dim=32; num_heads=2; num_layers=2"
BLOCK, SLOTS, NUM_BLOCKS = 4, 3, 24
PREFIX = [5, 9, 14, 3, 22, 7, 41, 18]  # two full blocks

# (prompt, max_new_tokens): a shared prefix seated by incref and a
# suffix tile, a full-prompt match (the planned copy-on-write), a
# one-token answer, and private prompts; 6 requests over 3 slots
REQUESTS = [
    (PREFIX + [11, 2], 6),
    (list(range(30, 43)), 7),
    (PREFIX + [33, 1, 60], 5),
    (PREFIX, 4),
    ([7, 7, 8], 1),
    (PREFIX + [11, 2, 50, 51, 52], 9),
]


@pytest.fixture(scope="module")
def rig():
    mesh = mesh_lib.build_mesh({"dp": 1}, devices=jax.devices()[:1])
    trainer = Trainer(load_model_spec_from_module(zoo), mesh=mesh,
                      model_params=PARAMS, seed=0)
    toks = (np.arange(33)[None, :] % 64).astype(np.int32)
    state = trainer.init_state(({"tokens": toks[:, :-1]}, toks[:, 1:]))
    params = jax.tree.map(np.asarray, flax.core.meta.unbox(state.params))
    return trainer, state, params_from_flax(params)


def port_model(state_dict):
    model = TransformerLM(device="cpu", **CFG)
    model.load_state_dict(state_dict)
    return model


def drive(engine, reqs):
    """Seat requests in order as slots and blocks allow, step until all
    finish; returns each request's generated tokens."""
    pending = list(reqs)
    for _ in range(200):
        while pending and engine.free_slots() and engine.can_seat(
                pending[0]):
            engine.insert(pending.pop(0))
        if not pending and not engine.active_count():
            break
        engine.step()
    assert not pending and not engine.active_count()
    return [list(r.generated) for r in reqs]


def test_greedy_streams_match_jax_engine_and_blocks_come_back(rig):
    trainer, state, sd = rig
    jeng = JaxPagedEngine(trainer, state, SLOTS, block_size=BLOCK,
                          num_blocks=NUM_BLOCKS, share_prefix=True)
    peng = PagedContinuousBatchingEngine(
        port_model(sd), SLOTS, block_size=BLOCK, num_blocks=NUM_BLOCKS,
        share_prefix=True)
    ref = drive(jeng, [JaxRequest(p, n) for p, n in REQUESTS])
    got = drive(peng, [ServingRequest(p, n) for p, n in REQUESTS])
    assert got == ref
    assert [len(g) for g in got] == [n for _p, n in REQUESTS]
    for eng in (jeng, peng):
        alloc = eng.kv.allocator
        assert alloc.prefix_hit_tokens > 0
        assert alloc.cow_copies == 1
        assert alloc.blocks_in_use() == 0
        assert alloc.available() == NUM_BLOCKS
        assert alloc.num_free() + alloc.num_cached() == NUM_BLOCKS
    assert (peng.kv.allocator.prefix_hit_tokens
            == jeng.kv.allocator.prefix_hit_tokens)
    assert np.all(peng.kv.tables == -1)


def _allocator_state(alloc, slots):
    return (
        [alloc.table(s) for s in slots], alloc.available(), alloc.num_free(),
        alloc.num_cached(), alloc.blocks_in_use(), alloc.shared_blocks(),
        alloc.prefix_hit_tokens, alloc.cow_copies,
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_allocator_tracks_jax_allocator_op_for_op(seed):
    """The port keeps its own copy of the BlockAllocator (here without a
    host tier; tests/test_torch_kv_host_tier.py holds that one).
    A random mix of seats on shared-prefix prompts, growth, CoW faults
    and releases, under pool pressure (reclaimable-LRU eviction and
    OutOfBlocks refusals), leaves both allocators in the same state
    after every operation."""
    rs = np.random.RandomState(seed)
    bs, nb, slots = 4, 20, range(5)
    ours = BlockAllocator(nb, bs, share_prefix=True)
    ref = JaxAllocator(nb, bs, share_prefix=True)

    def same(op):
        """Run op on both allocators; same result or same refusal."""
        outcomes = []
        for alloc, refused in ((ours, OutOfBlocks), (ref, JaxOutOfBlocks)):
            try:
                outcomes.append(("ok", op(alloc)))
            except refused:
                outcomes.append(("out", None))
        assert outcomes[0] == outcomes[1]
        return outcomes[0][0] == "ok"

    stems = [rs.randint(0, 50, size=12).tolist() for _ in range(3)]
    live = {}
    for _ in range(300):
        slot = int(rs.randint(len(slots)))
        action = rs.rand()
        if slot in live and action < 0.4:
            grown = live[slot] + int(rs.randint(1, 6))
            if same(lambda a: a.extend(slot, grown)):
                live[slot] = grown
        elif slot in live and action < 0.6:
            pos = int(rs.randint(live[slot]))
            same(lambda a: a.cow(slot, pos // bs))
        elif slot in live:
            same(lambda a: a.free(slot))
            del live[slot]
        else:
            stem = stems[int(rs.randint(len(stems)))]
            prompt = stem[:int(rs.randint(4, 13))] + rs.randint(
                0, 50, size=int(rs.randint(0, 3))).tolist()
            commit = len(prompt) + int(rs.randint(0, 8))
            same(lambda a: a.can_seat(prompt, len(prompt), commit))
            if same(lambda a: a.alloc(slot, len(prompt), commit, prompt)):
                ours.register_prefix(slot, prompt)
                ref.register_prefix(slot, prompt)
                live[slot] = len(prompt)
        assert _allocator_state(ours, slots) == _allocator_state(ref, slots)


def test_server_backpressure_waits_for_blocks(rig):
    """A block budget that fits one request at a time: the rest stay
    queued (can_seat refuses) and seat as completions free blocks."""
    _trainer, _state, sd = rig
    server = GenerationServer(
        port_model(sd),
        ServingConfig(num_slots=3, queue_capacity=8, kv_paged=True,
                      kv_block_size=4,
                      kv_num_blocks=4, kv_shared=False),
    ).start()
    try:
        reqs = [server.submit(list(range(i + 1, i + 9)), 6)
                for i in range(3)]
        for req in reqs:
            for _chunk in server.events(req):
                pass
        assert [len(r.generated) for r in reqs] == [6, 6, 6]
        assert max(server.scheduler.step_batch) == 1
        with pytest.raises(AdmissionError) as exc:
            server.submit(list(range(1, 17)), 8)  # 23 rows > 16 in the pool
        assert exc.value.code == "INVALID_ARGUMENT"
    finally:
        server.stop(timeout=30)
    assert server.engine.kv.allocator.available() == 4


def test_sampled_tokens_do_not_depend_on_batch_mates(rig):
    _trainer, _state, sd = rig
    model = port_model(sd)

    def run(specs):
        eng = PagedContinuousBatchingEngine(model, SLOTS, block_size=BLOCK,
                                            num_blocks=NUM_BLOCKS)
        return drive(eng, [ServingRequest(p, n, temperature=t, seed=s)
                           for p, n, t, s in specs])

    sampled = (PREFIX + [1], 8, 1.3, 7)
    alone = run([sampled])[0]
    crowded = run([(PREFIX + [2, 3], 6, 0.9, 1), sampled,
                   ([9, 9, 9, 9, 9], 7, 0.0, 0)])[1]
    assert alone == crowded
    other_seed = run([sampled[:3] + (8,)])[0]
    assert other_seed != alone


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (0, 0.6),
                                         (3, 0.3)])
def test_sampling_filters_and_greedy_match_jax(top_k, top_p):
    """The filter pipeline before the draw is the JAX package's, entry
    for entry; greedy is the same argmax."""
    logits = np.random.RandomState(top_k).randn(4, 64).astype(np.float32)
    ref = np.asarray(jgen._filter_logits(jax.numpy.asarray(logits), top_k,
                                         top_p))
    got = tgen._filter_logits(torch.from_numpy(logits), top_k, top_p)
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(ref))
    kept = ~np.isinf(ref)
    np.testing.assert_allclose(got.numpy()[kept], ref[kept])
    scaled_ref = np.asarray(jgen._filter_logits(
        jax.numpy.asarray(logits / 0.8), top_k, top_p))
    for row, allowed in zip(logits, ~np.isinf(scaled_ref)):
        assert tgen.serving_next_token(torch.from_numpy(row), 1, 5, 0.0) == \
            int(jgen.serving_next_token(jax.numpy.asarray(row), 1, 5, 0.0))
        tok = tgen.serving_next_token(torch.from_numpy(row), 1, 5, 0.8,
                                      top_k, top_p)
        assert allowed[tok]


def test_in_process_server_answers_concurrent_requests(rig):
    _trainer, _state, sd = rig
    offline = drive(
        PagedContinuousBatchingEngine(port_model(sd), SLOTS,
                                      block_size=BLOCK,
                                      num_blocks=NUM_BLOCKS),
        [ServingRequest(p, n) for p, n in REQUESTS])
    server = GenerationServer(
        port_model(sd),
        ServingConfig(num_slots=SLOTS, queue_capacity=16, kv_paged=True,
                      kv_block_size=BLOCK, kv_num_blocks=NUM_BLOCKS),
    ).start()
    results, errors = {}, {}

    def call(i, prompt, n):
        try:
            results[i] = server.generate(prompt, n)
        except AdmissionError as e:
            errors[i] = e

    try:
        threads = [threading.Thread(target=call, args=(i, p, n))
                   for i, (p, n) in enumerate(REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        for i, (p, _n) in enumerate(REQUESTS):
            assert results[i] == p + offline[i]
        chunks = list(server.generate_stream(REQUESTS[1][0],
                                             REQUESTS[1][1]))
        assert sum(chunks, []) == offline[1]
        with pytest.raises(AdmissionError) as exc:
            server.generate([1] * 30, 5)
        assert exc.value.code == "INVALID_ARGUMENT"
        assert server.scheduler.completed == len(REQUESTS) + 1
    finally:
        server.stop(timeout=30)
    assert not server.scheduler.is_alive()
    assert server.engine.kv.allocator.blocks_in_use() == 0


def test_main_serves_json_lines_on_cpu(rig, tmp_path):
    _trainer, state, sd = rig
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                flax.core.meta.unbox(state.params))[0]}
    npz = tmp_path / "params.npz"
    np.savez(npz, **flat)
    args = port_main.parse_serving_args([
        "--device", "cpu", "--model_params", PARAMS, "--num_slots", "2",
        "--kv_paged", "1", "--kv_block_size", "4", "--params_npz", str(npz),
    ])
    server = port_main.build_server(args).start()
    try:
        answers = port_main.serve_lines(server, [
            '{"prompt": %s, "max_new_tokens": 6}' % REQUESTS[0][0],
            '{"prompt": [], "max_new_tokens": 2}',
        ])
    finally:
        server.stop(timeout=30)
    offline = drive(
        PagedContinuousBatchingEngine(port_model(sd), SLOTS,
                                      block_size=BLOCK,
                                      num_blocks=NUM_BLOCKS),
        [ServingRequest(*REQUESTS[0])])
    assert answers[0] == {"tokens": REQUESTS[0][0] + offline[0]}
    assert answers[1]["error"] == "INVALID_ARGUMENT"


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = port_main.parse_serving_args(["--model_params", PARAMS])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main.build_server(args)
