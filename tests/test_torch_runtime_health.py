"""The port's runtime-health plane against the JAX package's.

The sentry, the watchdog, the flight ring, the accountant and
`RuntimeHealth.check` / `reconcile` run on one fake clock on both sides
and must agree; bundles validate under both packages' `validate_bundle`;
`tracked_call` counts what `tracked_jit` traces over one call sequence;
the port's paged engine's compile counts are held against the JAX
engine's on the same requests, with the two names where the port's
shapes differ named; an in-process replica wedged at `engine_step` turns
`stalled`, dumps a valid bundle and says so on its status and its
/metrics page (parsed by both parsers); the leak drill's buffer is
convicted; SIGUSR2 dumps a subprocess's stacks; a kernel build in flight
is progress. Every wait and join is bounded.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticdl_tpu.common.model_utils import load_model_spec_from_module
from elasticdl_tpu.observability import promparse as jpromparse
from elasticdl_tpu.observability import runtime_health as jrh
from elasticdl_tpu.observability.metrics import (
    render_prometheus as jrender,
)
from elasticdl_tpu.parallel import mesh as mesh_lib
from elasticdl_tpu.serving.admission import ServingRequest as JaxRequest
from elasticdl_tpu.serving.engine import (
    ContinuousBatchingEngine as JaxDenseEngine,
)
from elasticdl_tpu.serving.engine import (
    PagedContinuousBatchingEngine as JaxPagedEngine,
)
from elasticdl_tpu.serving.engine import StepProfiler as JaxProfiler
from elasticdl_tpu.training.trainer import Trainer
from elasticdl_tpu_torch.common.fault_injection import (
    HEALTH_RPCS,
    FaultInjector,
    InjectedRpcError,
)
from elasticdl_tpu_torch.convert import params_from_flax
from elasticdl_tpu_torch.model_zoo.transformer_lm import TransformerLM
from elasticdl_tpu_torch.observability import promparse
from elasticdl_tpu_torch.observability import runtime_health as prh
from elasticdl_tpu_torch.observability.metrics import render_prometheus
from elasticdl_tpu_torch.observability.tracing import recorder
from elasticdl_tpu_torch.ops import _build
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.serving import main as port_main
from elasticdl_tpu_torch.serving.admission import ServingRequest
from elasticdl_tpu_torch.serving.engine import (
    ContinuousBatchingEngine as DenseEngine,
)
from elasticdl_tpu_torch.serving.engine import (
    PagedContinuousBatchingEngine,
    StepProfiler,
)
from elasticdl_tpu_torch.serving.server import GenerationServer, ServingConfig
from elasticdl_tpu_torch.serving.telemetry import ServingTelemetry
from model_zoo.transformer_lm import transformer_lm as zoo

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=64, seq_len=32, embed_dim=32, num_heads=2,
           num_layers=2)
PARAMS = "vocab_size=64; seq_len=32; embed_dim=32; num_heads=2; num_layers=2"
BLOCK, SLOTS, NUM_BLOCKS = 4, 3, 24
PREFIX = [5, 9, 14, 3, 22, 7, 41, 18]
REQUESTS = [
    (PREFIX + [11, 2], 6),
    (list(range(30, 43)), 7),
    (PREFIX + [33, 1, 60], 5),
    (PREFIX, 4),
    ([7, 7, 8], 1),
    (PREFIX + [11, 2, 50, 51, 52], 9),
]
WAIT_S = 20.0


class Clock(object):
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def wait_for(pred, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "timed out waiting for " + what
        time.sleep(0.01)


def both(fn):
    """fn(module) for the JAX module and the port's."""
    return fn(jrh), fn(prh)


def without_builds(snap):
    return {k: v for k, v in snap.items() if k != "builds"}


# ------------------------------------------------------------ fakes


class FakeTelemetry(object):
    def __init__(self):
        self.counters = {"tokens_generated": 0, "stalls": 0,
                         "steady_recompiles": 0}
        self.gauges = {}

    def count(self, name, n=1):
        self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name, value):
        self.gauges[name] = value


class FakeJaxEngine(object):
    """What the JAX accountant walks: trees of arrays."""

    def __init__(self, kv, nbytes, draft_nbytes):
        self.kv = kv
        self.variables = {"w": np.zeros(nbytes // 4, np.float32)}
        self._exec_variables = self.variables  # not quantized: the same
        self._d_pool = {"k": np.zeros(draft_nbytes, np.int8)}
        self.seated = 0

    def kv_stats(self):
        return dict(self.kv)

    def active_count(self):
        return self.seated


class FakePortEngine(object):
    """What the port's accountant walks: modules and the draft's pool."""

    def __init__(self, kv, nbytes, draft_nbytes):
        self.kv = kv
        self.device = torch.device("cpu")
        self.model = torch.nn.Linear(nbytes // 4 - 1, 1)  # + 1 bias
        self._d_pool = [(torch.zeros(draft_nbytes, dtype=torch.int8),)]
        self.seated = 0

    def kv_stats(self):
        return dict(self.kv)

    def active_count(self):
        return self.seated


KV = {"kv_bytes_total": 4096, "kv_host_bytes": 512, "kv_blocks_free": 3,
      "kv_blocks_cached": 1, "kv_host_blocks": 2, "kv_bytes_in_use": 1024}


def health_pair(clock, live, tmp_path, stall_after=2.0):
    """(JAX RuntimeHealth, port RuntimeHealth) over fakes of equal bytes
    and one clock; `live` is the list the injected live_bytes reads."""
    def live_fn():
        return live[0], None

    out = []
    for mod, eng, sub in ((jrh, FakeJaxEngine(KV, 400, 64), "jax"),
                          (prh, FakePortEngine(KV, 400, 64), "port")):
        kw = dict(stall_after_secs=stall_after, clock=clock,
                  health_dir=str(tmp_path / sub), live_bytes_fn=live_fn)
        if mod is prh:
            kw["builds_fn"] = lambda: {"started": 0, "finished": 0,
                                       "in_flight": [], "builds": []}
        out.append(mod.RuntimeHealth(eng, [], FakeTelemetry(), **kw))
    return out


# ------------------------------------------------------------ tests


def test_constants_and_env_defaults_match(monkeypatch):
    assert prh.HEALTH_STATES == jrh.HEALTH_STATES
    assert prh.BUNDLE_SCHEMA == jrh.BUNDLE_SCHEMA
    assert (prh.HEALTH_DIR_ENV, prh.HEALTH_ENV, prh.STALL_AFTER_ENV) == (
        jrh.HEALTH_DIR_ENV, jrh.HEALTH_ENV, jrh.STALL_AFTER_ENV)
    assert HEALTH_RPCS == ("engine_step", "health_leak")
    for env in ({}, {"EDL_RUNTIME_HEALTH": "0", "EDL_STALL_AFTER_SECS":
                     "2.5", "EDL_HEALTH_DIR": "/x"},
                {"EDL_STALL_AFTER_SECS": "junk"}):
        for k in ("EDL_RUNTIME_HEALTH", "EDL_STALL_AFTER_SECS",
                  "EDL_HEALTH_DIR"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for name in ("runtime_health_default", "stall_after_default",
                     "health_dir_default"):
            a, b = both(lambda m: getattr(m, name)())
            assert a == b, (name, env)


def test_sentry_counts_steady_boundary_and_family_match():
    clock = Clock()
    js, ps = jrh.RecompileSentry(clock=clock), prh.RecompileSentry(
        clock=clock)
    for name in ("prefill[64]", "decode_step", "prefill[64]"):
        js.record_compile(name)
        ps.record_compile(name)
    js.mark_steady(), ps.mark_steady()
    clock.t = 105.0
    before = len(recorder().snapshot())
    for name in ("prefill[128]", "decode_step", "decode_step"):
        js.record_compile(name)
        ps.record_compile(name)
    js.mark_steady(), ps.mark_steady()  # the first mark wins
    snap = ps.snapshot()
    assert without_builds(snap) == js.snapshot()
    assert snap["builds"] is None
    assert (snap["recompiles"], snap["steady_recompiles"]) == (3, 2)
    assert [a["at"] for a in snap["anomalies"]] == [105.0, 105.0]
    spans = [s for s in recorder().snapshot()[before:]
             if s.name == "recompile_anomaly"]
    assert len(spans) == 2 and spans[0].attrs["fn"] == "decode_step"
    assert render_prometheus(ps.prometheus()) == jrender(js.prometheus())
    assert ps.total_compiles() == js.total_compiles() == 6


def test_watchdog_matches_jax_on_one_clock():
    clock = Clock(0.0)
    j = jrh.ProgressWatchdog(stall_after_secs=2.0, clock=clock)
    p = prh.ProgressWatchdog(stall_after_secs=2.0, clock=clock)
    script = [(0, 0, 0.0), (1, 0, 0.5), (1, 0, 1.9), (1, 0, 2.0),
              (1, 0, 3.0), (1, 5, 3.5), (0, 5, 9.0), (2, 5, 9.5),
              (2, 5, 12.0), (2, 6, 12.5)]
    for work, counter, t in script:
        clock.t = t
        assert p.observe(work, counter) == j.observe(work, counter), t
        assert p.snapshot() == j.snapshot()
        assert p.last_progress_age_ms() == j.last_progress_age_ms()
    assert p.stalls == j.stalls == 2


def test_watchdog_busy_is_progress():
    clock = Clock(0.0)
    w = prh.ProgressWatchdog(stall_after_secs=1.0, clock=clock)
    for t in (0.0, 0.6, 1.2, 1.8, 2.4):
        clock.t = t
        assert not w.observe(1, 7, busy=True)
    assert w.state == "ok" and w.last_progress_age_ms() == 0.0
    clock.t = 3.5
    assert w.observe(1, 7)  # no build, no progress since 2.4
    assert w.state == "stalled" and w.stalls == 1


def test_flight_recorder_ring_matches():
    j, p = both(lambda m: m.FlightRecorder(capacity=3))
    for i in range(5):
        j.record({"i": i})
        p.record({"i": i})
    assert p.snapshot() == j.snapshot() == [{"i": 2}, {"i": 3}, {"i": 4}]
    assert (p.recorded, p.dropped) == (j.recorded, j.dropped) == (5, 2)


def test_accountant_math_matches_jax():
    live = [10000]
    jacc = jrh.DeviceMemoryAccountant(FakeJaxEngine(KV, 400, 64),
                                      live_bytes_fn=lambda: (live[0], None))
    pacc = prh.DeviceMemoryAccountant(FakePortEngine(KV, 400, 64),
                                      live_bytes_fn=lambda: (live[0], None))
    assert pacc.ledger() == jacc.ledger() == {
        "kv_bytes_total": 4096, "kv_host_bytes": 512, "param_bytes": 400,
        "draft_pool_bytes": 64}
    for value, rebase in ((10000, False), (12000, False), (11000, True),
                          (11500, False), (20000, False), (11000, False)):
        live[0] = value
        if rebase:
            jacc.rebase()
            pacc.rebase()
        assert pacc.reconcile() == jacc.reconcile()
        assert pacc.snapshot() == jacc.snapshot()
    snap = pacc.snapshot()
    assert (snap["unaccounted_bytes"], snap["unaccounted_peak_bytes"]) == (
        0, 9000)


def test_accountant_counts_each_storage_once_and_the_draft():
    class Tied(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.a = torch.nn.Linear(8, 8, bias=False)
            self.b = torch.nn.Linear(8, 8, bias=False)
            self.b.weight = self.a.weight  # one storage, two names
            self.register_buffer("steps", torch.zeros(4, dtype=torch.int64))

    eng = FakePortEngine(KV, 400, 64)
    eng.model = Tied()
    eng._draft = torch.nn.Linear(4, 4, bias=False)
    acc = prh.DeviceMemoryAccountant(eng, live_bytes_fn=lambda: (0, None))
    assert acc._param_bytes() == 8 * 8 * 4 + 4 * 8 + 4 * 4 * 4
    assert acc._draft_pool_bytes() == 64


def test_leak_is_convicted_by_the_cpu_live_walk():
    """The default live view on the CPU (the deduplicated storages of
    live tensors) sees the drill's 8 MiB."""
    eng = FakePortEngine(KV, 400, 64)
    acc = prh.DeviceMemoryAccountant(eng)
    acc.reconcile()
    acc.rebase()
    assert acc.leak_for_drill(8 << 20) == 8 << 20
    view = acc.reconcile()
    assert view["unaccounted_bytes"] >= 8 << 20
    assert acc.snapshot()["leaked_buffers"] == 1
    live, stats = prh._live_bytes("cpu")
    assert live >= 8 << 20 and stats is None


def test_runtime_health_check_reconcile_and_bundle_match(tmp_path):
    clock, live = Clock(0.0), [50000]
    jh, ph = health_pair(clock, live, tmp_path)
    for h in (jh, ph):
        h.reconcile(clock.t)
        h.mark_steady()
        h.record_tick(2, 1, 0.0123, 1)
        h._engine.seated = 1
    script = [(0.5, 1), (1.0, 2), (2.0, 2), (2.9, 2), (3.0, 2), (3.5, 2),
              (4.0, 3)]
    for t, tokens in script:
        clock.t = t
        for h in (jh, ph):
            h._telemetry.counters["tokens_generated"] = tokens
        assert ph.check() == jh.check(), t
        assert ph.snapshot()["health_state"] == jh.snapshot()[
            "health_state"]
    live[0] = 60000
    for h in (jh, ph):
        h.reconcile(clock.t)
    js, ps = jh.snapshot(), ph.snapshot()
    assert ({k: v for k, v in ps.items() if k != "bundles"}
            == {k: v for k, v in js.items() if k != "bundles"})
    assert ps["stalls"] == 1 and ps["memory_unaccounted_bytes"] == 10000
    assert ph._telemetry.counters == jh._telemetry.counters
    assert ph._telemetry.gauges == jh._telemetry.gauges
    assert len(ph.bundles) == len(jh.bundles) == 1
    with open(ph.bundles[0]) as f:
        pbundle = json.load(f)
    with open(jh.bundles[0]) as f:
        jbundle = json.load(f)
    assert set(pbundle) == set(jbundle) | {"builds"}
    for b in (pbundle, jbundle):
        assert prh.validate_bundle(b) == [] == jrh.validate_bundle(b)
    assert pbundle["ring"] == [dict(jbundle["ring"][0],
                                    t=pbundle["ring"][0]["t"])]
    assert pbundle["health"] == jbundle["health"]
    broken = dict(pbundle, schema="x", stacks={})
    del broken["ring"]
    assert prh.validate_bundle(broken) == jrh.validate_bundle(broken)
    assert len(prh.validate_bundle(broken)) == 3
    assert prh.validate_bundle([]) == jrh.validate_bundle([])


def test_no_health_dir_is_advertise_only(tmp_path):
    clock, live = Clock(0.0), [0]
    _jh, ph = health_pair(clock, live, tmp_path, stall_after=1.0)
    ph.health_dir = ""
    ph._engine.seated = 1
    ph.check()
    clock.t = 2.0
    assert ph.check() and ph.health_state() == "stalled"
    assert ph.bundles == [] and ph.dump_bundle("x") is None


def test_tracked_call_counts_what_tracked_jit_traces():
    js, ps = jrh.RecompileSentry(), prh.RecompileSentry()

    def f(x, ys, n, scale):
        return x

    jf = jrh.tracked_jit(f, "f", js, static_argnames=("n",))
    pf = prh.tracked_call(f, "f", lambda: ps, static_argnames=("n",))
    calls = [
        ((4,), "f", [(2,)], 2, 1.0),
        ((4,), "f", [(2,)], 2, 3.0),   # a new float value: no trace
        ((8,), "f", [(2,)], 2, 1.0),   # a new shape
        ((4,), "i", [(2,)], 2, 1.0),   # a new dtype
        ((4,), "f", [(2,)], 3, 1.0),   # a new static value
        ((4,), "f", [(2,), (2,)], 2, 1.0),  # a longer list
        ((4,), "f", [(2,)], 2, 1),     # an int where a float was
        ((8,), "f", [(2,)], 2, 2.0),   # seen before
        ((4,), "i", [(2,)], 3, 5.0),   # a new combination
    ]
    for shape, kind, ys, n, scale in calls:
        dt = (jnp.float32, torch.float32) if kind == "f" else (
            jnp.int32, torch.int32)
        jf(jnp.zeros(shape, dt[0]), [jnp.zeros(s, jnp.float32) for s in ys],
           n=n, scale=scale)
        pf(torch.zeros(shape, dtype=dt[1]),
           [torch.zeros(s) for s in ys], n=n, scale=scale)
    assert ps.snapshot()["compiles"] == js.snapshot()["compiles"] == {
        "f": 7}
    # a first call's run is a compile in flight
    seen = []
    probe = prh.tracked_call(lambda: seen.append(ps.compiling), "probe", ps)
    probe()
    probe()
    assert seen == [1, 0] and ps.compiling == 0
    # no sentry: the signature is remembered, nothing counted
    quiet = prh.tracked_call(f, "g", None)
    quiet(torch.zeros(2), [], 1, 1.0)
    assert "g" not in ps.compiles


@pytest.fixture(scope="module")
def rig():
    mesh = mesh_lib.build_mesh({"dp": 1}, devices=jax.devices()[:1])
    trainer = Trainer(load_model_spec_from_module(zoo), mesh=mesh,
                      model_params=PARAMS, seed=0)
    toks = (np.arange(33)[None, :] % 64).astype(np.int32)
    state = trainer.init_state(({"tokens": toks[:, :-1]}, toks[:, 1:]))
    params = jax.tree.map(np.asarray, flax.core.meta.unbox(state.params))
    return trainer, state, params_from_flax(params)


def port_model(sd):
    model = TransformerLM(device="cpu", **CFG)
    model.load_state_dict(sd)
    return model


def drive(engine, reqs, batches=None):
    pending = list(reqs)
    for _ in range(200):
        while pending and engine.free_slots() and engine.can_seat(
                pending[0]):
            engine.insert(pending.pop(0))
        if not pending and not engine.active_count():
            break
        if batches is not None:
            batches.add(engine.active_count())
        engine.step()
    assert not pending and not engine.active_count()
    return [list(r.generated) for r in reqs]


#: per mode: the names whose shapes follow the active-slot count in the
#: port (one compile each there, one in JAX, which steps every slot),
#: and the writes that take the prefill bucket's rows in the port (one
#: compile per bucket; the JAX pool traces them again at their second
#: call)
ENGINE_MODES = {
    "paged": (("paged_step",), ("kv_prompt_write",)),
    "profiled": (("paged_decode.split", "paged_scatter.split"),
                 ("kv_prompt_write",)),
    "dense": (("decode_step",), ("slot_write",)),
}


def engines(rig, mode):
    trainer, state, sd = rig
    if mode == "dense":
        return (JaxDenseEngine(trainer, state, SLOTS),
                DenseEngine(port_model(sd), SLOTS))
    jeng = JaxPagedEngine(trainer, state, SLOTS, block_size=BLOCK,
                          num_blocks=NUM_BLOCKS, share_prefix=True)
    peng = PagedContinuousBatchingEngine(
        port_model(sd), SLOTS, block_size=BLOCK, num_blocks=NUM_BLOCKS,
        share_prefix=True)
    if mode == "profiled":
        jeng.profiler, peng.profiler = JaxProfiler(), StepProfiler()
    return jeng, peng


@pytest.mark.parametrize("mode", sorted(ENGINE_MODES))
def test_engine_compiles_match_jax_but_where_shapes_differ(rig, mode):
    """The same requests through both engines: the same names and counts
    but for the ENGINE_MODES names (ROADMAP Queue 3): the port's step
    compiles once per active-slot count, its prompt write once per
    prefill bucket."""
    jeng, peng = engines(rig, mode)
    js, ps = jrh.RecompileSentry(), prh.RecompileSentry()
    jeng.sentry, peng.sentry = js, ps
    if mode != "dense":
        assert peng.kv.sentry is ps
    batches = set()
    ref = drive(jeng, [JaxRequest(p, n) for p, n in REQUESTS])
    got = drive(peng, [ServingRequest(p, n) for p, n in REQUESTS], batches)
    assert got == ref
    jc, pc = js.snapshot()["compiles"], ps.snapshot()["compiles"]
    steps, writes = ENGINE_MODES[mode]
    assert set(pc) == set(jc)
    same = set(pc) - set(steps) - set(writes)
    assert {k: pc[k] for k in same} == {k: jc[k] for k in same}
    assert "prefill[32]" in same
    for name in steps:
        assert jc[name] == 1 and pc[name] == len(batches) == 3
    for name in writes:
        assert jc[name] == 2 and pc[name] == 1  # one prefill bucket
    # a second pass over warm shapes compiles nothing new
    ps.mark_steady()
    drive(peng, [ServingRequest(p, n) for p, n in REQUESTS])
    assert ps.snapshot()["steady_recompiles"] == 0
    assert ps.snapshot()["compiles"] == pc


def test_speculative_sites_carry_the_jax_names(rig):
    """The speculative tick's sites, plain and profiled: the JAX
    engine's names, the tick's parts once per active-slot count."""
    _trainer, _state, sd = rig
    for profiled, tick in ((False, ("spec_step",)), (True, (
            "spec_draft.split", "spec_verify.split",
            "spec_scatter.split"))):
        target = port_model(sd)
        peng = PagedContinuousBatchingEngine(
            target, SLOTS, block_size=BLOCK, num_blocks=NUM_BLOCKS,
            draft=target, draft_k=2)
        if profiled:
            peng.profiler = StepProfiler()
        peng.sentry = sentry = prh.RecompileSentry()
        batches = set()
        drive(peng, [ServingRequest(p, n) for p, n in REQUESTS], batches)
        compiles = sentry.snapshot()["compiles"]
        assert {k: compiles.pop(k) for k in tick} == dict.fromkeys(
            tick, len(batches))
        compiles.pop("kv_cow_copy", None)  # as seats and acceptance fall
        assert compiles == {"prefill[32]": 1, "kv_prompt_write": 1,
                            "draft_prefill[32]": 1, "draft_slot_write": 1,
                            "suffix_prefill[8]": 1}


def test_offline_decode_sites_count_once_per_configuration(rig):
    from elasticdl_tpu_torch.api import generation as tgen

    _trainer, _state, sd = rig
    model = port_model(sd)
    sentry = prh.RecompileSentry()
    tgen.set_decode_sentry(sentry)
    try:
        prompt = torch.tensor([[1, 2, 3]])
        tgen.autoregressive_generate(model, prompt, 3)
        tgen.autoregressive_generate(model, prompt, 3)
        tgen.autoregressive_generate(model, prompt, 3, temperature=0.5,
                                     seed=1)
        tgen.autoregressive_generate(model, prompt, 3, use_cache=True)
        tgen.beam_search_generate(model, prompt, 2, num_beams=2)
        tgen.beam_search_generate(model, prompt, 2, num_beams=2,
                                  use_cache=True)
        tgen.speculative_generate(model, model, prompt, 3, gamma=2)
        tgen.speculative_generate(model, model, prompt, 3, gamma=2)
    finally:
        tgen.set_decode_sentry(None)
    assert sentry.snapshot()["compiles"] == {
        "offline_decode_nocache": 2, "offline_decode_kv": 1,
        "offline_beam_nocache": 1, "offline_beam_kv": 1,
        "offline_speculative": 1}


class Wedge(object):
    """An injector whose engine_step blocks, bounded, on `release` once
    `armed` (the drill's delay rule, released by the test); health_leak
    fires once when `leak` is set. No servicer rules: the transport's
    wrapper stays off."""

    rules = ()

    def __init__(self):
        self.armed = threading.Event()
        self.release = threading.Event()
        self.wedged = threading.Event()
        self.leak = False

    def intercept(self, name, *args, **kwargs):
        if name == "engine_step" and self.armed.is_set():
            self.wedged.set()
            self.release.wait(timeout=WAIT_S)
        if name == "health_leak" and self.leak:
            self.leak = False
            raise InjectedRpcError("UNAVAILABLE", "injected fault: drop")


def tiny_server(injector=None, **cfg):
    model = TransformerLM(device="cpu", seed=0, **CFG)
    base = dict(num_slots=2, kv_paged=True, kv_block_size=BLOCK,
                idle_wait_secs=0.01)
    base.update(cfg)
    return GenerationServer(model, ServingConfig(**base), injector=injector)


def test_wedged_engine_step_reads_stalled_with_bundle_status_and_page(
        tmp_path):
    wedge = Wedge()
    server = tiny_server(wedge, stall_after_secs=0.3,
                         health_dir=str(tmp_path), metrics_port=0,
                         health_reconcile_secs=0.2).start()
    try:
        server.generate([1, 2, 3], 3)
        server.mark_steady()
        h = server.health.snapshot()
        assert h["steady_marked"] and h["jit_compiles"] > 0
        wedge.armed.set()
        req = server.submit([4, 5, 6], 6)
        assert wedge.wedged.wait(WAIT_S)
        wait_for(lambda: server.health.bundles, "the stall bundle")
        st = server.raw_servicer.server_status(pb.ServerStatusRequest())
        assert st.health_state == "stalled"
        assert st.last_progress_age_ms >= 300.0
        assert st.jit_compiles == h["jit_compiles"]
        with open(server.health.bundles[0]) as f:
            bundle = json.load(f)
        assert prh.validate_bundle(bundle) == jrh.validate_bundle(bundle) \
            == []
        assert bundle["reason"] == "progress_stall" and bundle["ring"]
        stacks = [t for t in bundle["stacks"]["threads"]
                  if t["thread"] == "serving-scheduler"]
        assert stacks and "intercept" in "".join(stacks[0]["stack"])
        page = server.metrics and _get(server.metrics.port)
        for parse in (promparse.parse_prometheus_text,
                      jpromparse.parse_prometheus_text):
            fams = parse(page)
            assert fams["edl_serving_stalls_total"]["samples"][0][2] == 1
            fns = {s[1]["fn"] for s in
                   fams["edl_serving_recompiles_total"]["samples"]}
            assert fns == set(server.health.sentry.compiles)
        wedge.release.set()
        for _chunk in server.events(req):
            pass
        assert len(req.generated) == 6
        wait_for(lambda: server.health.health_state() == "ok", "recovery")
    finally:
        wedge.release.set()
        server.stop(timeout=WAIT_S)
    assert server.health.snapshot()["stalls"] == 1


def _get(port):
    import urllib.request

    return urllib.request.urlopen("http://127.0.0.1:%d/metrics" % port,
                                  timeout=WAIT_S).read().decode()


def test_status_read_is_a_watchdog_check_and_leak_is_convicted():
    """No health thread: a status read alone detects the stall; the
    leak rule fires at a reconcile after the steady mark only."""
    wedge = Wedge()
    server = tiny_server(wedge, stall_after_secs=0.2)
    server.scheduler.start()  # the health thread is not started
    try:
        server.generate([1, 2], 2)
        wedge.leak = True
        server.health.reconcile()
        assert wedge.leak  # before the steady mark: not consulted
        server.mark_steady()
        server.health.reconcile()
        before = server.health.accountant.snapshot()
        wedge.leak_before = before["unaccounted_peak_bytes"]
        server.health.reconcile()
        after = server.health.accountant.snapshot()
        assert not wedge.leak and after["leaked_buffers"] == 1
        assert after["unaccounted_peak_bytes"] >= 8 << 20
        wedge.armed.set()
        server.submit([3, 4], 5)
        assert wedge.wedged.wait(WAIT_S)
        wait_for(lambda: server.raw_servicer.server_status(
            pb.ServerStatusRequest()).health_state == "stalled",
            "a status read to see the stall")
        st = server.raw_servicer.server_status(pb.ServerStatusRequest())
        assert st.memory_unaccounted_bytes >= 8 << 20
        assert server.telemetry.counters["stalls"] == 1
    finally:
        wedge.release.set()
        server.stop(timeout=WAIT_S)


def test_plane_off_reports_nothing():
    server = tiny_server(runtime_health=False, metrics_port=0).start()
    try:
        server.generate([1, 2], 2)
        server.mark_steady()  # a no-op
        st = server.raw_servicer.server_status(pb.ServerStatusRequest())
        assert (st.health_state, st.jit_compiles, st.last_progress_age_ms,
                st.steady_recompiles) == ("", 0, 0.0, 0)
        assert server.health is None and "health" not in server.status()
        assert server.engine.sentry is None
        assert "edl_serving_recompiles_total" not in _get(
            server.metrics.port)
    finally:
        server.stop(timeout=WAIT_S)


def test_entry_parses_health_flags_and_marks_steady():
    args = port_main.parse_serving_args([
        "--device", "cpu", "--kv_paged", "1", "--kv_block_size", "4",
        "--num_slots", "2", "--port", "0", "--stall_after_secs", "3.5",
        "--model_params", PARAMS])
    server = port_main.build_server(args)
    assert server.config.runtime_health and server.health is not None
    assert server.health.watchdog.stall_after_secs == 3.5
    server.start()
    try:
        port_main.warmup(server, 2)
        assert server.health.snapshot()["steady_marked"]
    finally:
        server.stop(timeout=WAIT_S)
    off = port_main.build_server(port_main.parse_serving_args([
        "--device", "cpu", "--runtime_health", "0", "--model_params",
        PARAMS]))
    assert off.health is None


def test_injector_spec_drives_the_health_hooks():
    inj = FaultInjector(spec="engine_step:drop:1:skip=1;health_leak:drop:1")
    inj.intercept("engine_step")
    with pytest.raises(InjectedRpcError):
        inj.intercept("engine_step")
    inj.intercept("engine_step")
    with pytest.raises(InjectedRpcError):
        inj.intercept("health_leak")
    assert inj.injected == {"engine_step": 1, "health_leak": 1}
    # a dropped tick skips one decode step; the request still finishes
    server = tiny_server(FaultInjector(spec="engine_step:drop:2"))
    server.start()
    try:
        out = server.generate([1, 2, 3], 4)
        assert len(out) == 7
    finally:
        server.stop(timeout=WAIT_S)


SIGUSR2_CHILD = r"""
import sys, threading, time
from elasticdl_tpu_torch.observability.runtime_health import (
    install_sigusr2_dump)
path = install_sigusr2_dump()
worker = threading.Thread(target=time.sleep, args=(60,), name="sleeper",
                          daemon=True)
worker.start()
print("READY", path, flush=True)
for line in sys.stdin:
    print("ECHO", line.strip(), flush=True)
"""


def test_sigusr2_dumps_all_stacks_and_the_process_lives_on(tmp_path):
    env = dict(os.environ, EDL_HEALTH_DIR=str(tmp_path),
               PYTHONPATH=REPO)
    proc = subprocess.Popen([sys.executable, "-c", SIGUSR2_CHILD], env=env,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("READY")
        path = line.split()[1]
        assert path == str(tmp_path / ("sigusr2-%d.txt" % proc.pid))
        proc.send_signal(signal.SIGUSR2)
        wait_for(lambda: os.path.exists(path) and "Current thread" in open(
            path).read(), "the stack dump")
        text = open(path).read()
        # the sleeper's stack and the main thread's
        assert text.count("hread 0x") == 2 and "threading.py" in text
        proc.stdin.write("ping\n")
        proc.stdin.flush()
        assert proc.stdout.readline().strip() == "ECHO ping"
        assert proc.poll() is None
    finally:
        proc.kill()
        proc.wait(timeout=WAIT_S)
        proc.stdin.close()
        proc.stdout.close()


def test_kernel_build_in_flight_is_progress(tmp_path, monkeypatch):
    """A real build() of the host library through a stand-in compiler
    that takes a while: the watchdog, with work seated and no tokens,
    does not stall while it runs, and the stats name it after."""
    cxx = tmp_path / "slow-cxx"
    cxx.write_text("#!/bin/sh\nsleep 1.2\nout=\nwhile [ $# -gt 0 ]; do "
                   "if [ \"$1\" = -o ]; then out=$2; fi; shift; done\n"
                   "touch \"$out\"\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    before = _build.build_stats()
    eng = FakePortEngine(KV, 400, 64)
    eng.seated = 1
    health = prh.RuntimeHealth(eng, [], FakeTelemetry(),
                               stall_after_secs=0.3, health_dir="",
                               live_bytes_fn=lambda: (0, None))
    health.check()
    build_thread = threading.Thread(target=_build.build, args=(
        ("host_embedding",),), daemon=True)
    build_thread.start()
    wait_for(lambda: _build.build_stats()["in_flight"], "the build")
    while build_thread.is_alive() and _build.build_stats()["in_flight"]:
        assert not health.check()
        time.sleep(0.05)
    build_thread.join(timeout=WAIT_S)
    stats = _build.build_stats()
    assert (stats["started"] - before["started"],
            stats["finished"] - before["finished"]) == (1, 1)
    last = stats["builds"][-1]
    assert last["name"] == "host_embedding" and last["ok"]
    assert last["seconds"] >= 1.0 and stats["in_flight"] == []
    assert health.sentry.snapshot()["builds"] == stats
    assert not health.check()  # the finished build moved the counter
    assert health.health_state() == "ok"
    time.sleep(0.4)
    assert health.check() and health.health_state() == "stalled"


def test_paged_step_tracking_costs_microseconds():
    """The decode step's tracked site: its signature walk over a step's
    arguments, timed, with a generous bound."""
    sentry = prh.RecompileSentry()
    site = prh.tracked_call(lambda *a: None, "paged_step", lambda: sentry)
    args = (torch.zeros(8, 1, dtype=torch.long), torch.zeros(8, 64),
            np.arange(8))
    site(*args)
    t0 = time.perf_counter()
    for _ in range(2000):
        site(*args)
    per_call = (time.perf_counter() - t0) / 2000
    assert sentry.compiles == {"paged_step": 1}
    assert per_call < 100e-6, per_call


def test_telemetry_carries_the_health_pair():
    tel = ServingTelemetry()
    assert {"steady_recompiles", "stalls"} <= set(tel.counters)
    assert {"last_progress_age_ms", "memory_unaccounted_bytes"} <= set(
        tel.gauges)
