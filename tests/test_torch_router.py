"""The port's serving router and what it stands on, against the JAX
package's (no sockets: fake replica stubs, the transport is in
tests/test_torch_router_wire.py).

* prefix affinity: fingerprints bit for bit over seeded prompts, block
  sizes and caps; HashRing lookups and failover walks as nodes come and
  go; one seeded AffinityIndex learn / lookup / expire / evict / forget
  sequence;
* the six router messages byte for byte against elasticdl_pb2, both
  ways: defaults, a full RouterStatusResponse, a singular block set but
  empty, and unset;
* the SLO burn-rate engine over both rings fed the same observations,
  RouterTelemetry's snapshot, the span recorder's retention, export and
  Chrome trace;
* the router itself: each scenario function runs the same scripted fleet
  (a fake clock, fake replicas with set statuses and failures) through
  the JAX Router and the port's, each side raising its own package's
  errors (grpc status codes for JAX, the port's RpcError by status
  name), and holds equal every chosen replica, breaker state, telemetry
  snapshot and status_response, step by step.
"""

import os
import random
import threading
import time

import grpc
import numpy as np
import pytest

from elasticdl_tpu.common import fault_injection as jfault
from elasticdl_tpu.observability import metrics as jmetrics
from elasticdl_tpu.observability import slo as jslo
from elasticdl_tpu.observability import tracing as jtracing
from elasticdl_tpu.proto import elasticdl_pb2 as jpb
from elasticdl_tpu.serving import prefix_affinity as jaff
from elasticdl_tpu.serving import router as jrouter
from elasticdl_tpu.serving import telemetry as jtelemetry
from elasticdl_tpu_torch.common import fault_injection as pfault
from elasticdl_tpu_torch.observability import metrics as pmetrics
from elasticdl_tpu_torch.observability import slo as pslo
from elasticdl_tpu_torch.observability import tracing as ptracing
from elasticdl_tpu_torch.observability.histogram import LogLinearHistogram
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.serving import prefix_affinity as paff
from elasticdl_tpu_torch.serving import router as prouter
from elasticdl_tpu_torch.serving import telemetry as ptelemetry

WAIT = 5.0  # seconds: every real wait in this file is bounded by it


class FakeClock(object):
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# ------------------------------------------------------ prefix affinity


@pytest.mark.parametrize("block_tokens,max_blocks", [
    (16, 4), (4, 1), (1, 8), (8, 64), (3, 5)])
def test_fingerprint_bit_equal(block_tokens, max_blocks):
    rs = np.random.RandomState(block_tokens * 100 + max_blocks)
    prompts = [rs.randint(-2 ** 40, 2 ** 40, size=n).tolist()
               for n in (0, 1, block_tokens - 1, block_tokens,
                         block_tokens + 1, 3 * block_tokens + 2, 200)]
    prompts += [rs.randint(0, 32000, size=n).tolist() for n in range(40)]
    for p in prompts:
        want = jaff.prefix_fingerprint(p, block_tokens, max_blocks)
        assert paff.prefix_fingerprint(p, block_tokens, max_blocks) == want
    with pytest.raises(ValueError):
        paff.prefix_fingerprint([1], block_tokens=0)


def test_hash_ring_equal_as_nodes_change():
    rs = np.random.RandomState(7)
    keys = ["%x" % k for k in rs.randint(0, 2 ** 62, size=300)]
    j, p = jaff.HashRing(vnodes=16), paff.HashRing(vnodes=16)
    assert p.lookup("k") is None and p.successors("k") == []
    for op, node in [("add", "a"), ("add", "b"), ("add", "cell:3"),
                     ("add", "b"), ("remove", "a"), ("add", "d"),
                     ("remove", "zz"), ("add", "e"), ("remove", "cell:3")]:
        getattr(j, op)(node)
        getattr(p, op)(node)
        assert p.nodes() == j.nodes() and len(p) == len(j)
        for k in keys:
            assert p.lookup(k) == j.lookup(k)
            assert p.successors(k) == j.successors(k)
    assert [jaff.HashRing(["x", "y"], vnodes=3).lookup(k) for k in keys] == \
        [paff.HashRing(["x", "y"], vnodes=3).lookup(k) for k in keys]


def test_affinity_index_equal_over_a_seeded_sequence():
    rs = np.random.RandomState(11)
    j = jaff.AffinityIndex(ttl_secs=5.0, capacity=8)
    p = paff.AffinityIndex(ttl_secs=5.0, capacity=8)
    fps = ["fp%d" % i for i in range(20)] + [None]
    addrs = ["r%d" % i for i in range(4)]
    now = 0.0
    for _ in range(600):
        now += float(rs.uniform(0, 0.7))
        op = rs.randint(4)
        if op == 0:
            args = (fps[rs.randint(len(fps))], addrs[rs.randint(4)], now)
            j.learn(*args)
            p.learn(*args)
        elif op == 1 or op == 2:
            fp = fps[rs.randint(len(fps))]
            assert p.lookup(fp, now) == j.lookup(fp, now)
        else:
            a = addrs[rs.randint(4)]
            assert p.forget_address(a) == j.forget_address(a)
        assert len(p) == len(j)


# -------------------------------------------------------------- messages


FULL_REPLICA = dict(
    address="localhost:50051", healthy=True, draining=True,
    breaker="half_open", lease_remaining_secs=1.25, queue_depth=3,
    active_slots=8, kv_blocks_free=100, queue_wait_ms=12.5,
    dispatched=1 << 40, failures=2, inflight=4, kv_cache_dtype="int8",
    kv_host_blocks=6, kv_host_bytes=1 << 33, revive_uploads=7,
    prefill_tokens_revived=8, host_drops=9, prefix_hit_rate_window=0.75,
    slow_cause_counts=[1, 0, 3, 0, 5, 6, 7], last_progress_age_ms=8.5,
    health_state="stalled", kv_blocks_cached=23, kv_blocks_shared=24,
    role="prefill", model_version=-3, reload_failed=True)
FULL_SLO = dict(name="ttft_p99", kind="latency", threshold_ms=30000.0,
                goal=0.01, fast_burn=2.5, slow_burn=-0.0,
                fast_window_secs=30.0, slow_window_secs=120.0,
                fast_samples=1 << 35, slow_samples=9, alerting=True)
FULL_AUTOSCALER = dict(
    enabled=True, target=4, live=3, starting=1, draining=2, scale_ups=5,
    scale_downs=6, replacements=7, spawn_failures=8, circuit_open=True,
    last_decision="up", last_reason="queue wait ✓",
    last_decision_age_secs=1.5, supervisor_restarts=9)
FULL_ROLLOUT = dict(
    enabled=True, phase="wave", target_version=7, old_version=6, wave=2,
    waves_total=3, swapped=2, fleet=3, canary="localhost:1",
    verdict="pass", last_error="", rollbacks=1, rollout_restarts=2)
FULL_STATUS = dict(
    replicas=3, healthy=2, routed=1 << 41, completed=5, redispatched=6,
    hedges=7, hedge_wins=8, shed=9, breaker_trips=10, uptime_secs=11.5,
    e2e_p50_ms=1e-300, e2e_p90_ms=float("inf"), e2e_p99_ms=3.0,
    ttft_p50_ms=4.0, ttft_p90_ms=5.0, ttft_p99_ms=6.0,
    queue_wait_p50_ms=7.0, queue_wait_p90_ms=8.0, queue_wait_p99_ms=9.0,
    kv_host_blocks=22, kv_host_bytes=23, revive_uploads=24,
    prefill_tokens_revived=25, host_drops=26, cell_id=1, cells=2,
    affinity_hits=30, affinity_misses=31, journal_events=32,
    journal_replayed=33, cell_restarts=34, disagg_handoffs=35,
    disagg_fallbacks=36)


def _both(name, kwargs, nested=()):
    """(port message, JAX message) built from the same field values;
    `nested` names the message-valued fields in kwargs."""
    jk, pk = {}, {}
    for k, v in kwargs.items():
        if k in nested:
            if isinstance(v, list):
                pk[k] = [getattr(pb, cls)(**d) for cls, d in v]
                jk[k] = [getattr(jpb, cls)(**d) for cls, d in v]
            else:
                cls, d = v
                pk[k] = getattr(pb, cls)(**d)
                jk[k] = getattr(jpb, cls)(**d)
        else:
            pk[k], jk[k] = v, v
    return getattr(pb, name)(**pk), getattr(jpb, name)(**jk)


MESSAGE_CASES = {
    "defaults": [(name, {}, ()) for name in (
        "RouterStatusRequest", "AutoscalerStatus", "SloObjective",
        "ReplicaStatus", "RolloutStatus", "RouterStatusResponse")],
    "full": [
        ("ReplicaStatus", FULL_REPLICA, ()),
        ("SloObjective", FULL_SLO, ()),
        ("AutoscalerStatus", FULL_AUTOSCALER, ()),
        ("RolloutStatus", FULL_ROLLOUT, ()),
        ("RouterStatusResponse", dict(
            FULL_STATUS,
            replica=[("ReplicaStatus", dict(FULL_REPLICA, address=a))
                     for a in ("a:1", "b:2", "")],
            slo=[("SloObjective", dict(FULL_SLO, name=n))
                 for n in ("ttft_p99", "e2e_p99", "goodput")],
            autoscaler=("AutoscalerStatus", FULL_AUTOSCALER),
            rollout=("RolloutStatus", FULL_ROLLOUT)),
         ("replica", "slo", "autoscaler", "rollout")),
    ],
    "set_but_empty": [
        ("RouterStatusResponse", dict(
            replicas=1, autoscaler=("AutoscalerStatus", {}),
            rollout=("RolloutStatus", {}),
            replica=[("ReplicaStatus", {})]),
         ("replica", "autoscaler", "rollout")),
    ],
    "unset": [
        ("RouterStatusResponse", dict(healthy=2, rollout=(
            "RolloutStatus", dict(phase="idle"))), ("rollout",)),
        ("RouterStatusResponse", dict(healthy=2, autoscaler=(
            "AutoscalerStatus", dict(live=1))), ("autoscaler",)),
    ],
}


def _normalize(msg, cls):
    """A field dict of `msg` (either package's) in the port's names;
    singular blocks as None when unset."""
    out = {}
    for name, _n, kind in cls.FIELDS:
        v = getattr(msg, name)
        if isinstance(kind, pb._Message):
            set_ = (v is not None if isinstance(msg, pb.Message)
                    else msg.HasField(name))
            out[name] = _normalize(v, kind.cls) if set_ else None
        elif isinstance(kind, pb._RepeatedMessage):
            out[name] = [_normalize(x, kind.cls) for x in v]
        elif isinstance(kind, pb._Repeated):
            out[name] = list(v)
        else:
            out[name] = v
    return out


@pytest.mark.parametrize("case", sorted(MESSAGE_CASES))
def test_router_messages_byte_equal_both_ways(case):
    for name, kwargs, nested in MESSAGE_CASES[case]:
        pm, jm = _both(name, kwargs, nested)
        data = pm.SerializeToString()
        assert data == jm.SerializeToString(), name
        cls = getattr(pb, name)
        back = cls.FromString(jm.SerializeToString())
        assert back == pm
        assert back.SerializeToString() == data
        j2 = getattr(jpb, name).FromString(data)
        assert _normalize(j2, cls) == _normalize(back, cls)
        if name == "RouterStatusResponse":
            for block in ("autoscaler", "rollout"):
                assert back.HasField(block) == jm.HasField(block)


def test_singular_block_repeats_merge_as_protobuf():
    a = jpb.RouterStatusResponse(autoscaler=jpb.AutoscalerStatus(
        target=3, last_reason="a"), replicas=1).SerializeToString()
    b = jpb.RouterStatusResponse(autoscaler=jpb.AutoscalerStatus(
        live=2), replicas=4).SerializeToString()
    want = jpb.RouterStatusResponse.FromString(a + b)
    got = pb.RouterStatusResponse.FromString(a + b)
    assert got.SerializeToString() == want.SerializeToString()
    assert (got.autoscaler.target, got.autoscaler.live) == (3, 2)
    with pytest.raises(TypeError):
        pb.RouterStatusResponse(autoscaler=pb.RolloutStatus())
    with pytest.raises(ValueError):
        pb.RouterStatusResponse().HasField("replicas")


# ------------------------------------------------------ SLO and telemetry


def _feed_rings(seed):
    """Both packages' rings over one fake clock, fed the same cumulative
    observations; returns (port ring, JAX ring, clock)."""
    clock = FakeClock(0.0)
    pr = pmetrics.TimeSeriesRing(interval_secs=2.0, capacity=50, clock=clock)
    jr = jmetrics.TimeSeriesRing(interval_secs=2.0, capacity=50, clock=clock)
    rs = np.random.RandomState(seed)
    e2e, fleet = LogLinearHistogram(), LogLinearHistogram()
    counters = {"routed": 0, "shed": 0, "errors": 0}
    for _ in range(400):
        clock.advance(float(rs.uniform(0.05, 0.9)))
        for _ in range(rs.randint(4)):
            counters["routed"] += 1
            e2e.record(float(rs.lognormal(6.0, 2.0)))
            fleet.record(float(rs.lognormal(5.0, 1.5)))
            if rs.uniform() < 0.05:
                counters["shed" if rs.uniform() < 0.5 else "errors"] += 1
        obs = dict(counters=dict(counters),
                   hists={"e2e_ms": e2e.to_counts(),
                          "fleet_ttft_ms": fleet.to_counts()})
        pr.observe(**obs)
        jr.observe(**obs)
    return pr, jr, clock


@pytest.mark.parametrize("seed", [0, 1])
def test_burn_rate_engine_equal_over_both_rings(seed):
    pr, jr, clock = _feed_rings(seed)
    for ttft, e2e, goodput in ((200.0, 500.0, 0.02), (1e4, 3e3, 0.1)):
        pe = pslo.BurnRateEngine(pslo.default_router_slos(
            ttft, e2e, goodput, latency_goal=0.05), 30.0, 120.0)
        je = jslo.BurnRateEngine(jslo.default_router_slos(
            ttft, e2e, goodput, latency_goal=0.05), 30.0, 120.0)
        for now in (None, clock() - 40.0):
            got, want = pe.evaluate(pr, now), je.evaluate(jr, now)
            assert got == want
            assert any(r["fast_samples"] for r in got)
    for horizon in (None, 10.0, 60.0):
        for name in ("e2e_ms", "fleet_ttft_ms", "nope"):
            assert (pr.merged_hist_counts(name, horizon)
                    == jr.merged_hist_counts(name, horizon))
    with pytest.raises(ValueError):
        pslo.SloSpec("x", "latency", 0.01)
    with pytest.raises(ValueError):
        pslo.SloSpec("x", "latency", 1.0, hist="h", threshold_ms=1.0)


def test_router_telemetry_snapshot_and_ring_equal():
    clock = FakeClock(10.0)
    pt = ptelemetry.RouterTelemetry(clock=clock)
    jt = jtelemetry.RouterTelemetry(clock=clock)
    rs = np.random.RandomState(3)
    engine_p = pslo.BurnRateEngine(pslo.default_router_slos(50, 80, 0.02))
    engine_j = jslo.BurnRateEngine(jslo.default_router_slos(50, 80, 0.02))
    for step in range(120):
        clock.advance(0.3)
        for t in (pt, jt):
            t.gauge("cell_id", 1)
        name = ptelemetry.RouterTelemetry.COUNTERS[rs.randint(12)]
        lat = float(rs.lognormal(4.0, 1.0))
        for t in (pt, jt):
            t.count(name, 2)
            t.record_e2e(lat, trace_id="t%d" % step)
        if step % 3 == 0:
            fleet = {"fleet_ttft_ms": [0, 1, step], "fleet_queue_wait_ms": []}
            pt.record_poll(step % 4, 4, fleet_hists=fleet)
            jt.record_poll(step % 4, 4, fleet_hists=fleet)
            assert (pt.evaluate_slos(engine_p)
                    == jt.evaluate_slos(engine_j))
        assert pt.snapshot() == jt.snapshot()
    for t in (pt, jt):
        t.close()
    assert pt.ring.sum_counter("routed") == jt.ring.sum_counter("routed")
    with pytest.raises(ValueError):
        pt.count("nope")
    with pytest.raises(ValueError):
        pt.gauge("nope", 1)
    with pytest.raises(NotImplementedError, match="item 6"):
        ptelemetry.RouterTelemetry(log_dir="/nonexistent")


# ---------------------------------------------------------------- tracing


def _drive_recorder(mod, seed):
    """One seeded span sequence through a fresh recorder of `mod` with a
    classifier (slow or failed roots retained, the rest sampled out at
    sample_rate 0.5) under ring pressure."""
    clock = FakeClock(100.0)
    rec = mod.SpanRecorder(service="svc", capacity=12, clock=clock,
                           retained_capacity=9, sample_rate=0.5, seed=seed)

    def classify(span):
        if span.name != "root":
            return None
        return span.status != "ok" or span.end - span.start > 1.0

    rec.add_classifier(classify)
    rec.add_classifier(classify)
    rs = np.random.RandomState(seed)
    for i in range(40):
        tid = "trace%02d" % i
        root = rec.start_span("root", trace_id=tid, req=i)
        root.event("queued", n=i)
        for leg in range(rs.randint(1, 3)):
            clock.advance(float(rs.uniform(0, 0.5)))
            child = rec.start_span("dispatch", trace_id=tid,
                                   parent_span_id=root.span_id, leg=leg)
            child.event("redispatched" if leg else "seated")
            child.finish("ok" if rs.uniform() < 0.8 else "UNAVAILABLE")
        root.set(tokens=i)
        root.finish("ok" if rs.uniform() < 0.85 else "RESOURCE_EXHAUSTED")
        root.finish("error")  # a second finish is a no-op
    rec.remove_classifier(classify)
    return rec


def _structure(doc):
    """A span document with ids replaced by their order of appearance."""
    ids = {}

    def rid(x):
        return ids.setdefault(x, len(ids)) if x else ""

    return [(s["name"], s["trace_id"], rid(s["span_id"]),
             rid(s["parent_span_id"]), s["service"], s["start"], s["end"],
             s["status"], s["attrs"], s["events"]) for s in doc["spans"]]


@pytest.mark.parametrize("seed", [0, 5])
def test_span_recorder_retention_and_export_equal(seed):
    p, j = _drive_recorder(ptracing, seed), _drive_recorder(jtracing, seed)
    pd, jd = p.export(), j.export()
    for key in ("service", "dropped", "retained", "retained_dropped",
                "sampled_out"):
        assert pd[key] == jd[key], key
    assert _structure(pd) == _structure(jd)
    assert len(p) == len(j) and pd["retained"] > 0 and pd["dropped"] > 0
    pspans, jspans = pd["spans"], jd["spans"]
    assert ({t: len(v) for t, v in ptracing.group_by_trace(pspans).items()}
            == {t: len(v) for t, v in jtracing.group_by_trace(
                jspans).items()})
    assert (len(ptracing.trace_roots(pspans))
            == len(jtracing.trace_roots(jspans)))
    pc = ptracing.chrome_trace(pspans)["traceEvents"]
    jc = jtracing.chrome_trace(jspans)["traceEvents"]

    def strip(events):
        out = []
        for e in events:
            e = dict(e, args={k: v for k, v in e["args"].items()
                              if k not in ("span_id", "parent_span_id")})
            out.append(e)
        return out

    assert strip(pc) == strip(jc)


def test_recorder_flush_writes_only_with_a_trace_dir(tmp_path, monkeypatch):
    rec = ptracing.SpanRecorder(service="router:1/x")
    rec.start_span("a").finish()
    monkeypatch.delenv(ptracing.TRACE_DIR_ENV, raising=False)
    assert rec.flush() is None
    monkeypatch.setenv(ptracing.TRACE_DIR_ENV, str(tmp_path))
    path = rec.flush()
    assert path.endswith("spans-router-1-x-%d.json" % os.getpid())
    assert ptracing.configure(service="router:9") is ptracing.recorder()
    assert ptracing.recorder().service == "router:9"
    ptracing.configure(service="proc")


# ------------------------------------------------------ the router vs JAX


class Side(object):
    """One package's router surface: its pb module, Router classes and an
    error factory by status name."""

    def __init__(self, name):
        self.name = name
        if name == "jax":
            self.pb, self.mod, self.fault = jpb, jrouter, jfault
        else:
            self.pb, self.mod, self.fault = pb, prouter, pfault

    def err(self, code, msg="x"):
        if self.name == "jax":
            return jfault.InjectedRpcError(getattr(grpc.StatusCode, code),
                                           msg)
        return pfault.InjectedRpcError(code, msg)

    def telemetry(self, clock):
        mod = jtelemetry if self.name == "jax" else ptelemetry
        return mod.RouterTelemetry(clock=clock)

    def start(self, router, injector=None):
        """Start without a transport; the heartbeat's first sweep lands
        before this returns (the rigs that start set a long poll_secs,
        so it is the only one)."""
        polls = router.telemetry.snapshot()["polls"]
        if self.name == "jax":
            router.start(grpc_server=False, injector=injector)
        else:
            router.start(transport=False, injector=injector)
        _wait_until(lambda: router.telemetry.snapshot()["polls"] > polls)


class FakeReplicaStub(object):
    """ServingStub-shaped fake: scripted status, failures and blocking,
    plus the handoff's three methods."""

    def __init__(self, side, token):
        self.side = side
        self.token = token
        self.poll_ok = True
        self.status = {}
        self.gen_errors = []
        self.stream_errors = []
        self.stream_fail_after_chunks = None
        self.calls = 0
        self.block_until = None
        self.status_calls = 0
        self.status_block_until = None
        self.closed = 0
        self.export_error = None
        self.import_ok = True
        self.handoff_calls = []

    def close(self):
        self.closed += 1

    def server_status(self, request, timeout=None):
        self.status_calls += 1
        if self.status_block_until is not None:
            assert self.status_block_until.wait(WAIT)
        if not self.poll_ok:
            raise self.side.err("UNAVAILABLE", "poll down")
        return self.side.pb.ServerStatusResponse(**self.status)

    def generate(self, request, timeout=None):
        self.calls += 1
        if request.prefill_only:
            self.handoff_calls.append("prefill")
        if self.block_until is not None:
            assert self.block_until.wait(WAIT)
        if self.gen_errors:
            raise self.gen_errors.pop(0)
        return self.side.pb.GenerateResponse(
            tokens=list(request.prompt) + [self.token], model_version=1)

    def generate_stream(self, request, timeout=None):
        self.calls += 1
        if self.stream_errors:
            raise self.stream_errors.pop(0)
        pbm, fail_after, err = (self.side.pb, self.stream_fail_after_chunks,
                                self.side.err)

        def chunks():
            for i in range(request.max_new_tokens):
                if fail_after is not None and i >= fail_after:
                    raise err("UNAVAILABLE", "died mid-stream")
                yield pbm.TokenChunk(tokens=[self.token + i],
                                     model_version=1)
            yield pbm.TokenChunk(tokens=[], done=True, model_version=1)

        return chunks()

    def export_chain(self, request, timeout=None):
        self.handoff_calls.append("export:%s" % request.transfer_id[:5])
        if self.export_error is not None:
            raise self.export_error
        p = self.side.pb
        return p.TransferChainRequest(
            transfer_id=request.transfer_id, block_size=4,
            leaf_dtypes=["float32"],
            blocks=[p.KvChainBlock(tokens=list(request.prompt[:4]),
                                   leaves=[b"\0" * 8])])

    def transfer_chain(self, request, timeout=None):
        self.handoff_calls.append("import")
        return self.side.pb.TransferChainResponse(
            transfer_id=request.transfer_id, ok=self.import_ok,
            blocks=len(request.blocks) if self.import_ok else 0,
            error="" if self.import_ok else "refused")

    def abort_transfer(self, request, timeout=None):
        self.handoff_calls.append("abort")
        return self.side.pb.TransferChainResponse(
            transfer_id=request.transfer_id, ok=True)


class Rig(object):
    """A router over n fake replicas ("rep0".. with tokens 100, 200, ...)
    on a fake clock; sleeps advance the clock unless told not to."""

    def __init__(self, side, n=2, advance_on_sleep=True, **cfg):
        self.side = side
        self.clock = FakeClock()
        self.stubs = {"rep%d" % i: FakeReplicaStub(side, 100 * (i + 1))
                      for i in range(n)}
        knobs = dict(lease_secs=10.0, breaker_threshold=2,
                     breaker_cooldown_secs=5.0, redispatch_window_secs=8.0,
                     base_delay_secs=0.01, max_delay_secs=0.05)
        knobs.update(cfg)
        config = side.mod.RouterConfig(**knobs)
        self.router = side.mod.Router(
            sorted(self.stubs), config=config,
            stub_factory=lambda a: self.stubs[a], clock=self.clock,
            sleep=self.clock.advance if advance_on_sleep else (lambda s: 0),
            telemetry=side.telemetry(self.clock))
        self.trace = []

    def req(self, prompt=(1, 2), new=3, deadline_ms=0):
        return self.side.pb.GenerateRequest(
            prompt=list(prompt), max_new_tokens=new, deadline_ms=deadline_ms)

    def call(self, fn, *args):
        """fn's outcome: ("ok", last token or tokens) or ("err", code,
        shed?)."""
        try:
            out = fn(*args)
        except self.side.mod.RouterError as e:
            return ("err", e.code, str(e).startswith("no healthy"))
        except Exception as e:  # noqa: BLE001 - an injected fault
            code = e.code()
            return ("raised", getattr(code, "name", code))
        if hasattr(out, "tokens"):
            return ("ok", list(out.tokens)[-1])
        return ("ok", out)

    def gen(self, **kw):
        return self.call(self.router.dispatch_generate, self.req(**kw))

    def stream(self, **kw):
        got = []

        def run():
            for chunk in self.router.dispatch_stream(self.req(**kw)):
                got.extend(chunk.tokens)
            return "done"

        out = self.call(run)
        return out + (got,)

    def note(self, label, value=None):
        self.trace.append((label, value))

    def observe(self, label=""):
        r = self.router
        snap = r.telemetry.snapshot()
        self.trace.append(("snapshot" + label, snap))
        self.trace.append(("breakers" + label, {
            x.address: (x.breaker.state, x.breaker.failures, x.inflight,
                        x.dispatched, x.failures)
            for x in r.replicas()}))
        self.trace.append(("status" + label, _normalize(
            r.status_response(), pb.RouterStatusResponse)))

    def stop(self):
        self.router.stop()


def _wait_until(cond):
    t0 = time.monotonic()
    while not cond() and time.monotonic() - t0 < WAIT:
        time.sleep(0.005)
    assert cond()


def sc_breaker_unit(side):
    out = []
    b = side.mod.CircuitBreaker(threshold=3, cooldown_secs=2.0)
    for step in [("fail", 0.0), ("fail", 0.0), ("fail", 0.0),
                 ("eligible", 1.0), ("eligible", 2.0), ("acquire", 2.0),
                 ("eligible", 2.0), ("acquire", 2.0), ("release", None),
                 ("eligible", 2.5), ("acquire", 2.5), ("fail", 2.5),
                 ("eligible", 4.0), ("eligible", 4.6), ("acquire", 4.6),
                 ("success", None), ("fail", 5.0), ("success", None),
                 ("fail", 5.0), ("fail", 5.0), ("fail", 5.0)]:
        op, now = step
        res = {"fail": lambda: b.record_failure(now),
               "eligible": lambda: b.eligible(now),
               "acquire": lambda: b.acquire(now),
               "release": b.release_probe,
               "success": b.record_success}[op]()
        out.append((op, (res, b.state, b.failures)))
    return out


def sc_half_open_probe(side):
    """A half-open probe that fails INVALID_ARGUMENT releases its slot;
    one answered RESOURCE_EXHAUSTED closes the breaker."""
    rig = Rig(side, 1)
    try:
        r, s = rig.router, rig.stubs["rep0"]
        for final in ("INVALID_ARGUMENT", "RESOURCE_EXHAUSTED"):
            r.poll_once()
            s.gen_errors = [side.err("UNAVAILABLE") for _ in range(50)]
            rig.note("burn", rig.gen())
            rig.observe()
            s.gen_errors = []
            rig.note("open", rig.gen())
            rig.clock.advance(r.config.breaker_cooldown_secs + 0.1)
            r.poll_once()
            s.gen_errors = [side.err(final)]
            rig.note("probe", rig.gen())
            rig.observe()
            rig.note("after", rig.gen())
            rig.observe()
        return rig.trace
    finally:
        rig.stop()


def sc_least_loaded(side):
    rig = Rig(side, 3)
    try:
        r, st = rig.router, rig.stubs
        st["rep0"].status = dict(queue_depth=5)
        r.poll_once()
        rig.note("depth", rig.gen())
        st["rep0"].status = dict(queue_depth=2, queue_wait_ms=500.0)
        st["rep1"].status = dict(queue_depth=2)
        st["rep2"].status = dict(queue_depth=2, kv_blocks_free=9)
        r.poll_once()
        rig.note("wait+free", rig.gen())
        rig.observe()
        # in-flight dispatches spread a tie
        gate = threading.Event()
        for s in st.values():
            s.status, s.block_until = {}, gate
        r.poll_once()
        done = []
        ts = [threading.Thread(target=lambda: done.append(rig.gen()))
              for _ in range(3)]
        for t in ts:
            t.start()
            reps = r.replicas()
            _wait_until(lambda: sum(x.inflight for x in reps)
                        == ts.index(t) + 1)
        rig.note("spread", sorted(x.inflight for x in r.replicas()))
        gate.set()
        for t in ts:
            t.join(WAIT)
        rig.note("done", sorted(done))
        rig.observe()
        return rig.trace
    finally:
        rig.stop()


def sc_lease_shed_wedged(side):
    rig = Rig(side, 2, poll_timeout_secs=0.2)
    try:
        r, st = rig.router, rig.stubs
        r.poll_once()
        st["rep0"].poll_ok = False
        rig.clock.advance(11.0)
        rig.note("healthy", r.poll_once())
        rig.note("lease", rig.gen())
        rig.observe()
        st["rep1"].poll_ok = False
        rig.clock.advance(11.0)
        r.poll_once()
        rig.note("shed", rig.gen())
        rig.observe()
        # a wedged poll neither stalls the sweep nor piles up
        st["rep0"].poll_ok = st["rep1"].poll_ok = True
        gate = threading.Event()
        st["rep0"].status_block_until = gate
        try:
            rig.clock.advance(11.0)
            t0 = time.monotonic()
            rig.note("sweep", r.poll_once())
            assert time.monotonic() - t0 < 2.0
            rig.note("wedged", rig.gen())
            r.poll_once()
            r.poll_once()
            rig.note("polls", (st["rep0"].status_calls,
                               st["rep1"].status_calls))
        finally:
            gate.set()
        _wait_until(lambda: not r.replicas()[0]._poll_inflight)
        rig.observe()
        return rig.trace
    finally:
        rig.stop()


def sc_redispatch_codes(side):
    rig = Rig(side, 2)
    try:
        r, st = rig.router, rig.stubs
        st["rep1"].status = dict(queue_depth=3)
        r.poll_once()
        for code in ("UNAVAILABLE", "CANCELLED", "DEADLINE_EXCEEDED",
                     "RESOURCE_EXHAUSTED", "INVALID_ARGUMENT", "INTERNAL",
                     "UNKNOWN", "NOT_FOUND"):
            st["rep0"].gen_errors.append(side.err(code))
            rig.note(code, rig.gen())
            rig.observe(code)
        st["rep0"].stream_errors.append(side.err("RESOURCE_EXHAUSTED"))
        rig.note("stream", rig.stream())
        rig.observe()
        return rig.trace
    finally:
        rig.stop()


def sc_spent_deadline(side):
    """A replica's DEADLINE_EXCEEDED on a request with a client deadline
    is the client's clock running out: terminal, never re-dispatched;
    without a deadline it is transient. A budget spent while routing
    (re-dispatch backoff) is terminal before the next dispatch."""
    rig = Rig(side, 2, breaker_threshold=100)
    try:
        r, st = rig.router, rig.stubs
        st["rep1"].status = dict(queue_depth=3)
        r.poll_once()
        st["rep0"].gen_errors.append(side.err("DEADLINE_EXCEEDED"))
        rig.note("unary", rig.gen(deadline_ms=5000))
        st["rep0"].stream_errors.append(side.err("DEADLINE_EXCEEDED"))
        rig.note("stream", rig.stream(deadline_ms=5000))
        st["rep0"].gen_errors.append(side.err("DEADLINE_EXCEEDED"))
        rig.note("no deadline", rig.gen())
        for s in st.values():
            s.gen_errors = [side.err("UNAVAILABLE") for _ in range(20)]
        rig.note("spent while routing", rig.gen(deadline_ms=20))
        rig.note("calls", (st["rep0"].calls, st["rep1"].calls))
        rig.observe()
        return rig.trace
    finally:
        rig.stop()


def sc_window_and_breakers(side):
    rig = Rig(side, 2)
    try:
        r, st = rig.router, rig.stubs
        r.poll_once()
        for s in st.values():
            s.gen_errors = [side.err("UNAVAILABLE") for _ in range(50)]
        rig.note("all fail", rig.gen())
        rig.observe()
        for s in st.values():
            s.gen_errors = []
        rig.note("all open", rig.gen())
        rig.clock.advance(5.1)
        r.poll_once()
        rig.note("probe", rig.gen())
        rig.observe()
        return rig.trace
    finally:
        rig.stop()


def sc_drain(side):
    rig = Rig(side, 2)
    try:
        r, st = rig.router, rig.stubs
        st["rep0"].status = dict(draining=True)
        r.poll_once()
        rig.note("drain", [rig.gen() for _ in range(3)])
        rig.observe()
        st["rep0"].status = {}
        st["rep1"].status = dict(queue_depth=5)
        r.poll_once()
        rig.note("back", rig.gen())
        st["rep1"].status = dict(draining=True)
        st["rep0"].status = dict(draining=True)
        r.poll_once()
        rig.note("all draining", rig.gen())
        rig.observe()
        return rig.trace
    finally:
        rig.stop()


def sc_streams(side):
    rig = Rig(side, 2)
    try:
        r, st = rig.router, rig.stubs
        st["rep1"].status = dict(queue_depth=3)
        r.poll_once()
        st["rep0"].stream_errors.append(side.err("UNAVAILABLE"))
        rig.note("before first", rig.stream(new=3))
        rig.observe("a")
        st["rep0"].stream_fail_after_chunks = 2
        rig.note("after first", rig.stream(new=5))
        rig.note("calls", (st["rep0"].calls, st["rep1"].calls))
        rig.observe("b")
        # an abandoned stream settles its in-flight count
        st["rep0"].stream_fail_after_chunks = None
        g = r.dispatch_stream(rig.req(new=4))
        next(g)
        rig.note("inflight", [x.inflight for x in r.replicas()])
        g.close()
        rig.note("closed", [x.inflight for x in r.replicas()])
        rig.observe("c")
        return rig.trace
    finally:
        rig.stop()


def sc_hedging(side):
    out = []
    for case in ("hedge wins", "hedge leg fails", "primary wins"):
        delay = 5.0 if case == "primary wins" else 0.05
        rig = Rig(side, 3 if case == "hedge leg fails" else 2,
                  advance_on_sleep=False, hedge_delay_secs=delay)
        try:
            r, st = rig.router, rig.stubs
            gate = threading.Event()
            if case == "hedge wins":
                st["rep1"].status = dict(queue_depth=3)
                r.poll_once()
                st["rep0"].block_until = gate
            elif case == "hedge leg fails":
                st["rep2"].status = dict(queue_depth=5)
                r.poll_once()
                st["rep0"].block_until = gate
                st["rep0"].gen_errors.append(side.err("UNAVAILABLE"))
                st["rep1"].gen_errors.append(side.err("UNAVAILABLE"))
                threading.Timer(0.3, gate.set).start()
            else:
                r.poll_once()
            try:
                rig.note(case, rig.gen())
            finally:
                gate.set()
            _wait_until(lambda: all(x.inflight == 0 for x in r.replicas()))
            rig.note("calls", [s.calls for _a, s in sorted(st.items())])
            rig.observe()
            out.extend(rig.trace)
        finally:
            rig.stop()
    return out


PREFIX = tuple([7] * 16)


def _warm(stub, **kw):
    stub.status = dict(kv_blocks_cached=4, kv_blocks_shared=2, **kw)


def sc_affinity_ladder(side):
    out = []
    for case in ("margin", "past margin", "cold", "draining", "stalled",
                 "breaker", "short", "stream", "removed", "off"):
        rig = Rig(side, 2, affinity=case != "off")
        try:
            r, st = rig.router, rig.stubs
            _warm(st["rep0"])
            if case == "off":
                st["rep1"].status = dict(queue_depth=1)
            r.poll_once()
            if case == "stream":
                rig.note("learn", rig.stream(prompt=PREFIX + (1, 2)))
            elif case == "short":
                rig.note("learn", rig.gen(prompt=(1, 2)))
            else:
                rig.note("learn", rig.gen(prompt=PREFIX + (1, 2)))
            if case in ("margin", "stream"):
                _warm(st["rep0"], queue_depth=1)
            elif case == "past margin":
                _warm(st["rep0"], queue_depth=5)
            elif case == "cold":
                st["rep0"].status = dict(queue_depth=1)
            elif case == "draining":
                _warm(st["rep0"], draining=True)
            elif case == "stalled":
                _warm(st["rep0"], health_state="stalled")
            elif case == "breaker":
                st["rep0"].gen_errors = [side.err("UNAVAILABLE")] * 2
                rig.note("trip1", rig.gen(prompt=PREFIX + (3, 4)))
                rig.note("trip2", rig.gen(prompt=PREFIX + (5, 6)))
            elif case == "removed":
                r.remove_replica("rep0")
                rig.note("index", len(r._affinity))
            elif case == "off":
                st["rep0"].status = dict(queue_depth=2)
                st["rep1"].status = {}
            r.poll_once()
            rig.note(case, rig.gen(prompt=PREFIX + (9, 9)))
            rig.note("index", len(r._affinity))
            rig.note("calls", [s.calls for _a, s in sorted(st.items())])
            rig.observe()
            out.extend(rig.trace)
        finally:
            rig.stop()
    return out


def sc_remove_replica(side):
    rig = Rig(side, 2)
    try:
        r, st = rig.router, rig.stubs
        r.poll_once()
        rep = r.remove_replica("rep0")
        rig.note("removed", (rep.retired, st["rep0"].closed,
                             [x.address for x in r.replicas()]))
        rig.note("again", (r.remove_replica("rep0"), st["rep0"].closed))
        rig.note("survivor", rig.gen())
        # a close deferred past an in-flight poll
        gate = threading.Event()
        st["rep1"].status_block_until = gate
        t = threading.Thread(target=r.poll_once)
        t.start()
        _wait_until(lambda: st["rep1"].status_calls == 2)
        r.remove_replica("rep1")
        rig.note("poll holds", st["rep1"].closed)
        gate.set()
        t.join(WAIT)
        _wait_until(lambda: st["rep1"].closed == 1)
        # ... and past an in-flight dispatch
        r.add_replica("rep0")
        r.poll_once()
        st["rep0"].closed = 0
        rep = r.replicas()[0]
        gate = threading.Event()
        st["rep0"].block_until = gate
        done = []
        t = threading.Thread(target=lambda: done.append(rig.gen()))
        t.start()
        _wait_until(lambda: rep.inflight == 1)
        r.remove_replica("rep0")
        rig.note("dispatch holds", st["rep0"].closed)
        gate.set()
        t.join(WAIT)
        rig.note("settled", (done, rep.inflight, st["rep0"].closed))
        rig.observe()
        return rig.trace
    finally:
        rig.stop()


def sc_fault_spec(side):
    """A spec naming only router_* RPCs fires at the router boundary and
    never on a replica's servicer."""
    spec = "router_generate:drop:1;router_status:error:1"
    rig = Rig(side, 2, poll_secs=1000.0)
    try:
        r = rig.router
        r.poll_once()

        class Echo(object):
            def generate(self, request, _context=None):
                return side.pb.GenerateResponse(tokens=list(request.prompt))

        inj = side.fault.FaultInjector(spec=spec)
        replica = side.fault.maybe_wrap_servicer(
            Echo(), inj, rpcs=side.fault.SERVING_RPCS)
        rig.note("replica", [list(replica.generate(rig.req()).tokens)
                             for _ in range(3)] + [inj.injected])
        inj = side.fault.FaultInjector(spec=spec)
        side.start(r, injector=inj)
        wrapped = r.servicer
        rig.note("drop", rig.call(wrapped.router_generate, rig.req()))
        rig.note("pass", rig.call(wrapped.router_generate, rig.req()))
        rig.note("status", rig.call(
            wrapped.router_status, side.pb.RouterStatusRequest()))
        rig.note("stream", rig.call(lambda: [
            list(c.tokens) for c in wrapped.router_generate_stream(
                rig.req(new=2))]))
        rig.note("injected", inj.injected)
        rig.observe()
        return rig.trace
    finally:
        rig.stop()


def sc_handoff(side):
    """The router-driven handoff over fake stubs: a prefill replica out
    of normal rotation warms a cold prefix and the chain lands on the
    least-loaded decode replica; an export failure, a refused import and
    the disagg_handoff hook each fall back to a cold dispatch."""
    rig = Rig(side, 3, poll_secs=1000.0, affinity_block_tokens=4)
    try:
        r, st = rig.router, rig.stubs
        st["rep0"].status = dict(role="prefill")
        st["rep1"].status = dict(role="decode", queue_depth=2)
        st["rep2"].status = dict(role="unified")
        r.poll_once()
        inj = side.fault.FaultInjector(
            spec="disagg_handoff:error:1;disagg_handoff:drop:1:skip=3")
        side.start(r, injector=inj)
        prompts = [tuple([k] * 8) + (1,) for k in range(1, 8)]
        rig.note("warm", rig.gen(prompt=prompts[0]))
        rig.note("known", rig.gen(prompt=prompts[0]))
        st["rep0"].export_error = side.err("UNAVAILABLE")
        rig.note("export fails", rig.stream(prompt=prompts[1]))
        st["rep0"].export_error = None
        st["rep2"].import_ok = False
        rig.note("import refused", rig.gen(prompt=prompts[2]))
        st["rep2"].import_ok = True
        rig.note("hook drops", rig.gen(prompt=prompts[3]))
        rig.note("after hook", rig.gen(prompt=prompts[4]))
        rig.note("short", rig.gen(prompt=(1, 2)))
        rig.note("prefill log", st["rep0"].handoff_calls)
        rig.note("decode log", st["rep2"].handoff_calls)
        rig.note("injected", inj.injected)
        rig.observe()
        r.config.disagg = False
        rig.note("off", rig.gen(prompt=prompts[5]))
        rig.observe("off")
        return rig.trace
    finally:
        rig.stop()


def sc_status_slo(side):
    """status_response after polls carrying replica histograms and an
    attached autoscaler / rollout block; SLO reports over the fake-clock
    ring."""
    rig = Rig(side, 3, slo_fast_window_secs=4.0, slo_slow_window_secs=10.0,
              slo_ttft_p99_ms=5.0, slo_e2e_p99_ms=1.0)
    try:
        r, st = rig.router, rig.stubs
        hists = {"rep0": ([0, 3, 0, 1], [2, 2]), "rep1": ([], []),
                 "rep2": ([5] * 70 + [0] * 100 + [9], [1] * 80)}
        for step in range(12):
            for addr, (ttft, wait) in hists.items():
                st[addr].status = dict(
                    ttft_hist=[c * (step + 1) for c in ttft],
                    queue_wait_hist=[c * (step + 1) for c in wait],
                    kv_host_blocks=step, kv_host_bytes=1000 * step,
                    revive_uploads=2, prefill_tokens_revived=3,
                    host_drops=1, role="decode", model_version=4,
                    kv_cache_dtype="int8", slow_cause_counts=[step, 1],
                    last_progress_age_ms=1.5, prefix_hit_rate_window=0.25,
                    reload_failed=step % 2 == 0)
            if step == 6:
                st["rep1"].poll_ok = False
            rig.clock.advance(1.5)
            r.poll_once()
            rig.note("gen", rig.gen(prompt=list(range(step + 1))))
            rig.note("slo", r.slo_reports())
        rig.observe("plain")

        class Block(object):
            def __init__(self, msg):
                self.msg = msg

            def status_block(self):
                return self.msg

        r.set_autoscaler(Block(side.pb.AutoscalerStatus(live=2)))
        r.set_rollout(Block(side.pb.RolloutStatus()))
        r.hold_replica("rep0")
        rig.note("held", (sorted(r.held_replicas()), rig.gen()))
        r.release_replica("rep0")
        rig.observe("blocks")
        return rig.trace
    finally:
        rig.stop()


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_breaker_unit, sc_half_open_probe, sc_least_loaded,
    sc_lease_shed_wedged, sc_redispatch_codes, sc_spent_deadline,
    sc_window_and_breakers, sc_drain, sc_streams, sc_hedging,
    sc_affinity_ladder, sc_remove_replica, sc_fault_spec, sc_handoff,
    sc_status_slo)}


def _run(side_name, scenario):
    random.seed(1234)  # the backoff's full jitter draws from `random`
    return SCENARIOS[scenario](Side(side_name))


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_router_matches_jax(scenario):
    want = _run("jax", scenario)
    got = _run("port", scenario)
    assert [label for label, _ in got] == [label for label, _ in want]
    for (label, g), (_l, w) in zip(got, want):
        assert g == w, label


def test_router_scenarios_see_what_they_claim():
    """The port's own verdicts in some scenarios above, so that a fault
    shared by both routers cannot pass as agreement."""
    by = dict(_run("port", "spent_deadline"))
    assert by["unary"] == ("err", "DEADLINE_EXCEEDED", False)
    assert by["stream"] == ("err", "DEADLINE_EXCEEDED", False, [])
    assert by["no deadline"] == ("ok", 200)
    assert by["spent while routing"] == ("err", "DEADLINE_EXCEEDED", False)
    by = dict(_run("port", "streams"))
    assert by["before first"] == ("ok", "done", [200, 201, 202])
    assert by["after first"] == ("err", "UNAVAILABLE", False, [100, 101])
    assert by["calls"] == (2, 1)
    assert by["inflight"] == [0, 1] and by["closed"] == [0, 0]
    by = dict(_run("port", "handoff"))
    assert by["prefill log"] == ["prefill", "export:xfer-"] * 2 + [
        "abort", "prefill", "export:xfer-", "abort", "prefill",
        "export:xfer-"]
    assert by["decode log"] == ["import"] * 3
    assert by["injected"] == {"disagg_handoff": 1}
    assert (by["snapshot"]["disagg_handoffs"],
            by["snapshot"]["disagg_fallbacks"]) == (2, 3)
    trace = _run("port", "affinity_ladder")
    verdicts = {label: v for label, v in trace if label in (
        "margin", "past margin", "cold", "draining", "stalled", "breaker",
        "stream", "removed", "off")}
    assert verdicts == {"margin": ("ok", 100), "past margin": ("ok", 200),
                        "cold": ("ok", 200), "draining": ("ok", 200),
                        "stalled": ("ok", 200), "breaker": ("ok", 200),
                        "stream": ("ok", 100), "removed": ("ok", 200),
                        "off": ("ok", 200)}


def test_status_field_tables_cover_the_messages():
    rep = prouter.Replica
    replica_fields = {n for n, _k, _ in pb.ReplicaStatus.FIELDS}
    forward, computed = set(rep.STATUS_FORWARD), set(rep.STATUS_COMPUTED)
    assert not forward & computed
    assert forward | computed == replica_fields
    status_fields = {n for n, _k, _ in pb.ServerStatusResponse.FIELDS}
    observed = set(rep.OBSERVED_SCALARS) | set(rep.OBSERVED_LISTS)
    assert observed <= status_fields
    assert rep.OBSERVED_SCALARS == jrouter.Replica.OBSERVED_SCALARS
    for name in ("OBSERVED_LISTS", "STATUS_FORWARD", "STATUS_COMPUTED"):
        assert getattr(rep, name) == getattr(jrouter.Replica, name)
    assert (vars(prouter.RouterConfig())
            == {k: v for k, v in vars(jrouter.RouterConfig()).items()})


def test_metrics_port_and_log_dir_raise(monkeypatch):
    # the metrics port is ported: it resolves as JAX's RouterConfig does
    assert prouter.RouterConfig(metrics_port=0).metrics_port == 0
    monkeypatch.setenv("EDL_METRICS_PORT", "9100")
    assert (prouter.RouterConfig().metrics_port
            == jrouter.RouterConfig().metrics_port == 9100)
    monkeypatch.setenv("EDL_METRICS_PORT", "nope")
    assert prouter.RouterConfig().metrics_port is None
    monkeypatch.delenv("EDL_METRICS_PORT")
    with pytest.raises(NotImplementedError, match="item 6"):
        prouter.Router([], prouter.RouterConfig(telemetry_dir="/x"))
