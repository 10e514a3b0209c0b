"""The port's tail forensics against the JAX package's (no card).

* attribution: `attribute`, `is_terminally_slow` and `cause_histogram`
  on the named span trees of tests/test_forensics.py;
* the replica: a port replica and a JAX replica (in-process, a tiny
  transformer_lm over the same weights) take the same requests with
  trace context and record the same serve spans (names, parents,
  statuses, events in order, attribute keys); the serve-span classifier
  and its retention; the slow-seat scenario on both packages' schedulers
  gives equal `slow_cause_counts`; a routed request is one span tree
  across the port router and a port replica on their transports;
* the offline tools: `merge_dir` / `drops_by_service` / the dump CLI and
  `build_report` equal to JAX's over the same exports and scrape bundle
  (two port MetricsServers scraped by `scrape_fleet`), `validate_report`
  refusing tampered reports, the collector CLI, and each package's
  collector reading the other's pages.
"""

import json
import os
import subprocess
import sys
import threading
import time

import pytest

from elasticdl_tpu.observability import collector as jcollector
from elasticdl_tpu.observability import dump as jdump
from elasticdl_tpu.observability import forensics as jforensics
from elasticdl_tpu.observability import metrics as jmetrics
from elasticdl_tpu.observability import slo as jslo
from elasticdl_tpu.observability import tracing as jtracing
from elasticdl_tpu.proto import elasticdl_pb2 as jpb
from elasticdl_tpu.serving import ServingConfig as JConfig
from elasticdl_tpu.serving import GenerationServer as JServer
from elasticdl_tpu.serving import server as jserver
from elasticdl_tpu.serving import telemetry as jtelemetry
from elasticdl_tpu.serving.admission import RequestQueue as JQueue
from elasticdl_tpu_torch.model_zoo.transformer_lm import TransformerLM
from elasticdl_tpu_torch.observability import collector, dump, forensics
from elasticdl_tpu_torch.observability import metrics as pmetrics
from elasticdl_tpu_torch.observability import slo as pslo
from elasticdl_tpu_torch.observability import tracing as ptracing
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.proto import service
from elasticdl_tpu_torch.serving import server as pserver
from elasticdl_tpu_torch.serving import telemetry as ptelemetry
from elasticdl_tpu_torch.serving.admission import RequestQueue
from elasticdl_tpu_torch.serving.router import Router, RouterConfig
from test_torch_serving_wire import CFG, _jax_rig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 60  # seconds: every real wait in this file is bounded by it


# ------------------------------------------------------------ attribute


def _span(name, start, end, status="ok", parent="", span_id=None,
          events=()):
    return {"name": name, "trace_id": "T",
            "span_id": span_id or "%s-%s" % (name, start),
            "parent_span_id": parent, "service": "t", "start": start,
            "end": end, "status": status, "attrs": {},
            "events": [{"ts": ts, "name": n, "attrs": a}
                       for ts, n, a in events]}


def _serve(start=10.0, end=10.5, queued=10.0, seated=10.1, first=10.2,
           parent="", blocked=0.0, revive_ms=0.0):
    events = [(queued, "queued", {}),
              (seated, "seated", {"queue_wait_ms": (seated - queued) * 1e3,
                                  "prefill_blocked_ms": blocked})]
    if revive_ms:
        events.append((seated, "revive_upload", {"ms": revive_ms}))
    events += [(first, "first_token", {}), (end, "completed", {})]
    return _span("serve", start, end, parent=parent, events=events)


TREES = {
    "queue_wait": [_serve(end=10.65, seated=10.5, first=10.55)],
    "blocked": [_serve(seated=10.4, first=10.45, blocked=380.0)],
    "prefill_own": [_serve(end=10.75, seated=10.01, first=10.7)],
    "revive": [_serve(end=10.8, seated=10.01, first=10.7, revive_ms=600.0)],
    "decode": [_serve(end=11.0, seated=10.01, first=10.05)],
    "routed": [
        _span("router_generate", 10.0, 11.5, span_id="root",
              events=[(10.4, "redispatched", {})]),
        _span("dispatch", 10.0, 10.4, "error", "root", "d0"),
        _span("dispatch", 10.6, 11.5, parent="root", span_id="d1"),
        _serve(start=10.6, end=10.9, queued=10.6, seated=10.61,
               first=10.65, parent="d1")],
    "expired_queued": [_span("serve", 10.0, 10.4, "DEADLINE_EXCEEDED",
                             events=[(10.0, "queued", {}), (10.4, "expired", {
                                 "where": "queued",
                                 "prefill_blocked_ms": 150.0})])],
    "no_serve": [_span("router_generate", 10.0, 10.3, "UNAVAILABLE",
                       span_id="root")],
    "empty": [],
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_attribute_verdicts_equal_jax(name):
    got = forensics.attribute(TREES[name])
    assert got == jforensics.attribute(TREES[name])
    if name in ("queue_wait", "decode", "prefill_own"):
        assert got["dominant_cause"] == name
    assert got["dominant_cause"] in forensics.CAUSES + (None,)


def test_slow_classifier_and_cause_histogram_equal_jax():
    for args in (("DEADLINE_EXCEEDED", 10.0, 0), ("ok", 90.0, 100.0),
                 ("ok", 10.0, 100.0), ("ok", 90.0, 0),
                 ("RESOURCE_EXHAUSTED", 90.0, 100.0), ("ok", 80.0, 100.0)):
        assert (forensics.is_terminally_slow(*args)
                == jforensics.is_terminally_slow(*args))
    verdicts = [jforensics.attribute(t) for t in TREES.values()]
    assert (forensics.cause_histogram(verdicts)
            == jforensics.cause_histogram(verdicts))
    assert forensics.CAUSES == jforensics.CAUSES


# ------------------------------------------------------------ the replica


@pytest.fixture(scope="module")
def replicas():
    """A JAX replica and a port replica over the same weights, each
    started without a transport."""
    trainer, state, sd = _jax_rig(0)
    base = dict(num_slots=2, queue_capacity=8, kv_paged=True,
                kv_block_size=8, kv_shared=True, reload_poll_secs=0)
    jrep = JServer(trainer, state, JConfig(runtime_health=False, **base))
    jrep.start(grpc_server=False)
    model = TransformerLM(device="cpu", **CFG)
    model.load_state_dict(sd)
    prep = pserver.GenerationServer(model, pserver.ServingConfig(**base))
    yield jrep, prep.start()
    jrep.stop()
    prep.stop()


PREFIX = list(range(40, 56))
REQUESTS = [  # (prompt, new, extra): a prefill, a prefix hit, one token,
    (PREFIX + [1, 2], 4, {}),  # an empty prompt, an over-long one,
    (PREFIX + [3], 3, {"deadline_ms": 60000}),  # a prefill-only seat
    ([7, 8], 1, {}), ([], 2, {}), ([5] * 200, 2, {}),
    (PREFIX + [9, 9], 1, {"prefill_only": True})]


def _spans(rec, traces):
    out = []
    for s in rec.snapshot():
        d = s.to_dict()
        if d["trace_id"] not in traces:
            continue
        attrs = dict(d["attrs"])
        attrs.pop("request_id")
        out.append((d["name"], d["trace_id"], d["parent_span_id"],
                    d["status"], attrs,
                    [(e["name"], sorted(e["attrs"])) for e in d["events"]]))
    return sorted(out, key=lambda t: t[1])


def test_serve_spans_match_jax(replicas):
    traces = set()
    for rep, mod in ((replicas[0], jpb), (replicas[1], pb)):
        for i, (prompt, new, extra) in enumerate(REQUESTS):
            tid = "span-case-%d" % i
            traces.add(tid)
            try:
                rep.raw_servicer.generate(mod.GenerateRequest(
                    prompt=prompt, max_new_tokens=new, trace_id=tid,
                    parent_span_id="dispatch-%d" % i, **extra))
            except Exception as e:  # noqa: BLE001 - the refused ones
                assert i in (3, 4), e
    ours = _spans(ptracing.recorder(), traces)
    assert ours == _spans(jtracing.recorder(), traces)
    by = {t[1]: t for t in ours}
    assert [e for e, _k in by["span-case-1"][5]] == [
        "queued", "seated", "prefix_hit", "first_token", "completed"]
    assert by["span-case-3"][3] == "INVALID_ARGUMENT"
    assert by["span-case-0"][2] == "dispatch-0"


def test_serve_span_classifier_and_retention(replicas):
    class S(object):
        def __init__(self, name, status, deadline_ms, secs):
            self.name, self.status = name, status
            self.attrs = {"deadline_ms": deadline_ms}
            self.start, self.end = 10.0, 10.0 + secs

    for span in (S("serve", "ok", 1000, 0.1), S("serve", "ok", 1000, 0.9),
                 S("serve", "DEADLINE_EXCEEDED", 0, 0.1),
                 S("dispatch", "ok", 0, 0.1), S("serve", "ok", 0, 9.0)):
        assert (pserver.serve_span_classifier(span)
                == jserver.serve_span_classifier(span))
    rec = ptracing.SpanRecorder(service="t", capacity=4)
    rec.add_classifier(pserver.serve_span_classifier)
    bad = rec.start_span("serve", trace_id="bad", deadline_ms=50)
    bad.finish("DEADLINE_EXCEEDED")
    for i in range(20):
        rec.start_span("serve", trace_id="h%d" % i).finish("ok")
    assert rec.dropped > 0 and "bad" in {s.trace_id for s in rec.snapshot()}
    # held on the process recorder while a forensics-on server runs
    assert pserver.serve_span_classifier in ptracing.recorder()._classifiers


class _SlowSeatEngine(object):
    """One slot, instant seats: the slowness comes from the queue."""

    num_slots, model_version, seq_len = 1, 0, 64
    draft_k = draft_proposed = draft_accepted = 0

    def __init__(self):
        self._slots, self.prefill_busy_ms = {}, 0.0

    def free_slots(self):
        return [] if self._slots else [0]

    def can_seat(self, _req):
        return True

    def insert(self, request):
        self._slots[0] = request
        return 0, 11, False

    def evict_expired(self, now):
        out = [r for r in self._slots.values() if r.expired(now)]
        self._slots = {s: r for s, r in self._slots.items()
                       if not r.expired(now)}
        return out

    def active_count(self):
        return len(self._slots)

    def active_requests(self):
        return list(self._slots.values())

    def step(self):
        out = []
        for slot, req in list(self._slots.items()):
            req.generated.append(12)
            finished = len(req.generated) >= req.max_new_tokens
            if finished:
                del self._slots[slot]
            out.append((slot, req, [12], finished))
        return out

    def max_cached_tokens(self):
        return self.seq_len

    def kv_stats(self):
        return {"kv_bytes_in_use": 0, "kv_blocks_free": 0}


def _slow_seat(side):
    engine = _SlowSeatEngine()
    if side == "jax":
        queue, tel, mod = JQueue(capacity=8, seq_len=64), \
            jtelemetry.ServingTelemetry(), jpb
        sched = jserver._Scheduler(engine, queue, tel, idle_wait_secs=0.001,
                                   forensics_on=True)
        servicer = jserver.ServingServicer(
            queue, engine, tel, scheduler_alive=lambda: True,
            handler_poll_secs=0.02, draining=lambda: False)
    else:
        queue, tel, mod = RequestQueue(capacity=8, seq_len=64), \
            ptelemetry.ServingTelemetry(), pb
        sched = pserver._Scheduler(engine, queue, idle_wait_secs=0.001,
                                   telemetry=tel, forensics_on=True)
        sched.is_alive = lambda: True  # driven by hand below
        servicer = pserver.ServingServicer(sched, handler_poll_secs=0.02)
    done = {}

    def call(key, deadline_ms):
        try:
            done[key] = servicer.generate(mod.GenerateRequest(
                prompt=[1, 2], max_new_tokens=50, deadline_ms=deadline_ms))
        except Exception as e:  # noqa: BLE001 - the datum
            done[key] = e

    threads = [threading.Thread(target=call, args=("a", 0))]
    threads[0].start()
    deadline = time.monotonic() + WAIT
    while not engine.active_count() and time.monotonic() < deadline:
        sched._iterate()
    threads.append(threading.Thread(target=call, args=("b", 60)))
    threads[1].start()
    while "b" not in done and time.monotonic() < deadline:
        time.sleep(0.08)  # the deadline lapses while queued
        sched._iterate()
    while "a" not in done and time.monotonic() < deadline:
        sched._iterate()
    for t in threads:
        t.join(timeout=WAIT)
    snap = tel.snapshot()
    return (snap["slow_cause_counts"], snap["expired"], snap["completed"],
            pmetrics.render_prometheus(tel.prometheus()[-2:-1]))


def test_slow_seat_scenario_counts_equal_jax():
    got = _slow_seat("port")
    assert got == _slow_seat("jax")
    assert got[0] == [1, 0, 0, 0, 0, 0, 0] and got[1:3] == (1, 1)


def test_a_routed_request_is_one_span_tree():
    model = TransformerLM(device="cpu", seed=0, **CFG)
    rep = pserver.GenerationServer(model, pserver.ServingConfig(
        num_slots=2, kv_paged=True, kv_block_size=8, port=0)).start(
        transport=True)
    router = Router(["localhost:%d" % rep.port],
                    RouterConfig(poll_secs=0.05, port=0)).start()
    try:
        stub = service.RouterStub(service.build_channel(
            "localhost:%d" % router.port))
        for method in ("router_generate", "router_generate_stream"):
            tid = "routed-" + method
            out = getattr(stub, method)(pb.GenerateRequest(
                prompt=[3, 4, 5], max_new_tokens=3, trace_id=tid),
                timeout=WAIT)
            if method.endswith("stream"):
                list(out)
            spans = {s.name: s for s in ptracing.recorder().snapshot()
                     if s.trace_id == tid}
            assert sorted(spans) == ["dispatch", method, "serve"]
            assert spans[method].parent_span_id == ""
            assert spans["dispatch"].parent_span_id == spans[method].span_id
            assert spans["serve"].parent_span_id == spans["dispatch"].span_id
            assert all(s.status == "ok" for s in spans.values())
    finally:
        router.stop()
        rep.stop()


# ------------------------------------------------------ the offline tools


def _exports(tmp_path):
    """Span exports of two services (one dropping) and a torn file."""
    small = ptracing.SpanRecorder(service="tiny", capacity=2)
    for i in range(5):
        small.start_span("serve", trace_id="t%d" % i).finish("ok")
    small.flush(str(tmp_path))
    fine = ptracing.SpanRecorder(service="fine", capacity=64)
    root = fine.start_span("router_generate", trace_id="x")
    fine.start_span("dispatch", trace_id="x",
                    parent_span_id=root.span_id).finish("ok")
    root.finish("ok")
    fine.flush(str(tmp_path))
    (tmp_path / "spans-torn-1.json").write_text("{not json")


def test_merge_dir_drops_and_dump_equal_jax(tmp_path):
    _exports(tmp_path)
    got = dump.merge_dir(str(tmp_path))
    assert got == jdump.merge_dir(str(tmp_path))
    assert dump.drops_by_service(got[1]) == jdump.drops_by_service(
        got[1]) == {"tiny": 3}
    docs = []
    for mod in (dump, jdump):
        out = str(tmp_path / ("%s.trace" % mod.__name__))
        assert mod.main(["--dir", str(tmp_path), "--out", out]) == 0
        docs.append(json.load(open(out)))
    assert docs[0] == docs[1]
    assert docs[0]["otherData"]["evidence_complete"] is False


class _Req(object):
    def __init__(self, tid, ago):
        self.trace_id, self.submitted_at = tid, time.monotonic() - ago


def _rig(tmp_path, tel_mod, metrics_mod, rec_mod, n=2):
    """Replica-shaped rigs: a telemetry fed traced requests, its
    MetricsServer, and serve spans exported under `tmp_path`."""
    servers, tels = [], []
    for k in range(n):
        tel = tel_mod.ServingTelemetry()
        rec = rec_mod.SpanRecorder(service="replica%d" % k)
        for i in range(15):
            tid = "r%d_%04d" % (k, i)
            sp = rec.start_span("serve", trace_id=tid, deadline_ms=200)
            for ev in ("queued", "seated", "first_token", "completed"):
                sp.event(ev, prefill_blocked_ms=1.0)
            sp.finish("ok")
            tel.record_ttft(_Req(tid, 0.010 + 0.015 * i))
            tel.count("admitted")
            tel.record_e2e(30.0 + 15 * i, trace_id=tid)
        rec.flush(str(tmp_path))
        servers.append(metrics_mod.MetricsServer(tel.prometheus, port=0,
                                                 host="127.0.0.1"))
        tels.append(tel)
    return servers, tels


def _specs(mod):
    return mod.default_router_slos(50.0, 100.0, 0.02, latency_goal=0.01)


@pytest.fixture
def port_rig(tmp_path):
    servers, tels = _rig(tmp_path, ptelemetry, pmetrics, ptracing)
    yield ["127.0.0.1:%d" % s.port for s in servers], tels
    for s in servers:
        s.close()


def test_build_report_equal_jax(port_rig, tmp_path):
    endpoints, tels = port_rig

    def sleep_and_feed(secs):
        time.sleep(secs)
        for tel in tels:
            tel.count("admitted")
            tel.record_ttft(_Req("hot", 0.450))
            tel.record_e2e(600.0, trace_id="hot")

    bundle = collector.scrape_fleet(endpoints, scrapes=3, interval_secs=0.1,
                                    sleep=sleep_and_feed)
    assert bundle["rounds"][0]["counters"]["admitted"] == 30
    ours = collector.build_report(bundle, _specs(pslo), str(tmp_path))
    ref = jcollector.build_report(bundle, _specs(jslo), str(tmp_path))
    assert collector.validate_report(ours) is ours
    jcollector.validate_report(ours)
    ours.pop("generated_unix"), ref.pop("generated_unix")
    assert ours == ref
    assert "ttft_p99" in ours["alerting"]
    assert any(e["resolved"] for e in ours["exemplars"])
    assert ours["span_evidence"]["complete"]
    assert ours["dominant_cause"] in forensics.CAUSES
    text = collector.render_text(dict(ours, generated_unix=0.0))
    assert "ALERTING" in text and ours["dominant_cause"] in text


@pytest.mark.parametrize("tamper", [
    lambda r: r.update(schema="bogus/9"),
    lambda r: r.update(cause_histogram={"made_up_cause": 3}),
    lambda r: r.pop("span_evidence"),
    lambda r: r.update(scrapes=1),
    lambda r: r["slo"][0].update(fast_burn=float("inf")),
    lambda r: r["exemplars"][0].update(trace_id=""),
    lambda r: r["traces"][next(iter(r["traces"]))]["attribution"].update(
        dominant_cause="cosmic_rays")])
def test_validate_report_refuses_tampering(tamper, port_rig, tmp_path):
    bundle = collector.scrape_fleet(port_rig[0], scrapes=2,
                                    interval_secs=0.01)
    report = collector.build_report(bundle, _specs(pslo), str(tmp_path))
    tamper(report)
    for mod in (collector, jcollector):
        with pytest.raises(ValueError):
            mod.validate_report(report)


def test_collector_cli_rc_and_report(port_rig, tmp_path):
    out, txt = str(tmp_path / "incident.json"), str(tmp_path / "i.txt")
    assert collector.main([
        "--endpoints", port_rig[0][0], "--scrapes", "2", "--interval", "0.05",
        "--trace_dir", str(tmp_path), "--out", out, "--text", txt,
        "--slo_ttft_p99_ms", "50"]) == 0
    report = json.load(open(out))
    jcollector.validate_report(collector.validate_report(report))
    assert report["endpoints"] == port_rig[0][:1] and os.path.exists(txt)
    assert collector.main(["--endpoints", ""]) == 2
    with pytest.raises(ValueError):
        collector.scrape_fleet(["x"], scrapes=1)
    # the collector and dump processes load no torch
    probe = subprocess.run([sys.executable, "-c", (
        "import sys; import elasticdl_tpu_torch.observability.collector, "
        "elasticdl_tpu_torch.observability.dump; "
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'grpc', 'numpy', 'elasticdl_tpu')))")],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), text=True,
        capture_output=True, timeout=WAIT)
    assert probe.stdout.strip() == "[]", probe.stderr


def _rounds(bundle):
    return [{k: v for k, v in r.items() if k not in ("at", "unix")}
            for r in bundle["rounds"]]


def test_each_collector_reads_the_other_packages_pages(port_rig, tmp_path):
    jservers, _tels = _rig(tmp_path, jtelemetry, jmetrics, jtracing)
    try:
        for endpoints in (port_rig[0], ["127.0.0.1:%d" % s.port
                                        for s in jservers]):
            ours = collector.scrape_fleet(endpoints, 2, interval_secs=0.01)
            ref = jcollector.scrape_fleet(endpoints, 2, interval_secs=0.01)
            assert _rounds(ours) == _rounds(ref)
            assert ours["rounds"][1]["exemplars"]["fleet_ttft_ms"]
    finally:
        for s in jservers:
            s.close()
