"""The port's metrics plane against the JAX package's (no card).

* exemplars: record, merge and the wire form of LogLinearHistogram
  against JAX's on seeded samples; the ring's windows, exemplar maps,
  horizon queries, rebase and `merge_window_deltas` under churn on one
  fake clock;
* the exposition: `render_prometheus` byte for byte on families with
  escaped labels, NaN and infinities, empty histograms and exemplars;
  each package's parser reads both pages to equal results and both
  reject the same malformed pages;
* ServingTelemetry, RouterTelemetry, StepProfiler and the router's
  `_metrics_families` (burn, alerting, the autoscaler and rollout series
  on the scripted fake fleet of tests/test_torch_router.py) render the
  JAX package's text after the same calls, exemplar timestamps pinned;
* MetricsServer: scrape, 404, 500, close; the master's families against
  JAX's `_start_metrics` over equal dispatchers;
* the entries as processes: `serving.main --metrics_port 0` (its page
  through JAX's parser, its spans exported on SIGTERM) and
  `router_main --metrics_port 0`.
"""

import json
import math
import os
import random
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from elasticdl_tpu.master import main as jmaster_main
from elasticdl_tpu.master.task_dispatcher import TaskDispatcher as JDispatcher
from elasticdl_tpu.observability import histogram as jhist
from elasticdl_tpu.observability import metrics as jmetrics
from elasticdl_tpu.observability.promparse import (
    parse_prometheus_text as jparse,
)
from elasticdl_tpu.serving import engine as jengine
from elasticdl_tpu.serving import telemetry as jtelemetry
from elasticdl_tpu_torch.common import model_handler
from elasticdl_tpu_torch.master import main as master_main
from elasticdl_tpu_torch.master.task_dispatcher import TaskDispatcher
from elasticdl_tpu_torch.observability import histogram as phist
from elasticdl_tpu_torch.observability import metrics as pmetrics
from elasticdl_tpu_torch.observability.promparse import (
    parse_prometheus_text as pparse,
)
from elasticdl_tpu_torch.serving import engine as pengine
from elasticdl_tpu_torch.serving import telemetry as ptelemetry
from test_torch_router import FakeClock, Rig, Side

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = ("vocab_size=256; seq_len=128; embed_dim=32; num_heads=2; "
          "num_layers=2")
WAIT = 60  # seconds: every real wait in this file is bounded by it
UNIX = 1722800000.0  # the pinned exemplar timestamp


@pytest.fixture
def pinned_time(monkeypatch):
    """time.time() pinned, so exemplar timestamps agree across sides."""
    monkeypatch.setattr(time, "time", lambda: UNIX)


def _samples(seed, n=400):
    rng = random.Random(seed)
    return [("t%04d" % i, rng.uniform(0.05, 5000.0), 1000.0 + i)
            for i in range(n)]


# ------------------------------------------------------------ exemplars


def test_exemplar_record_merge_and_wire_match_jax():
    samples = _samples(7)
    out = []
    for mod in (jhist, phist):
        whole = mod.LogLinearHistogram()
        shards = [mod.LogLinearHistogram() for _ in range(4)]
        for n, (tid, value, ts) in enumerate(samples):
            whole.record(value, trace_id=tid, ts=ts)
            shards[n % 4].record(value, trace_id=tid if n % 3 else None,
                                 ts=ts)
        merged = mod.LogLinearHistogram()
        for s in shards:
            merged.merge(s)
        wire = json.loads(json.dumps(merged.exemplars_wire()))
        back = mod.LogLinearHistogram.from_counts(merged.to_counts(), wire)
        small = mod.LogLinearHistogram()
        for value, tid in ((3.0, "aa"), (700.0, "bb"), (0.5, None)):
            small.record(value, trace_id=tid, ts=10.0)
        out.append((whole.exemplars, merged.exemplars, back.exemplars,
                    back.count, small.exemplars_wire(), small.to_counts()))
    assert out[0] == out[1]
    assert phist.EXEMPLAR_SLOTS == jhist.EXEMPLAR_SLOTS
    assert len(out[1][0]) == phist.EXEMPLAR_SLOTS
    assert out[1][2] == out[1][1] and out[1][3] == len(samples)


def _drive_ring(mod):
    """Cumulative counters, buckets and exemplar maps under churn."""
    clock = FakeClock(0.0)
    ring = mod.TimeSeriesRing(interval_secs=1.0, capacity=6, clock=clock)
    rng = random.Random(3)
    counts, exes, n = [0] * 40, {}, 0
    out = []
    for i in range(60):
        clock.advance(rng.uniform(0.1, 0.7))
        for _ in range(rng.randint(0, 5)):
            idx = rng.randint(0, 39)
            counts[idx] += 1
            value = 0.01 * idx + 0.001 * rng.random()
            cur = exes.get(idx)
            if cur is None or value >= cur[1]:
                exes[idx] = ("t%d" % i, value, 100.0 + i)
        n += rng.randint(0, 3)
        ring.observe(counters={"a": n, "b": 2 * n}, gauges={"g": i},
                     hists={"h": list(counts)},
                     exemplars={"h": dict(exes)}, roll=i % 7 != 3)
        if i == 30:
            ring.rebase()
        if i % 9 == 0:
            out.append((ring.pending_counter("a"),
                        ring.baseline_counter("b"), ring.due()))
    ring.flush()
    wins = ring.windows()
    out += [wins, ring.windows(horizon_secs=3.0), ring.dropped,
            ring.merged_exemplars("h"), ring.merged_exemplars("h", 2.5),
            ring.merged_hist_counts("h", 4.0), ring.sum_counter("a", 5.0),
            ring.latest(), mod.merge_window_deltas(wins[0], wins[-1]),
            mod.merge_exemplars({1: ("x", 0.5, 1.0)}, {1: ("y", 0.5, 2.0)})]
    return out


def test_ring_windows_and_exemplars_match_jax():
    ours, ref = _drive_ring(pmetrics), _drive_ring(jmetrics)
    assert ours == ref
    wins = ours[-10]
    assert any(w["exemplars"]["h"] for w in wins)


# ------------------------------------------------------------ exposition


def _families(mod, hmod):
    h = hmod.LogLinearHistogram()
    for v, tid in ((0.5, None), (3.0, "a b"), (250.0, 'q"x'), (0.004, "z")):
        h.record(v, trace_id=tid, ts=UNIX)
    return [
        mod.counter_family("edl_test_requests_total", 'req\\s\nx', 42),
        mod.labeled_counter_family("edl_test_cause_total", "by cause",
                                   [({"cause": "a"}, 1), ({"cause": "b"}, 0)]),
        mod.gauge_family("edl_test_depth", "depth", [
            ({"shard": 'a"b\\c\nd', "2bad-name": "v"}, 3.5),
            ({"shard": "nan"}, float("nan")),
            ({"shard": "inf"}, float("inf")), ({"shard": "-inf"}, -math.inf),
            ({}, 1e300), ({"x": "y"}, 0.1), ({"x": "z"}, -7)]),
        mod.hist_family("edl_test_latency_ms", "latency", [
            ({"phase": "p"}, h.to_counts(), h.sum, h.exemplars),
            ({"phase": "empty"}, [], None),
            ({}, [0, 2, 0, 1], None, {1: ("k", 0.015, 5.0)})]),
        mod.hist_family("edl_test_empty_ms", "no series", []),
    ]


def _norm(parsed):
    """Parsed families as text (NaN != NaN in a dict compare)."""
    return json.dumps(parsed, sort_keys=True, default=repr)


def test_render_prometheus_byte_equal_and_both_parsers_agree():
    text = pmetrics.render_prometheus(_families(pmetrics, phist))
    assert text == jmetrics.render_prometheus(_families(jmetrics, jhist))
    assert "# {" in text and "NaN" in text and "-Inf" in text
    assert _norm(pparse(text)) == _norm(jparse(text))


_HEAD = "# HELP f help\n# TYPE f histogram\n"
MALFORMED = [
    _HEAD + 'f_bucket{le="1"} 5\nf_bucket{le="2"} 3\nf_bucket{le="+Inf"} 5\n',
    _HEAD + 'f_bucket{le="1"} 1\n',
    _HEAD + 'f_bucket{le="+Inf"} 3\nf_count 4\n',
    "# HELP c help\n# TYPE c counter\nc 1\n",
    "orphan_metric 1\n",
    "# HELP g help\n# TYPE g gauge\ng\n",
    '# TYPE edl_x_total counter\nedl_x_total 1 # {trace_id="t"} 1 1\n',
    '# TYPE edl_g gauge\nedl_g 1 # {trace_id="t"} 1 1\n',
    '# TYPE h histogram\nh_bucket{le="+Inf"} 1 # {} 0.5 1\nh_sum 1\n',
    '# TYPE h histogram\nh_bucket{le="1"} 1 # {trace_id="t"} 5 1\n'
    'h_bucket{le="+Inf"} 1\n',
    '# TYPE h histogram\nh_bucket{le="+Inf"} 1 # {trace_id="t"} +Inf 1\n',
    '# TYPE h histogram\nh_bucket{le="+Inf"} 1 # {trace_id="t"} 0.5 1 j\n',
    '# TYPE h histogram\nh_bucket{le="+Inf"} 1 # {trace_id="t"}\n',
    '# TYPE h histogram\nh_bucket{le="+Inf"} 1 # {trace id="t"} 0.5\n',
]


@pytest.mark.parametrize("page", MALFORMED)
def test_both_parsers_reject_malformed_pages(page):
    for parse in (pparse, jparse):
        with pytest.raises(ValueError):
            parse(page)


def test_a_hash_inside_a_label_value_is_no_exemplar():
    text = '# TYPE g gauge\ng{tag="a # b"} 1\n'
    assert pparse(text) == jparse(text)
    assert pparse(text)["g"]["exemplars"] == []


# ------------------------------------------------------------ collectors


class _Req(object):
    def __init__(self, submitted_at, trace_id):
        self.submitted_at, self.trace_id = submitted_at, trace_id


def _serving_page(mod, metrics_mod):
    clock = FakeClock(100.0)
    tel = mod.ServingTelemetry(clock=clock)
    for i in range(40):
        clock.advance(0.011 * (i % 5 + 1))
        tel.count("admitted")
        tel.record_queue_wait(0.003 * i, trace_id="q%d" % i)
        tel.record_ttft(_Req(clock.t - 0.02 - 0.004 * i, "t%d" % i))
        tel.record_step(i % 3, 1 + i % 2, 0.005 + 0.0002 * i, 2,
                        kv_bytes_in_use=512 * i, kv_blocks_free=90 - i)
        tel.count("prompt_tokens", 9)
        if i % 4 == 0:
            tel.count("prefix_hit_tokens", 8)
            tel.record_e2e(40.0 + i, trace_id="e%d" % i)
            tel.count("completed")
    tel.count_slow_cause("decode", 2)
    tel.count_slow_cause("queue_wait")
    quiet = mod.ServingTelemetry(clock=clock, exemplars=False)
    quiet.record_ttft(_Req(clock.t - 0.5, "hidden"))
    return [metrics_mod.render_prometheus(tel.prometheus()),
            metrics_mod.render_prometheus(quiet.prometheus())]


def _router_page(mod, metrics_mod):
    clock = FakeClock(50.0)
    tel = mod.RouterTelemetry(clock=clock, ring_secs=1.0, ring_windows=3)
    for i in range(12):
        clock.advance(0.6)
        tel.count("routed")
        tel.count("completed" if i % 5 else "errors")
        tel.record_e2e(20.0 + 37.0 * i, trace_id="r%d" % i)
        tel.record_poll(2, 3, fleet_hists={
            "fleet_ttft_ms": [i, 0, 2 * i], "fleet_queue_wait_ms": [1] * i})
    return [metrics_mod.render_prometheus(tel.prometheus())]


def _profiler_page(mod, metrics_mod):
    prof = mod.StepProfiler()
    rng = random.Random(5)
    for phase in ("decode", "scatter", "prefill", "reload_swap"):
        for _ in range(30):
            prof.observe(phase, rng.expovariate(250.0))
    return [metrics_mod.render_prometheus(prof.prometheus())]


@pytest.mark.parametrize("page,mods", [
    (_serving_page, (ptelemetry, jtelemetry)),
    (_router_page, (ptelemetry, jtelemetry)),
    (_profiler_page, (pengine, jengine))])
def test_collector_pages_equal_jax(page, mods, pinned_time):
    texts = page(mods[0], pmetrics)
    assert texts == page(mods[1], jmetrics)
    for text in texts:
        assert _norm(jparse(text)) == _norm(pparse(text))
    if page is not _profiler_page:
        assert 'trace_id="' in texts[0] and "hidden" not in "".join(texts)


def _router_families(side_name):
    """The router's page on the scripted fake fleet: polls with replica
    buckets, traced requests, then an autoscaler and a rollout block."""
    side = Side(side_name)
    rig = Rig(side, 3, slo_fast_window_secs=4.0, slo_slow_window_secs=10.0,
              slo_ttft_p99_ms=5.0, slo_e2e_p99_ms=1.0)
    mod = jmetrics if side_name == "jax" else pmetrics
    pages = []
    try:
        r = rig.router
        for step in range(8):
            for k, addr in enumerate(sorted(rig.stubs)):
                rig.stubs[addr].status = dict(
                    ttft_hist=[k * (step + 1), step] + [0] * 600 + [k + step],
                    queue_wait_hist=[step + 1])
            rig.clock.advance(1.5)
            r.poll_once()
            rig.call(r.dispatch_generate, side.pb.GenerateRequest(
                prompt=[1, step], max_new_tokens=2, trace_id="t%d" % step))
        pages.append(mod.render_prometheus(r._metrics_families()))

        class Block(object):
            def __init__(self, msg):
                self.msg = msg

            def status_block(self):
                return self.msg

        r.set_autoscaler(Block(side.pb.AutoscalerStatus(
            live=2, target=3, scale_ups=4, circuit_open=True)))
        r.set_rollout(Block(side.pb.RolloutStatus(
            phase="canary", target_version=7, rollbacks=1)))
        pages.append(mod.render_prometheus(r._metrics_families()))
    finally:
        rig.stop()
    return pages


def test_router_metrics_families_match_jax(pinned_time):
    random.seed(1234)
    want = _router_families("jax")
    random.seed(1234)
    got = _router_families("port")
    assert got == want
    fams = pparse(got[1])
    assert len(fams["edl_router_slo_burn"]["samples"]) == 6
    alerting = {s[1]["slo"]: s[2]
                for s in fams["edl_router_slo_alerting"]["samples"]}
    assert alerting["ttft_p99"] == 1.0
    assert fams["edl_router_e2e_ms"]["exemplars"]
    assert "edl_autoscaler_live" in fams and "edl_rollout_active" in fams


# ---------------------------------------------------------- the server


def _get(port, path="/metrics"):
    return urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                  timeout=WAIT).read().decode()


def test_metrics_server_scrape_404_500_and_close():
    calls = []

    def collect():
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("collector broke")
        return [pmetrics.counter_family("edl_t_total", "t", len(calls))]

    server = pmetrics.MetricsServer(collect, port=0, host="127.0.0.1")
    port = server.port
    try:
        for n in (1, 2):  # collect runs per scrape
            assert jparse(_get(port))["edl_t_total"]["samples"][0][2] == n
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port)
        assert e.value.code == 500
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port, "/other")
        assert e.value.code == 404
    finally:
        server.close()
    server.close()  # twice is fine
    with pytest.raises(OSError):
        _get(port)


class _Master(object):
    def __init__(self, task_d):
        self.task_d, self.state_store = task_d, None


class _Args(object):
    metrics_port = 0


def test_master_families_match_jax(capsys):
    shards = {"f0": (0, 40), "f1": (0, 24)}
    pages = []
    for mod, cls in ((jmaster_main, JDispatcher), (master_main,
                                                   TaskDispatcher)):
        random.seed(9)
        task_d = cls(shards, {}, {}, records_per_task=8, num_epochs=1)
        task_d.get(0)
        task_d.get(1)
        task_d.record_model_version(3)
        server = mod._start_metrics(_Args(), _Master(task_d))
        try:
            pages.append(_get(server.port))
        finally:
            server.close()
        assert task_d.queue_depths() == (6, 2, 0)
    assert pages[0] == pages[1]
    assert capsys.readouterr().out.count("METRICS_READY port=") == 2


def test_mesh_model_handler_names_item_7():
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        model_handler.MeshModelHandler()


# ------------------------------------------------------------ the entries


class _Proc(object):
    """An entry process whose output lines are collected."""

    def __init__(self, argv, env):
        self.proc = subprocess.Popen(argv, cwd=REPO, env=env, text=True,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT)
        self.lines = []
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in iter(self.proc.stdout.readline, ""):
            self.lines.append(line)

    def port(self, prefix):
        deadline = time.monotonic() + WAIT
        while True:
            hit = [l for l in list(self.lines) if l.startswith(prefix)]
            if hit:
                return int(hit[0].split("port=")[1].split()[0])
            assert self.proc.poll() is None and time.monotonic() < deadline, (
                "".join(self.lines))
            time.sleep(0.01)

    def stop(self):
        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(timeout=WAIT)
        self._reader.join(timeout=WAIT)
        self.proc.stdout.close()
        return rc

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=WAIT)


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO, **extra)
    env.pop("EDL_FAULT_SPEC", None)
    env.pop("EDL_METRICS_PORT", None)
    return env


def test_replica_entry_serves_metrics_and_exports_spans(tmp_path):
    from elasticdl_tpu_torch.proto import messages as pb
    from elasticdl_tpu_torch.proto import service

    proc = _Proc([sys.executable, "-m", "elasticdl_tpu_torch.serving.main",
                  "--device", "cpu", "--port", "0", "--metrics_port", "0",
                  "--model_params", PARAMS, "--kv_paged", "1",
                  "--kv_block_size", "8", "--num_slots", "2"],
                 _env(EDL_TRACE_DIR=str(tmp_path)))
    try:
        mport = proc.port("METRICS_READY")
        port = proc.port("SERVING_READY")
        stub = service.ServingStub(service.build_channel("localhost:%d"
                                                         % port))
        stub.generate(pb.GenerateRequest(prompt=[5, 6, 7], max_new_tokens=3,
                                         trace_id="cafe", deadline_ms=60000),
                      timeout=WAIT)
        fams = jparse(_get(mport))
        assert _norm(fams) == _norm(pparse(_get(mport)))
        assert fams["edl_serving_completed_total"]["samples"][0][2] == 1
        assert [ex[2]["trace_id"] for ex in
                fams["edl_serving_ttft_ms"]["exemplars"]] == ["cafe"]
        assert proc.stop() == 0
    finally:
        proc.kill()
    [export] = os.listdir(str(tmp_path))
    assert export.startswith("spans-replica-%d-" % port)
    doc = json.load(open(str(tmp_path / export)))
    [span] = [s for s in doc["spans"] if s["trace_id"] == "cafe"]
    assert span["name"] == "serve" and span["status"] == "ok"


def test_router_main_serves_metrics():
    proc = _Proc([sys.executable, "-m",
                  "elasticdl_tpu_torch.serving.router_main", "--replica",
                  "localhost:1", "--port", "0", "--metrics_port", "0"],
                 _env())
    try:
        mport = proc.port("METRICS_READY")
        proc.port("ROUTER_READY")
        text = _get(mport)
        fams = jparse(text)
        assert _norm(fams) == _norm(pparse(text))
        assert fams["edl_router_replicas"]["samples"][0][2] == 1
        assert {"edl_router_slo_burn", "edl_router_e2e_ms",
                "edl_router_routed_total"} <= set(fams)
        assert proc.stop() == 0
    finally:
        proc.kill()
