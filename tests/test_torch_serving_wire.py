"""The port's serving replica on the wire, against the JAX package's.

* wire: every serving message the port encodes parses in protobuf
  (elasticdl_pb2) to the same fields and the same bytes, and the
  reverse: fp32 temperatures (0.7, -0.0, inf, nan, a subnormal),
  doubles, empty / single / negative / 10,000-long token lists, a
  ServerStatusResponse with all 59 fields set; unpacked repeated input,
  unknown fields, and malformed bytes that raise in both;
* replica against replica: the JAX rig of tests/test_serving_e2e.py (a
  real gRPC GenerationServer) and a port replica on its HTTP transport
  serve the same weights (params_from_flax) on port 0 and take the same
  greedy requests: concurrent streams, GenerateResponse bytes, the
  TokenChunk stream, the deterministic ServerStatusResponse fields after
  the same sequential requests, the status codes of backpressure, an
  empty prompt, a deadline behind a slow request, a graceful stop and an
  injected fault, reload verdicts and the chunk versions across a
  mid-stream reload, a stream past its deadline, a client that hangs up;
* the transport's streamed call, its handler bound and its hang-ups;
  the telemetry and its ring against JAX's on one fake clock;
* the entry: `python -m elasticdl_tpu_torch.serving.main --device cpu
  --port 0` prints SERVING_READY, streams, and drains on SIGTERM.

A slow decode step is made by wrapping each engine's `step` with a
sleep (the same on both sides), so that requests overlap on this CPU.
"""

import math
import os
import signal
import struct
import subprocess
import sys
import threading
import time

import flax
import grpc
import jax
import numpy as np
import pytest
import torch

from elasticdl_tpu.checkpoint.saver import CheckpointSaver as JSaver
from elasticdl_tpu.common import fault_injection as jfault
from elasticdl_tpu.common.model_utils import load_model_spec_from_module
from elasticdl_tpu.observability.metrics import TimeSeriesRing as JRing
from elasticdl_tpu.parallel import mesh as mesh_lib
from elasticdl_tpu.proto import elasticdl_pb2 as jpb
from elasticdl_tpu.proto import service as jservice
from elasticdl_tpu.serving import GenerationServer as JServer
from elasticdl_tpu.serving import ServingConfig as JConfig
from elasticdl_tpu.serving.telemetry import ServingTelemetry as JTelemetry
from elasticdl_tpu.training.trainer import Trainer
from elasticdl_tpu_torch.common import fault_injection
from elasticdl_tpu_torch.convert import params_from_flax
from elasticdl_tpu_torch.model_zoo.transformer_lm import TransformerLM
from elasticdl_tpu_torch.observability.metrics import TimeSeriesRing
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.proto import service
from elasticdl_tpu_torch.serving import main as port_main
from elasticdl_tpu_torch.serving.admission import AdmissionError
from elasticdl_tpu_torch.serving.server import GenerationServer, ServingConfig
from elasticdl_tpu_torch.serving.telemetry import ServingTelemetry
from model_zoo.transformer_lm import transformer_lm as zoo

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=256, seq_len=128, embed_dim=32, num_heads=2,
           num_layers=2)
PARAMS = ("vocab_size=256; seq_len=128; embed_dim=32; num_heads=2; "
          "num_layers=2")
BLOCK = 8
PREFIX = list(range(40, 56))  # two full blocks
WAIT = 60  # seconds: every wait in this file is bounded by it


# ---------------------------------------------------------------- wire

FULL_STATUS = dict(
    queue_depth=3, active_slots=2, num_slots=8, model_version=-4,
    admitted=1 << 40, rejected=5, expired=6, completed=7,
    tokens_generated=8, reloads=9, uptime_secs=12.5, max_active_slots=8,
    kv_bytes_in_use=1 << 33, kv_bytes_total=1 << 34, kv_blocks_free=100,
    kv_blocks_total=512, kv_block_size=16, kv_paged=True,
    kv_bytes_in_use_peak=1 << 33, kv_bytes_per_token=1234.5678,
    draining=True, queue_wait_ms=0.1, ttft_p50_ms=1e-300,
    ttft_p90_ms=-0.0, ttft_p99_ms=float("inf"), queue_wait_p50_ms=2.5,
    queue_wait_p90_ms=3.25, queue_wait_p99_ms=1e300,
    ttft_hist=[0, 0, 3, 0, 1 << 50], queue_wait_hist=[1, -1],
    kv_shared=True, kv_blocks_shared=4, kv_blocks_cached=5,
    prefix_hit_tokens=64, cow_copies=1, draft_k=2, draft_proposed=40,
    draft_accepted=31, kv_cache_dtype="int8", kv_host_blocks=6,
    kv_host_bytes=7, revive_uploads=8, prefill_tokens_revived=9,
    host_drops=10, prefix_hit_rate_window=0.75,
    slow_cause_counts=[1, 2, 3, 4, 5, 6, 7], last_progress_age_ms=8.5,
    health_state="ok", jit_compiles=11, steady_recompiles=12,
    memory_unaccounted_bytes=13, role="unified", chain_exports=14,
    chain_imports=15, chain_import_tokens=16, transfer_aborts=17,
    transfers_inflight=18, reload_failed=True, reload_error="torn ✗")

WIRE_CASES = [
    ("GenerateRequest", dict(prompt=[1, 2, 3], max_new_tokens=8,
                             temperature=0.7, seed=5, deadline_ms=1500,
                             trace_id="t-1", parent_span_id="s-2",
                             prefill_only=True)),
    ("GenerateRequest", dict(prompt=[7], temperature=-0.0)),
    ("GenerateRequest", dict(prompt=[], temperature=float("inf"))),
    ("GenerateRequest", dict(prompt=[-1, -(1 << 31), (1 << 31) - 1],
                             temperature=float("nan"))),
    ("GenerateRequest", dict(prompt=[3], temperature=1e-45,
                             deadline_ms=-(1 << 63))),
    ("GenerateRequest", dict(prompt=[2], temperature=3.4e38, seed=-1)),
    ("GenerateRequest", dict(prompt=list(range(10_000)),
                             max_new_tokens=1)),
    ("GenerateRequest", dict()),
    ("GenerateResponse", dict(tokens=[5, 0, 255], model_version=3)),
    ("GenerateResponse", dict(tokens=[], model_version=-1)),
    ("TokenChunk", dict(tokens=[9], done=False, model_version=2)),
    ("TokenChunk", dict(tokens=[], done=True, model_version=7)),
    ("ServerStatusRequest", dict()),
    ("ServerStatusResponse", FULL_STATUS),
    ("ServerStatusResponse", dict(uptime_secs=-0.0, role="")),
    ("ReloadCheckpointRequest", dict(version=-3)),
    ("ReloadCheckpointResponse", dict(ok=True, model_version=4)),
    ("ReloadCheckpointResponse", dict(ok=False, model_version=1,
                                      error="version-9 not found")),
]


def _fields(msg, cls):
    return {name: (list(getattr(msg, name))
                   if isinstance(kind, pb._Repeated) else getattr(msg, name))
            for name, _n, kind in cls.FIELDS}


def _same(a, b):
    """Field dicts equal, NaN equal to NaN and -0.0 told from 0.0."""
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, float) and isinstance(y, float):
            assert struct.pack("<d", x) == struct.pack("<d", y), (k, x, y)
        else:
            assert x == y, (k, x, y)


@pytest.mark.parametrize("name,kwargs", WIRE_CASES, ids=[
    "%s-%d" % (c[0], i) for i, c in enumerate(WIRE_CASES)])
def test_serving_messages_round_trip_with_protobuf(name, kwargs):
    ours_cls, ref_cls = getattr(pb, name), getattr(jpb, name)
    ours, ref = ours_cls(**kwargs), ref_cls(**kwargs)
    ours_bytes, ref_bytes = ours.SerializeToString(), ref.SerializeToString()
    assert ours_bytes == ref_bytes
    expected = _fields(ref, ours_cls)
    _same(_fields(ours, ours_cls), expected)
    _same(_fields(ref_cls.FromString(ours_bytes), ours_cls), expected)
    _same(_fields(ours_cls.FromString(ref_bytes), ours_cls), expected)
    if name == "GenerateRequest" and kwargs.get("temperature") == 0.7:
        # fp32, as protobuf stores it
        assert ours.temperature == ref.temperature == 0.699999988079071


def test_status_sets_every_field():
    assert len(pb.ServerStatusResponse.FIELDS) == 59
    assert set(FULL_STATUS) == {n for n, _, _ in pb.ServerStatusResponse
                                .FIELDS}
    assert not [f for f in pb.ServerStatusResponse.FIELDS
                if not getattr(pb.ServerStatusResponse(**FULL_STATUS), f[0])
                and f[0] != "ttft_p90_ms"]


def _tag(number, wire_type):
    return bytes([(number << 3) | wire_type]) if number < 16 else bytes(
        [((number << 3) | wire_type) & 0x7F | 0x80, (number << 3) >> 7])


UNPACKED = [
    # prompt unpacked, then packed: the occurrences concatenate
    ("GenerateRequest", b"\x08\x05\x08\xff\xff\xff\xff\xff\xff\xff\xff\xff"
     b"\x01\x0a\x02\x07\x08"),
    # a scalar given twice keeps its last value; bool from a varint 2
    ("GenerateRequest", b"\x10\x03\x10\x09\x40\x02"),
    # unknown fields of every wire type, and known numbers under a wire
    # type their kind does not take (skipped as unknown)
    ("GenerateRequest", b"\xb8\x06\x96\x01\xc1\x06" + b"\x01" * 8
     + b"\xca\x06\x03abc\xd5\x06" + b"\x02" * 4 + b"\xdb\x06\x08\x01\xdc\x06"
     + b"\x0d\x01\x02\x03\x04\x18\x05\x10\x07"),
    ("ServerStatusResponse", _tag(29, 0) + b"\x04" + _tag(29, 2)
     + b"\x02\x05\x06" + _tag(46, 0) + b"\x01" + b"\x59" + b"\x00" * 8),
    ("TokenChunk", b"\x0a\x00\x10\x01\x18\x02"),
]


@pytest.mark.parametrize("name,data", UNPACKED, ids=[
    "%s-%d" % (c[0], i) for i, c in enumerate(UNPACKED)])
def test_unpacked_and_unknown_fields_parse_as_protobuf(name, data):
    ours_cls = getattr(pb, name)
    ref = getattr(jpb, name).FromString(data)
    ours = ours_cls.FromString(data)
    _same(_fields(ours, ours_cls), _fields(ref, ours_cls))
    # and writes back what protobuf writes (packed, without the unknowns)
    assert ours.SerializeToString() == getattr(jpb, name)(
        **{k: v for k, v in _fields(ref, ours_cls).items()}
    ).SerializeToString()


MALFORMED = [
    b"\x0a\x05\x01\x02",  # packed prompt longer than the message
    b"\x0a\x01\xff",  # a packed varint cut short
    b"\x1d\x00\x00",  # a float cut short
    b"\x08",  # a varint with no value
    b"\x32\x02\xff\xfe",  # trace_id that is not UTF-8
    b"\x0b",  # a group never ended
    b"\x10" + b"\xff" * 11,  # a varint over 10 bytes
]


@pytest.mark.parametrize("data", MALFORMED, ids=range(len(MALFORMED)))
def test_malformed_bytes_raise_in_both(data):
    with pytest.raises(Exception):
        jpb.GenerateRequest.FromString(data)
    with pytest.raises(pb.DecodeError):
        pb.GenerateRequest.FromString(data)


def test_field_values_are_checked_as_protobuf_checks_them():
    for kwargs, exc in ((dict(prompt=[1.5]), TypeError),
                        (dict(prompt=[1 << 31]), ValueError),
                        (dict(temperature="1"), TypeError),
                        (dict(prefill_only=1.0), TypeError)):
        with pytest.raises(exc):
            jpb.GenerateRequest(**kwargs)
        with pytest.raises(exc):
            pb.GenerateRequest(**kwargs)
    # past fp32's range: an infinity, in both
    assert pb.GenerateRequest(temperature=1e40).temperature == math.inf
    assert jpb.GenerateRequest(temperature=1e40).temperature == math.inf
    assert pb.GenerateRequest(prefill_only=2).prefill_only is True


def test_serving_table_and_fault_names_match_jax():
    assert service.SERVING_SERVICE_NAME == jservice.SERVING_SERVICE_NAME
    # the whole table, the chain handoff's three methods included
    assert {k: (a.__name__, b.__name__, s)
            for k, (a, b, s) in service._SERVING_METHODS.items()} == {
        k: (a.__name__, b.__name__, s)
        for k, (a, b, s) in jservice._SERVING_METHODS.items()}
    assert fault_injection.SERVING_RPCS == jfault.SERVING_RPCS


# ------------------------------------------------------------ the rigs


def _jax_rig(seed):
    mesh = mesh_lib.build_mesh({"dp": 1}, devices=jax.devices()[:1])
    trainer = Trainer(load_model_spec_from_module(zoo), mesh=mesh,
                      model_params=PARAMS, seed=seed)
    toks = (np.arange(129)[None, :] % 256).astype(np.int32)
    state = trainer.init_state(({"tokens": toks[:, :-1]}, toks[:, 1:]))
    sd = params_from_flax(jax.tree.map(
        np.asarray, flax.core.meta.unbox(state.params)))
    return trainer, state, sd


@pytest.fixture(scope="module")
def rig():
    """The weights (JAX seed 0) and a second set (seed 123)."""
    return _jax_rig(0), _jax_rig(123)


class Replica(object):
    """One side's server and stub; `code(fn)` is the status name of the
    RpcError `fn` raises."""

    def __init__(self, kind, server, stub, channel):
        self.kind, self.server, self.stub = kind, server, stub
        self._channel = channel
        self.pb = jpb if kind == "jax" else pb

    def request(self, prompt, new, **kw):
        return self.pb.GenerateRequest(prompt=prompt, max_new_tokens=new,
                                       **kw)

    def stream(self, prompt, new, **kw):
        return self.stub.generate_stream(self.request(prompt, new, **kw),
                                         timeout=WAIT)

    def generate(self, prompt, new, **kw):
        return self.stub.generate(self.request(prompt, new, **kw),
                                  timeout=WAIT)

    def status(self):
        return self.stub.server_status(self.pb.ServerStatusRequest(),
                                       timeout=WAIT)

    def reload(self, version):
        return self.stub.reload_checkpoint(
            self.pb.ReloadCheckpointRequest(version=version), timeout=WAIT)

    def slow_steps(self, secs, gate=None):
        """Every decode step sleeps `secs` first; `gate(n)` runs before
        step n (1-based)."""
        engine = self.server.engine
        step = type(engine).step.__get__(engine)
        count = [0]

        def slow():
            count[0] += 1
            if gate is not None:
                gate(count[0])
            time.sleep(secs)
            return step()

        engine.step = slow

    def fast_steps(self):
        self.server.engine.__dict__.pop("step", None)

    def stop(self, drain=True):
        self.server.stop(drain=drain)
        if self._channel is not None:
            self._channel.close()


def code_of(fn):
    try:
        fn()
    except grpc.RpcError as e:
        return e.code().name
    except service.RpcError as e:
        return e.code()
    raise AssertionError("the call did not fail")


def start_pair(rig, **cfg):
    """A JAX replica and a port replica over the same weights with the
    same config, each on an ephemeral port."""
    (trainer, state, sd), _second = rig
    base = dict(num_slots=4, queue_capacity=64, kv_paged=True,
                kv_block_size=BLOCK, kv_shared=True, port=0,
                reload_poll_secs=0)
    base.update(cfg)
    jserver = JServer(trainer, state, JConfig(runtime_health=False,
                                              **base)).start()
    jchannel = jservice.build_channel("localhost:%d" % jserver.port)
    model = TransformerLM(device="cpu", **CFG)
    model.load_state_dict(sd)
    pserver = GenerationServer(model, ServingConfig(**base)).start(
        transport=True)
    pstub = service.ServingStub(service.build_channel(
        "localhost:%d" % pserver.port))
    return (Replica("jax", jserver, jservice.ServingStub(jchannel), jchannel),
            Replica("port", pserver, pstub, None))


def run_threads(fns):
    """Run each fn on a thread of its own; their results (or errors) in
    order."""
    out = [None] * len(fns)

    def body(i, fn):
        try:
            out[i] = fn()
        except Exception as e:  # noqa: BLE001 - returned to the test
            out[i] = e

    threads = [threading.Thread(target=body, args=(i, fn), daemon=True)
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
        assert not t.is_alive(), "a client thread did not finish"
    return out


def wait_for(cond, what):
    deadline = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < deadline, "timed out waiting for " + what
        time.sleep(0.005)


def chunks_of(stream):
    return [(list(c.tokens), c.done, c.model_version) for c in stream]


# 8 greedy requests: four share a two-block prefix, one repeats a prompt
REQUESTS = [
    (PREFIX + [1, 2], 12),
    (list(range(100, 113)), 9),
    (PREFIX + [3], 15),
    (PREFIX, 6),
    ([7, 7, 8], 1),
    (PREFIX + [1, 2], 10),
    ([200, 3, 9, 9, 27, 64], 20),
    (list(range(60, 90)), 5),
]


@pytest.fixture(scope="module")
def pair(rig):
    replicas = start_pair(rig)
    yield replicas
    for r in replicas:
        r.stop()


def test_concurrent_streams_and_unary_answers_match_jax(pair):
    jax_r, port_r = pair
    streams = {}
    for r in pair:
        streams[r.kind] = run_threads([
            (lambda r=r, p=p, n=n: chunks_of(r.stream(p, n)))
            for p, n in REQUESTS])
    for got in streams.values():
        assert not [g for g in got if isinstance(g, Exception)], got
    assert streams["port"] == streams["jax"]
    for chunks, (_p, n) in zip(streams["port"], REQUESTS):
        assert sum(len(c[0]) for c in chunks) == n
        assert chunks[-1] == ([], True, 0)
        assert all(len(c[0]) == 1 and not c[1] for c in chunks[:-1])
    # the unary answer: the same bytes
    for prompt, n in REQUESTS[:3]:
        ref = jax_r.generate(prompt, n)
        got = port_r.generate(prompt, n)
        assert got.SerializeToString() == ref.SerializeToString()
        tokens = sum((c[0] for c in streams["jax"][REQUESTS.index(
            (prompt, n))]), [])
        assert list(got.tokens) == prompt + tokens
    for r in pair:
        assert code_of(lambda r=r: r.generate([], 3)) == "INVALID_ARGUMENT"
        assert code_of(lambda r=r: list(r.stream([1] * 120, 20))) == (
            "INVALID_ARGUMENT")


def test_a_stream_past_its_deadline_ends_deadline_exceeded(pair):
    got = {}
    for r in pair:
        r.slow_steps(0.03)
        try:
            chunks = []

            def read(r=r, chunks=chunks):
                for c in r.stream([5, 6, 7], 100, deadline_ms=1500):
                    chunks.append(list(c.tokens))

            got[r.kind] = (code_of(read), len(chunks))
        finally:
            r.fast_steps()
    for kind, (code, n) in got.items():
        assert code == "DEADLINE_EXCEEDED", kind
        assert 0 < n < 100, (kind, n)


def test_a_client_that_hangs_up_does_not_wedge_the_scheduler(pair):
    for r in pair:
        r.slow_steps(0.01)
        try:
            stream = r.stream([9, 8, 7], 60)
            first = next(iter(stream))
            assert len(first.tokens) == 1
            stream.cancel()
        finally:
            r.fast_steps()
        assert list(r.generate([1, 2, 3], 4).tokens)[:3] == [1, 2, 3]
        wait_for(lambda r=r: r.status().active_slots == 0, "the slot")
        assert r.server.scheduler.is_alive()
        assert r.server.scheduler.crashed is None


STATUS_FIELDS = (
    "admitted", "rejected", "expired", "completed", "tokens_generated",
    "reloads", "num_slots", "model_version", "kv_bytes_in_use",
    "kv_bytes_total", "kv_blocks_free", "kv_blocks_total", "kv_block_size",
    "kv_paged", "kv_bytes_in_use_peak", "kv_bytes_per_token", "kv_shared",
    "kv_blocks_shared", "kv_blocks_cached", "kv_cache_dtype",
    "kv_host_blocks", "kv_host_bytes", "prefix_hit_tokens", "cow_copies",
    "draft_k", "draft_proposed", "draft_accepted", "role",
    "reload_failed", "slow_cause_counts", "health_state", "queue_depth",
    "active_slots", "draining", "revive_uploads", "prefill_tokens_revived",
    "host_drops", "chain_exports", "chain_imports", "transfer_aborts",
    "transfers_inflight", "max_active_slots", "prefix_hit_rate_window")


def test_status_after_the_same_requests_matches_jax(rig):
    replicas = start_pair(rig, num_slots=2)
    try:
        status = {}
        for r in replicas:
            for prompt, n in REQUESTS:
                list(r.stream(prompt, n))
            assert code_of(lambda r=r: r.generate([], 2)) == (
                "INVALID_ARGUMENT")
            st = r.status()
            status[r.kind] = {f: (list(getattr(st, f)) if f ==
                                  "slow_cause_counts" else getattr(st, f))
                              for f in STATUS_FIELDS}
            # the latency fields are the host's, but both have them
            assert st.uptime_secs > 0 and st.ttft_p50_ms > 0
            assert sum(st.ttft_hist) == len(REQUESTS)
            assert sum(st.queue_wait_hist) == len(REQUESTS)
    finally:
        for r in replicas:
            r.stop()
    assert status["port"] == status["jax"]
    st = status["port"]
    assert st["prefix_hit_tokens"] > 0
    assert st["completed"] == len(REQUESTS) and st["rejected"] == 1
    assert st["tokens_generated"] == sum(n for _p, n in REQUESTS)
    assert st["role"] == "unified" and st["health_state"] == ""


def test_status_codes_of_overload_deadline_and_graceful_stop_match(rig):
    """One slot and a queue of two: a slow request A (100 steps of 20+
    ms) holds the slot, D (a 300 ms deadline) and B wait; C finds the
    queue full. D expires behind A; then a graceful stop: A finishes, B
    is refused."""
    replicas = start_pair(rig, num_slots=1, queue_capacity=2)
    got = {}
    try:
        for r in replicas:
            r.slow_steps(0.02)
            out = {}

            def stream(key, prompt, n, r=r, out=out, **kw):
                chunks = []
                try:
                    for c in r.stream(prompt, n, **kw):
                        chunks.append(list(c.tokens))
                    out[key] = ("OK", sum(chunks, []))
                except (grpc.RpcError, service.RpcError) as e:
                    code = e.code()
                    out[key] = (getattr(code, "name", code),
                                sum(chunks, []))

            a = threading.Thread(target=stream, args=("A", [3, 1, 4], 100))
            a.start()
            wait_for(lambda r=r: r.status().active_slots == 1, "A seated")
            d = threading.Thread(target=stream, args=("D", [2, 7], 5),
                                 kwargs={"deadline_ms": 300})
            d.start()
            wait_for(lambda r=r: r.status().queue_depth == 1, "D queued")
            b = threading.Thread(target=stream, args=("B", [1, 6, 1], 5))
            b.start()
            wait_for(lambda r=r: r.status().queue_depth == 2, "B queued")
            out["C"] = code_of(lambda r=r: r.generate([8], 3))
            d.join(timeout=WAIT)
            r.server.stop(drain=True)
            for t in (a, b):
                t.join(timeout=WAIT)
                assert not t.is_alive()
            got[r.kind] = out
    finally:
        for r in replicas:
            r.stop()
    assert got["port"]["C"] == got["jax"]["C"] == "RESOURCE_EXHAUSTED"
    for key, code in (("D", "DEADLINE_EXCEEDED"),
                      ("B", "RESOURCE_EXHAUSTED"), ("A", "OK")):
        assert got["port"][key][0] == got["jax"][key][0] == code, key
    assert got["port"]["A"][1] == got["jax"]["A"][1]
    assert len(got["port"]["A"][1]) == 100
    assert got["port"]["D"][1] == got["jax"]["D"][1] == []


def test_an_injected_fault_at_generate_answers_alike(rig, monkeypatch):
    monkeypatch.setenv("EDL_FAULT_SPEC", "generate:error:1")
    replicas = start_pair(rig)
    try:
        for r in replicas:
            assert code_of(lambda r=r: r.generate([1, 2], 3)) == (
                "UNAVAILABLE")
            # the handler ran: the next call is served
            assert len(r.generate([1, 2], 3).tokens) == 5
            assert r.status().completed == 2
    finally:
        for r in replicas:
            r.stop()


def _checkpoints(rig, path):
    (_t, state, _sd), (_t2, state2, _sd2) = rig
    for version, st in ((1, state), (2, state2)):
        JSaver(str(path), checkpoint_steps=1).save(st, version)


def test_reload_verdicts_match_jax(rig, tmp_path):
    """Versions 1 and 2 on disk, reload_poll_secs 0: a newer, an older,
    the serving and a missing version get the same verdicts."""
    _checkpoints(rig, tmp_path)
    replicas = start_pair(rig, checkpoint_dir=str(tmp_path))
    verdicts = {}
    try:
        for r in replicas:
            verdicts[r.kind] = [
                (v.ok, v.model_version, bool(v.error))
                for v in (r.reload(2), r.reload(1), r.reload(1),
                          r.reload(9))]
            st = r.status()
            verdicts[r.kind].append((st.model_version, st.reloads,
                                     st.reload_failed, bool(st.reload_error)))
            # the old weights still serve
            assert len(r.generate([4, 5], 3).tokens) == 5
    finally:
        for r in replicas:
            r.stop()
    assert verdicts["port"] == verdicts["jax"]
    assert verdicts["port"] == [(True, 2, False), (True, 1, False),
                                (True, 1, False), (False, 1, True),
                                (1, 2, True, True)]


def _reload_mid_stream(r, version):
    """Stream 12 tokens; hold its 5th decode step until a reload to
    `version` is queued on the scheduler; the chunks' versions."""
    reached, release = threading.Event(), threading.Event()

    def gate(n):
        if n == 5:
            reached.set()
            assert release.wait(WAIT)

    r.slow_steps(0.0, gate)
    out = {}

    def reload():
        assert reached.wait(WAIT)
        out["verdict"] = r.reload(version)

    try:
        results = [None, None]

        def read():
            results[0] = chunks_of(r.stream([11, 12, 13], 12))

        t_read = threading.Thread(target=read, daemon=True)
        t_reload = threading.Thread(target=reload, daemon=True)
        t_read.start()
        t_reload.start()
        wait_for(lambda: len(r.server.scheduler._jobs) > 0 or
                 not t_reload.is_alive(), "the reload job")
        release.set()
        for t in (t_read, t_reload):
            t.join(timeout=WAIT)
            assert not t.is_alive()
    finally:
        r.fast_steps()
    assert out["verdict"].ok
    return results[0]


def test_chunk_versions_switch_at_the_same_token_across_a_reload(
        rig, tmp_path):
    _checkpoints(rig, tmp_path)
    replicas = start_pair(rig, checkpoint_dir=str(tmp_path))
    chunks = {}
    try:
        for r in replicas:
            assert r.reload(1).ok
            chunks[r.kind] = _reload_mid_stream(r, 2)
            assert r.status().model_version == 2
    finally:
        for r in replicas:
            r.stop()
    assert chunks["port"] == chunks["jax"]
    versions = [c[2] for c in chunks["port"]]
    # the prefill's token and 5 decode steps under version 1, the rest
    # and the done chunk under version 2
    assert versions == [1] * 6 + [2] * 7


# ------------------------------------------------------- the transport


class _FakeServing(object):
    """generate holds on `release` (at most WAIT s) and logs when each
    call entered; generate_stream yields `n` chunks `gap` s apart, then
    fails with `fail` when set."""

    def __init__(self, n=3, gap=0.0, fail=None):
        self.release = threading.Event()
        self.entered = []
        self.n, self.gap, self.fail = n, gap, fail

    def generate(self, request, _context=None):
        self.entered.append(time.monotonic())
        assert self.release.wait(WAIT)
        return pb.GenerateResponse(tokens=list(request.prompt))

    def generate_stream(self, request, _context=None):
        if not request.prompt:
            raise AdmissionError("INVALID_ARGUMENT", "empty prompt")

        def stream():
            for i in range(self.n):
                time.sleep(self.gap)
                yield pb.TokenChunk(tokens=[i])
            if self.fail is not None:
                raise self.fail
            yield pb.TokenChunk(done=True)

        return stream()

    def server_status(self, request, _context=None):
        return pb.ServerStatusResponse(role="unified")

    def reload_checkpoint(self, request, _context=None):
        raise RuntimeError("no watcher")

    def export_chain(self, request, _context=None):
        raise RuntimeError("no pool")

    transfer_chain = abort_transfer = export_chain


def _fake_server(servicer, **kw):
    server = service.build_server(**kw)
    service.add_serving_servicer_to_server(servicer, server)
    port = server.add_insecure_port("[::]:0")
    server.start()
    return server, service.ServingStub(service.build_channel(
        "localhost:%d" % port)), port


@pytest.mark.parametrize("fail,code", [
    (None, None),
    (AdmissionError("DEADLINE_EXCEEDED", "deadline expired mid-decode"),
     "DEADLINE_EXCEEDED"),
    (service.RpcError("ABORTED", "injected"), "ABORTED"),
    (RuntimeError("boom"), "UNKNOWN"),
])
def test_a_stream_ends_with_its_handler_status_after_the_chunks(fail, code):
    server, stub, _port = _fake_server(_FakeServing(n=3, fail=fail))
    try:
        got = []
        stream = stub.generate_stream(pb.GenerateRequest(prompt=[1]),
                                      timeout=WAIT)
        if code is None:
            got = [list(c.tokens) for c in stream]
            assert got == [[0], [1], [2], []]
        else:
            with pytest.raises(service.RpcError) as err:
                for c in stream:
                    got.append(list(c.tokens))
            assert got == [[0], [1], [2]]
            assert err.value.code() == code
            if code == "UNKNOWN":
                assert "boom" in err.value.details()
        # a failure at admission: before any chunk
        assert code_of(lambda: list(stub.generate_stream(
            pb.GenerateRequest(), timeout=WAIT))) == "INVALID_ARGUMENT"
        # a method that is not ported (the router's), and a handler error
        assert code_of(lambda: service.Channel(
            "localhost:%d" % _port).call(
                "/elasticdl_tpu.Router/router_generate", b"",
                timeout=WAIT)) == "UNIMPLEMENTED"
        assert code_of(lambda: stub.reload_checkpoint(
            pb.ReloadCheckpointRequest(), timeout=WAIT)) == "UNKNOWN"
    finally:
        server.stop(grace=1.0)


def test_timeout_bounds_the_whole_stream():
    server, stub, _port = _fake_server(_FakeServing(n=60, gap=0.05))
    try:
        got = []
        t0 = time.monotonic()
        with pytest.raises(service.RpcError) as err:
            for c in stub.generate_stream(pb.GenerateRequest(prompt=[1]),
                                          timeout=1.0):
                got.append(c)
        assert err.value.code() == "DEADLINE_EXCEEDED"
        assert 0 < len(got) < 60 and time.monotonic() - t0 < 5
    finally:
        server.stop(grace=3.0)


def test_a_stream_closed_before_its_trailer_is_unavailable():
    import socket

    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    frame = pb.TokenChunk(tokens=[4]).SerializeToString()

    def serve():
        conn, _ = listener.accept()
        with conn:
            conn.settimeout(WAIT)
            data = b""
            while b"\r\n\r\n" not in data:
                data += conn.recv(4096)
            conn.sendall(b"HTTP/1.0 200 OK\r\nX-Rpc-Status: OK\r\n"
                         b"X-Rpc-Stream: frames\r\n\r\n"
                         + struct.pack(">BI", 0, len(frame)) + frame)

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    try:
        stub = service.ServingStub(service.build_channel(
            "localhost:%d" % listener.getsockname()[1]))
        got = []
        with pytest.raises(service.RpcError) as err:
            for c in stub.generate_stream(pb.GenerateRequest(prompt=[1]),
                                          timeout=WAIT):
                got.append(list(c.tokens))
        assert got == [[4]] and err.value.code() == "UNAVAILABLE"
    finally:
        t.join(timeout=WAIT)
        listener.close()
    # nobody listening: UNAVAILABLE from the first read
    assert code_of(lambda: list(stub.generate_stream(
        pb.GenerateRequest(prompt=[1]), timeout=WAIT))) == "UNAVAILABLE"


def test_calls_beyond_max_workers_wait_and_are_served():
    fake = _FakeServing()
    server, stub, _port = _fake_server(fake, max_workers=1)
    try:
        answers = []
        threads = [threading.Thread(target=lambda i=i: answers.append(
            stub.generate(pb.GenerateRequest(prompt=[i]), timeout=WAIT)))
            for i in range(2)]
        for t in threads:
            t.start()
        wait_for(lambda: len(fake.entered) == 1, "the first handler")
        time.sleep(0.3)
        assert len(fake.entered) == 1  # the second call waits
        released = time.monotonic()
        fake.release.set()
        for t in threads:
            t.join(timeout=WAIT)
            assert not t.is_alive()
        assert sorted(list(a.tokens) for a in answers) == [[0], [1]]
        assert fake.entered[1] >= released
    finally:
        server.stop(grace=1.0)


# ------------------------------------------------------------ telemetry


class _Clock(object):
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class _Req(object):
    def __init__(self, submitted_at):
        self.submitted_at = submitted_at
        self.trace_id = ""


def _drive_telemetry(tel, clock):
    for _ in range(3):
        tel.count("admitted")
    tel.count("rejected")
    for i in range(70):
        clock.t += 0.013 * (i % 5 + 1)
        tel.record_queue_wait(0.002 * i)
        tel.count("prompt_tokens", 10 + i)
        if i % 3:
            tel.count("prefix_hit_tokens", 8)
        tel.record_ttft(_Req(clock.t - 0.05 - 0.001 * i))
        tel.record_step(i % 4, 1 + i % 3, 0.004 + 0.0001 * i, 1 + i % 3,
                        kv_bytes_in_use=4096 * (i % 7),
                        kv_blocks_free=64 - i % 9)
        if i % 10 == 0:
            tel.record_e2e(30.0 + i)
            tel.count("completed")
    tel.count("cow_copies")
    tel.count_slow_cause("decode")
    tel.count_slow_cause("queue_wait", 2)


def test_telemetry_snapshot_matches_jax_on_one_clock():
    snaps = []
    for cls in (JTelemetry, ServingTelemetry):
        clock = _Clock()
        tel = cls(clock=clock)
        _drive_telemetry(tel, clock)
        snap = tel.snapshot()
        tel.reset_latency()
        clock.t += 5.0
        after = tel.snapshot()
        for bad in (lambda: tel.count("admited"),
                    lambda: tel.gauge("nope", 1),
                    lambda: tel.count_slow_cause("cosmic_rays")):
            with pytest.raises(ValueError):
                bad()
        tel.close()
        snaps.append((snap, after, tel.ring.windows()))
    (jsnap, jafter, jwin), (snap, after, win) = snaps
    assert snap == jsnap and after == jafter
    assert snap["slow_cause_counts"] == [2, 0, 0, 0, 0, 1, 0]
    assert 0 < snap["prefix_hit_rate_window"] < 1
    for a, b in zip(win, jwin):
        assert a == {k: v for k, v in b.items() if k != "exemplars"}
    assert len(win) == len(jwin)
    assert ServingTelemetry.COUNTERS == JTelemetry.COUNTERS
    assert ServingTelemetry.GAUGES == JTelemetry.GAUGES
    assert ServingTelemetry.SLOW_CAUSES == JTelemetry.SLOW_CAUSES
    with pytest.raises(NotImplementedError, match="item 6"):
        ServingTelemetry(log_dir="tb")


def test_time_series_ring_matches_jax():
    rings = []
    for cls in (JRing, TimeSeriesRing):
        clock = _Clock()
        ring = cls(interval_secs=1.0, capacity=5, clock=clock)
        for i in range(40):
            clock.t += 0.37
            ring.observe(counters={"a": i * i, "b": 3 * i},
                         gauges={"g": float(i)},
                         hists={"h": [i, 0, i // 2]})
        baseline = (ring.baseline_counter("a"), ring.due())
        ring.flush()
        rings.append((
            [{k: v for k, v in w.items() if k != "exemplars"}
             for w in ring.windows()],
            ring.windows(horizon_secs=2.5), ring.sum_counter("a", 3.0),
            ring.dropped, baseline, ring.due()))
    jring, ours = rings
    assert ours[0] == jring[0]
    assert [w["t1"] for w in ours[1]] == [w["t1"] for w in jring[1]]
    assert ours[2:] == jring[2:]


# ------------------------------------------------------------ the entry


def test_entry_flags_of_later_items_raise():
    for flag, item in (("--metrics_port", "item 6"),
                       ("--stall_after_secs", "item 6")):
        with pytest.raises(SystemExit):
            port_main.parse_serving_args([flag, "1"])
        assert item in port_main.NOT_PORTED[flag]
    # item 3's flags are ported: the host tier's budget and the role
    assert not {"--kv_host_bytes", "--role"} & set(port_main.NOT_PORTED)
    args = port_main.parse_serving_args(["--kv_host_bytes", "4096",
                                         "--role", "decode"])
    assert (args.kv_host_bytes, args.role) == (4096, "decode")
    with pytest.raises(SystemExit):
        port_main.parse_serving_args(["--role", "router"])
    args = port_main.parse_serving_args([])
    assert (args.port, args.max_workers, args.device) == (50051, 64, "cuda")
    assert args.model_def == "transformer_lm.custom_model"
    assert os.path.samefile(args.model_zoo, os.path.join(
        REPO, "elasticdl_tpu_torch", "model_zoo"))
    with pytest.raises(ValueError, match="seq_len"):
        port_main.build_model(port_main.parse_serving_args([
            "--device", "cpu", "--model_def", "dlrm.custom_model",
            "--model_params", "table_size=100; embedding_dim=4"]))


def _read_lines(pipe, lines):
    for line in iter(pipe.readline, ""):
        lines.append(line)


def test_entry_serves_on_a_port_and_drains_on_sigterm():
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("EDL_FAULT_SPEC", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "elasticdl_tpu_torch.serving.main",
         "--device", "cpu", "--port", "0", "--model_params", PARAMS,
         "--kv_paged", "1", "--kv_block_size", str(BLOCK), "--num_slots",
         "2", "--warmup_tokens", "2"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    out, err = [], []
    readers = [threading.Thread(target=_read_lines, args=(p, lines),
                                daemon=True)
               for p, lines in ((proc.stdout, out), (proc.stderr, err))]
    for t in readers:
        t.start()
    try:
        wait_for(lambda: any(l.startswith("SERVING_READY") for l in out)
                 or proc.poll() is not None, "SERVING_READY")
        ready = [l for l in out if l.startswith("SERVING_READY")]
        assert ready, "".join(err)
        port = int(ready[0].split("port=")[1])
        stub = service.ServingStub(service.build_channel(
            "localhost:%d" % port))
        stream = iter(stub.generate_stream(pb.GenerateRequest(
            prompt=[1, 2, 3], max_new_tokens=120), timeout=WAIT))
        chunks = [next(stream)]
        proc.send_signal(signal.SIGTERM)
        chunks.extend(stream)
        assert sum(len(c.tokens) for c in chunks) == 120
        assert chunks[-1].done
        assert proc.wait(timeout=WAIT) == 0, "".join(err)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT)
        for t in readers:
            t.join(timeout=WAIT)
        proc.stdout.close()
        proc.stderr.close()
    assert len(ready) == 1
