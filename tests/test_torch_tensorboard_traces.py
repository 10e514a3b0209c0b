"""The TensorBoard writers and the training plane's task traces in the
port against the JAX package's.

Under one wall clock and node name (`time.time` and `os.uname` pinned in
both packages at once) the event files of `EventFileWriter`,
`TensorboardService`, `ServingTelemetry`, `RouterTelemetry` and the
master servicer's tier gauges are equal byte for byte; the encoders
equal JAX's on seeded tags, values and steps; the task-dispatch span
trees equal JAX's once ids and times are taken out; the port's Worker
parents one `worker_task` span under each task's dispatch span; the
entries' TensorBoard flags parse as JAX's. Every file is also read by a
parser that shares no code with either writer (a table-free CRC32C).
"""

import glob
import os
import random
import struct
import time
import types

import numpy as np
import pytest
import torch

from elasticdl_tpu.common import args as jargs
from elasticdl_tpu.common import tb_events as jtb
from elasticdl_tpu.master import servicer as jservicer
from elasticdl_tpu.master import task_dispatcher as jdispatch
from elasticdl_tpu.master import tensorboard_service as jtbs
from elasticdl_tpu.observability import tracing as jtracing
from elasticdl_tpu.proto import elasticdl_pb2 as jpb
from elasticdl_tpu.serving import main as jserving_main
from elasticdl_tpu.serving import router_main as jrouter_main
from elasticdl_tpu.serving import telemetry as jtelemetry
from elasticdl_tpu_torch.client import main as client_main
from elasticdl_tpu_torch.common import args as pargs
from elasticdl_tpu_torch.common import tb_events as ptb
from elasticdl_tpu_torch.common.model_utils import (
    load_model_spec_from_module,
)
from elasticdl_tpu_torch.master import servicer as pservicer
from elasticdl_tpu_torch.master import task_dispatcher as pdispatch
from elasticdl_tpu_torch.master import tensorboard_service as ptbs
from elasticdl_tpu_torch.master.master import Master
from elasticdl_tpu_torch.model_zoo import transformer_lm as tzoo
from elasticdl_tpu_torch.observability import tracing as ptracing
from elasticdl_tpu_torch.proto import messages as ppb
from elasticdl_tpu_torch.serving import main as pserving_main
from elasticdl_tpu_torch.serving import router_main as prouter_main
from elasticdl_tpu_torch.serving import telemetry as ptelemetry
from elasticdl_tpu_torch.worker.worker import Worker
from tests import test_torch_master_worker as MW
from tests import test_torch_training as T

torch.set_num_threads(2)

WALL = 1760000000.375
NODE = "edl-node"


@pytest.fixture
def pinned(monkeypatch):
    """One wall clock and node name for both packages' writers."""
    monkeypatch.setattr(time, "time", lambda: WALL)
    monkeypatch.setattr(os, "uname",
                        lambda: types.SimpleNamespace(nodename=NODE))


class Clock(object):
    def __init__(self, t=50.0):
        self.t = t

    def __call__(self):
        return self.t


# ------------------------------------------- an independent event reader


def crc32c_bitwise(data):
    """Table-free CRC32C: shares no code with either writer."""
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
    return crc ^ 0xFFFFFFFF


def _masked(data):
    crc = crc32c_bitwise(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(buf, off):
    out = shift = 0
    while True:
        b = buf[off]
        off += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, off
        shift += 7


def _fields(buf):
    out, off = [], 0
    while off < len(buf):
        key, off = _varint(buf, off)
        num, wt = key >> 3, key & 7
        if wt == 0:
            val, off = _varint(buf, off)
        elif wt == 1:
            (val,) = struct.unpack_from("<d", buf, off)
            off += 8
        elif wt == 5:
            (val,) = struct.unpack_from("<f", buf, off)
            off += 4
        elif wt == 2:
            n, off = _varint(buf, off)
            val, off = buf[off:off + n], off + n
        else:
            raise AssertionError("wire type %d" % wt)
        out.append((num, val))
    return out


def read_events(path):
    """[(step, {tag: value})] of one file; the header event first (step
    None, its version under "file_version"). Both CRCs of every record
    are checked."""
    blob = open(path, "rb").read()
    events, off = [], 0
    while off < len(blob):
        (n,) = struct.unpack_from("<Q", blob, off)
        payload = blob[off + 12:off + 12 + n]
        assert struct.unpack_from("<I", blob, off + 8)[0] == _masked(
            blob[off:off + 8])
        assert struct.unpack_from("<I", blob, off + 12 + n)[0] == _masked(
            payload)
        off += 16 + n
        step, tags = None, {}
        for num, val in _fields(payload):
            if num == 2:
                step = val - (1 << 64) if val >= 1 << 63 else val
            elif num == 3:
                tags["file_version"] = bytes(val)
            elif num == 5:
                for _n, sval in _fields(val):
                    tag = value = None
                    for vnum, vval in _fields(sval):
                        if vnum == 1:
                            tag = bytes(vval).decode("utf-8")
                        elif vnum == 2:
                            value = vval
                    tags[tag] = value
        events.append((step, tags))
    assert off == len(blob)
    return events


def only_file(d, suffix=""):
    files = glob.glob(os.path.join(str(d), "events.out.tfevents.*"))
    assert len(files) == 1 and files[0].endswith(suffix), files
    return files[0]


def same_bytes(jdir, pdir, suffix=""):
    """The one event file of each directory: same name, same bytes;
    returns its events."""
    jf, pf = only_file(jdir, suffix), only_file(pdir, suffix)
    assert os.path.basename(jf) == os.path.basename(pf)
    data = open(pf, "rb").read()
    assert data == open(jf, "rb").read()
    events = read_events(pf)
    assert events[0][1] == {"file_version": b"brain.Event:2"}
    return events


# ------------------------------------------------------------ encoders


@pytest.mark.parametrize("data", [b"", b"a", b"123456789", bytes(32),
                                  bytes(range(32)), b"\xff" * 32])
def test_crc32c_on_known_vectors(data):
    # RFC 3720's check values, where the vector has one
    known = {b"123456789": 0xE3069283, bytes(32): 0x8A9136AA,
             b"\xff" * 32: 0x62A8AB43, bytes(range(32)): 0x46DD794E}
    got = ptb.crc32c(data)
    assert got == jtb.crc32c(data) == crc32c_bitwise(data)
    if data in known:
        assert got == known[data]
    assert ptb._masked_crc(data) == jtb._masked_crc(data) == _masked(data)


@pytest.mark.parametrize("seed", range(4))
def test_crc32c_on_seeded_bytes(seed):
    rs = np.random.RandomState(seed)
    for n in (1, 7, 64, 1000):
        data = rs.randint(0, 256, size=n).astype(np.uint8).tobytes()
        assert ptb.crc32c(data) == jtb.crc32c(data) == crc32c_bitwise(data)


TAGS = ["serving/ttft_ms", "router/routed_total", "tier/x/worker-3",
        "ünïcødé/延迟", "", "a" * 300]
VALUES = [0.0, -0.0, 1.5, -3.25, 1e30, -1e-30, 3.4e38, float("nan"),
          float("inf"), float("-inf"), 7]
STEPS = [0, 1, -1, 127, 128, 2 ** 32 + 5, -(2 ** 40), 2 ** 62]


@pytest.mark.parametrize("tag", TAGS)
def test_encoders_equal_jax(tag):
    rs = np.random.RandomState(len(tag))
    for value in VALUES + list(rs.randn(4) * 1e3):
        for step in STEPS:
            for wall in (None, 0.0, 1.5e9 + 0.125):
                if wall is None:
                    wall = WALL
                got = ptb.encode_scalar_event(tag, value, step, wall)
                assert got == jtb.encode_scalar_event(tag, value, step, wall)
                assert ptb.frame_record(got) == jtb.frame_record(got)
    assert ptb.encode_file_version_event(2.5) == \
        jtb.encode_file_version_event(2.5)
    # one of them read back by the independent reader
    path_bytes = ptb.frame_record(ptb.encode_scalar_event(tag, -3.25, -7,
                                                          1.0))
    assert _masked(path_bytes[:8]) == struct.unpack_from("<I",
                                                          path_bytes, 8)[0]


# ------------------------------------------------------- file writers


def test_event_file_writer_bytes_equal_jax(tmp_path, pinned):
    vals = list(np.random.RandomState(1).randn(20) * 100) + VALUES
    for mod, sub in ((jtb, "jax"), (ptb, "port")):
        w = mod.EventFileWriter(str(tmp_path / sub), filename_suffix=".x")
        for i, value in enumerate(vals):
            w.add_scalar(TAGS[i % len(TAGS)], value, STEPS[i % len(STEPS)])
        w.close()
    events = same_bytes(tmp_path / "jax", tmp_path / "port", ".x")
    assert len(events) == len(vals) + 1
    assert [s for s, _t in events[1:9]] == STEPS
    got = [list(t.values())[0] for _s, t in events[1:]]
    want = [float(np.float32(v)) for v in vals]
    assert [g for g in got if g == g] == [w for w in want if w == w]


def test_tensorboard_service_bytes_equal_jax(tmp_path, pinned):
    metrics = {"auc": 0.75, "loss": np.float32(1.25), "count": 3,
               "skip": "not-a-number", "arr": np.arange(3)}
    for mod, sub in ((jtbs, "jax"), (ptbs, "port")):
        svc = mod.TensorboardService(str(tmp_path / sub))
        assert not svc.is_active()
        svc.write_dict_to_summary(metrics, version=4)
        svc.write_dict_to_summary({"auc": 0.8}, version=6)
        svc.stop()
        svc.write_dict_to_summary({"late": 1.0}, version=7)  # dropped
        svc.stop()
    events = same_bytes(tmp_path / "jax", tmp_path / "port")
    assert [(s, sorted(t)) for s, t in events[1:]] == [
        (4, ["auc"]), (4, ["loss"]), (4, ["count"]), (6, ["auc"])]


def test_tensorboard_service_start_without_the_binary(tmp_path,
                                                      monkeypatch):
    import shutil

    monkeypatch.setattr(shutil, "which", lambda name: None)
    svc = ptbs.TensorboardService(str(tmp_path))
    assert svc.start() is False and not svc.is_active()
    svc.stop()


def _serving_sequence(tel, clock, rs, n):
    for i in range(n):
        clock.t += 0.004 + 0.002 * rs.rand()
        tel.count("admitted")
        tel.count("prompt_tokens", int(rs.randint(4, 40)))
        if rs.rand() < 0.4:
            tel.count("prefix_hit_tokens", int(rs.randint(1, 4)))
        tel.record_queue_wait(0.001 * rs.rand(), trace_id="t%d" % i)
        req = types.SimpleNamespace(submitted_at=clock.t - 0.02 * rs.rand(),
                                    trace_id="t%d" % i)
        tel.record_ttft(req)
        tel.record_step(int(rs.randint(0, 4)), int(rs.randint(1, 5)),
                        0.005 + 0.003 * rs.rand(), int(rs.randint(1, 5)),
                        kv_bytes_in_use=int(rs.randint(0, 1 << 20)),
                        kv_blocks_free=int(rs.randint(0, 64)),
                        kv_host_blocks=int(rs.randint(0, 4)),
                        kv_host_bytes=int(rs.randint(0, 4096)))
        if i % 3 == 0:
            tel.record_e2e(30.0 + 10 * rs.rand(), trace_id="t%d" % i)
            tel.count("completed")
        if i % 7 == 0:
            tel.count_slow_cause("decode")
            tel.gauge("last_progress_age_ms", 5.0 * i)


@pytest.mark.parametrize("n", [13, 57, 100])
def test_serving_telemetry_files_equal_jax(tmp_path, pinned, n):
    """flush_every 10: windows closed by the steps, and a close() mid-
    window (n = 13, 57) or on a boundary (100) that flushes the tail;
    the last totals equal the counters and the ring's sum."""
    snaps = []
    for mod, sub in ((jtelemetry, "jax"), (ptelemetry, "port")):
        clock = Clock()
        tel = mod.ServingTelemetry(log_dir=str(tmp_path / sub),
                                   flush_every=10, clock=clock,
                                   ring_secs=0.05)
        _serving_sequence(tel, clock, np.random.RandomState(n), n)
        snaps.append(tel.snapshot())
        tel.close()
        tel.close()
    assert snaps[0] == snaps[1]
    events = same_bytes(tmp_path / "jax", tmp_path / "port", ".serving")
    last = {}
    for _step, tags in events[1:]:
        last.update(tags)
    for name in ptelemetry.ServingTelemetry.COUNTERS:
        assert last["serving/%s_total" % name] == snaps[1][name], name
    assert last["serving/admitted_total"] == n


@pytest.mark.parametrize("polls", [7, 40])
def test_router_telemetry_files_equal_jax(tmp_path, pinned, polls):
    rs0 = np.random.RandomState(polls)
    script = [(int(rs0.randint(0, 4)), int(rs0.randint(0, 3)),
               float(rs0.rand() * 90)) for _ in range(polls)]
    snaps = []
    for mod, sub in ((jtelemetry, "jax"), (ptelemetry, "port")):
        clock = Clock()
        tel = mod.RouterTelemetry(log_dir=str(tmp_path / sub),
                                  flush_every=5, clock=clock)
        tel.gauge("cell_id", 1)
        tel.gauge("cells", 2)
        for i, (routed, errors, ms) in enumerate(script):
            clock.t += 0.5
            tel.count("routed", routed)
            tel.count("completed", routed)
            tel.count("errors", errors)
            tel.record_e2e(ms, trace_id="r%d" % i)
            tel.record_poll(i % 3, 3, fleet_hists={"fleet_ttft_ms": [i, 1]})
        snaps.append(tel.snapshot())
        tel.close()
    assert snaps[0] == snaps[1]
    events = same_bytes(tmp_path / "jax", tmp_path / "port", ".router")
    last = {}
    for _step, tags in events[1:]:
        last.update(tags)
    assert last["router/routed_total"] == sum(r for r, _e, _m in script)
    assert events[-1][0] == polls


GAUGE_KEYS = ("tier/host_dropped_row_updates", "fault/rpc_retries",
              "tier/host_failed_cycles", "fault/reconnects")


def _tier_reports(servicer, pb, worker_ids, multi):
    """Dispatch and report every task, each report carrying a growing
    tier/ or fault/ counter (all four when `multi`) and an unrelated
    one, the third report failed; then a late report of an unknown task
    (dropped)."""
    n = 0
    while True:
        for wid in worker_ids:
            task = servicer.get_task(pb.GetTaskRequest(worker_id=wid))
            if task.type != pb.TRAINING:
                req = pb.ReportTaskResultRequest(task_id=999)
                req.exec_counters["tier/host_failed_cycles"] = 1
                servicer.report_task_result(req)
                return n
            n += 1
            req = pb.ReportTaskResultRequest(task_id=task.task_id)
            for key in (GAUGE_KEYS if multi
                        else [GAUGE_KEYS[n % len(GAUGE_KEYS)]]):
                req.exec_counters[key] = 10 * n + len(key)
            req.exec_counters["unrelated"] = 5
            if n == 3:
                req.err_message = "boom"
            servicer.report_task_result(req)


@pytest.mark.parametrize("multi", [False, True])
def test_master_tier_gauges_equal_jax(tmp_path, pinned, multi):
    """The master servicers fed the same reports: `/worker-<id>` tags at
    each worker's report index, the unrelated and the unknown task's
    counters dropped; the same bytes. A report of several counters
    writes the same records, in the order its map yields them (a
    protobuf map's order in JAX, insertion order in the port)."""
    counts, files = [], []
    for tbs, sv, disp, pb, sub in (
            (jtbs, jservicer, jdispatch, jpb, "jax"),
            (ptbs, pservicer, pdispatch, ppb, "port")):
        random.seed(3)
        task_d = disp.TaskDispatcher({"a": (0, 32), "b": (0, 16)}, {}, {},
                                     records_per_task=8, num_epochs=1)
        tb = tbs.TensorboardService(str(tmp_path / sub))
        servicer = sv.MasterServicer(4, task_d, tensorboard_service=tb)
        counts.append(_tier_reports(servicer, pb, (0, 1), multi))
        tb.stop()
        files.append(only_file(tmp_path / sub))
    assert counts[0] == counts[1] == 7
    if multi:
        jev, events = (read_events(f) for f in files)
        assert sorted(map(repr, jev)) == sorted(map(repr, events))
        assert len(events) == 1 + 7 * len(GAUGE_KEYS)
    else:
        events = same_bytes(tmp_path / "jax", tmp_path / "port")
        assert len(events) == 1 + 7
    tags = [(st, t) for st, tg in events[1:] for t in tg]
    assert all(t.rsplit("/", 1)[1] in ("worker-0", "worker-1")
               for _s, t in tags)
    assert not any("unrelated" in t for _s, t in tags)
    for wid in (0, 1):
        steps = sorted({st for st, t in tags if t.endswith("-%d" % wid)})
        assert steps == list(range(len(steps))) and steps


# ----------------------------------------------------------- task spans


class _ScriptedDispatcher(object):
    """One task, dispatched, re-dispatched under the same id, reported."""

    def __init__(self, mod):
        self._task = mod.Task("shard", 0, 10, mod.TaskType.TRAINING)
        self.model_version = 0

    def get(self, worker_id):
        return 1, self._task

    def get_eval_task(self, worker_id):
        return -1, None

    def finished(self):
        return False

    def invoke_deferred_callback(self):
        return False

    def report(self, task_id, success, exec_counters=None):
        return 0.5, self._task, 0


def _shape(span_dicts, roots):
    """Span dicts without ids and times: the parent as an index into the
    list, the events without their stamps."""
    index = {s["span_id"]: i for i, s in enumerate(span_dicts)}
    out = []
    for s in span_dicts:
        out.append({
            "name": s["name"], "status": s["status"], "attrs": s["attrs"],
            "parent": index.get(s["parent_span_id"], None),
            "events": [(e["name"], e["attrs"]) for e in s["events"]],
            "root": s["span_id"] in roots})
    return out


def test_task_dispatch_spans_equal_jax():
    """Dispatch, re-dispatch of the same task id, a worker span under the
    second dispatch, an ok report, then a late duplicate report: the
    same span trees in both packages."""
    shapes = []
    for sv, tr, disp, pb in ((jservicer, jtracing, jdispatch, jpb),
                             (pservicer, ptracing, pdispatch, ppb)):
        rec = tr.recorder()
        rec.clear()
        servicer = sv.MasterServicer(32, _ScriptedDispatcher(disp))
        first = servicer.get_task(pb.GetTaskRequest(worker_id=0))
        second = servicer.get_task(pb.GetTaskRequest(worker_id=1))
        assert first.trace_id and second.trace_id != first.trace_id
        span = rec.start_span("worker_task", trace_id=second.trace_id,
                              parent_span_id=second.span_id,
                              task_id=second.task_id)
        span.finish("ok")
        servicer.report_task_result(pb.ReportTaskResultRequest(
            task_id=second.task_id))
        servicer.report_task_result(pb.ReportTaskResultRequest(
            task_id=second.task_id, err_message="late"))
        spans = [s.to_dict() for s in rec.snapshot()]
        roots = {s["span_id"] for s in tr.trace_roots(spans)}
        shapes.append(_shape(spans, roots))
        rec.clear()
    assert shapes[0] == shapes[1]
    statuses = sorted((s["name"], s["status"]) for s in shapes[1])
    assert statuses == [("task_dispatch", "ok"),
                        ("task_dispatch", "redispatched"),
                        ("worker_task", "ok")]


def test_worker_task_spans_parent_under_dispatch(tmp_path):
    """The port's Worker over its in-process Master on a small job: each
    dispatched task has one task_dispatch span sealed ok and exactly one
    worker_task child with its task id, fetched and reported events."""
    data = MW._tokens(str(tmp_path / "train"))
    rec = ptracing.recorder()
    rec.clear()
    random.seed(0)
    master = Master(load_model_spec_from_module(tzoo), training_data=data,
                    minibatch_size=MW.MINIBATCH,
                    records_per_task=MW.PER_TASK)
    worker = Worker(0, load_model_spec_from_module(tzoo),
                    master_servicer=master.servicer,
                    minibatch_size=MW.MINIBATCH, training_data=data,
                    model_params=T.PARAMS, wait_sleep_secs=0.01,
                    device="cpu")
    worker.run()
    assert master.task_d.finished() and worker.job_complete
    spans = [s.to_dict() for s in rec.snapshot()]
    rec.clear()
    dispatch = [s for s in spans if s["name"] == "task_dispatch"]
    tasks = [s for s in spans if s["name"] == "worker_task"]
    assert len(dispatch) == len(tasks) == 4  # 2 files x 16 / 8
    for d in dispatch:
        assert d["status"] == "ok" and d["attrs"]["worker_id"] == 0
        kids = [t for t in tasks if t["parent_span_id"] == d["span_id"]]
        assert len(kids) == 1
        kid = kids[0]
        assert kid["trace_id"] == d["trace_id"] and kid["status"] == "ok"
        assert kid["attrs"]["task_id"] == d["attrs"]["task_id"]
        assert [e["name"] for e in kid["events"]] == ["fetched", "reported"]
        assert kid["events"][0]["attrs"]["end"] == (
            kid["events"][0]["attrs"]["start"] + MW.PER_TASK)
        # the worker seals its span once the report's RPC has returned
        assert d["start"] <= kid["start"] <= d["end"] <= kid["end"]


# -------------------------------------------------------------- entries


@pytest.mark.parametrize("entry", ["serving", "router", "master", "client"])
def test_tensorboard_flags_parse_as_jax(entry, tmp_path):
    tb = ["--tensorboard_log_dir", str(tmp_path)]
    if entry == "serving":
        zoo = ["--model_zoo", "model_zoo", "--model_def",
               "transformer_lm.transformer_lm.custom_model"]
        got = pserving_main.parse_serving_args(zoo + tb)
        want = jserving_main.parse_serving_args(zoo + tb)
        assert got.tensorboard_log_dir == want.tensorboard_log_dir
        return
    if entry == "router":
        argv = ["--replica", "localhost:1"] + tb
        assert vars(prouter_main.parse_router_args(argv)) == vars(
            jrouter_main.parse_router_args(argv))
        return
    base = ["--model_zoo", "z", "--model_def", "m.f", "--need_tensorboard"]
    if entry == "master":
        got = vars(pargs.parse_master_args(base + tb))
        assert got.pop("device") == "cuda"
        assert got == vars(jargs.parse_master_args(base + tb))
        assert got["need_tensorboard"] is True
        return
    parser = client_main.build_argument_parser()
    args, _extra = parser.parse_known_args(
        ["train", "--training_data", str(tmp_path)] + base + tb)
    assert args.need_tensorboard and args.tensorboard_log_dir == str(
        tmp_path)
