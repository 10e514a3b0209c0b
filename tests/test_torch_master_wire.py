"""The port's control plane against the JAX package's, without a model.

* wire: every Master message the port encodes parses in protobuf
  (elasticdl_pb2) to the same fields, and every message protobuf
  encodes parses in the port to the same fields; the bytes are equal
  for the messages without maps (map entries may come in any order, so
  maps are compared after parsing). The cases hold maps, negative int32
  and int64, empty and default fields and a bytes field of over 1 MB;
  unknown fields of every wire type are skipped as protobuf skips them,
  and malformed bytes raise in both;
* transport: a fake servicer served over the port's HTTP transport
  answers the five methods; a call to a stopped server is UNAVAILABLE,
  one past its deadline DEADLINE_EXCEEDED, one whose handler raises
  UNKNOWN (and is not retried), one over the size cap
  RESOURCE_EXHAUSTED, and an injected drop reaches the client with its
  code; the retry classifiers agree with the JAX package's on every
  status code;
* arguments: parsed flags serialize to the command lines JAX's
  build_arguments_from_parsed_result gives, flags the port does not
  honour raise, and --device defaults to cuda.
"""

import argparse
import os
import socket
import struct
import threading
import time

import grpc
import numpy as np
import pytest

from elasticdl_tpu.common import args as jargs
from elasticdl_tpu.common import retry as jretry
from elasticdl_tpu.common.fault_injection import (
    InjectedRpcError as JInjectedRpcError,
)
from elasticdl_tpu.proto import elasticdl_pb2 as jpb
from elasticdl_tpu_torch.common import args as pargs
from elasticdl_tpu_torch.common import retry
from elasticdl_tpu_torch.common.fault_injection import (
    FaultInjectingServicer,
    FaultInjector,
    InjectedRpcError,
)
from elasticdl_tpu_torch.common.tensor_utils import serialize_ndarray_dict
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.proto import service

BIG = serialize_ndarray_dict({"output": np.random.RandomState(0).randn(
    300_000).astype(np.float32)})  # 1.2 MB

CASES = [
    ("Task", dict(task_id=7, shard_name="/data/t-0.trec", start=0,
                  end=1 << 40, type=pb.EVALUATION, model_version=3,
                  minibatch_size=8, reason=pb.JOB_COMPLETE,
                  trace_id="abc", span_id="déf",
                  extended_config={"a": "1", "": "", "kü": "ß"})),
    ("Task", dict(task_id=-(1 << 31), start=-1, end=-(1 << 63),
                  model_version=(1 << 31) - 1, type=pb.TRAINING)),
    ("Task", dict(type=pb.NONE, reason=pb.JOB_COMPLETE)),
    ("Task", dict()),
    ("GetTaskRequest", dict(worker_id=3, task_type=pb.WAIT)),
    ("GetTaskRequest", dict(worker_id=-5)),
    ("ReportTaskResultRequest", dict(
        task_id=5, err_message="boom",
        exec_counters={"fail_count": 3, "x": -7, "zero": 0})),
    ("ReportTaskResultRequest", dict(task_id=1)),
    ("ReportEvaluationMetricsRequest", dict(
        worker_id=2, model_version=-1, model_outputs=BIG,
        labels=b"\x00\xff" * 8)),
    ("ReportVersionRequest", dict(worker_id=1, model_version=-1)),
    ("Empty", dict()),
    ("RegisterWorkerRequest", dict(worker_id=0, address="host:1",
                                   num_devices=8)),
    ("RegisterWorkerResponse", dict(cluster_version=(1 << 31) - 1)),
]
MAP_FIELDS = {"extended_config", "exec_counters"}


def _fields(msg, cls):
    return {name: (dict(getattr(msg, name)) if name in MAP_FIELDS
                   else getattr(msg, name))
            for name, _n, _k in cls.FIELDS}


@pytest.mark.parametrize("name,kwargs", CASES,
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(CASES)])
def test_messages_round_trip_with_protobuf(name, kwargs):
    ours_cls, ref_cls = getattr(pb, name), getattr(jpb, name)
    ours, ref = ours_cls(**kwargs), ref_cls(**kwargs)
    expected = _fields(ours, ours_cls)
    ours_bytes, ref_bytes = ours.SerializeToString(), ref.SerializeToString()
    assert _fields(ref_cls.FromString(ours_bytes), ours_cls) == expected
    assert _fields(ours_cls.FromString(ref_bytes), ours_cls) == expected
    if not MAP_FIELDS & {k for k, v in kwargs.items() if v}:
        assert ours_bytes == ref_bytes
    else:
        assert len(ours_bytes) == len(ref_bytes)
    assert ours_cls.FromString(ours_bytes) == ours
    if "task_id" in kwargs and kwargs["task_id"] < 0:
        # a negative int32 is the 10-byte varint of its 64-bit form
        assert ours_bytes[:11] == b"\x08" + b"\x80\x80\x80\x80\xf8" \
            b"\xff\xff\xff\xff\x01"


def test_unknown_fields_are_skipped_and_bad_bytes_raise():
    known = jpb.Task(task_id=4, shard_name="s", end=9).SerializeToString()
    unknown = (b"\xb8\x06\x96\x01"  # 103: varint
               b"\xc1\x06" + b"\x01" * 8 +  # 104: fixed64
               b"\xca\x06\x03abc"  # 105: length-delimited
               b"\xd5\x06" + b"\x02" * 4 +  # 106: fixed32
               b"\xdb\x06\x08\x01\xdc\x06")  # 107: a group holding a varint
    data = unknown + known + unknown
    ref = jpb.Task.FromString(data)
    ours = pb.Task.FromString(data)
    assert _fields(ours, pb.Task) == _fields(ref, pb.Task)
    assert ours.task_id == 4 and ours.end == 9
    # a repeated scalar keeps its last value, map entries merge
    assert pb.Task.FromString(b"\x08\x01\x08\x02").task_id == 2
    two = (pb.ReportTaskResultRequest(exec_counters={"a": 1}).
           SerializeToString() + pb.ReportTaskResultRequest(
               exec_counters={"a": 2, "b": 3}).SerializeToString())
    assert pb.ReportTaskResultRequest.FromString(two).exec_counters == dict(
        jpb.ReportTaskResultRequest.FromString(two).exec_counters) == {
            "a": 2, "b": 3}
    for bad in (b"\x08", b"\x12\x05ab", b"\x12\x02\xff\xfe", b"\x0b",
                b"\x08" + b"\xff" * 11):
        with pytest.raises(Exception):
            jpb.Task.FromString(bad)
        with pytest.raises(pb.DecodeError):
            pb.Task.FromString(bad)
    with pytest.raises(ValueError):
        pb.Task(task_id=1 << 31)
    with pytest.raises(ValueError):
        jpb.Task(task_id=1 << 31)
    with pytest.raises(TypeError):
        pb.Task(shard_name=b"bytes")
    with pytest.raises(AttributeError):
        pb.Task(no_such_field=1)


def test_enums_match_protobuf():
    for enum in ("TaskType", "TaskReason"):
        ours, ref = getattr(pb, enum), getattr(jpb, enum)
        assert [(n, v) for n, v in ours._VALUES] == list(ref.items())
        for n, v in ref.items():
            assert getattr(pb, n) == getattr(jpb, n) == v
            assert ours.Name(v) == ref.Name(v) and ours.Value(n) == v
    assert len(pb.MESSAGES) == 8
    assert service.SERVICE_NAME == "elasticdl_tpu.Master"
    from elasticdl_tpu.proto import service as jservice

    assert {k: (a.__name__, b.__name__)
            for k, (a, b) in service._METHODS.items()} == {
        k: (a.__name__, b.__name__)
        for k, (a, b) in jservice._METHODS.items()}


# ------------------------------------------------------------ transport


class _FakeMasterServicer(object):
    """Answers the five methods; `slow` holds get_task on an event (at
    most 5 s), and report_version raises for a negative version."""

    def __init__(self):
        self.calls = []
        self.release = threading.Event()
        self.slow = False

    def get_task(self, request, _context=None):
        self.calls.append(("get_task", request.worker_id))
        if self.slow:
            self.release.wait(timeout=5)
        return pb.Task(task_id=request.worker_id + 1, shard_name="s",
                       start=0, end=-3, type=request.task_type,
                       extended_config={"w": str(request.worker_id)})

    def report_task_result(self, request, _context=None):
        self.calls.append(("report_task_result",
                           dict(request.exec_counters)))
        return pb.Empty()

    def report_evaluation_metrics(self, request, _context=None):
        self.calls.append(("report_evaluation_metrics",
                           len(request.model_outputs)))
        return pb.Empty()

    def report_version(self, request, _context=None):
        self.calls.append(("report_version", request.model_version))
        if request.model_version < 0:
            raise RuntimeError("negative version %d"
                               % request.model_version)
        return pb.Empty()

    def register_worker(self, request, _context=None):
        self.calls.append(("register_worker", request.address))
        return pb.RegisterWorkerResponse(cluster_version=9)


def _serve(servicer, **limits):
    server = service.build_server(**limits)
    service.add_master_servicer_to_server(servicer, server)
    port = server.add_insecure_port("[::]:0")
    server.start()
    return server, port


def _code(fn):
    with pytest.raises(service.RpcError) as err:
        fn()
    return err.value.code(), err.value.details()


def test_unary_reply_to_a_client_that_hung_up_is_quiet(capfd):
    """A client resets its connection while a unary handler runs: the
    reply's failed write leaves no traceback on stderr, and the next
    call is served."""
    fake = _FakeMasterServicer()
    fake.slow = True
    server, port = _serve(fake)
    try:
        body = pb.GetTaskRequest(worker_id=7).SerializeToString()
        sock = socket.create_connection(("localhost", port), timeout=5)
        sock.sendall(b"POST /%s/get_task HTTP/1.0\r\nContent-Length: %d"
                     b"\r\n\r\n" % (service.SERVICE_NAME.encode(),
                                    len(body)) + body)
        deadline = time.monotonic() + 5
        while not fake.calls and time.monotonic() < deadline:
            time.sleep(0.01)
        assert fake.calls == [("get_task", 7)]
        # a reset, not a FIN: the reply's first write fails
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
        sock.close()
        fake.slow = False
        fake.release.set()
        stub = service.MasterStub(service.build_channel("localhost:%d"
                                                        % port))
        task = stub.get_task(pb.GetTaskRequest(worker_id=4), timeout=5)
        assert task.task_id == 5
        time.sleep(0.3)  # the hung-up call's handler thread ends
    finally:
        server.stop(0)
    err = capfd.readouterr().err
    assert "Traceback" not in err and "Error" not in err, err


def test_transport_answers_and_classifies_failures():
    fake = _FakeMasterServicer()
    server, port = _serve(fake, max_receive_message_length=1 << 16)
    channel = service.build_channel("localhost:%d" % port)
    try:
        stub = service.MasterStub(channel)
        task = stub.get_task(pb.GetTaskRequest(worker_id=4,
                                               task_type=pb.EVALUATION),
                             timeout=5)
        assert (task.task_id, task.end, task.type, task.extended_config) \
            == (5, -3, pb.EVALUATION, {"w": "4"})
        stub.report_task_result(pb.ReportTaskResultRequest(
            task_id=1, exec_counters={"fail_count": 2}), timeout=5)
        stub.report_evaluation_metrics(pb.ReportEvaluationMetricsRequest(
            model_outputs=b"x" * 1000), timeout=5)
        stub.report_version(pb.ReportVersionRequest(model_version=3),
                            timeout=5)
        resp = stub.register_worker(pb.RegisterWorkerRequest(address="a"),
                                    timeout=5)
        assert resp == pb.RegisterWorkerResponse(cluster_version=9)
        assert [c[0] for c in fake.calls] == [
            "get_task", "report_task_result", "report_evaluation_metrics",
            "report_version", "register_worker"]
        assert fake.calls[1][1] == {"fail_count": 2}
        # a handler that raises: UNKNOWN, with gRPC's message, not retried
        code, details = _code(lambda: stub.report_version(
            pb.ReportVersionRequest(model_version=-1), timeout=5))
        assert code == "UNKNOWN" and "negative version -1" in details
        assert details.startswith("Exception calling application")
        tries = []

        def once():
            tries.append(1)
            return stub.report_version(
                pb.ReportVersionRequest(model_version=-2), timeout=5)

        with pytest.raises(service.RpcError):
            retry.retry_call(once, retry.RetryPolicy(base_delay_secs=0.001))
        assert len(tries) == 1
        # over the server's receive cap
        code, _ = _code(lambda: stub.report_evaluation_metrics(
            pb.ReportEvaluationMetricsRequest(model_outputs=b"x" * 70000),
            timeout=5))
        assert code == "RESOURCE_EXHAUSTED"
        # over the client's send cap: never sent
        small = service.MasterStub(service.build_channel(
            "localhost:%d" % port, max_send_message_length=100))
        n = len(fake.calls)
        code, _ = _code(lambda: small.report_evaluation_metrics(
            pb.ReportEvaluationMetricsRequest(model_outputs=b"x" * 200),
            timeout=5))
        assert code == "RESOURCE_EXHAUSTED" and len(fake.calls) == n
        # past the call's deadline
        fake.slow = True
        code, _ = _code(lambda: stub.get_task(pb.GetTaskRequest(),
                                              timeout=0.2))
        assert code == "DEADLINE_EXCEEDED"
        fake.release.set()
        # an injected fault reaches the client with its code
        server.stop(grace=1.0)
        injector = FaultInjector(
            spec="get_task:drop:1;report_version:error:1:code=ABORTED")
        server, port = _serve(FaultInjectingServicer(fake, injector))
        stub = service.MasterStub(service.build_channel(
            "localhost:%d" % port))
        fake.slow = False
        assert _code(lambda: stub.get_task(pb.GetTaskRequest(),
                                           timeout=5))[0] == "UNAVAILABLE"
        assert stub.get_task(pb.GetTaskRequest(), timeout=5).task_id == 1
        assert _code(lambda: stub.report_version(
            pb.ReportVersionRequest(model_version=1), timeout=5))[0] \
            == "ABORTED"
        assert fake.calls[-1] == ("report_version", 1)  # the handler ran
        # unknown method
        assert _code(lambda: service.Channel(
            "localhost:%d" % port).call("/elasticdl_tpu.Master/nope", b"",
                                        timeout=5))[0] == "UNIMPLEMENTED"
    finally:
        channel.close()
        server.stop(grace=1.0)
    # the server is gone
    code, _ = _code(lambda: stub.get_task(pb.GetTaskRequest(), timeout=5))
    assert code == "UNAVAILABLE"
    assert retry.is_transient_rpc_error(
        service.RpcError(code)) and not retry.is_transient_rpc_error(
            service.RpcError("UNKNOWN"))


@pytest.mark.parametrize("code", service.STATUS_CODES)
def test_retry_classifiers_match_jax(code):
    ours = service.RpcError(code, "x")
    injected = InjectedRpcError(code, "x")
    ref = JInjectedRpcError(getattr(grpc.StatusCode, code), "x")
    for fn in ("is_transient_rpc_error", "is_backpressure_rpc_error",
               "is_retryable_rpc_error"):
        expected = getattr(jretry, fn)(ref)
        assert getattr(retry, fn)(ours) == expected, (fn, code)
        assert getattr(retry, fn)(injected) == expected, (fn, code)
        assert not getattr(retry, fn)(RuntimeError(code))


def test_retry_call_gives_up_after_the_window():
    clock = [0.0]
    sleeps = []

    def sleep(s):
        sleeps.append(s)
        clock[0] += s + 1.0

    def fail():
        raise service.RpcError("UNAVAILABLE", "down")

    policy = retry.RetryPolicy(base_delay_secs=0.5, max_delay_secs=1.0,
                               reconnect_window_secs=5.0)
    with pytest.raises(service.RpcError):
        retry.retry_call(fail, policy, sleep=sleep, clock=lambda: clock[0])
    assert 2 <= len(sleeps) <= 5 and all(0 <= s <= 1.0 for s in sleeps)
    assert policy.backoff(10) <= 1.0


# ------------------------------------------------------------ arguments


def _client_parser(pkg):
    parser = argparse.ArgumentParser()
    pkg.add_common_params(parser)
    pkg.add_master_params(parser)
    return parser


ARGV = ["--model_zoo", "zoo", "--model_def", "transformer_lm.custom_model",
        "--model_params", "vocab_size=32; dtype='bf16'",
        "--minibatch_size", "8", "--num_epochs", "2",
        "--records_per_task", "16", "--training_data", "/d/train",
        "--validation_data", "/d/val", "--evaluation_steps", "2",
        "--checkpoint_dir", "/c k", "--checkpoint_steps", "2",
        "--num_workers", "2", "--port", "0", "--disable_relaunch",
        "--job_status_file", "/s.json", "--seed", "3"]


def test_arguments_round_trip_against_jax():
    ours = _client_parser(pargs).parse_args(ARGV)
    ref = _client_parser(jargs).parse_args(ARGV)
    assert ours.device == "cuda"
    mine = pargs.build_arguments_from_parsed_result(
        ours, filter_args=pargs.MASTER_ONLY_ARGS)
    theirs = jargs.build_arguments_from_parsed_result(
        ref, filter_args=jargs.MASTER_ONLY_ARGS)
    # the same command line, plus the port's --device
    i = mine.index("--device")
    assert mine[i + 1] == "cuda" and mine[:i] + mine[i + 2:] == theirs
    assert pargs.MASTER_ONLY_ARGS == jargs.MASTER_ONLY_ARGS
    line = pargs.wrap_args_with_string(mine)
    assert line == jargs.wrap_args_with_string(mine) and "'/c k'" in line
    master = pargs.parse_master_args(pargs.build_arguments_from_parsed_result(
        ours))
    assert vars(master) == vars(ours)
    worker = pargs.parse_worker_args(mine + ["--worker_id", "1",
                                             "--master_addr", "h:1"])
    assert worker.device == "cuda" and worker.model_params == \
        "vocab_size=32; dtype='bf16'"
    for spec in ("cpu=1,memory=4096Mi", "", " a = b ,"):
        assert pargs.parse_resource_spec(spec) == \
            jargs.parse_resource_spec(spec)


@pytest.mark.parametrize("flag", [
    ["--worker_image", "img"], ["--need_tensorboard"],
    ["--distribution_strategy", "AllreduceStrategy"],
    ["--mesh_spec", "sp=2"], ["--metrics_port", "0"], "env"])
def test_unhonoured_flags_raise(flag, monkeypatch):
    base = ["--model_zoo", "z", "--model_def", "m.f"]
    if flag == "env" or flag[0] in ("--metrics_port", "--need_tensorboard"):
        # the master's /metrics exposition and TensorBoard service are
        # ported: the flags and the environment parse as JAX's do
        # (master/main.py serves them)
        if flag == "env":
            monkeypatch.setenv(pargs.METRICS_PORT_ENV, "9100")
            flag = []
        args = vars(pargs.parse_master_args(base + flag))
        assert args.pop("device") == "cuda"  # the port's one addition
        assert args == vars(jargs.parse_master_args(base + flag))
        monkeypatch.delenv(pargs.METRICS_PORT_ENV, raising=False)
        return
    monkeypatch.delenv(pargs.METRICS_PORT_ENV, raising=False)
    with pytest.raises(NotImplementedError):
        pargs.parse_master_args(base + flag)
    if flag and flag[0] in ("--distribution_strategy", "--mesh_spec"):
        with pytest.raises(NotImplementedError):
            pargs.parse_worker_args(base + flag + ["--worker_id", "0",
                                                   "--master_addr", "h:1"])
    monkeypatch.delenv(pargs.METRICS_PORT_ENV, raising=False)
    assert pargs.parse_master_args(base).device == "cuda"


def test_cli_refuses_what_is_not_ported(tmp_path):
    from elasticdl_tpu_torch.client import main as client_main

    base = ["--model_zoo", "z", "--model_def", "m.f",
            "--training_data", str(tmp_path)]
    with pytest.raises(NotImplementedError):
        client_main.main(["train", "--image_name", "img"] + base)
    for cmd in (["zoo", "init"], ["zoo", "build"], ["zoo", "push"]):
        with pytest.raises(NotImplementedError):
            client_main.main(cmd)
    with pytest.raises(ValueError):
        client_main.main(["evaluate"] + base)
    from elasticdl_tpu_torch.data.reader import data_reader_factory as f

    csv_dir = tmp_path / "csv"
    csv_dir.mkdir()
    (csv_dir / "a.csv").write_text("x\n1\n")
    with pytest.raises(NotImplementedError):
        f.create_data_reader(str(tmp_path), 8, reader_type="ODPS")
    # the CSV reader is ported: a .csv directory and reader_type="CSV"
    # both build it, as the JAX factory does
    from elasticdl_tpu_torch.data.reader.csv_reader import CSVDataReader

    for origin, kw in ((str(csv_dir), {}), (str(csv_dir), {
            "reader_type": "CSV"})):
        reader = f.create_data_reader(origin, 8, **kw)
        assert isinstance(reader, CSVDataReader)
        assert reader.create_shards() == {str(csv_dir / "a.csv"): (0, 1)}
    with pytest.raises(ValueError):
        f.create_data_reader(str(tmp_path), 8, reader_type="Parquet")
    reader = f.build_data_reader(str(tmp_path), 8, "reader_type='RecordIO'")
    assert reader.create_shards() == {} and os.path.isdir(str(tmp_path))
