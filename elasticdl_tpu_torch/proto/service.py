"""The Master, Serving and Router services over a transport from the
standard library: the port's copy of elasticdl_tpu/proto/service.py
without gRPC.

The JAX package binds the services' method tables to grpc. The card's
machine has neither grpc nor protobuf, so the port carries the same
messages (proto/messages.py, the proto3 wire format by hand) over
HTTP/1.0 on a TCP socket:

* one call is `POST /<service>/<method>` whose body is the encoded
  request; a 200 reply carries the encoded response, one connection
  per call;
* a failed call replies with HTTP status 500, the gRPC status name in
  the `X-Rpc-Status` header and the details as the body; the stub
  raises `RpcError`, whose `code()` is that name (a string:
  "UNAVAILABLE", ...), so common/retry.py classifies it as the JAX
  package classifies `grpc.RpcError`:

    connection refused / reset / closed   UNAVAILABLE
    socket timeout (the call's deadline)  DEADLINE_EXCEEDED
    a handler that raises                 UNKNOWN, "Exception calling
                                          application: <message>"
    a handler that raises an RpcError     its own code (the fault
    (an injected fault)                   injector's drop / error)
    a handler that raises an              its own code (the serving
    AdmissionError                        servicer's RESOURCE_EXHAUSTED,
                                          INVALID_ARGUMENT, ...), as
                                          the JAX servicer aborts
    a body over the size cap              RESOURCE_EXHAUSTED
    a request that does not parse         INTERNAL
    an unknown method                     UNIMPLEMENTED

* a server-streaming method (`generate_stream`,
  `router_generate_stream`) replies 200 with the
  `X-Rpc-Stream` header and no Content-Length (the body ends when the
  server closes the connection); the body is a run of frames, each a
  1-byte kind, a 4-byte big-endian length and the payload: kind 0 an
  encoded response message, kind 1 the trailer, "<status name>\n
  <details>", always the last frame. The client yields the messages
  and then raises RpcError with the trailer's status unless it is OK,
  after the messages already sent, as gRPC does; a connection that
  closes before the trailer is UNAVAILABLE. A failure before the
  handler's first message (its admission) is the unary error reply; an
  exception the handler's iterator raises later ends the stream in a
  trailer with that exception's code (an AdmissionError's own, a
  router's UNAVAILABLE after a replica lost mid-stream), and a client
  that hangs up closes the iterator at the next frame.
  Each frame is one write on a socket with TCP_NODELAY set at both
  ends, so a small frame is not held back for an ACK;
* `timeout=` on a stub call is the call's deadline: connect, send and
  each read get the time left, and a call past it raises
  DEADLINE_EXCEEDED (for a stream: at the read that passes it);
* bodies and stream frames are bounded by GRPC.MAX_SEND_MESSAGE_LENGTH
  / MAX_RECEIVE_MESSAGE_LENGTH (256 MB), as the JAX channel and server
  options bound them; a server drains an oversized body before it
  answers, so the client reads the answer and not a reset;
* the server answers each connection on a daemon thread of its own and
  runs at most `max_workers` handlers at once (the JAX package's
  ThreadPoolExecutor(max_workers)): a call beyond the bound waits for
  a handler to finish, it is not refused; `add_insecure_port("[::]:0")`
  binds an ephemeral port on every IPv4 interface and returns the
  bound one; `stop(grace)` waits up to `grace` seconds for the calls
  in flight and then closes their connections.

A request is only ever parsed by its message class's `FromString`:
nothing on this path unpickles or evaluates what a client sent. The
Serving table holds one replica's methods, the disaggregated chain
handoff's three among them (export_chain, whose response is the
TransferChainRequest payload the decode side imports, transfer_chain
and abort_transfer). The Router table (`router_generate`, the streamed
`router_generate_stream`, `router_status`; serving/router.py) is a
service of its own: a replica's server does not serve it, so a call to
one of its methods there answers UNIMPLEMENTED.
"""

import contextlib
import http.client
import http.server
import logging
import socket
import struct
import threading
import time

from elasticdl_tpu_torch.common.constants import GRPC
from elasticdl_tpu_torch.proto import messages as pb
from elasticdl_tpu_torch.serving.admission import AdmissionError

logger = logging.getLogger(__name__)

SERVICE_NAME = "elasticdl_tpu.Master"
SERVING_SERVICE_NAME = "elasticdl_tpu.Serving"
ROUTER_SERVICE_NAME = "elasticdl_tpu.Router"

# method name -> (request class, response class)
_METHODS = {
    "get_task": (pb.GetTaskRequest, pb.Task),
    "report_task_result": (pb.ReportTaskResultRequest, pb.Empty),
    "report_evaluation_metrics": (
        pb.ReportEvaluationMetricsRequest,
        pb.Empty,
    ),
    "report_version": (pb.ReportVersionRequest, pb.Empty),
    "register_worker": (
        pb.RegisterWorkerRequest,
        pb.RegisterWorkerResponse,
    ),
}

# method name -> (request class, response class, server-streaming?)
_SERVING_METHODS = {
    "generate": (pb.GenerateRequest, pb.GenerateResponse, False),
    "generate_stream": (pb.GenerateRequest, pb.TokenChunk, True),
    "server_status": (
        pb.ServerStatusRequest,
        pb.ServerStatusResponse,
        False,
    ),
    # disaggregated prefill/decode handoff (serving/disagg.py)
    "export_chain": (
        pb.ExportChainRequest,
        pb.TransferChainRequest,
        False,
    ),
    "transfer_chain": (
        pb.TransferChainRequest,
        pb.TransferChainResponse,
        False,
    ),
    "abort_transfer": (
        pb.AbortTransferRequest,
        pb.TransferChainResponse,
        False,
    ),
    "reload_checkpoint": (
        pb.ReloadCheckpointRequest,
        pb.ReloadCheckpointResponse,
        False,
    ),
}

# the routing tier's surface (serving/router.py); its names differ from
# the replica's, so a fault-injection spec targets one boundary only
_ROUTER_METHODS = {
    "router_generate": (pb.GenerateRequest, pb.GenerateResponse, False),
    "router_generate_stream": (pb.GenerateRequest, pb.TokenChunk, True),
    "router_status": (
        pb.RouterStatusRequest,
        pb.RouterStatusResponse,
        False,
    ),
}

#: gRPC's status names (grpc.StatusCode), the codes an RpcError carries
STATUS_CODES = (
    "OK", "CANCELLED", "UNKNOWN", "INVALID_ARGUMENT", "DEADLINE_EXCEEDED",
    "NOT_FOUND", "ALREADY_EXISTS", "PERMISSION_DENIED", "RESOURCE_EXHAUSTED",
    "FAILED_PRECONDITION", "ABORTED", "OUT_OF_RANGE", "UNIMPLEMENTED",
    "INTERNAL", "UNAVAILABLE", "DATA_LOSS", "UNAUTHENTICATED",
)

_STATUS_HEADER = "X-Rpc-Status"
_STREAM_HEADER = "X-Rpc-Stream"
_DRAIN_CHUNK = 1 << 20
_FRAME = struct.Struct(">BI")  # kind, payload length
_MESSAGE, _TRAILER = 0, 1


class RpcError(Exception):
    """A failed call: `code()` is the gRPC status name, `details()` the
    message."""

    def __init__(self, code, details=""):
        super().__init__(details)
        self._code = code
        self._details = details

    def code(self):
        return self._code

    def details(self):
        return self._details

    def __str__(self):
        return "RpcError(%s, %r)" % (self._code, self._details)


def status_name(exc):
    """The status name an RpcError or an AdmissionError carries, or
    None for other exceptions."""
    if isinstance(exc, RpcError):
        return exc.code()
    if isinstance(exc, AdmissionError):
        return exc.code
    return None


def _error_status(exc, prefix):
    """(status name, details) the transport answers a handler's
    exception with."""
    code = status_name(exc)
    if code in STATUS_CODES and code != "OK":
        return code, (exc.details() if isinstance(exc, RpcError)
                      else str(exc))
    return "UNKNOWN", "%s: %s" % (prefix, exc)


def _nodelay(sock):
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:  # not a TCP socket
        pass


def _split_address(addr):
    host, _, port = addr.rpartition(":")
    host = host.strip("[]")
    if host in ("", "::", "0.0.0.0"):
        host = "0.0.0.0"
    elif host == "localhost":
        # the server binds IPv4: skip the refused ::1 attempt
        host = "127.0.0.1"
    return host, int(port)


# ------------------------------------------------------------- server


class _Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.0"

    def setup(self):
        _nodelay(self.request)
        super().setup()

    def log_message(self, fmt, *args):
        logger.debug("rpc %s: " + fmt, self.address_string(), *args)

    def _reply(self, code, body):
        """One unary answer. A client that hung up before it is a debug
        line, as a mid-stream hang-up is; every other error propagates."""
        try:
            self.send_response(200 if code == "OK" else 500)
            self.send_header(_STATUS_HEADER, code)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except OSError as e:
            logger.debug("rpc %s: the client hung up before the reply (%s)",
                         self.path, e)

    def _fail(self, code, details):
        self._reply(code, details.encode("utf-8", "replace"))

    def _drain(self, n):
        while n > 0:
            got = self.rfile.read(min(n, _DRAIN_CHUNK))
            if not got:
                return
            n -= len(got)

    def do_POST(self):
        rpc = self.server.rpc
        length = int(self.headers.get("Content-Length") or 0)
        method = rpc.handlers.get(self.path)
        if length > rpc.max_receive:
            self._drain(length)
            self._fail("RESOURCE_EXHAUSTED",
                       "Received message larger than max (%d vs. %d)"
                       % (length, rpc.max_receive))
            return
        body = self.rfile.read(length) if length else b""
        if method is None:
            self._fail("UNIMPLEMENTED", "Method not found: %s" % self.path)
            return
        fn, req_cls, streaming = method
        try:
            request = req_cls.FromString(body)
        except Exception as e:  # noqa: BLE001 - answered as INTERNAL
            self._fail("INTERNAL", "Exception deserializing request: %s"
                       % e)
            return
        with rpc.worker_slot():
            try:
                response = fn(request, None)
            except Exception as e:  # noqa: BLE001 - every failure answered
                code, details = _error_status(
                    e, "Exception calling application")
                if code == "UNKNOWN":
                    logger.exception("rpc %s raised", self.path)
                self._fail(code, details)
                return
            if streaming:
                self._stream(response)
                return
        out = response.SerializeToString()
        if len(out) > rpc.max_send:
            self._fail("RESOURCE_EXHAUSTED",
                       "Sent message larger than max (%d vs. %d)"
                       % (len(out), rpc.max_send))
            return
        self._reply("OK", out)

    def _frame(self, kind, payload):
        self.wfile.write(_FRAME.pack(kind, len(payload)) + payload)

    def _stream(self, responses):
        """Write `responses` as message frames, then the trailer. A
        client that hung up ends the stream (the iterator is closed)."""
        self.send_response(200)
        self.send_header(_STATUS_HEADER, "OK")
        self.send_header(_STREAM_HEADER, "frames")
        self.send_header("Content-Type", "application/octet-stream")
        self.end_headers()
        code, details = "OK", ""
        max_send = self.server.rpc.max_send
        try:
            for response in responses:
                out = response.SerializeToString()
                if len(out) > max_send:
                    code, details = ("RESOURCE_EXHAUSTED",
                                     "Sent message larger than max (%d "
                                     "vs. %d)" % (len(out), max_send))
                    break
                try:
                    self._frame(_MESSAGE, out)
                except OSError as e:
                    logger.debug("rpc %s: the client hung up mid-stream "
                                 "(%s)", self.path, e)
                    return
        except Exception as e:  # noqa: BLE001 - ends in the trailer
            code, details = _error_status(e, "Exception iterating "
                                             "responses")
            if code == "UNKNOWN":
                logger.exception("rpc %s raised mid-stream", self.path)
        finally:
            close = getattr(responses, "close", None)
            if close is not None:
                close()
        try:
            self._frame(_TRAILER, ("%s\n%s" % (code, details)).encode(
                "utf-8", "replace"))
        except OSError:
            pass


class _HTTPServer(http.server.ThreadingHTTPServer):
    daemon_threads = True
    block_on_close = False
    # the listen backlog: socketserver's 5 resets connections of a burst
    # of concurrent calls before the accept loop reaches them
    request_queue_size = 128

    def __init__(self, address, rpc):
        self.rpc = rpc
        super().__init__(address, _Handler)

    def process_request_thread(self, request, client_address):
        with self.rpc.connection(request):
            super().process_request_thread(request, client_address)


class Server(object):
    """The gRPC server's surface the master and the replica use:
    `add_insecure_port`, `start`, `stop(grace)`; at most `max_workers`
    handlers run at once."""

    def __init__(self,
                 max_send_message_length=GRPC.MAX_SEND_MESSAGE_LENGTH,
                 max_receive_message_length=GRPC.MAX_RECEIVE_MESSAGE_LENGTH,
                 max_workers=None):
        # "/service/method" -> (fn, request class, server-streaming?)
        self.handlers = {}
        self.max_send = max_send_message_length
        self.max_receive = max_receive_message_length
        self._workers = (threading.BoundedSemaphore(int(max_workers))
                         if max_workers else None)
        self._httpd = None
        self._thread = None
        self._live = set()  # sockets of the connections being answered
        self._live_cv = threading.Condition()

    def add_handlers(self, service_name, methods, servicer):
        for name, spec in methods.items():
            self.handlers["/%s/%s" % (service_name, name)] = (
                getattr(servicer, name), spec[0],
                bool(spec[2]) if len(spec) > 2 else False)

    @contextlib.contextmanager
    def worker_slot(self):
        """Hold one of the `max_workers` handler slots (waiting for
        one) while a handler runs."""
        if self._workers is None:
            yield
            return
        self._workers.acquire()
        try:
            yield
        finally:
            self._workers.release()

    @contextlib.contextmanager
    def connection(self, sock):
        with self._live_cv:
            self._live.add(sock)
        try:
            yield
        finally:
            with self._live_cv:
                self._live.discard(sock)
                self._live_cv.notify_all()

    def add_insecure_port(self, address):
        """Bind `host:port` (port 0: an ephemeral one); returns the
        bound port."""
        if self._httpd is not None:
            raise RuntimeError("the server is already bound")
        self._httpd = _HTTPServer(_split_address(address), self)
        return self._httpd.server_address[1]

    def start(self):
        if self._httpd is None:
            raise RuntimeError("add_insecure_port before start")
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.05},
            name="rpc-server", daemon=True)
        self._thread.start()

    def stop(self, grace=None):
        """Stop accepting calls and close the socket, waiting at most
        `grace` seconds (1 s when None) for the accept loop. With a
        `grace`, the calls in flight get up to that long to finish and
        their connections are then closed; with None they finish on
        their daemon threads."""
        httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        wait = 1.0 if grace is None else max(0.05, float(grace))
        if self._thread is not None:
            stopper = threading.Thread(target=httpd.shutdown, daemon=True)
            stopper.start()
            stopper.join(timeout=wait)
            self._thread.join(timeout=wait)
            self._thread = None
        httpd.server_close()
        if grace is None:
            return
        deadline = time.monotonic() + float(grace)
        with self._live_cv:
            while self._live and time.monotonic() < deadline:
                self._live_cv.wait(deadline - time.monotonic())
            cut = list(self._live)
        for sock in cut:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


def add_master_servicer_to_server(servicer, server):
    server.add_handlers(SERVICE_NAME, _METHODS, servicer)


def add_serving_servicer_to_server(servicer, server):
    server.add_handlers(SERVING_SERVICE_NAME, _SERVING_METHODS, servicer)


def add_router_servicer_to_server(servicer, server):
    server.add_handlers(ROUTER_SERVICE_NAME, _ROUTER_METHODS, servicer)


def build_server(max_send_message_length=GRPC.MAX_SEND_MESSAGE_LENGTH,
                 max_receive_message_length=GRPC.MAX_RECEIVE_MESSAGE_LENGTH,
                 max_workers=None):
    return Server(max_send_message_length, max_receive_message_length,
                  max_workers=max_workers)


# ------------------------------------------------------------- client


class _UnaryCall(object):
    def __init__(self, channel, path, request_serializer,
                 response_deserializer):
        self._channel = channel
        self._path = path
        self._serialize = request_serializer
        self._deserialize = response_deserializer

    def __call__(self, request, timeout=None):
        return self._deserialize(self._channel.call(
            self._path, self._serialize(request), timeout))


class _StreamCall(_UnaryCall):
    def __call__(self, request, timeout=None):
        return _Stream(self._channel, self._path, self._serialize(request),
                       self._deserialize, timeout)


def _left(deadline):
    """Seconds left before `deadline` (None: no deadline); raises
    DEADLINE_EXCEEDED once it has passed."""
    if deadline is None:
        return None
    left = deadline - time.monotonic()
    if left <= 0:
        raise RpcError("DEADLINE_EXCEEDED", "Deadline Exceeded")
    return left


@contextlib.contextmanager
def _transport_errors():
    """Socket and HTTP failures as the RpcError gRPC would raise."""
    try:
        yield
    except RpcError:
        raise
    except TimeoutError:
        raise RpcError("DEADLINE_EXCEEDED", "Deadline Exceeded")
    except (OSError, http.client.HTTPException) as e:
        raise RpcError("UNAVAILABLE", "%s: %s" % (type(e).__name__, e))


def _status_of(resp, body):
    """The reply's status name; raises RpcError unless it is OK."""
    code = resp.getheader(_STATUS_HEADER) or (
        "OK" if resp.status == 200 else "UNKNOWN")
    if code not in STATUS_CODES:
        code = "UNKNOWN"
    if code != "OK":
        raise RpcError(code, body.decode("utf-8", "replace"))
    return code


class Channel(object):
    """One server address; every call opens its own connection."""

    def __init__(self, addr,
                 max_send_message_length=GRPC.MAX_SEND_MESSAGE_LENGTH,
                 max_receive_message_length=GRPC.MAX_RECEIVE_MESSAGE_LENGTH):
        self.addr = addr
        self._host, self._port = _split_address(addr)
        self.max_send = max_send_message_length
        self.max_receive = max_receive_message_length

    def unary_unary(self, path, request_serializer, response_deserializer):
        return _UnaryCall(self, path, request_serializer,
                          response_deserializer)

    def unary_stream(self, path, request_serializer, response_deserializer):
        return _StreamCall(self, path, request_serializer,
                           response_deserializer)

    def open(self, path, body, deadline):
        """Connect and POST `body` to `path` (RpcError on failure);
        returns the connection (its `sock` kept: the reply owns the
        socket once read) and the reply's head."""
        if len(body) > self.max_send:
            raise RpcError("RESOURCE_EXHAUSTED",
                           "Sent message larger than max (%d vs. %d)"
                           % (len(body), self.max_send))
        conn = http.client.HTTPConnection(self._host, self._port,
                                          timeout=_left(deadline))
        try:
            with _transport_errors():
                conn.connect()
                _nodelay(conn.sock)
                conn.sock.settimeout(_left(deadline))
                conn.request("POST", path, body=body, headers={
                    "Content-Type": "application/octet-stream"})
                sock = conn.sock
                sock.settimeout(_left(deadline))
                resp = conn.getresponse()
                conn.sock = sock
                return conn, resp
        except BaseException:
            conn.close()
            raise

    def read_body(self, conn, resp, deadline):
        """The whole body of a reply that carries a Content-Length."""
        with _transport_errors():
            length = int(resp.getheader("Content-Length") or 0)
            if length > self.max_receive:
                raise RpcError("RESOURCE_EXHAUSTED",
                               "Received message larger than max (%d vs. "
                               "%d)" % (length, self.max_receive))
            conn.sock.settimeout(_left(deadline))
            data = resp.read(length)
            if len(data) != length:
                raise RpcError("UNAVAILABLE", "connection closed mid-reply")
        return data

    def call(self, path, body, timeout=None):
        """POST `body` to `path`; the response body, or RpcError."""
        deadline = None if timeout is None else time.monotonic() + timeout
        conn, resp = self.open(path, body, deadline)
        try:
            data = self.read_body(conn, resp, deadline)
        finally:
            conn.close()
        _status_of(resp, data)
        return data

    def close(self):
        """Nothing is held between calls."""


class _Stream(object):
    """A server-streaming call: iterate it for the response messages.
    The request is sent when the call is made; a failure (admission,
    transport, the trailer's status) raises RpcError from the iteration,
    after the messages that came before it. `cancel()` hangs up."""

    def __init__(self, channel, path, body, deserialize, timeout):
        self._channel = channel
        self._deserialize = deserialize
        self._deadline = (None if timeout is None
                          else time.monotonic() + timeout)
        self._conn = self._resp = self._error = None
        self._done = False
        try:
            self._conn, self._resp = channel.open(path, body,
                                                  self._deadline)
        except RpcError as e:
            self._error = e

    def __iter__(self):
        return self

    def _read(self, n):
        with _transport_errors():
            self._conn.sock.settimeout(_left(self._deadline))
            data = self._resp.read(n)
        if len(data) != n:
            raise RpcError("UNAVAILABLE",
                           "connection closed before the stream's trailer")
        return data

    def __next__(self):
        if self._done:
            raise StopIteration
        try:
            return self._next()
        except BaseException:
            self._finish()
            raise

    def _next(self):
        if self._error is not None:
            raise self._error
        if self._conn is None:
            raise RpcError("CANCELLED", "Locally cancelled by application!")
        if not self._resp.getheader(_STREAM_HEADER):
            data = self._channel.read_body(self._conn, self._resp,
                                           self._deadline)
            _status_of(self._resp, data)
            raise RpcError("INTERNAL", "a unary reply to a streaming call")
        kind, n = _FRAME.unpack(self._read(_FRAME.size))
        if n > self._channel.max_receive:
            raise RpcError("RESOURCE_EXHAUSTED",
                           "Received message larger than max (%d vs. %d)"
                           % (n, self._channel.max_receive))
        payload = self._read(n)
        if kind == _MESSAGE:
            return self._deserialize(payload)
        code, _, details = payload.decode("utf-8", "replace").partition("\n")
        self._finish()
        if code not in STATUS_CODES:
            code = "UNKNOWN"
        if code != "OK":
            raise RpcError(code, details)
        raise StopIteration

    def _finish(self):
        self._done = True
        if self._conn is not None:
            self._conn.close()

    def cancel(self):
        """Hang up: the server stops writing at its next frame."""
        self._finish()
        self._conn = None


class MasterStub(object):
    def __init__(self, channel):
        for name, (req_cls, resp_cls) in _METHODS.items():
            setattr(self, name, channel.unary_unary(
                "/%s/%s" % (SERVICE_NAME, name),
                request_serializer=req_cls.SerializeToString,
                response_deserializer=resp_cls.FromString))


def _bind(stub, channel, service_name, methods):
    for name, (req_cls, resp_cls, streaming) in methods.items():
        make = channel.unary_stream if streaming else channel.unary_unary
        setattr(stub, name, make(
            "/%s/%s" % (service_name, name),
            request_serializer=req_cls.SerializeToString,
            response_deserializer=resp_cls.FromString))


class ServingStub(object):
    def __init__(self, channel):
        _bind(self, channel, SERVING_SERVICE_NAME, _SERVING_METHODS)


class RouterStub(object):
    def __init__(self, channel):
        _bind(self, channel, ROUTER_SERVICE_NAME, _ROUTER_METHODS)


def build_channel(addr,
                  max_send_message_length=GRPC.MAX_SEND_MESSAGE_LENGTH,
                  max_receive_message_length=GRPC.MAX_RECEIVE_MESSAGE_LENGTH):
    return Channel(addr, max_send_message_length,
                   max_receive_message_length)
