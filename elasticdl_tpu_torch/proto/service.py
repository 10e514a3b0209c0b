"""The Master service over a transport from the standard library: the
port's copy of elasticdl_tpu/proto/service.py without gRPC.

The JAX package binds the Master service's method table to grpc. The
card's machine has neither grpc nor protobuf, so the port carries the
same messages (proto/messages.py, the proto3 wire format by hand) over
HTTP/1.0 on a TCP socket:

* one call is `POST /elasticdl_tpu.Master/<method>` whose body is the
  encoded request; a 200 reply carries the encoded response, one
  connection per call;
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
    a body over the size cap              RESOURCE_EXHAUSTED
    a request that does not parse         INTERNAL
    an unknown method                     UNIMPLEMENTED

* `timeout=` on a stub call is the call's deadline: connect, send and
  each read get the time left, and a call past it raises
  DEADLINE_EXCEEDED;
* bodies are bounded by GRPC.MAX_SEND_MESSAGE_LENGTH /
  MAX_RECEIVE_MESSAGE_LENGTH (256 MB), as the JAX channel and server
  options bound them; a server drains an oversized body before it
  answers, so the client reads the answer and not a reset;
* the server answers each connection on a daemon thread of its own;
  `add_insecure_port("[::]:0")` binds an ephemeral port on every IPv4
  interface and returns the bound one.

A request is only ever parsed by its message class's `FromString`:
nothing on this path unpickles or evaluates what a client sent. The
serving and router method tables are not ported yet.
"""

import http.client
import http.server
import logging
import threading
import time

from elasticdl_tpu_torch.common.constants import GRPC
from elasticdl_tpu_torch.proto import messages as pb

logger = logging.getLogger(__name__)

SERVICE_NAME = "elasticdl_tpu.Master"

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

#: gRPC's status names (grpc.StatusCode), the codes an RpcError carries
STATUS_CODES = (
    "OK", "CANCELLED", "UNKNOWN", "INVALID_ARGUMENT", "DEADLINE_EXCEEDED",
    "NOT_FOUND", "ALREADY_EXISTS", "PERMISSION_DENIED", "RESOURCE_EXHAUSTED",
    "FAILED_PRECONDITION", "ABORTED", "OUT_OF_RANGE", "UNIMPLEMENTED",
    "INTERNAL", "UNAVAILABLE", "DATA_LOSS", "UNAUTHENTICATED",
)

_STATUS_HEADER = "X-Rpc-Status"
_DRAIN_CHUNK = 1 << 20


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
    """The status name an RpcError carries, or None for other
    exceptions."""
    return exc.code() if isinstance(exc, RpcError) else None


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

    def log_message(self, fmt, *args):
        logger.debug("rpc %s: " + fmt, self.address_string(), *args)

    def _reply(self, code, body):
        self.send_response(200 if code == "OK" else 500)
        self.send_header(_STATUS_HEADER, code)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

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
        fn, req_cls = method
        try:
            request = req_cls.FromString(body)
        except Exception as e:  # noqa: BLE001 - answered as INTERNAL
            self._fail("INTERNAL", "Exception deserializing request: %s"
                       % e)
            return
        try:
            response = fn(request, None)
        except Exception as e:  # noqa: BLE001 - every failure is answered
            code = status_name(e)
            if code in STATUS_CODES and code != "OK":
                self._fail(code, e.details())
            else:
                logger.exception("rpc %s raised", self.path)
                self._fail("UNKNOWN", "Exception calling application: %s"
                           % e)
            return
        out = response.SerializeToString()
        if len(out) > rpc.max_send:
            self._fail("RESOURCE_EXHAUSTED",
                       "Sent message larger than max (%d vs. %d)"
                       % (len(out), rpc.max_send))
            return
        self._reply("OK", out)


class _HTTPServer(http.server.ThreadingHTTPServer):
    daemon_threads = True
    block_on_close = False

    def __init__(self, address, rpc):
        self.rpc = rpc
        super().__init__(address, _Handler)


class Server(object):
    """The gRPC server's surface the master uses: `add_insecure_port`,
    `start`, `stop(grace)`."""

    def __init__(self,
                 max_send_message_length=GRPC.MAX_SEND_MESSAGE_LENGTH,
                 max_receive_message_length=GRPC.MAX_RECEIVE_MESSAGE_LENGTH):
        self.handlers = {}  # "/service/method" -> (fn, request class)
        self.max_send = max_send_message_length
        self.max_receive = max_receive_message_length
        self._httpd = None
        self._thread = None

    def add_handlers(self, service_name, methods, servicer):
        for name, (req_cls, _resp_cls) in methods.items():
            self.handlers["/%s/%s" % (service_name, name)] = (
                getattr(servicer, name), req_cls)

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
        `grace` seconds (1 s when None) for the accept loop; calls in
        flight finish on their daemon threads."""
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


def add_master_servicer_to_server(servicer, server):
    server.add_handlers(SERVICE_NAME, _METHODS, servicer)


def build_server(max_send_message_length=GRPC.MAX_SEND_MESSAGE_LENGTH,
                 max_receive_message_length=GRPC.MAX_RECEIVE_MESSAGE_LENGTH):
    return Server(max_send_message_length, max_receive_message_length)


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


def _left(deadline):
    """Seconds left before `deadline` (None: no deadline); raises
    DEADLINE_EXCEEDED once it has passed."""
    if deadline is None:
        return None
    left = deadline - time.monotonic()
    if left <= 0:
        raise RpcError("DEADLINE_EXCEEDED", "Deadline Exceeded")
    return left


class Channel(object):
    """One master address; every call opens its own connection."""

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

    def call(self, path, body, timeout=None):
        """POST `body` to `path`; the response body, or RpcError."""
        if len(body) > self.max_send:
            raise RpcError("RESOURCE_EXHAUSTED",
                           "Sent message larger than max (%d vs. %d)"
                           % (len(body), self.max_send))
        deadline = None if timeout is None else time.monotonic() + timeout
        conn = http.client.HTTPConnection(self._host, self._port,
                                          timeout=_left(deadline))
        try:
            conn.connect()
            conn.sock.settimeout(_left(deadline))
            conn.request("POST", path, body=body, headers={
                "Content-Type": "application/octet-stream"})
            sock = conn.sock
            sock.settimeout(_left(deadline))
            resp = conn.getresponse()
            length = int(resp.getheader("Content-Length") or 0)
            if length > self.max_receive:
                raise RpcError("RESOURCE_EXHAUSTED",
                               "Received message larger than max (%d vs. "
                               "%d)" % (length, self.max_receive))
            sock.settimeout(_left(deadline))
            data = resp.read(length)
            if len(data) != length:
                raise RpcError("UNAVAILABLE", "connection closed mid-reply")
        except RpcError:
            raise
        except TimeoutError:
            raise RpcError("DEADLINE_EXCEEDED", "Deadline Exceeded")
        except (OSError, http.client.HTTPException) as e:
            raise RpcError("UNAVAILABLE", "%s: %s" % (type(e).__name__, e))
        finally:
            conn.close()
        code = resp.getheader(_STATUS_HEADER) or (
            "OK" if resp.status == 200 else "UNKNOWN")
        if code not in STATUS_CODES:
            code = "UNKNOWN"
        if code != "OK":
            raise RpcError(code, data.decode("utf-8", "replace"))
        return data

    def close(self):
        """Nothing is held between calls."""


class MasterStub(object):
    def __init__(self, channel):
        for name, (req_cls, resp_cls) in _METHODS.items():
            setattr(self, name, channel.unary_unary(
                "/%s/%s" % (SERVICE_NAME, name),
                request_serializer=req_cls.SerializeToString,
                response_deserializer=resp_cls.FromString))


def build_channel(addr,
                  max_send_message_length=GRPC.MAX_SEND_MESSAGE_LENGTH,
                  max_receive_message_length=GRPC.MAX_RECEIVE_MESSAGE_LENGTH):
    return Channel(addr, max_send_message_length,
                   max_receive_message_length)
