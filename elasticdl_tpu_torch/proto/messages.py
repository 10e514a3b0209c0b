"""The control-plane messages, the port's copy of the Master and Serving
parts of elasticdl_tpu/proto/elasticdl.proto, with the proto3 binary
wire format written and read by hand.

The card's machine has no protobuf package, so each message is a plain
Python class declaring its fields by proto3 field number, type and
default. `SerializeToString()` and `FromString(data)` write and read the
same bytes protobuf does for these messages:

* int32, int64, enums and bools are varints; a negative int32 or int64
  is the 10-byte varint of its 64-bit two's complement, as proto3
  writes it; a bool parses True from any non-zero varint;
* float is 4 little-endian bytes (wire type 5) and double 8 (wire type
  1); a float field holds its value rounded to fp32, as protobuf's
  does (0.7 reads back as 0.699999988), and a value past fp32's range
  becomes an infinity;
* string and bytes are length-delimited (strings UTF-8, checked on
  parse as protobuf does);
* repeated int32 / int64 are written packed (one length-delimited
  run of varints), as proto3 writes them, and parse packed or not;
  occurrences of the field concatenate;
* repeated string, repeated bytes and repeated nested messages are
  one length-delimited record per item (never packed; an empty string
  or an empty message is still written), in list order;
* `map<string, string>` and `map<string, int32>` are repeated entry
  messages (key = 1, value = 2, both always written) under the map's
  field number, in the dict's order;
* scalars equal to their default (0, False, "", b"", an empty list)
  are not written, a float or double only when all its bits are zero
  (so -0.0 is written, as protobuf writes it), and fields go out in
  field-number order;
* on parse, a singular scalar keeps its last value, map entries merge
  (a later key wins), and fields of unknown numbers, or of a known
  number under a wire type its kind does not take, are skipped (all
  five wire types), as protobuf does.

The enums (`TaskType`, `TaskReason`) keep their numbers, and their
values are module constants (`TRAINING` ... `NONE`, `JOB_COMPLETE`) as
in the generated module. The serving messages are those of one
replica (generate, generate_stream, server_status, reload_checkpoint)
and of the disaggregated chain handoff (export_chain, transfer_chain,
abort_transfer); the router's messages are not ported yet.
"""

import math
import struct

_MASK64 = (1 << 64) - 1
_INT32 = (-(1 << 31), (1 << 31) - 1)
_INT64 = (-(1 << 63), (1 << 63) - 1)

# wire types
_VARINT, _I64, _LEN, _SGROUP, _EGROUP, _I32 = 0, 1, 2, 3, 4, 5


class DecodeError(ValueError):
    """Bytes that are not a valid encoding of the message."""


class _Enum(object):
    """A proto3 enum: its values as class attributes, `Name(number)`
    and `Value(name)` as in the generated module."""

    _VALUES = ()

    @classmethod
    def Name(cls, number):
        for name, value in cls._VALUES:
            if value == number:
                return name
        raise ValueError("enum %s has no value %r" % (cls.__name__, number))

    @classmethod
    def Value(cls, name):
        return dict(cls._VALUES)[name]


class TaskType(_Enum):
    _VALUES = (("TRAINING", 0), ("EVALUATION", 1), ("PREDICTION", 2),
               ("WAIT", 3), ("TRAIN_END_CALLBACK", 4), ("NONE", 5))


class TaskReason(_Enum):
    _VALUES = (("REASON_UNSPECIFIED", 0), ("JOB_COMPLETE", 1))


for _enum in (TaskType, TaskReason):
    for _name, _value in _enum._VALUES:
        setattr(_enum, _name, _value)
        globals()[_name] = _value


# ----------------------------------------------------------- primitives


def _write_varint(out, value):
    value &= _MASK64
    while value > 0x7F:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)


def _read_varint(data, pos):
    result, shift = 0, 0
    while True:
        if pos >= len(data):
            raise DecodeError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & _MASK64, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than 10 bytes")


def _signed(value, bits):
    value &= (1 << bits) - 1
    return value - (1 << bits) if value >> (bits - 1) else value


def _write_tag(out, number, wire_type):
    _write_varint(out, (number << 3) | wire_type)


def _write_len(out, number, payload):
    _write_tag(out, number, _LEN)
    _write_varint(out, len(payload))
    out += payload


def _read_len(data, pos):
    n, pos = _read_varint(data, pos)
    end = pos + n
    if end > len(data):
        raise DecodeError("truncated length-delimited field")
    return data[pos:end], end


def _skip(data, pos, wire_type, number):
    """Position after one unknown field's value."""
    if wire_type == _VARINT:
        return _read_varint(data, pos)[1]
    if wire_type == _I64:
        pos += 8
    elif wire_type == _I32:
        pos += 4
    elif wire_type == _LEN:
        return _read_len(data, pos)[1]
    elif wire_type == _SGROUP:
        while True:
            key, pos = _read_varint(data, pos)
            if key & 7 == _EGROUP:
                if key >> 3 != number:
                    raise DecodeError("mismatched end-group tag")
                return pos
            pos = _skip(data, pos, key & 7, key >> 3)
    else:
        raise DecodeError("unexpected wire type %d" % wire_type)
    if pos > len(data):
        raise DecodeError("truncated fixed-width field")
    return pos


# --------------------------------------------------------- field kinds


_FIXED = {"float": ("<f", 4, _I32), "double": ("<d", 8, _I64)}


def _to_float32(value):
    """`value` rounded to fp32, as protobuf stores a float field."""
    try:
        return struct.unpack("<f", struct.pack("<f", value))[0]
    except OverflowError:  # past fp32's range
        return math.copysign(math.inf, value)


class _Scalar(object):
    """int32 / int64 / enum / bool / float / double / string / bytes."""

    def __init__(self, kind):
        self.kind = kind
        self.default = {"string": "", "bytes": b"", "bool": False,
                        "float": 0.0, "double": 0.0}.get(kind, 0)
        self.wire_types = (
            (_LEN,) if kind in ("string", "bytes")
            else (_FIXED[kind][2],) if kind in _FIXED else (_VARINT,))

    def check(self, name, value):
        if self.kind in ("int32", "enum", "int64"):
            if isinstance(value, bool) or not isinstance(value, int):
                raise TypeError("%s must be an int, got %r" % (name, value))
            lo, hi = _INT64 if self.kind == "int64" else _INT32
            if not lo <= value <= hi:
                raise ValueError("%s=%d is out of %s range"
                                 % (name, value, self.kind))
        elif self.kind == "bool":
            if not isinstance(value, int):
                raise TypeError("%s must be a bool, got %r" % (name, value))
            return bool(value)
        elif self.kind in _FIXED:
            if not isinstance(value, (int, float)):
                raise TypeError("%s must be a real number, got %r"
                                % (name, value))
            value = float(value)
            return _to_float32(value) if self.kind == "float" else value
        elif self.kind == "string":
            if not isinstance(value, str):
                raise TypeError("%s must be a str, got %r" % (name, value))
        elif not isinstance(value, (bytes, bytearray)):
            raise TypeError("%s must be bytes, got %r" % (name, type(value)))
        return bytes(value) if self.kind == "bytes" else value

    def _is_default(self, value):
        if self.kind in _FIXED:
            # all bits zero: -0.0 and NaN are written
            return not any(struct.pack(_FIXED[self.kind][0], value))
        return value == self.default

    def encode(self, out, number, value, always=False):
        if not always and self._is_default(value):
            return
        if self.kind == "string":
            _write_len(out, number, value.encode("utf-8"))
        elif self.kind == "bytes":
            _write_len(out, number, value)
        elif self.kind in _FIXED:
            fmt, _size, wire_type = _FIXED[self.kind]
            _write_tag(out, number, wire_type)
            out += struct.pack(fmt, value)
        else:
            _write_tag(out, number, _VARINT)
            _write_varint(out, int(value))

    def decode(self, data, pos, wire_type, current):
        if self.kind in ("string", "bytes"):
            raw, pos = _read_len(data, pos)
            if self.kind == "bytes":
                return bytes(raw), pos
            try:
                return bytes(raw).decode("utf-8"), pos
            except UnicodeDecodeError as e:
                raise DecodeError("string field is not UTF-8: %s" % e)
        if self.kind in _FIXED:
            fmt, size, _wire_type = _FIXED[self.kind]
            if pos + size > len(data):
                raise DecodeError("truncated fixed-width field")
            return struct.unpack_from(fmt, data, pos)[0], pos + size
        value, pos = _read_varint(data, pos)
        if self.kind == "bool":
            return bool(value), pos
        return _signed(value, 64 if self.kind == "int64" else 32), pos


class _Repeated(object):
    """repeated int32 / int64: written packed, parsed packed or not."""

    wire_types = (_LEN, _VARINT)

    def __init__(self, kind):
        self.item = _Scalar(kind)

    @property
    def default(self):
        return []

    def check(self, name, value):
        return [self.item.check(name, v) for v in value]

    def encode(self, out, number, values):
        if not values:
            return
        payload = bytearray()
        for v in values:
            _write_varint(payload, v)
        _write_len(out, number, payload)

    def decode(self, data, pos, wire_type, current):
        bits = 64 if self.item.kind == "int64" else 32
        if wire_type == _VARINT:
            value, pos = _read_varint(data, pos)
            current.append(_signed(value, bits))
            return current, pos
        raw, end = _read_len(data, pos)
        p = 0
        while p < len(raw):
            value, p = _read_varint(raw, p)
            current.append(_signed(value, bits))
        return current, end


class _RepeatedLen(object):
    """repeated string / bytes: one length-delimited record an item."""

    wire_types = (_LEN,)

    def __init__(self, kind):
        self.item = _Scalar(kind)

    @property
    def default(self):
        return []

    def check(self, name, value):
        return [self.item.check(name, v) for v in value]

    def encode(self, out, number, values):
        for v in values:
            self.item.encode(out, number, v, always=True)

    def decode(self, data, pos, wire_type, current):
        value, pos = self.item.decode(data, pos, wire_type, None)
        current.append(value)
        return current, pos


class _RepeatedMessage(object):
    """repeated <message>: one length-delimited record a message."""

    wire_types = (_LEN,)

    def __init__(self, cls):
        self.cls = cls

    @property
    def default(self):
        return []

    def check(self, name, value):
        value = list(value)
        for v in value:
            if not isinstance(v, self.cls):
                raise TypeError("%s items must be %s, got %r"
                                % (name, self.cls.__name__, type(v)))
        return value

    def encode(self, out, number, values):
        for v in values:
            _write_len(out, number, v.SerializeToString())

    def decode(self, data, pos, wire_type, current):
        raw, pos = _read_len(data, pos)
        current.append(self.cls.FromString(raw))
        return current, pos


class _Map(object):
    """map<string, V>: repeated {key = 1: string, value = 2: V}."""

    wire_types = (_LEN,)

    def __init__(self, value_kind):
        self.key = _Scalar("string")
        self.value = _Scalar(value_kind)

    @property
    def default(self):
        return {}

    def check(self, name, value):
        return {self.key.check(name, k): self.value.check(name, v)
                for k, v in dict(value).items()}

    def encode(self, out, number, mapping):
        for k, v in mapping.items():
            self.key.check("map key", k)
            v = self.value.check("map value", v)
            entry = bytearray()
            # protobuf writes both halves of an entry, defaults too
            self.key.encode(entry, 1, k, always=True)
            self.value.encode(entry, 2, v, always=True)
            _write_len(out, number, entry)

    def decode(self, data, pos, wire_type, current):
        raw, end = _read_len(data, pos)
        key, value = self.key.default, self.value.default
        p = 0
        while p < len(raw):
            tag, p = _read_varint(raw, p)
            number, wt = tag >> 3, tag & 7
            if number == 1 and wt in self.key.wire_types:
                key, p = self.key.decode(raw, p, wt, key)
            elif number == 2 and wt in self.value.wire_types:
                value, p = self.value.decode(raw, p, wt, value)
            else:
                p = _skip(raw, p, wt, number)
        current[key] = value
        return current, end


# ------------------------------------------------------------- messages


class Message(object):
    """Base of the hand-coded messages. `FIELDS` is ((name, number,
    kind), ...) in field-number order."""

    FIELDS = ()

    def __init__(self, **kwargs):
        for name, _number, kind in self.FIELDS:
            object.__setattr__(self, name, kind.default)
        for name, value in kwargs.items():
            setattr(self, name, value)

    def __setattr__(self, name, value):
        kind = self._kinds().get(name)
        if kind is None:
            raise AttributeError("%s has no field %r"
                                 % (type(self).__name__, name))
        object.__setattr__(self, name, kind.check(name, value))

    @classmethod
    def _kinds(cls):
        kinds = cls.__dict__.get("_KINDS")
        if kinds is None:
            kinds = {name: kind for name, _n, kind in cls.FIELDS}
            cls._KINDS = kinds
        return kinds

    def SerializeToString(self):
        out = bytearray()
        for name, number, kind in self.FIELDS:
            kind.encode(out, number, getattr(self, name))
        return bytes(out)

    @classmethod
    def FromString(cls, data):
        msg = cls()
        by_number = {number: (name, kind)
                     for name, number, kind in cls.FIELDS}
        data = bytes(data)
        pos = 0
        while pos < len(data):
            key, pos = _read_varint(data, pos)
            number, wire_type = key >> 3, key & 7
            if number == 0:
                raise DecodeError("field number 0")
            field = by_number.get(number)
            if field is None or wire_type not in field[1].wire_types:
                pos = _skip(data, pos, wire_type, number)
                continue
            name, kind = field
            value, pos = kind.decode(data, pos, wire_type,
                                     getattr(msg, name))
            object.__setattr__(msg, name, value)
        return msg

    def ListFields(self):
        """(name, value) of every field not at its default."""
        return [(name, getattr(self, name)) for name, _n, kind in self.FIELDS
                if getattr(self, name) != kind.default]

    def __eq__(self, other):
        return type(self) is type(other) and all(
            getattr(self, n) == getattr(other, n) for n, _, _ in self.FIELDS)

    def __repr__(self):
        return "%s(%s)" % (type(self).__name__, ", ".join(
            "%s=%r" % kv for kv in self.ListFields()))


def _fields(*spec):
    return tuple((name, number, kind) for name, number, kind in spec)


_I32_ = _Scalar("int32")
_I64_ = _Scalar("int64")
_ENUM = _Scalar("enum")
_STR = _Scalar("string")
_BYTES = _Scalar("bytes")
_BOOL = _Scalar("bool")
_FLOAT = _Scalar("float")
_DOUBLE = _Scalar("double")
_I32S = _Repeated("int32")
_I64S = _Repeated("int64")
_STRS = _RepeatedLen("string")
_BYTESS = _RepeatedLen("bytes")


class Task(Message):
    FIELDS = _fields(
        ("task_id", 1, _I32_), ("shard_name", 2, _STR), ("start", 3, _I64_),
        ("end", 4, _I64_), ("type", 5, _ENUM), ("model_version", 6, _I32_),
        ("minibatch_size", 7, _I32_),
        ("extended_config", 8, _Map("string")), ("reason", 9, _ENUM),
        ("trace_id", 10, _STR), ("span_id", 11, _STR))


class GetTaskRequest(Message):
    FIELDS = _fields(("worker_id", 1, _I32_), ("task_type", 2, _ENUM))


class ReportTaskResultRequest(Message):
    FIELDS = _fields(("task_id", 1, _I32_), ("err_message", 2, _STR),
                     ("exec_counters", 3, _Map("int32")))


class ReportEvaluationMetricsRequest(Message):
    FIELDS = _fields(("worker_id", 1, _I32_), ("model_version", 2, _I32_),
                     ("model_outputs", 3, _BYTES), ("labels", 4, _BYTES))


class ReportVersionRequest(Message):
    FIELDS = _fields(("worker_id", 1, _I32_), ("model_version", 2, _I32_))


class Empty(Message):
    FIELDS = ()


class RegisterWorkerRequest(Message):
    FIELDS = _fields(("worker_id", 1, _I32_), ("address", 2, _STR),
                     ("num_devices", 3, _I32_))


class RegisterWorkerResponse(Message):
    FIELDS = _fields(("cluster_version", 1, _I32_))


# ----------------------------------------------------------- serving


class GenerateRequest(Message):
    FIELDS = _fields(
        ("prompt", 1, _I32S), ("max_new_tokens", 2, _I32_),
        ("temperature", 3, _FLOAT), ("seed", 4, _I32_),
        ("deadline_ms", 5, _I64_), ("trace_id", 6, _STR),
        ("parent_span_id", 7, _STR), ("prefill_only", 8, _BOOL))


class GenerateResponse(Message):
    FIELDS = _fields(("tokens", 1, _I32S), ("model_version", 2, _I32_))


class TokenChunk(Message):
    FIELDS = _fields(("tokens", 1, _I32S), ("done", 2, _BOOL),
                     ("model_version", 3, _I32_))


class ServerStatusRequest(Message):
    FIELDS = ()


class ServerStatusResponse(Message):
    FIELDS = _fields(
        ("queue_depth", 1, _I32_), ("active_slots", 2, _I32_),
        ("num_slots", 3, _I32_), ("model_version", 4, _I32_),
        ("admitted", 5, _I64_), ("rejected", 6, _I64_),
        ("expired", 7, _I64_), ("completed", 8, _I64_),
        ("tokens_generated", 9, _I64_), ("reloads", 10, _I64_),
        ("uptime_secs", 11, _DOUBLE), ("max_active_slots", 12, _I32_),
        ("kv_bytes_in_use", 13, _I64_), ("kv_bytes_total", 14, _I64_),
        ("kv_blocks_free", 15, _I32_), ("kv_blocks_total", 16, _I32_),
        ("kv_block_size", 17, _I32_), ("kv_paged", 18, _BOOL),
        ("kv_bytes_in_use_peak", 19, _I64_),
        ("kv_bytes_per_token", 20, _DOUBLE), ("draining", 21, _BOOL),
        ("queue_wait_ms", 22, _DOUBLE), ("ttft_p50_ms", 23, _DOUBLE),
        ("ttft_p90_ms", 24, _DOUBLE), ("ttft_p99_ms", 25, _DOUBLE),
        ("queue_wait_p50_ms", 26, _DOUBLE),
        ("queue_wait_p90_ms", 27, _DOUBLE),
        ("queue_wait_p99_ms", 28, _DOUBLE), ("ttft_hist", 29, _I64S),
        ("queue_wait_hist", 30, _I64S), ("kv_shared", 31, _BOOL),
        ("kv_blocks_shared", 32, _I32_), ("kv_blocks_cached", 33, _I32_),
        ("prefix_hit_tokens", 34, _I64_), ("cow_copies", 35, _I64_),
        ("draft_k", 36, _I32_), ("draft_proposed", 37, _I64_),
        ("draft_accepted", 38, _I64_), ("kv_cache_dtype", 39, _STR),
        ("kv_host_blocks", 40, _I32_), ("kv_host_bytes", 41, _I64_),
        ("revive_uploads", 42, _I64_),
        ("prefill_tokens_revived", 43, _I64_), ("host_drops", 44, _I64_),
        ("prefix_hit_rate_window", 45, _DOUBLE),
        ("slow_cause_counts", 46, _I64S),
        ("last_progress_age_ms", 47, _DOUBLE), ("health_state", 48, _STR),
        ("jit_compiles", 49, _I64_), ("steady_recompiles", 50, _I64_),
        ("memory_unaccounted_bytes", 51, _I64_), ("role", 52, _STR),
        ("chain_exports", 53, _I64_), ("chain_imports", 54, _I64_),
        ("chain_import_tokens", 55, _I64_), ("transfer_aborts", 56, _I64_),
        ("transfers_inflight", 57, _I32_), ("reload_failed", 58, _BOOL),
        ("reload_error", 59, _STR))


class ReloadCheckpointRequest(Message):
    FIELDS = _fields(("version", 1, _I32_))


class ReloadCheckpointResponse(Message):
    FIELDS = _fields(("ok", 1, _BOOL), ("model_version", 2, _I32_),
                     ("error", 3, _STR))


# ------------------------------------- disaggregated prefill/decode


class ExportChainRequest(Message):
    FIELDS = _fields(("prompt", 1, _I32S), ("transfer_id", 2, _STR))


class KvChainBlock(Message):
    """One block of a chain: its token ids and its raw row bytes, one
    entry per row leaf in the JAX package's `jax.tree.leaves` order."""

    FIELDS = _fields(("tokens", 1, _I32S), ("leaves", 2, _BYTESS))


class TransferChainRequest(Message):
    FIELDS = _fields(
        ("transfer_id", 1, _STR), ("block_size", 2, _I32_),
        ("leaf_dtypes", 3, _STRS),
        ("blocks", 4, _RepeatedMessage(KvChainBlock)))


class TransferChainResponse(Message):
    FIELDS = _fields(
        ("transfer_id", 1, _STR), ("ok", 2, _BOOL), ("blocks", 3, _I32_),
        ("tokens", 4, _I32_), ("error", 5, _STR))


class AbortTransferRequest(Message):
    FIELDS = _fields(("transfer_id", 1, _STR))


MESSAGES = (Task, GetTaskRequest, ReportTaskResultRequest,
            ReportEvaluationMetricsRequest, ReportVersionRequest, Empty,
            RegisterWorkerRequest, RegisterWorkerResponse)
SERVING_MESSAGES = (GenerateRequest, GenerateResponse, TokenChunk,
                    ServerStatusRequest, ServerStatusResponse,
                    ReloadCheckpointRequest, ReloadCheckpointResponse,
                    ExportChainRequest, KvChainBlock, TransferChainRequest,
                    TransferChainResponse, AbortTransferRequest)
