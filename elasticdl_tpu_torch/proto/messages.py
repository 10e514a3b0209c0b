"""The master's control-plane messages, the port's copy of the Master
part of elasticdl_tpu/proto/elasticdl.proto, with the proto3 binary
wire format written and read by hand.

The card's machine has no protobuf package, so each message is a plain
Python class declaring its fields by proto3 field number, type and
default. `SerializeToString()` and `FromString(data)` write and read the
same bytes protobuf does for these messages:

* int32, int64 and enums are varints; a negative int32 or int64 is the
  10-byte varint of its 64-bit two's complement, as proto3 writes it;
* string and bytes are length-delimited (strings UTF-8, checked on
  parse as protobuf does);
* `map<string, string>` and `map<string, int32>` are repeated entry
  messages (key = 1, value = 2, both always written) under the map's
  field number, in the dict's order;
* scalars equal to their default (0, "", b"") are not written, and
  fields go out in field-number order;
* on parse, a repeated scalar keeps its last value, map entries merge
  (a later key wins), and fields of unknown numbers are skipped (all
  five wire types), as protobuf does.

The enums (`TaskType`, `TaskReason`) keep their numbers, and their
values are module constants (`TRAINING` ... `NONE`, `JOB_COMPLETE`) as
in the generated module. The serving and router messages are not
ported yet.
"""

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


class _Scalar(object):
    """int32 / int64 / enum / string / bytes."""

    def __init__(self, kind):
        self.kind = kind
        self.default = {"string": "", "bytes": b""}.get(kind, 0)

    def check(self, name, value):
        if self.kind in ("int32", "enum", "int64"):
            if isinstance(value, bool) or not isinstance(value, int):
                raise TypeError("%s must be an int, got %r" % (name, value))
            lo, hi = _INT64 if self.kind == "int64" else _INT32
            if not lo <= value <= hi:
                raise ValueError("%s=%d is out of %s range"
                                 % (name, value, self.kind))
        elif self.kind == "string":
            if not isinstance(value, str):
                raise TypeError("%s must be a str, got %r" % (name, value))
        elif not isinstance(value, (bytes, bytearray)):
            raise TypeError("%s must be bytes, got %r" % (name, type(value)))
        return bytes(value) if self.kind == "bytes" else value

    def encode(self, out, number, value, always=False):
        if value == self.default and not always:
            return
        if self.kind == "string":
            _write_len(out, number, value.encode("utf-8"))
        elif self.kind == "bytes":
            _write_len(out, number, value)
        else:
            _write_tag(out, number, _VARINT)
            _write_varint(out, value)

    def decode(self, data, pos, wire_type, current):
        if self.kind in ("string", "bytes"):
            if wire_type != _LEN:
                raise DecodeError("%s field with wire type %d"
                                  % (self.kind, wire_type))
            raw, pos = _read_len(data, pos)
            if self.kind == "bytes":
                return bytes(raw), pos
            try:
                return bytes(raw).decode("utf-8"), pos
            except UnicodeDecodeError as e:
                raise DecodeError("string field is not UTF-8: %s" % e)
        if wire_type != _VARINT:
            raise DecodeError("%s field with wire type %d"
                              % (self.kind, wire_type))
        value, pos = _read_varint(data, pos)
        return _signed(value, 64 if self.kind == "int64" else 32), pos


class _Map(object):
    """map<string, V>: repeated {key = 1: string, value = 2: V}."""

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
        if wire_type != _LEN:
            raise DecodeError("map field with wire type %d" % wire_type)
        raw, end = _read_len(data, pos)
        key, value = self.key.default, self.value.default
        p = 0
        while p < len(raw):
            tag, p = _read_varint(raw, p)
            number, wt = tag >> 3, tag & 7
            if number == 1:
                key, p = self.key.decode(raw, p, wt, key)
            elif number == 2:
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
            if field is None:
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


MESSAGES = (Task, GetTaskRequest, ReportTaskResultRequest,
            ReportEvaluationMetricsRequest, ReportVersionRequest, Empty,
            RegisterWorkerRequest, RegisterWorkerResponse)
