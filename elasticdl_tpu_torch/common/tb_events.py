"""TensorBoard event files without TensorFlow or protobuf: the port's copy
of elasticdl_tpu/common/tb_events.py.

An event file is TFRecord-framed `Event` protos; a scalar summary needs
only a few protobuf fields, encoded here by hand, and the record frame
is a length and the data, each followed by its masked CRC32C. Files
written here load in stock TensorBoard, and under one clock and node
name their bytes equal the JAX package's.

The master's TensorboardService (master/tensorboard_service.py), the
replica's and the router's telemetry (serving/telemetry.py) write
through `EventFileWriter`.
"""

import os
import struct
import time

# ------------------------------------------------------------- crc32c

_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for n in range(256):
        crc = n
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data):
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data):
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ----------------------------------------------------- protobuf encode


def _varint(n):
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _len_delimited(field_num, payload):
    return _varint((field_num << 3) | 2) + _varint(len(payload)) + payload


def _double_field(field_num, value):
    return _varint((field_num << 3) | 1) + struct.pack("<d", value)


def _float_field(field_num, value):
    return _varint((field_num << 3) | 5) + struct.pack("<f", value)


def _int64_field(field_num, value):
    return _varint(field_num << 3) + _varint(value & (2**64 - 1))


def encode_scalar_event(tag, value, step, wall_time=None):
    """Event{wall_time, step, summary{value{tag, simple_value}}}"""
    summary_value = _len_delimited(1, tag.encode("utf-8")) + _float_field(
        2, float(value))
    summary = _len_delimited(1, summary_value)
    return (
        _double_field(1, wall_time if wall_time is not None else time.time())
        + _int64_field(2, int(step))
        + _len_delimited(5, summary)
    )


def encode_file_version_event(wall_time=None):
    """The header event every event file starts with."""
    return _double_field(
        1, wall_time if wall_time is not None else time.time()
    ) + _len_delimited(3, b"brain.Event:2")


# -------------------------------------------------------- record frame


def frame_record(payload):
    """TFRecord framing: len(u64le) + masked_crc(len) + data +
    masked_crc(data)."""
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + payload
        + struct.pack("<I", _masked_crc(payload))
    )


class EventFileWriter(object):
    """Append scalar events to one `events.out.tfevents.*` file, each
    flushed as it is written."""

    def __init__(self, log_dir, filename_suffix=""):
        os.makedirs(log_dir, exist_ok=True)
        name = "events.out.tfevents.%d.%s%s" % (
            int(time.time()), os.uname().nodename, filename_suffix)
        self.path = os.path.join(log_dir, name)
        self._file = open(self.path, "ab")
        self._file.write(frame_record(encode_file_version_event()))
        self._file.flush()

    def add_scalar(self, tag, value, step):
        self._file.write(frame_record(encode_scalar_event(tag, value, step)))
        self._file.flush()

    def close(self):
        self._file.close()
