"""TRec, the framework's record file format: the port's copy of the
pure-Python reader and writer in elasticdl_tpu/data/record_format.py
(the native scanner is not ported).

    file  := MAGIC(8) VERSION(u32) record* footer
    record:= len(u64) crc32(u32) payload[len]
    footer:= offsets[count](u64 each) count(u64) FOOT_MAGIC(8)

The trailing offset index gives O(1) seek to record i, which makes
record-range tasks cheap. Files written by either package read in the
other.
"""

import os
import struct
import zlib

MAGIC = b"TRECIO\x00\x01"
FOOT_MAGIC = b"TRECEND\x00"
VERSION = 1

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_REC_HDR = struct.Struct("<QI")  # payload_len, crc32


class RecordWriter(object):
    """Append-only writer. Use as a context manager; the index footer is
    written on close."""

    def __init__(self, path):
        self._f = open(path, "wb")
        self._offsets = []
        self._f.write(MAGIC)
        self._f.write(_U32.pack(VERSION))
        self._closed = False

    def write(self, payload):
        if isinstance(payload, str):
            payload = payload.encode("utf-8")
        self._offsets.append(self._f.tell())
        self._f.write(_REC_HDR.pack(len(payload), zlib.crc32(payload)))
        self._f.write(payload)

    def close(self):
        if self._closed:
            return
        for off in self._offsets:
            self._f.write(_U64.pack(off))
        self._f.write(_U64.pack(len(self._offsets)))
        self._f.write(FOOT_MAGIC)
        self._f.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def get_record_count(path):
    size = os.path.getsize(path)
    tail = _U64.size + len(FOOT_MAGIC)
    if size < len(MAGIC) + _U32.size + tail:
        raise ValueError("%s is not a TRec file (too small)" % path)
    with open(path, "rb") as f:
        f.seek(size - tail)
        count = _U64.unpack(f.read(_U64.size))[0]
        if f.read(len(FOOT_MAGIC)) != FOOT_MAGIC:
            raise ValueError("%s has a corrupt TRec footer" % path)
    return count


def _read_index(path):
    size = os.path.getsize(path)
    count = get_record_count(path)
    tail = _U64.size + len(FOOT_MAGIC)
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError("%s is not a TRec file" % path)
        f.seek(size - tail - _U64.size * count)
        data = f.read(_U64.size * count)
    return [_U64.unpack_from(data, i * _U64.size)[0] for i in range(count)]


class Scanner(object):
    """Iterate `count` records of `path` starting at record `start`
    (count < 0: to the end)."""

    def __init__(self, path, start=0, count=-1):
        self._offsets = _read_index(path)
        n = len(self._offsets)
        if count < 0:
            count = n - start
        self._path = path
        self._start = max(0, start)
        self._end = min(n, start + count)

    def __iter__(self):
        with open(self._path, "rb") as f:
            for i in range(self._start, self._end):
                f.seek(self._offsets[i])
                length, crc = _REC_HDR.unpack(f.read(_REC_HDR.size))
                payload = f.read(length)
                if zlib.crc32(payload) != crc:
                    raise IOError(
                        "CRC mismatch in %s at record %d" % (self._path, i)
                    )
                yield payload
